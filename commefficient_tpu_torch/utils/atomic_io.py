"""Atomic file writes (`<path>.tmp`, flush, fsync, os.replace): the
port's copy of the part of commefficient_tpu/utils/atomic_io.py its
dataset caches use."""
from __future__ import annotations

import os

import numpy as np


def atomic_write_text(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_save(path: str, arr) -> None:
    """np.save to exactly `path` (the tmp file is opened here, so numpy
    appends no suffix)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_savez(path: str, **arrays) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
