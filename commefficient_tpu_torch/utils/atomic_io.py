"""Atomic file writes (`<path>.<pid>.tmp`, flush, fsync, os.replace)
and the durable append of self-delimited lines: the port's copy of
commefficient_tpu/utils/atomic_io.py (dataset caches, checkpoints, the
run journal). The temporary name carries the writer's process id, so
processes that write the same file at once (the ranks of a grid
preparing one dataset cache, with the same bytes) never rename one
another's half-written file."""
from __future__ import annotations

import os

import numpy as np


def _tmp(path: str) -> str:
    return f"{path}.{os.getpid()}.tmp"


def atomic_write_text(path: str, text: str) -> None:
    tmp = _tmp(path)
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_bytes(path: str, data: bytes) -> None:
    tmp = _tmp(path)
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_append_line(path: str, line: str) -> None:
    """Append ONE self-delimited line (a JSONL record) durably; see
    atomic_append_lines."""
    atomic_append_lines(path, (line,))


def atomic_append_lines(path: str, lines, check_tail: bool = True) -> None:
    """Append self-delimited lines durably, with ONE flush + fsync for
    the batch.

    A preemption mid-write can tear at most the final line, which the
    journal's reader reports without losing a committed record. Before
    appending, a torn tail left by an earlier process is sealed with a
    newline, so the fragment stays its own (detectably invalid) line
    instead of corrupting the first new record. A torn tail can only
    predate this process's first append, so a long-lived writer passes
    check_tail=False after its first call."""
    seal = b""
    if check_tail:
        try:
            with open(path, "rb") as rf:
                rf.seek(-1, os.SEEK_END)
                if rf.read(1) != b"\n":
                    seal = b"\n"
        except (OSError, ValueError):
            pass  # missing or empty file: nothing to seal
    data = seal + "".join(f"{ln}\n" for ln in lines).encode()
    with open(path, "ab") as f:  # graftlint: disable=GL006 -- the append-only JSONL path: fsynced, a torn tail sealed (docstring)
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def atomic_save(path: str, arr) -> None:
    """np.save to exactly `path` (the tmp file is opened here, so numpy
    appends no suffix)."""
    tmp = _tmp(path)
    with open(tmp, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_savez(path: str, **arrays) -> None:
    tmp = _tmp(path)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
