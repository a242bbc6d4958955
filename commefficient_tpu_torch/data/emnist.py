"""Federated EMNIST (LEAF FEMNIST), one client per writer: the port's
copy of commefficient_tpu/data/emnist.py (reference
data_utils/fed_emnist.py: LEAF per-user JSON, 28x28x1 images, 62
classes). The whole corpus lives in one .npz per split (images,
targets, per-writer offsets); fetches are numpy slices.

Sources, in order of preference:
  1. LEAF JSON shards under <dataset_dir>/EMNIST/raw/{train,test}/*.json;
  2. `synthetic_examples=(num_writers, images_per_writer)`: class
     templates plus a per-writer style shift, the same generator and
     draw order as the JAX package.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset
from commefficient_tpu_torch.utils.atomic_io import atomic_savez

NUM_CLASSES = 62
HW = 28


def read_leaf_dir(data_dir: str):
    """Parse every LEAF .json shard in `data_dir` into
    {user: (images [n, 28, 28, 1] uint8, labels [n] int64)}
    (reference read_data, fed_emnist.py:11-33; stdlib json instead of
    orjson, which is not in this environment)."""
    users = {}
    for fname in sorted(os.listdir(data_dir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(data_dir, fname)) as f:
            shard = json.load(f)
        for user, ud in shard["user_data"].items():
            x = np.asarray(ud["x"], np.float32).reshape(-1, HW, HW, 1)
            # LEAF stores white-background floats in [0, 1]
            x = (x * 255).astype(np.uint8)
            y = np.asarray(ud["y"], np.int64)
            users[user] = (x, y)
    return users


# bump when _synthetic_emnist's semantics change: the on-disk cache is
# keyed by sizing + this stamp (see _cached_stats_ok)
_SYNTH_VERSION = 1


def _synthetic_emnist(num_writers: int, per_writer: int, n_val: int,
                      seed: int):
    """Writer-heterogeneous synthetic handwriting: class templates +
    per-writer style shift, mirroring FEMNIST's non-IIDness."""
    rng = np.random.RandomState(seed)
    templates = rng.rand(NUM_CLASSES, HW, HW, 1).astype(np.float32)

    def writer(w_seed, n):
        wrng = np.random.RandomState(w_seed)
        style = wrng.randn(HW, HW, 1).astype(np.float32) * 0.1
        y = wrng.randint(0, NUM_CLASSES, n)
        x = templates[y] + style + wrng.randn(n, HW, HW, 1).astype(
            np.float32) * 0.05
        return (np.clip(x, 0, 1) * 255).astype(np.uint8), y

    train = [writer(seed * 77 + w, per_writer) for w in range(num_writers)]
    val_x, val_y = writer(seed * 77 - 1, n_val)
    return train, (val_x, val_y)


class FedEMNIST(FedDataset):
    num_classes = NUM_CLASSES

    def __init__(self, dataset_dir, dataset_name="EMNIST", transform=None,
                 do_iid=False, num_clients=None, train=True, download=False,
                 synthetic_examples: Optional[Tuple[int, int]] = None,
                 seed: int = 0):
        self._synthetic_examples = synthetic_examples
        self._seed = seed
        self._z = {}
        super().__init__(dataset_dir, dataset_name, transform, do_iid,
                         num_clients, train, download, seed)

    def _dir(self):
        return os.path.join(self.dataset_dir, self.dataset_name)

    def _npz_path(self, split: str) -> str:
        return os.path.join(self._dir(), f"{split}.npz")

    def _cached_stats_ok(self) -> bool:
        """Re-prepare when the cached corpus isn't the one that would
        be prepared NOW (same contract as FedCIFAR10._cached_stats_ok:
        real LEAF shards on disk always win, so a synthetic-stamped
        cache is stale once they appear; a synthetic cache must match
        the requested sizing and generator version)."""
        try:
            with open(self.stats_path()) as f:
                stats = json.load(f)
        except (OSError, ValueError):
            # a missing, unreadable or torn stats file: re-prepare
            return False
        if os.path.isdir(os.path.join(self._dir(), "raw", "train")):
            return stats.get("source") == "leaf"
        if self._synthetic_examples is None:
            return True
        writers, per_writer = self._synthetic_examples
        ipc = stats["images_per_client"]
        return (stats.get("source") == "synthetic"
                and stats.get("synthetic_version") == _SYNTH_VERSION
                and len(ipc) == writers
                and all(n == per_writer for n in ipc))

    def prepare(self, download: bool = False):
        raw_train = os.path.join(self._dir(), "raw", "train")
        raw_test = os.path.join(self._dir(), "raw", "test")
        if os.path.isdir(raw_train):
            users = read_leaf_dir(raw_train)
            train = [users[u] for u in sorted(users)]
            test_users = (read_leaf_dir(raw_test)
                          if os.path.isdir(raw_test) else {})
            if test_users:
                vx = np.concatenate([x for x, _ in test_users.values()])
                vy = np.concatenate([y for _, y in test_users.values()])
            else:
                vx = np.zeros((0, HW, HW, 1), np.uint8)
                vy = np.zeros((0,), np.int64)
        elif self._synthetic_examples is not None:
            writers, per_writer = self._synthetic_examples
            train, (vx, vy) = _synthetic_emnist(
                writers, per_writer, n_val=max(per_writer * 4, 64),
                seed=self._seed)
        else:
            raise FileNotFoundError(
                f"No LEAF shards under {raw_train} and no network egress; "
                f"pass synthetic_examples=(num_writers, images_per_writer)")

        os.makedirs(self._dir(), exist_ok=True)
        images = np.concatenate([x for x, _ in train])
        targets = np.concatenate([y for _, y in train])
        offsets = np.concatenate(
            [[0], np.cumsum([len(y) for _, y in train])])
        atomic_savez(self._npz_path("train"), images=images,
                     targets=targets, offsets=offsets)
        atomic_savez(self._npz_path("val"), images=vx, labels=vy)
        from_leaf = os.path.isdir(raw_train)
        self.write_stats(
            [len(y) for _, y in train], len(vy),
            extra=({"source": "leaf"} if from_leaf else
                   {"source": "synthetic",
                    "synthetic_version": _SYNTH_VERSION}))

    def _load(self, split: str):
        if split not in self._z:
            self._z[split] = dict(np.load(self._npz_path(split)))
        return self._z[split]

    def _get_train_batch(self, nat_client_id: int, idxs: np.ndarray):
        z = self._load("train")
        start = z["offsets"][nat_client_id]
        sel = start + np.asarray(idxs)
        return z["images"][sel], z["targets"][sel]

    def _get_val_batch(self, idxs: np.ndarray):
        z = self._load("val")
        return z["images"][idxs], z["labels"][idxs]
