"""Federated dataset base: the port's copy of
commefficient_tpu/data/fed_dataset.py (reference
data_utils/fed_dataset.py): a train corpus partitioned over clients
(natural units resharded over num_clients, or an IID reshuffle) plus a
flat validation set, with `stats.json` metadata beside the cached
arrays. Host-side numpy only.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from commefficient_tpu_torch.utils.atomic_io import atomic_write_text


class FedDataset:
    """Subclasses implement `prepare()` and the fetchers
    `_get_train_batch(client_id, idxs)` / `_get_val_batch(idxs)`."""

    def __init__(self, dataset_dir: str, dataset_name: str,
                 transform=None, do_iid: bool = False,
                 num_clients: Optional[int] = None, train: bool = True,
                 download: bool = False, seed: int = 0):
        self.dataset_dir = dataset_dir
        self.dataset_name = dataset_name
        self.transform = transform
        self.do_iid = do_iid
        self._num_clients = num_clients
        self.train = train

        if not do_iid and num_clients == 1:
            raise ValueError("can't have 1 client when non-iid")

        if (not os.path.exists(self.stats_path())
                or not self._cached_stats_ok()):
            self.prepare(download=download)
        self._load_meta()

        if self.do_iid:
            rng = np.random.RandomState(seed)
            self.iid_shuffle = rng.permutation(len(self))

        self._nat_cumsum = np.concatenate(
            [[0], np.cumsum(self.images_per_client)])

    # ---- metadata -------------------------------------------------------
    def stats_path(self) -> str:
        return os.path.join(self.dataset_dir, self.dataset_name,
                            "stats.json")

    def write_stats(self, images_per_client: Sequence[int],
                    num_val_images: int, extra: Optional[dict] = None):
        os.makedirs(os.path.dirname(self.stats_path()), exist_ok=True)
        stats = {"images_per_client": [int(x) for x in images_per_client],
                 "num_val_images": int(num_val_images)}
        if extra:
            stats.update(extra)
        atomic_write_text(self.stats_path(), json.dumps(stats))

    def _load_meta(self):
        with open(self.stats_path()) as f:
            stats = json.load(f)
        self.images_per_client = np.array(stats["images_per_client"])
        self.num_val_images = int(stats["num_val_images"])

    def _cached_stats_ok(self) -> bool:
        return True

    # ---- partition geometry ---------------------------------------------
    @property
    def num_clients(self) -> int:
        return (self._num_clients if self._num_clients is not None
                else len(self.images_per_client))

    @property
    def data_per_client(self) -> np.ndarray:
        """Per-client example counts after resharding the natural
        partition over num_clients (reference fed_dataset.py:31-48)."""
        if self.do_iid:
            n = len(self)
            per = np.full(self.num_clients, n // self.num_clients, dtype=int)
            per[self.num_clients - (n % self.num_clients):] += \
                1 if n % self.num_clients else 0
            return per
        out = []
        n_units = len(self.images_per_client)
        per_unit = (self._num_clients // n_units
                    if self._num_clients is not None else 1)
        if per_unit < 1 or (self._num_clients is not None
                            and self._num_clients % n_units):
            raise ValueError(
                f"non-IID partition needs num_clients to be a positive "
                f"multiple of the natural unit count ({n_units}), got "
                f"num_clients={self._num_clients}. Use a multiple of "
                f"{n_units}, or --iid.")
        for n_images in self.images_per_client:
            counts = [n_images // per_unit] * per_unit
            counts[-1] += n_images % per_unit
            out.extend(counts)
        return np.array(out)

    def __len__(self) -> int:
        if self.train:
            return int(np.sum(self.images_per_client))
        return self.num_val_images

    # ---- fetch ----------------------------------------------------------
    def client_flat_indices(self, client_id: int,
                            idx_within: np.ndarray) -> np.ndarray:
        dpc_cumsum = np.concatenate([[0], np.cumsum(self.data_per_client)])
        flat = dpc_cumsum[client_id] + idx_within
        if self.do_iid:
            flat = self.iid_shuffle[flat]
        return flat

    def get_client_batch(self, client_id: int,
                         idx_within: np.ndarray) -> Tuple[np.ndarray, ...]:
        flat = self.client_flat_indices(client_id, np.asarray(idx_within))
        nat = np.searchsorted(self._nat_cumsum, flat, side="right") - 1
        within = flat - self._nat_cumsum[nat]
        batch = self._gather_train(nat, within)
        if self.transform is not None:
            batch = self.transform(*batch)
        return batch

    def get_val_batch(self, idxs: np.ndarray) -> Tuple[np.ndarray, ...]:
        batch = self._get_val_batch(np.asarray(idxs))
        if self.transform is not None:
            batch = self.transform(*batch)
        return batch

    def _gather_train(self, nat_clients: np.ndarray,
                      idx_within: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Group by natural client, fetch, and restore the input order."""
        order = np.argsort(nat_clients, kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        sorted_nat = nat_clients[order]
        sorted_within = idx_within[order]
        outs = None
        for cid in np.unique(sorted_nat):
            sel = sorted_nat == cid
            got = self._get_train_batch(int(cid), sorted_within[sel])
            if outs is None:
                outs = [[] for _ in got]
            for o, g in zip(outs, got):
                o.append(g)
        stacked = [np.concatenate(o, axis=0) for o in outs]
        return tuple(s[inv] for s in stacked)

    # ---- subclass API ---------------------------------------------------
    def prepare(self, download: bool = False):
        raise NotImplementedError

    def _get_train_batch(self, nat_client_id: int, idxs: np.ndarray):
        raise NotImplementedError

    def _get_val_batch(self, idxs: np.ndarray):
        raise NotImplementedError
