"""Round-batch assembly: the port's copy of
commefficient_tpu/data/loader.py (single process, no feed slices).
Each round is (client_ids [W], data tuple of [W, B, ...] NHWC numpy
arrays, mask [W, B]); FedModel moves it to the device."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset
from commefficient_tpu_torch.data.sampler import FedSampler, ValSampler


class FedLoader:
    def __init__(self, dataset: FedDataset, num_workers: int,
                 local_batch_size: int, seed: int = 0,
                 max_local_batch: int = -1):
        self.dataset = dataset
        self.sampler = FedSampler(dataset.data_per_client, num_workers,
                                  local_batch_size, seed=seed,
                                  max_local_batch=max_local_batch)
        # the augmentation stream rides in the sampler's checkpoint state
        self.sampler.aug_rng = getattr(dataset.transform, "rng", None)

    @property
    def steps_per_epoch(self) -> int:
        return self.sampler.steps_per_epoch()

    def epoch(self, skip: int = 0
              ) -> Iterator[Tuple[np.ndarray, Tuple[np.ndarray, ...],
                                  np.ndarray]]:
        """skip: pass over the first `skip` rounds with the sampler's
        index math only (a resume's fast-forward; the sampler's rng
        advances as in a full epoch)."""
        B = self.sampler.round_batch_size
        for r in self.sampler.epoch():
            if skip > 0:
                skip -= 1
                continue
            per_client = []
            for w in range(len(r.client_ids)):
                n_valid = int(r.mask[w].sum())
                # an idle slot (the scheduler sampled fewer than
                # num_workers) fetches nothing: its rows stay zeros
                got = (self.dataset.get_client_batch(
                    int(r.client_ids[w]), r.idx_within[w, :n_valid])
                    if n_valid else None)
                per_client.append((n_valid, got))
            # the scheduler selects at least one participant
            protos = next(got for _, got in per_client if got is not None)
            data = tuple(np.zeros((len(per_client), B) + p.shape[1:],
                                  p.dtype) for p in protos)
            for i, (n_valid, got) in enumerate(per_client):
                if got is None:
                    continue
                for buf, g in zip(data, got):
                    buf[i, :n_valid] = g
            yield r.client_ids, data, r.mask


class FedValLoader:
    """Validation batches as [num_shards, valid_batch_size] blocks."""

    def __init__(self, dataset: FedDataset, valid_batch_size: int,
                 num_shards: int):
        self.dataset = dataset
        self.sampler = ValSampler(dataset.num_val_images, valid_batch_size,
                                  num_shards)
        self.vb = valid_batch_size
        self.num_shards = num_shards

    def batches(self):
        for r in self.sampler.batches():
            idx = r.idx_within
            got = self.dataset.get_val_batch(idx.reshape(-1))
            data = tuple(g.reshape((idx.shape[0], self.vb) + g.shape[1:])
                         for g in got)
            yield data, r.mask
