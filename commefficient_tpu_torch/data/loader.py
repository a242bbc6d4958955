"""Round-batch assembly: the port's copy of
commefficient_tpu/data/loader.py. Each round is (client_ids [W], data
tuple of [W, B, ...] NHWC numpy arrays, mask [W, B]); FedModel moves it
to the device.

`feed_slice` (a multi-rank run, parallel/multihost.apply_feed_slices):
the sampler still draws the whole round on every rank (seeded index
math, the same everywhere), but only the rows of the slice are fetched,
transformed and materialized; the batch then carries the whole cohort's
client ids and the rank's rows of data and mask, FedModel's multi-rank
contract. A transform that draws from a stateful generator (CIFAR's
crop and flip) draws for the fetched rows only, so a rank's
augmentations differ from the same rows of a one-process run, in both
packages."""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset
from commefficient_tpu_torch.data.sampler import FedSampler, ValSampler


class FedLoader:
    def __init__(self, dataset: FedDataset, num_workers: int,
                 local_batch_size: int, seed: int = 0,
                 max_local_batch: int = -1,
                 feed_slice: Optional[slice] = None):
        self.dataset = dataset
        self.feed_slice = feed_slice
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
            W = len(r.client_ids)
            rows = (range(W) if self.feed_slice is None
                    else range(*self.feed_slice.indices(W)))
            if len(rows) == 0:
                raise NotImplementedError(
                    "this process owns no rows of the clients axis; "
                    "zero-row feeding is not supported — use a mesh "
                    "layout that gives every process client shards")
            per_client = []
            for w in rows:
                n_valid = int(r.mask[w].sum())
                # an idle slot (the scheduler sampled fewer than
                # num_workers) fetches nothing: its rows stay zeros
                got = (self.dataset.get_client_batch(
                    int(r.client_ids[w]), r.idx_within[w, :n_valid])
                    if n_valid else None)
                per_client.append((n_valid, got))
            # the scheduler selects at least one participant
            protos = next((got for _, got in per_client
                           if got is not None), None)
            if protos is None:
                raise NotImplementedError(
                    "every row this process feeds is an idle "
                    "(zero-mask) slot; feeding cannot derive batch "
                    "shapes — scheduler over-provisioning is single-"
                    "controller only (Config.validate enforces this)")
            data = tuple(np.zeros((len(per_client), B) + p.shape[1:],
                                  p.dtype) for p in protos)
            for i, (n_valid, got) in enumerate(per_client):
                if got is None:
                    continue
                for buf, g in zip(data, got):
                    buf[i, :n_valid] = g
            mask = (r.mask if self.feed_slice is None
                    else r.mask[self.feed_slice])
            yield r.client_ids, data, mask


class FedValLoader:
    """Validation batches as [num_shards, valid_batch_size] blocks."""

    def __init__(self, dataset: FedDataset, valid_batch_size: int,
                 num_shards: int, feed_slice: Optional[slice] = None):
        """feed_slice: as FedLoader's, over the shards."""
        self.dataset = dataset
        self.sampler = ValSampler(dataset.num_val_images, valid_batch_size,
                                  num_shards)
        self.vb = valid_batch_size
        self.num_shards = num_shards
        self.feed_slice = feed_slice

    def batches(self):
        for r in self.sampler.batches():
            idx = r.idx_within
            mask = r.mask
            if self.feed_slice is not None:
                idx = idx[self.feed_slice]
                mask = mask[self.feed_slice]
            got = self.dataset.get_val_batch(idx.reshape(-1))
            data = tuple(g.reshape((idx.shape[0], self.vb) + g.shape[1:])
                         for g in got)
            yield data, mask
