"""Client sampling: the port's copy of the uniform draw of
commefficient_tpu/data/sampler.py (reference data_utils/fed_sampler.py).

Per epoch: permute each client's local indices, then repeatedly draw
`num_workers` non-exhausted clients without replacement and take up
to `local_batch_size` examples from each (the whole remaining client
dataset when -1). Every round is [num_workers, B] indices plus a
float validity mask, B fixed for the run. The draws are the JAX
package's numpy calls in the same order, so the same seed yields the
same rounds bit for bit. Throughput sampling, idle-slot padding and
mid-epoch stream checkpoints are ROADMAP.md Queue 1 items 6 and 9.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np


class RoundIndices(NamedTuple):
    client_ids: np.ndarray   # [num_workers] int32
    idx_within: np.ndarray   # [num_workers, B] int32 local indices
    mask: np.ndarray         # [num_workers, B] f32 validity


class FedSampler:
    def __init__(self, data_per_client: np.ndarray, num_workers: int,
                 local_batch_size: int, seed: int = 0,
                 max_local_batch: int = -1):
        """max_local_batch caps the static batch dim B when
        local_batch_size == -1 (whole-client batches)."""
        self.data_per_client = np.asarray(data_per_client)
        self.num_clients = len(self.data_per_client)
        self.num_workers = num_workers
        self.local_batch_size = local_batch_size
        self.max_local_batch = max_local_batch
        self.rng = np.random.RandomState(seed)
        if num_workers > self.num_clients:
            raise ValueError(
                f"num_workers={num_workers} > num_clients={self.num_clients}")

    def _cap(self, take):
        if self.local_batch_size == -1 and self.max_local_batch > 0:
            return np.minimum(take, self.max_local_batch)
        return take

    @property
    def round_batch_size(self) -> int:
        if self.local_batch_size == -1:
            return int(self._cap(int(self.data_per_client.max())))
        return self.local_batch_size

    def steps_per_epoch(self) -> int:
        if self.local_batch_size == -1:
            if self.max_local_batch > 0:
                participations = int(np.ceil(
                    self.data_per_client / self.max_local_batch).sum())
                return max(participations // self.num_workers, 1)
            return int(self.num_clients // self.num_workers)
        total = int(self.data_per_client.sum())
        return int(np.ceil(total / (self.local_batch_size * self.num_workers)))

    def epoch(self) -> Iterator[RoundIndices]:
        B = self.round_batch_size
        dpc = self.data_per_client
        perms = [self.rng.permutation(n) for n in dpc]
        cursor = np.zeros(self.num_clients, dtype=int)
        while True:
            alive = np.where(cursor < dpc)[0]
            if len(alive) < self.num_workers:
                return
            chosen = self.rng.choice(alive, self.num_workers, replace=False)
            idx = np.zeros((self.num_workers, B), np.int32)
            mask = np.zeros((self.num_workers, B), np.float32)
            for w, cid in enumerate(chosen):
                remaining = dpc[cid] - cursor[cid]
                take = remaining if self.local_batch_size == -1 else min(
                    remaining, self.local_batch_size)
                take = int(self._cap(take))
                idx[w, :take] = perms[cid][cursor[cid]:cursor[cid] + take]
                mask[w, :take] = 1.0
                cursor[cid] += take
            yield RoundIndices(chosen.astype(np.int32), idx, mask)


class ValSampler:
    """Validation indices as fixed [num_shards, valid_batch_size] blocks,
    the tail padded with masked examples."""

    def __init__(self, num_examples: int, valid_batch_size: int,
                 num_shards: int):
        self.n = num_examples
        self.vb = valid_batch_size
        self.num_shards = num_shards

    def batches(self) -> Iterator[RoundIndices]:
        per_super = self.vb * self.num_shards
        for start in range(0, self.n, per_super):
            idxs = np.arange(start, min(start + per_super, self.n))
            pad = per_super - len(idxs)
            mask = np.concatenate(
                [np.ones(len(idxs), np.float32), np.zeros(pad, np.float32)])
            idxs = np.concatenate([idxs, np.zeros(pad, np.int64)])
            yield RoundIndices(
                np.full(self.num_shards, -1, np.int32),
                idxs.reshape(self.num_shards, self.vb).astype(np.int32),
                mask.reshape(self.num_shards, self.vb))
