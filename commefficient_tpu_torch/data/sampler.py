"""Client sampling: the port's copy of the uniform draw of
commefficient_tpu/data/sampler.py (reference data_utils/fed_sampler.py).

Per epoch: permute each client's local indices, then repeatedly draw
`num_workers` non-exhausted clients without replacement and take up
to `local_batch_size` examples from each (the whole remaining client
dataset when -1). Every round is [num_workers, B] indices plus a
float validity mask, B fixed for the run. The draws are the JAX
package's numpy calls in the same order, so the same seed yields the
same rounds bit for bit.

The stream is checkpointable (`state_dict`, `smp_*` keys): the MT19937
state plus, mid-epoch, the live epoch's permutations, cursors and
position, so a resumed run continues the exact stream instead of
replaying the epoch head. The train transform's augmentation generator
(`aug_rng`, set by FedLoader) rides along as `aug_rng_*` keys, which
the JAX package neither writes nor reads: its resumes restart the
augmentation from the seed, and so does the port's resume of a
checkpoint without them (ROADMAP.md Queue 3).

With a round scheduler attached (`scheduler`, commefficient_tpu_torch/
scheduler), the scheduler picks each round's participants: the uniform
default makes the same `rng.choice` call, so the stream is unchanged.
A policy may pick fewer than num_workers (a survivor target); the other
slots are padded with distinct unchosen ids and all-zero masks, which
the scheduler's plan marks dead (survivor 0), as the JAX sampler does.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np


class RoundIndices(NamedTuple):
    client_ids: np.ndarray   # [num_workers] int32
    idx_within: np.ndarray   # [num_workers, B] int32 local indices
    mask: np.ndarray         # [num_workers, B] f32 validity


class FedSampler:
    def __init__(self, data_per_client: np.ndarray, num_workers: int,
                 local_batch_size: int, seed: int = 0,
                 max_local_batch: int = -1, scheduler=None):
        """max_local_batch caps the static batch dim B when
        local_batch_size == -1 (whole-client batches); scheduler: an
        optional RoundScheduler (scheduler.attach_round_scheduler sets
        it after construction)."""
        self.data_per_client = np.asarray(data_per_client)
        self.num_clients = len(self.data_per_client)
        self.num_workers = num_workers
        self.local_batch_size = local_batch_size
        self.max_local_batch = max_local_batch
        self.rng = np.random.RandomState(seed)
        self.scheduler = scheduler
        # `_epoch` mirrors the live epoch generator's permutations,
        # cursor and position (state_dict reads it); `_pending` holds a
        # restored mid-epoch stream the next epoch() continues;
        # `_restored` makes resolve_resume answer 0
        self._epoch: Optional[dict] = None
        self._pending: Optional[dict] = None
        self._restored = False
        # the train transform's augmentation generator, or None
        self.aug_rng: Optional[np.random.RandomState] = None
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
        if self._pending is not None:
            # continue a restored mid-epoch stream: the restored rng
            # already holds every draw up to the suspension point
            st, self._pending = self._pending, None
            perms, cursor, pos = st["perms"], st["cursor"], st["pos"]
        else:
            perms = [self.rng.permutation(n) for n in dpc]
            cursor = np.zeros(self.num_clients, dtype=int)
            pos = 0
        # cursor is mutated in place below, so state_dict() sees the
        # suspended stream's position; exhaustion clears the mirror,
        # the next epoch() overwrites it
        self._epoch = {"perms": perms, "cursor": cursor, "pos": pos}
        while True:
            alive = np.where(cursor < dpc)[0]
            if len(alive) < self.num_workers:
                self._epoch = None
                return
            if self.scheduler is not None:
                chosen = np.asarray(self.scheduler.select(
                    alive, self.num_workers, self.rng))
            else:
                chosen = self.rng.choice(alive, self.num_workers,
                                         replace=False)
            slot_ids = chosen
            if len(chosen) < self.num_workers:
                # idle slots: distinct unchosen ids, zero masks, cursors
                # untouched (a duplicate id would race the live
                # client's row in the scatter-back)
                pad = np.setdiff1d(np.arange(self.num_clients),
                                   chosen)[:self.num_workers - len(chosen)]
                slot_ids = np.concatenate([chosen, pad])
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
            if self.scheduler is not None:
                self.scheduler.commit_round(slot_ids, mask.sum(axis=1))
            self._epoch["pos"] += 1
            yield RoundIndices(slot_ids.astype(np.int32), idx, mask)

    # ---------------- checkpointable stream state ------------------------

    @property
    def resume_pending(self) -> bool:
        """A restored mid-epoch stream waits for the next epoch()."""
        return self._pending is not None

    @property
    def pending_pos(self) -> Optional[int]:
        """Rounds the restored mid-epoch stream had drawn, or None. A
        stream restored at the drivers' per-epoch cap was abandoned
        there by the uninterrupted run (discard_pending); one short of
        it may be driven for the remaining rounds only."""
        return (None if self._pending is None
                else int(self._pending["pos"]))

    def discard_pending(self) -> None:
        """Drop a restored mid-epoch stream: the next epoch() draws
        fresh permutations from the restored rng."""
        self._pending = None

    def abandon_epoch(self) -> None:
        """The drivers' per-epoch round cap ended the epoch before the
        generator ran out: clear the live-stream mirror so a checkpoint
        written after this records in_epoch = 0. The rng keeps the
        abandoned stream's draws, as the uninterrupted run does."""
        self._epoch = None

    def resolve_resume(self, skip_rounds: int) -> int:
        """The `epoch(skip=)` of the first resumed epoch: 0 when this
        run restored sampler state (the stream position is exact), else
        `skip_rounds` (a checkpoint without `smp_*` keys replays the
        epoch head)."""
        if not self._restored:
            return int(skip_rounds)
        self._restored = False
        return 0

    def state_dict(self) -> dict:
        """The stream state as plain numpy arrays: the MT19937
        generator and, while an epoch is live, its permutations,
        cursors and position."""
        out = _rng_state("rng", self.rng)
        out["in_epoch"] = np.int64(0)
        if self.aug_rng is not None:
            out.update(_rng_state("aug_rng", self.aug_rng))
        st = self._epoch if self._epoch is not None else self._pending
        if st is not None:
            out["in_epoch"] = np.int64(1)
            out["epoch_pos"] = np.int64(st["pos"])
            # a COPY: the live epoch advances `cursor` in place
            out["cursor"] = np.array(st["cursor"], np.int64, copy=True)
            out["perm_flat"] = (
                np.concatenate([np.asarray(p, np.int64)
                                for p in st["perms"]])
                if len(st["perms"]) else np.zeros((0,), np.int64))
        return out

    def load_state_dict(self, state: dict) -> None:
        """Restore a state_dict() capture; a mid-epoch one waits in
        `_pending` for the next epoch()."""
        _set_rng_state("rng", self.rng, state)
        if self.aug_rng is not None and "aug_rng_key" in state:
            _set_rng_state("aug_rng", self.aug_rng, state)
        self._epoch = None
        self._pending = None
        self._restored = True
        if not int(np.asarray(state.get("in_epoch", 0))):
            return
        cursor = np.asarray(state["cursor"], dtype=int)
        flat = np.asarray(state["perm_flat"], dtype=int)
        dpc = self.data_per_client
        if cursor.shape[0] != self.num_clients or \
                flat.shape[0] != int(dpc.sum()):
            raise ValueError(
                "sampler checkpoint does not match this dataset: "
                f"cursor for {cursor.shape[0]} clients / "
                f"{flat.shape[0]} permutation entries vs "
                f"{self.num_clients} clients / {int(dpc.sum())} "
                "examples")
        perms, off = [], 0
        for n in dpc:
            perms.append(flat[off:off + int(n)].copy())
            off += int(n)
        self._pending = {"perms": perms, "cursor": cursor.copy(),
                         "pos": int(np.asarray(state["epoch_pos"]))}


def _rng_state(name: str, rng: np.random.RandomState) -> dict:
    kind, key, pos, has_gauss, cached = rng.get_state()
    assert kind == "MT19937"
    return {f"{name}_key": np.asarray(key, np.uint32),
            f"{name}_pos": np.int64(pos),
            f"{name}_has_gauss": np.int64(has_gauss),
            f"{name}_cached": np.float64(cached)}


def _set_rng_state(name: str, rng: np.random.RandomState,
                   state: dict) -> None:
    rng.set_state((
        "MT19937", np.asarray(state[f"{name}_key"], np.uint32),
        int(np.asarray(state[f"{name}_pos"])),
        int(np.asarray(state[f"{name}_has_gauss"])),
        float(np.asarray(state[f"{name}_cached"]))))


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
