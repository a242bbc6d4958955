"""Per-client communication accounting: the port of
commefficient_tpu/federated/accounting.py.

Upload bytes per participating client per round are the mode's wire
bytes (Config.upload_bytes: 4 x r x c for sketch, 4 x D for
uncompressed). Download bytes per participating client are 4 x the
number of weights that changed since that client last participated,
with the reference's cheap path (one updated-since-init bitset when
num_epochs <= 1 and whole-dataset batches) and its bounded-staleness
clamp (a deque of 10 / participation-rate change sets).

For local_topk the accountant also keeps the realized nonzero count of
the previous round's aggregate update (`realized_nonzeros`, and its
running maximum) beside the analytic per-client k: the sampled
threshold selection can keep more than k on ties.

The device packs each round's change mask into D/32 uint32 words
(`pack_change_bits`) so only those words come to the host; the host
half (CommAccountant) is the JAX package's numpy code.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from commefficient_tpu_torch.hooks import explicit_transfer
from commefficient_tpu_torch.config import Config

DEQUE_MAXLEN_MULT = 10

_POPCOUNT_TABLE = np.array([bin(i).count("1") for i in range(256)],
                           dtype=np.uint32)


def pack_change_bits(update: torch.Tensor) -> torch.Tensor:
    """Pack (update != 0) into 32-bit words, bit i of word w holding
    coordinate 32 * w + i (the JAX packing). Returned as int64 on the
    update's device, each value < 2^32; `to_words` makes the host
    uint32 array."""
    d = update.shape[0]
    n_words = -(-d // 32)
    bits = torch.nn.functional.pad((update != 0).to(torch.int64),
                                   (0, n_words * 32 - d))
    shifts = torch.arange(32, device=update.device, dtype=torch.int64)
    return (bits.view(n_words, 32) << shifts).sum(dim=1)


def to_words(packed: torch.Tensor) -> np.ndarray:
    with explicit_transfer("accounting: the previous round's change "
                           "bits, one round late"):
        return packed.cpu().numpy().astype(np.uint32)


def from_words(words: np.ndarray, device) -> torch.Tensor:
    """The exact inverse of to_words: host uint32 words (a checkpoint's
    `acct_prev_change_words`) as pack_change_bits' int64 values on
    `device`."""
    return torch.from_numpy(
        np.asarray(words, np.uint32).astype(np.int64)).to(device)


def _popcount(words: np.ndarray) -> int:
    return int(_POPCOUNT_TABLE[np.ascontiguousarray(words)
                               .view(np.uint8)].sum())


def _prefix_or_popcounts(changes, depths, n_words: int) -> dict:
    """{s: popcount(OR of the last s change bitsets)} for each
    staleness s in `depths`, one shared OR-prefix walk."""
    depths = sorted(set(int(d) for d in depths))
    if not depths:
        return {}
    out = {}
    if depths[0] == 0:
        out[0] = 0
    acc = np.zeros(n_words, np.uint32)
    need = set(depths)
    for d in range(1, depths[-1] + 1):
        acc |= changes[-d]
        if d in need:
            out[d] = _popcount(acc)
    return out


# the dense-upload modes, whose payload shrinks by the frozen
# coordinates of --finetune (a sketch table and a top-k budget do not)
_DENSE_UPLOAD = ("uncompressed", "true_topk", "fedavg")


class CommAccountant:
    def __init__(self, cfg: Config, num_clients: int,
                 frozen_count: int = 0):
        self.cfg = cfg
        self.num_clients = num_clients
        self.n_words = -(-cfg.grad_size // 32)
        self.upload_floats = cfg.upload_floats
        self.upload_bytes = float(cfg.upload_bytes)
        if frozen_count and cfg.mode in _DENSE_UPLOAD:
            # frozen coordinates transmit nothing (the reference's
            # requires_grad=False parameters are not in its vector)
            self.upload_floats = cfg.grad_size - frozen_count
            self.upload_bytes = 4.0 * self.upload_floats
        # local_topk: popcount of the previous round's change bitset,
        # to compare with (uploaders x k)
        self.realized_nonzeros: Optional[int] = None
        self.max_realized_nonzeros = 0
        self.cheap = (cfg.num_epochs <= 1 and cfg.local_batch_size == -1)
        if self.cheap:
            self.updated_since_init = np.zeros(self.n_words, np.uint32)
        else:
            participation = (cfg.num_workers / num_clients
                             * (1.0 - cfg.client_dropout))
            self.changes: deque = deque(
                [], maxlen=int(DEQUE_MAXLEN_MULT / participation))
            self.rounds_seen = 0
            self._last_reset: dict = {}

    def _check_ids(self, participating: np.ndarray) -> None:
        if participating.size and (
                int(participating.min()) < 0
                or int(participating.max()) >= self.num_clients):
            raise ValueError(
                f"client id out of range for a {self.num_clients}-client "
                f"population: {participating}")

    def staleness(self, client_ids) -> np.ndarray:
        ids = np.asarray(client_ids, np.int64).reshape(-1)
        return np.array([self.rounds_seen - self._last_reset.get(int(c), 0)
                         for c in ids], np.int64)

    def record_round(self, participating: np.ndarray,
                     prev_changed_words: Optional[np.ndarray],
                     survivors: Optional[np.ndarray] = None):
        """Account one round. `prev_changed_words` is the packed change
        bitset of the PREVIOUS round's update (None on the first round:
        nothing changed since the clients were initialized).
        `survivors` ([W] {0,1}, aligned with `participating`): the
        clients that completed the round. The round passes the
        admitted set under screening and the contributors under a
        robust aggregator, so a dropped, screened or fully trimmed
        client is charged nothing and its staleness keeps growing.
        Returns (download_bytes, upload_bytes), each [W] aligned with
        `participating`, 0 at the uncharged slots."""
        participating = np.asarray(participating).reshape(-1)
        self._check_ids(participating)
        W = participating.shape[0]
        alive = (np.ones(W, bool) if survivors is None
                 else np.asarray(survivors).reshape(-1) > 0)
        completed = participating[alive]
        download = np.zeros(W)
        if self.cheap:
            if prev_changed_words is not None:
                self.updated_since_init |= np.asarray(prev_changed_words)
            download[alive] = 4.0 * _popcount(self.updated_since_init)
        else:
            if prev_changed_words is not None:
                self.changes.append(np.asarray(prev_changed_words))
            if len(self.changes) and len(completed):
                stale = np.clip(self.staleness(completed), 0,
                                len(self.changes))
                counts = _prefix_or_popcounts(
                    self.changes, np.unique(stale), self.n_words)
                download[alive] = [4.0 * counts[int(s)] for s in stale]
            for c in completed:
                self._last_reset[int(c)] = self.rounds_seen
            self.rounds_seen += 1
        upload = np.where(alive, self.upload_bytes, 0.0)
        if self.cfg.mode == "local_topk" and prev_changed_words is not None:
            self.realized_nonzeros = _popcount(
                np.asarray(prev_changed_words))
            self.max_realized_nonzeros = max(self.max_realized_nonzeros,
                                             self.realized_nonzeros)
        return download, upload

    # -- checkpoint round-trip (utils/checkpoint.py writes it under
    #    `acct_*` keys, so a resumed run keeps its download charges) ---
    def state_dict(self) -> dict:
        state = {}
        if self.cheap:
            state["updated_since_init"] = self.updated_since_init.copy()
        else:
            # sparse staleness: arrays over the clients ever seen
            ids = np.array(sorted(self._last_reset), np.int64)
            state["stale_rounds"] = np.int64(self.rounds_seen)
            state["stale_ids"] = ids
            state["stale_at"] = np.array(
                [self._last_reset[int(c)] for c in ids], np.int64)
            state["changes"] = (np.stack(list(self.changes))
                                if len(self.changes)
                                else np.zeros((0, self.n_words), np.uint32))
        return state

    def load_state_dict(self, state: dict) -> None:
        if self.cheap:
            self.updated_since_init = np.asarray(
                state["updated_since_init"], np.uint32)
            return
        if "stale_ids" in state:
            self.rounds_seen = int(np.asarray(state["stale_rounds"]))
            ids = np.asarray(state["stale_ids"], np.int64)
            at = np.asarray(state["stale_at"], np.int64)
            self._last_reset = {int(c): int(a) for c, a in zip(ids, at)}
        else:
            # legacy dense staleness vector: an equivalent sparse map,
            # anchored at its maximum (never-seen clients sat there)
            stale = np.asarray(state["stale"], np.int64)
            self.rounds_seen = int(stale.max()) if stale.size else 0
            self._last_reset = {
                int(c): int(self.rounds_seen - s)
                for c, s in enumerate(stale)
                if int(s) != self.rounds_seen}
        rows = np.asarray(state["changes"], np.uint32)
        if self.changes.maxlen is not None and \
                len(rows) > self.changes.maxlen:
            # written under a wider window: grow to fit rather than
            # undercharge returning clients by dropping the oldest rows
            self.changes = deque([], maxlen=len(rows))
        self.changes.clear()
        for row in rows:
            self.changes.append(row)
