"""The plain reference's count sketch, decode and server step (FetchSGD
with virtual momentum and virtual error), in plain PyTorch.

The hash family is the one the configuration's sketch is defined by
(a frozen copy of the convention): the [d] vector is cut into
B = ceil(d / c) chunks of c; row j sends coordinate i to bucket
(i mod c + off[j, i // c]) mod c with the sign eps[j, i mod c] *
delta[j, i // c]; the tables are numpy RandomState(42) drawn as
offsets [r, B], then eps [r, c], then delta [r, B], the signs from
(-1, +1). An estimate is the median over rows of the signed cells.

Decoding (the configuration's top-k of the error table's estimates):
past 32 Mi coordinates, with the padded vector under 256 Mi, by the
sampled threshold the sketch defines there (the estimates at chunk
positions 0, s, 2s, ... with s = min(max(1, padded // 2^20), c), the
round(k * n / padded)-th largest of their squares, every coordinate
whose square reaches it); otherwise exactly the k largest squares,
equal squares taken in index order (the order of a stable sort).

Everything works on slices of coordinates, so a [d] of hundreds of
millions needs a few GB at a time.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

THRESHOLD_MIN_D = 32 * 1024 * 1024
MATERIALIZE_LIMIT = 256 * 1024 * 1024
SAMPLE_TARGET = 1024 * 1024
SLICE = 1 << 25


class Sketch:
    def __init__(self, d: int, c: int, r: int, device, seed: int = 42):
        self.d, self.c, self.r = d, c, r
        self.B = -(-d // c)
        rng = np.random.RandomState(seed)
        off = rng.randint(0, c, size=(r, self.B)).astype(np.int64)
        eps = rng.choice([-1.0, 1.0], size=(r, c)).astype(np.float32)
        delta = rng.choice([-1.0, 1.0], size=(r, self.B)).astype(np.float32)
        self.off = torch.from_numpy(off).to(device)
        self.eps = torch.from_numpy(eps).to(device)
        self.delta = torch.from_numpy(delta).to(device)
        self.device = device

    def _hash(self, j: int, idx: torch.Tensor):
        b, p = idx // self.c, idx % self.c
        return ((p + self.off[j, b]) % self.c,
                self.eps[j, p] * self.delta[j, b])

    def _slices(self):
        for lo in range(0, self.d, SLICE):
            hi = min(lo + SLICE, self.d)
            yield lo, torch.arange(lo, hi, device=self.device)

    def encode(self, v: torch.Tensor) -> torch.Tensor:
        table = torch.zeros(self.r, self.c, device=self.device)
        for lo, idx in self._slices():
            x = v[lo:lo + idx.numel()]
            for j in range(self.r):
                bucket, sign = self._hash(j, idx)
                table[j].index_add_(0, bucket, sign * x)
        return table

    def estimate(self, table: torch.Tensor, idx: torch.Tensor
                 ) -> torch.Tensor:
        rows = []
        for j in range(self.r):
            bucket, sign = self._hash(j, idx)
            rows.append(sign * table[j, bucket])
        est = torch.stack(rows).median(dim=0).values
        return torch.where(idx < self.d, est, torch.zeros_like(est))

    def decode(self, table: torch.Tensor, k: int) -> torch.Tensor:
        """The [d] update: the top-k estimates, zero elsewhere."""
        padded = self.B * self.c
        if self.d > THRESHOLD_MIN_D and padded <= MATERIALIZE_LIMIT:
            stride = min(max(1, padded // SAMPLE_TARGET), self.c)
            ns = self.c // stride
            pos = (torch.arange(self.B, device=self.device)[:, None] * self.c
                   + torch.arange(ns, device=self.device)[None, :] * stride)
            sample = self.estimate(table, pos.reshape(-1).clamp(max=padded))
            n = sample.numel()
            ks = max(1, min(int(round(k * n / padded)), n))
            thr = torch.topk(sample * sample, ks).values[-1].clamp(
                min=torch.finfo(torch.float32).tiny)
            out = torch.zeros(self.d, device=self.device)
            for lo, idx in self._slices():
                est = self.estimate(table, idx)
                out[lo:lo + idx.numel()] = torch.where(
                    est * est >= thr, est, torch.zeros_like(est))
            return out
        est = torch.empty(self.d, device=self.device)
        for lo, idx in self._slices():
            est[lo:lo + idx.numel()] = self.estimate(table, idx)
        # the k largest squares, equal squares taken in index order
        sq = est * est
        kth = torch.topk(sq, min(k, self.d)).values[-1]
        keep = sq > kth
        ties = torch.nonzero(sq == kth)[:, 0]
        keep[ties[:min(k, self.d) - int(keep.sum())]] = True
        return torch.where(keep, est, torch.zeros_like(est))


def server_step(sk: Sketch, grad_table: torch.Tensor, V: torch.Tensor,
                E: torch.Tensor, k: int, rho: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(update [d], V, E): momentum and error in table space, the
    top-k of the error's estimates, and the cells the update's sketch
    lands in zeroed in both tables."""
    V = grad_table + rho * V
    E = E + V
    update = sk.decode(E, k)
    not_sent = (sk.encode(update) == 0).float()
    return update, V * not_sent, E * not_sent


def downloads(changes: List[torch.Tensor], seen: dict, round_idx: int,
              client_ids, depth: int) -> np.ndarray:
    """Bytes each client downloads at round `round_idx`: 4 x the
    coordinates changed since it last took part (every round so far for
    a new client), over at most the last `depth` rounds. `changes[t]`
    is round t's [d] bool change mask; `seen` maps a client to the
    round it last took part in."""
    out = []
    for cid in np.asarray(client_ids).reshape(-1):
        s = min(round_idx - seen.get(int(cid), 0), len(changes), depth)
        if s <= 0:
            out.append(0.0)
            continue
        acc = changes[-1].clone()
        for m in changes[-s:-1]:
            acc |= m
        out.append(4.0 * float(acc.sum()))
    return np.array(out)
