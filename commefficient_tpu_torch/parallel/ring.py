"""Ring attention: causal attention with the sequence sharded over a
ring of ranks, the port of commefficient_tpu/parallel/ring.py.

Each rank of the ring holds one contiguous chunk of the sequence ([B,
H, Lc, Dh] of queries, keys and values; chunk i holds the global
positions [i * Lc, (i + 1) * Lc)). The key and value chunks rotate
around the ring, and every rank folds each arriving chunk into the
online-softmax state of ops/attention.online_softmax_fold, so no rank
holds more than [B, H, Lc, Lc] scores. After n steps every (query, key)
pair has met once; causality compares global positions, so the chunks
off the diagonal need no special case.

The ring is named by a `SeqRing`: the torch.distributed process group
of its ranks and their order (position i holds chunk i). The JAX
package names a `seq` mesh axis; here a mesh axis is a process group
(parallel/mesh.py), and the ring holds the group and the ordered ranks
itself, so it composes with a Layout's clients and model groups without
widening the Layout. A world of several rings is a PARTITION of its
ranks (`bind(partition=...)`): torch.distributed.new_group is a
collective every rank of the world makes for every group, in one order,
so every rank builds every ring's group and keeps its own, as
Layout.bind builds every clients and model group.

The rotation (`_Rotate`, a torch.autograd.Function whose backward is
the inverse rotation) is a point-to-point exchange with the neighbours
(torch.distributed.batch_isend_irecv) on CPU tensors and under NCCL.
Gloo has no send or receive on CUDA tensors, only all_reduce and
broadcast, so there each rank's chunk is broadcast to the ring, and
every rank keeps its predecessor's (`rotate="broadcast"`; n broadcasts a
step, which at n = 2 is the exchange itself). Out of torch.distributed,
a ring of one rank is plain causal attention.
"""
from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import torch

from commefficient_tpu_torch.ops.attention import NEG_INF, online_softmax_fold
from commefficient_tpu_torch.parallel import multihost as mh
from commefficient_tpu_torch.parallel.mesh import CollectiveStats

ROTATIONS = ("auto", "p2p", "broadcast")


class SeqRing:
    """The ranks of one ring in order, this rank's position, and their
    process group (built by `bind`, a collective call every rank of the
    world makes in the same order: with the same `partition`, after the
    same other groups). `rotate` picks the rotation:
    "p2p", "broadcast", or "auto" (broadcast for CUDA tensors under a
    gloo group, p2p otherwise). `stats` counts the rotations' calls,
    bytes and host seconds."""

    def __init__(self, ranks: Sequence[int], rotate: str = "auto"):
        if rotate not in ROTATIONS:
            raise ValueError(f"unknown rotate {rotate!r} (choices: "
                             f"{ROTATIONS})")
        self.ranks = [int(r) for r in ranks]
        self.rotate = rotate
        self.group = None
        self.position = 0
        self.stats = CollectiveStats()

    @property
    def size(self) -> int:
        return len(self.ranks)

    def bind(self, rank: Optional[int] = None,
             partition: Optional[Sequence[Sequence[int]]] = None
             ) -> "SeqRing":
        """Fix this rank's position and, under torch.distributed, build
        the group of every ring of `partition` (disjoint rings, this
        one among them, covering the world), keeping this ring's. With
        no partition the ring must span the whole world."""
        me = mh.process_index() if rank is None else int(rank)
        if me not in self.ranks:
            raise ValueError(f"rank {me} is not in the ring {self.ranks}")
        self.position = self.ranks.index(me)
        rings = ([self.ranks] if partition is None
                 else [[int(r) for r in ring] for ring in partition])
        if self.ranks not in rings:
            raise ValueError(f"the ring {self.ranks} is not a ring of the "
                             f"partition {rings}")
        flat = [r for ring in rings for r in ring]
        if len(set(flat)) != len(flat):
            raise ValueError(f"the rings of {rings} overlap")
        if mh.is_distributed():
            import torch.distributed as dist
            world = mh.process_count()
            if sorted(flat) != list(range(world)):
                raise ValueError(
                    f"the rings {rings} do not partition the world of "
                    f"{world} ranks: new_group is a collective of every "
                    "rank, so bind every ring of the world (partition=)")
            for ring in rings:
                g = dist.new_group(ranks=ring)
                if ring == self.ranks:
                    self.group = g
        return self

    def _mode(self, t: torch.Tensor) -> str:
        if self.rotate != "auto":
            return self.rotate
        import torch.distributed as dist
        gloo = dist.get_backend(self.group) == "gloo"
        return "broadcast" if (gloo and t.is_cuda) else "p2p"

    def shift(self, t: torch.Tensor, step: int) -> torch.Tensor:
        """Every rank's `t` moved `step` (+1 or -1) positions around the
        ring: this rank receives the tensor of position (me - step)."""
        import torch.distributed as dist
        n, me = self.size, self.position
        t = t.contiguous()
        src = self.ranks[(me - step) % n]
        dst = self.ranks[(me + step) % n]
        t0 = time.perf_counter()
        if self._mode(t) == "p2p":
            out = torch.empty_like(t)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, t, dst, group=self.group),
                dist.P2POp(dist.irecv, out, src, group=self.group)])
            for r in reqs:
                r.wait()
            self.stats.calls += 1
        else:
            out = None
            for r in self.ranks:
                buf = t if r == self.ranks[me] else torch.empty_like(t)
                dist.broadcast(buf, src=r, group=self.group)
                if r == src:
                    out = buf
            self.stats.calls += n
            # every rank's chunk crosses the ring, this one's included
            self.stats.bytes += (n - 1) * t.numel() * t.element_size()
        self.stats.bytes += t.numel() * t.element_size()
        self.stats.seconds += time.perf_counter() - t0
        return out


class _Rotate(torch.autograd.Function):
    """`ring.shift(x, +1)`, whose gradient is the inverse shift."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return ring.shift(x, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.shift(g, -1), None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   ring: Optional[SeqRing],
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention over a sequence sharded on `ring`.

    q, k, v: [B, H, Lc, Dh], this rank's chunk (the global length is Lc
    times the ring's size, chunk i at positions [i * Lc, (i + 1) *
    Lc)). Returns this rank's [B, H, Lc, Dh] output. The JAX ring's
    static schedule: at step t the chunk of position (me - t) mod n is
    folded, then the chunks move one rank on."""
    B, H, Lc, Dh = q.shape
    n = 1 if ring is None else ring.size
    my = 0 if ring is None else ring.position
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dh)
    dev = q.device
    acc_t = torch.promote_types(q.dtype, torch.float32)

    qs = q.to(acc_t) * scale
    q_pos = my * Lc + torch.arange(Lc, device=dev)
    state = (torch.full((B, H, Lc), NEG_INF, dtype=acc_t, device=dev),
             torch.zeros((B, H, Lc), dtype=acc_t, device=dev),
             torch.zeros((B, H, Lc, Dh), dtype=acc_t, device=dev))
    kt, vt = k, v
    for t in range(n):
        src = (my - t) % n
        k_pos = src * Lc + torch.arange(Lc, device=dev)
        state = online_softmax_fold(state, qs, kt, vt, q_pos, k_pos)
        if t + 1 < n:
            kt = _Rotate.apply(kt, ring)
            vt = _Rotate.apply(vt, ring)
    m, l, acc = state
    l_safe = torch.clamp(l, min=1e-30)
    return (acc / l_safe[..., None]).to(q.dtype)
