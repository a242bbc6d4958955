"""Count sketch for gradient compression: the port of
commefficient_tpu/ops/sketch.py.

The hash family is the JAX package's, so the same seed gives the same
buckets and signs: view the [d] vector as B = ceil(d / c) chunks of
length c; row j's bucket of coordinate i is
    (i mod c + offset[j, i // c]) mod c
and its sign eps[j, i mod c] * delta[j, i // c]. The tables come from
numpy `RandomState(seed)` drawn in the JAX order — offsets, then eps,
then delta — never from a torch.Generator, so both packages build
identical tables.

The dense hot-path ops run on hand-written CUDA kernels when the
tensor is on the card (ops/kernels/sketch_cuda.py): `encode` (K1),
`estimate_all` (K2) and the threshold decode of `decode_topk_dense`
(K3a sample, K3b mask). On the CPU they take the kernels' plain
versions.
The sparse ops (hash_indices, estimate, encode_sparse) are gathers and
scatter-adds, as in the JAX package, which has no kernel for them
either.

Route gates keep the JAX values: STATIC_UNROLL_LIMIT and
DECODE_MATERIALIZE_LIMIT decide whether `decode_topk_sparse` may
materialize the full estimate; past either it takes the blockwise route
(`blockwise_topk`): K2 estimates a window of chunks at a time
(`sketch_cuda.estimate_window`, at most DECODE_WINDOW_BYTES of
estimates), each chunk keeps its top min(k, c), and one top-k over the
candidates picks the k, in the JAX package's order (its approx_max_k is
exact off the TPU: ties to the lower chunk, then the lower rank).
THRESHOLD_DECODE_MIN_D routes `decode_topk_dense` to the
sampled-threshold decode (kernel K3).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from commefficient_tpu_torch.hooks import setup_region
from commefficient_tpu_torch.ops.flat import (
    threshold_from_sq_sample, topk_indices,
)
from commefficient_tpu_torch.ops.kernels import sketch_cuda

STATIC_UNROLL_LIMIT = 2048
DECODE_MATERIALIZE_LIMIT = 256 * 1024 * 1024
THRESHOLD_DECODE_MIN_D = 32 * 1024 * 1024
# the blockwise decode's window: as many chunks as an estimate of this
# many bytes holds (134 chunks of 500,000 columns), at most 65,535 (the
# kernel's grid)
DECODE_WINDOW_BYTES = 256 * 1024 * 1024
# encode_k_sparse re-sketches through the dense encode past this many
# scattered elements on an accelerator (scatter-add is slow there); on
# the CPU the scatter always wins
K_SPARSE_DENSE_MIN = 1_000_000


def k_sparse_route(r: int, k: int, device: torch.device) -> str:
    """'dense' or 'sparse': the route encode_k_sparse takes for r rows
    and k entries on `device` (the JAX gate, sketch.py:294-295, with
    the device standing in for the backend)."""
    if r * k > K_SPARSE_DENSE_MIN and torch.device(device).type != "cpu":
        return "dense"
    return "sparse"


class CSVec:
    """Count-sketch geometry: d-dim vectors into an [r, c] table.

    `num_blocks` is accepted for parity and changes nothing (chunking is
    intrinsic, B = ceil(d / c))."""

    def __init__(self, d: int, c: int, r: int, num_blocks: int = 1,
                 seed: int = 42):
        self.d, self.c, self.r = int(d), int(c), int(r)
        self.num_blocks = num_blocks
        self.seed = seed
        rng = np.random.RandomState(seed)
        B = self.n_chunks
        self._offsets = rng.randint(0, self.c, size=(self.r, B)).astype(
            np.int32)
        self._eps = rng.choice([-1.0, 1.0], size=(self.r, self.c)).astype(
            np.float32)
        self._delta = rng.choice([-1.0, 1.0], size=(self.r, B)).astype(
            np.float32)
        self._on_device: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        self._bits_on_device: Dict[torch.device,
                                   Tuple[torch.Tensor, torch.Tensor]] = {}
        self.sign_packs = 0

    # --- geometry --------------------------------------------------------
    @property
    def n_chunks(self) -> int:
        return -(-self.d // self.c)

    @property
    def _static_path(self) -> bool:
        return self.r * self.n_chunks <= STATIC_UNROLL_LIMIT

    @property
    def table_shape(self) -> Tuple[int, int]:
        return (self.r, self.c)

    @property
    def _threshold_decode(self) -> bool:
        padded = self.n_chunks * self.c
        return (self.d > THRESHOLD_DECODE_MIN_D
                and padded <= DECODE_MATERIALIZE_LIMIT)

    def tables(self, device) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """(offsets int32 [r, B], eps f32 [r, c], delta f32 [r, B]) on
        `device`, copied there once."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        got = self._on_device.get(dev)
        if got is None:
            with setup_region():
                got = tuple(torch.from_numpy(a).to(dev)
                            for a in (self._offsets, self._eps, self._delta))
            self._on_device[dev] = got
        return got

    def sign_bits(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(eps bits, delta bits) on `device`: the signs of eps and delta
        packed by `sketch_cuda.pack_sign_bits` (bit j * c + s of eps,
        j * B + b of delta), the form in which `sketch_cuda.encode`,
        `estimate_all` and the threshold decode take them. Packed once
        per device; `sign_packs` counts the packings."""
        _, eps, delta = self.tables(device)
        got = self._bits_on_device.get(eps.device)
        if got is None:
            with setup_region():
                got = (sketch_cuda.pack_sign_bits(eps),
                       sketch_cuda.pack_sign_bits(delta))
            self._bits_on_device[eps.device] = got
            self.sign_packs += 1
        return got

    def zeros(self, device) -> torch.Tensor:
        return torch.zeros(self.table_shape, dtype=torch.float32,
                           device=device)

    # --- hashing ---------------------------------------------------------
    def hash_indices(self, idx: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Buckets [r, n] (int64 in [0, c)) and signs [r, n] (+-1 f32)
        for an index tensor [n]; out-of-range indices get an arbitrary
        valid bucket (callers mask their values)."""
        off, eps, delta = self.tables(idx.device)
        safe = idx.long().clamp(0, self.d - 1)
        b = safe // self.c
        p = safe % self.c
        buckets = (p[None, :] + off[:, b].long()) % self.c
        signs = eps[:, p] * delta[:, b]
        return buckets, signs

    # --- encode ----------------------------------------------------------
    def encode(self, vec: torch.Tensor) -> torch.Tensor:
        """[r, c] table of a dense [d] vector (kernel K1 on the card)."""
        off = self.tables(vec.device)[0]
        eps_bits, delta_bits = self.sign_bits(vec.device)
        return sketch_cuda.encode(vec.float().contiguous(), off, delta_bits,
                                  eps_bits, self.c)

    def encode_sparse(self, indices: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
        """Table of a sparse vector (indices [n], values [n]); indices
        outside [0, d) are dropped. O(r * n) scatter-add."""
        buckets, signs = self.hash_indices(indices)
        valid = ((indices >= 0) & (indices < self.d)).to(torch.float32)
        vals = values * valid
        flat_pos = (torch.arange(self.r, device=indices.device)[:, None]
                    * self.c + buckets).reshape(-1)
        table = self.zeros(indices.device)
        table.view(-1).index_add_(0, flat_pos,
                                  (signs * vals[None, :]).reshape(-1))
        return table

    def encode_k_sparse(self, indices: torch.Tensor, values: torch.Tensor,
                        dense: torch.Tensor = None) -> torch.Tensor:
        """Sketch of a k-sparse vector by the faster route for its size
        and device (k_sparse_route): the scatter-add, or the dense
        encode of `dense` (built here when not given). The two routes are
        equal by linearity up to summation order."""
        route = k_sparse_route(self.r, int(indices.shape[0]),
                               indices.device)
        if route == "sparse":
            return self.encode_sparse(indices, values)
        if dense is None:
            dense = scatter_drop(self.d, indices.long(), values)
        return self.encode(dense)

    # --- decode ----------------------------------------------------------
    def estimate(self, table: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
        """Median-of-rows estimates of coordinates `idx` [n]."""
        buckets, signs = self.hash_indices(idx)
        rows = torch.arange(self.r, device=table.device)[:, None]
        return sketch_cuda.median_rows(signs * table[rows, buckets])

    def estimate_all(self, table: torch.Tensor) -> torch.Tensor:
        """[B, c] estimates of every coordinate, the tail (>= d) zeroed
        (kernel K2 on the card)."""
        off = self.tables(table.device)[0]
        eps_bits, delta_bits = self.sign_bits(table.device)
        return sketch_cuda.estimate_all(table.float().contiguous(), off,
                                        delta_bits, eps_bits, self.d)

    def _flat_estimates(self, table: torch.Tensor) -> torch.Tensor:
        return self.estimate_all(table).reshape(-1)

    def decode_topk(self, table: torch.Tensor, k: int) -> torch.Tensor:
        """Dense [d] vector holding the k largest-magnitude estimates."""
        idx, vals = self.decode_topk_sparse(table, k)
        return scatter_drop(self.d, idx, vals)

    def decode_topk_dense(self, table: torch.Tensor, k: int) -> torch.Tensor:
        """decode_topk for callers that need only the dense update. Past
        THRESHOLD_DECODE_MIN_D (with a padded d the estimate could be
        materialized at) the selection is by sampled threshold: every
        coordinate whose estimate squared reaches the k-th largest
        square priced from a ~1M-point sample, so about k are kept
        (ties at the threshold all are).

        The threshold route is the JAX package's Pallas route
        (`pallas_threshold_decode`): K3a draws the sample per chunk, at
        the positions 0, stride, ... of every chunk; the threshold is
        priced on the device (`threshold_from_sq_sample`, no host
        sync); K3b re-derives the estimates and writes the [d] update.
        The JAX package's `xla` route samples the materialized estimate
        at one global stride instead; the two selections differ within
        sampling noise (~1% of k). `--kernel_backend` stays accepted
        for parity and changes nothing here."""
        if not self._threshold_decode:
            return self.decode_topk(table, k)
        k = min(k, self.d)
        off = self.tables(table.device)[0]
        eps_bits, delta_bits = self.sign_bits(table.device)
        table = table.float().contiguous()
        stride, ns = sketch_cuda.threshold_sample_geometry(self.n_chunks,
                                                           self.c)
        sample = sketch_cuda.threshold_sample(table, off, delta_bits,
                                              eps_bits, self.d, stride, ns)
        thr = threshold_from_sq_sample((sample * sample).reshape(-1), k,
                                       self.n_chunks * self.c)
        return sketch_cuda.threshold_mask(table, off, delta_bits, eps_bits,
                                          thr, self.d)

    def decode_topk_sparse(self, table: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(indices [k] int64, values [k]) of the top-k estimates by
        magnitude. Slots holding a zero estimate carry index d, which
        downstream drop-mode scatters ignore."""
        k = min(k, self.d)
        if not (self._static_path
                and self.n_chunks * self.c <= DECODE_MATERIALIZE_LIMIT):
            # past the gates the [d] estimate is never held at once
            off = self.tables(table.device)[0]
            eps_bits, delta_bits = self.sign_bits(table.device)
            table = table.float().contiguous()
            return blockwise_topk(
                lambda b0, nb: sketch_cuda.estimate_window(
                    table, off, delta_bits, eps_bits, self.d, b0, nb),
                self.n_chunks, self.c, self.d, k)
        flat = self._flat_estimates(table)
        idx = topk_indices(flat * flat, k)
        vals = flat[idx]
        idx = torch.where(vals == 0.0, torch.full_like(idx, self.d), idx)
        return idx, vals

    # --- norms -----------------------------------------------------------
    def l2estimate(self, table: torch.Tensor) -> torch.Tensor:
        """Median over rows of the per-row L2 norm (jnp.median's
        even-count convention)."""
        return torch.sqrt(sketch_cuda.median_rows(
            torch.sum(table * table, dim=1)))


def window_chunks(c: int) -> int:
    """Chunks in one window of the blockwise decode."""
    return max(1, min(DECODE_WINDOW_BYTES // (4 * int(c)), 65535))


def blockwise_topk(estimate_window: Callable[[int, int], torch.Tensor],
                   n_chunks: int, c: int, d: int, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices [k] int64, values [k]) of the k largest-magnitude
    estimates, window by window: `estimate_window(b0, nb)` gives chunks
    b0 .. b0 + nb - 1's [nb, c] estimates, zero at or past d; each chunk
    keeps its top min(k, c) by a stable sort (ties to the lower index,
    as lax.top_k), in chunk order, and one stable top-k over those
    candidates picks the k (ties to the earlier candidate). Zero values
    carry index d, as in the materialized route."""
    kc = min(k, c)
    step = window_chunks(c)
    cand_idx, cand_vals = [], []
    for b0 in range(0, n_chunks, step):
        nb = min(step, n_chunks - b0)
        est = estimate_window(b0, nb)
        sel = torch.sort(est * est, dim=1, descending=True,
                         stable=True).indices[:, :kc]
        cand_vals.append(torch.gather(est, 1, sel).reshape(-1))
        base = torch.arange(b0, b0 + nb, device=est.device,
                            dtype=torch.int64)[:, None] * c
        cand_idx.append((sel + base).reshape(-1))
        del est, sel
    cand_idx = torch.cat(cand_idx)
    cand_vals = torch.cat(cand_vals)
    pick = topk_indices(cand_vals * cand_vals, k)
    idx, vals = cand_idx[pick], cand_vals[pick]
    idx = torch.where(vals == 0.0, torch.full_like(idx, d), idx)
    return idx, vals


def scatter_drop(d: int, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """zeros(d).at[idx].set(vals, mode='drop'): entries whose index is
    outside [0, d) land in a spare slot that is cut off (no boolean
    mask, so no wait on the device)."""
    idx = idx.long()
    idx = torch.where((idx < 0) | (idx > d), torch.full_like(idx, d), idx)
    out = torch.zeros(d + 1, dtype=torch.float32, device=vals.device)
    out[idx] = vals
    return out[:d]


@functools.lru_cache(maxsize=8)
def cached_sketch(d: int, c: int, r: int, seed: int = 42) -> CSVec:
    """One CSVec per geometry for the process: drawing the hash tables
    (r * c random signs) and copying them to the card happens once, not
    once a round."""
    return CSVec(d=d, c=c, r=r, seed=seed)
