"""Causal attention for long sequences: the port of
commefficient_tpu/ops/attention.py.

  * forward: the flash forward K4 (ops/kernels/attention_cuda.py, CUDA)
    on the card; on the CPU its plain version `_flash_fwd_plain`, the
    port of `_flash_fwd_xla` — the online-softmax fold over key blocks
    that the JAX package runs off the TPU. Outputs o and the per-row
    logsumexp.
  * backward: `_flash_bwd_plain`, the port of `_flash_bwd_xla`:
    recompute p per key block from the saved (o, lse), never
    materializing [L, L]. The JAX backward is XLA, not a TPU kernel, so
    plain PyTorch is its counterpart on both devices.
  * `flash_attention` wraps both in a `torch.autograd.Function`.

Any L: the JAX package pads L up to a block multiple (causality keeps
the padding invisible to real queries, and poisons the pad rows of the
saved logsumexp with LSE_PAD); the port masks the ragged last block
instead and makes no padded copy. The outputs equal the JAX padded
computation's `[:L]`.

Shapes: q, k, v [B, H, L, Dh]. Returns [B, H, L, Dh].
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

DEFAULT_BLOCK = 128
NEG_INF = -1e30
# what the JAX package writes into pad rows of the saved logsumexp so
# exp(s - lse) == 0 there; the port has no pad rows (ragged blocks are
# masked), and keeps the constant for parity
LSE_PAD = 1e30


def _resolve_scale(sm_scale: Optional[float], dh: int) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(dh)


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in its accumulation type: float32, or float64 for a float64
    input (the CPU float64 reference of a card run)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _key_blocks(L: int, block: int):
    """(start, stop) of each key block; the last may be ragged."""
    return [(j, min(j + block, L)) for j in range(0, L, block)]


# ---------------- shared online-softmax fold ----------------------------

def online_softmax_fold(state, qs, kt, vt, q_pos, k_pos):
    """One flash block fold: fold keys `kt`/values `vt` (global
    positions `k_pos`) into the running (m, l, acc) softmax state of
    queries `qs` (already scaled; global positions `q_pos`). Shapes:
    qs [..., Lq, Dh], kt/vt [..., Lk, Dh], state m/l [..., Lq],
    acc [..., Lq, Dh]. Causal: k > q masked."""
    m, l, acc = state
    s = torch.matmul(qs, _acc(kt).transpose(-1, -2))
    s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                    torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    rescale = torch.exp(m - m_new)
    l = l * rescale + p.sum(dim=-1)
    acc = acc * rescale[..., None] + torch.matmul(p, _acc(vt))
    return m_new, l, acc


# ---------------- plain forward (the kernel's plain version) -------------

def _flash_fwd_plain(q, k, v, sm_scale: float,
                     block_k: int = DEFAULT_BLOCK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the online-softmax forward as a loop over key blocks —
    `_flash_fwd_xla` with the ragged last block masked instead of
    padded. O(L * block) live."""
    L = q.shape[-2]
    qs = _acc(q) * sm_scale
    q_pos = torch.arange(L, device=q.device)
    lead = q.shape[:-1]
    state = (torch.full(lead, NEG_INF, dtype=qs.dtype, device=q.device),
             torch.zeros(lead, dtype=qs.dtype, device=q.device),
             torch.zeros(q.shape, dtype=qs.dtype, device=q.device))
    for a, b in _key_blocks(L, block_k):
        k_pos = torch.arange(a, b, device=q.device)
        state = online_softmax_fold(state, qs, k[..., a:b, :],
                                    v[..., a:b, :], q_pos, k_pos)
    m, l, acc = state
    l_safe = torch.clamp(l, min=1e-30)
    o = (acc / l_safe[..., None]).to(q.dtype)
    return o, m + torch.log(l_safe)


# ---------------- tiled backward ----------------------------------------

def _flash_bwd_plain(q, k, v, o, lse, do, sm_scale: float,
                     block_k: int = DEFAULT_BLOCK):
    """Flash-style backward from the saved (o, lse): recompute p per key
    block, never materializing [L, L] — `_flash_bwd_xla` with the
    ragged last block masked instead of padded."""
    L = q.shape[-2]
    qs = _acc(q)
    do_f = _acc(do)
    delta = (do_f * _acc(o)).sum(dim=-1)                  # [..., L]
    q_pos = torch.arange(L, device=q.device)
    dq = torch.zeros(q.shape, dtype=qs.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=qs.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=qs.dtype, device=q.device)
    for a, b in _key_blocks(L, block_k):
        kj = _acc(k[..., a:b, :])
        vj = _acc(v[..., a:b, :])
        s = torch.matmul(qs * sm_scale, kj.transpose(-1, -2))
        k_pos = torch.arange(a, b, device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                        torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse[..., None])                 # [..., L, bk]
        dv[..., a:b, :] = torch.matmul(p.transpose(-1, -2), do_f)
        dp = torch.matmul(do_f, vj.transpose(-1, -2))
        ds = p * (dp - delta[..., None])
        dq = dq + sm_scale * torch.matmul(ds, kj)
        dk[..., a:b, :] = sm_scale * torch.matmul(ds.transpose(-1, -2), qs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------- public op ---------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Forward: K4 on a CUDA tensor, `_flash_fwd_plain` on a CPU tensor
    (attention_cuda.flash_fwd routes by device). Saves (q, k, v, o,
    lse); the backward is `_flash_bwd_plain`."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        from commefficient_tpu_torch.ops.kernels import attention_cuda
        scale = _resolve_scale(sm_scale, q.shape[-1])
        o, lse = attention_cuda.flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_plain(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, sm_scale: Optional[float] = None):
    """Causal flash attention, [B, H, L, Dh] -> [B, H, L, Dh]."""
    return _FlashAttention.apply(q, k, v, sm_scale)


def reference_attention(q, k, v, sm_scale: Optional[float] = None):
    """O(L^2)-memory attention (the models/gpt2.py short-sequence path),
    for equivalence tests."""
    scale = _resolve_scale(sm_scale, q.shape[-1])
    L = q.shape[-2]
    s = torch.matmul(_acc(q) * scale, _acc(k).transpose(-1, -2))
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=q.device))
    s = torch.where(causal, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, _acc(v)).to(q.dtype)
