"""The per-round options (ROADMAP item 6b) against the JAX package on the
same numpy inputs: the clipping and DP functions of ops/flat.py, the
quantized sketch wire (ops/kernels/quant.py) and its byte count, and
`--bf16` client compute (the tiny ResNet9 and GPT2 at L >= 256, and the
flash attention op on bfloat16 q/k/v).

bf16 limits. XLA's CPU and torch's CPU round bfloat16 at mostly the
same points (both round every elementwise op and reduce in float32),
but not everywhere: XLA keeps some float32 intermediates across the
converts of a fusion (an embedding sum feeding a LayerNorm, the exp
under log_softmax's sum), and flax's Dense rounds the product before
the bias add where torch's addmm rounds once. Max pooling and ReLU turn
one-ulp differences into different routings of the gradient. So the
two bf16 gradients are held to the size of bf16's own error, and the
control that tells bf16 from a silent float32 run is the accuracy of
each against a float64 gradient of the same weights and batch:

  * BF16_GRAD_LIMIT: |g_port - g_jax| <= 1.5 |g_jax - g64| (relative L2;
    measured 0.03-0.46 for the ResNet9 across seeds and inputs, 1.02-1.18
    for the GPT2);
  * BF16_ACCURACY_BAND: |g_port - g64| / |g_jax - g64| in [1/3, 3]
    (measured 1.00 for the ResNet9, 0.57-0.87 for the GPT2, whose port
    rounds the bias add once);
  * BF16_LOSS_RTOL: the losses within 2**-8 relative (bf16 keeps 8
    bits; measured 0 to 5e-4).

A float32 run sits ~4e-7 from float64, 1e-5 of bf16's error: the band
refuses it by four orders of magnitude (at least 2x is asked for).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.federated.client import (
    make_flat_grad_fn as j_make_flat_grad_fn,
)
from commefficient_tpu.ops import attention as JA
from commefficient_tpu.ops import flat as jflat
from commefficient_tpu.ops.kernels import quant as jquant
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.federated.client import (
    make_flat_grad_fn as t_make_flat_grad_fn,
)
from commefficient_tpu_torch.ops import attention as TA
from commefficient_tpu_torch.ops import flat as tflat
from commefficient_tpu_torch.ops import prng
from commefficient_tpu_torch.ops.flat import flatten_params
from commefficient_tpu_torch.ops.kernels import quant as tquant

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BF16_GRAD_LIMIT = 1.5
BF16_ACCURACY_BAND = (1 / 3, 3.0)
BF16_LOSS_RTOL = 2.0 ** -8


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------- ops/flat.py: clipping and DP noise -----------------------

@pytest.mark.parametrize("clip", [0.5, 1e6])
def test_clip_to_l2_matches_jax(clip):
    # above and below the clip; the norm reduces in another order, so
    # the scale agrees to float32 rounding
    v = np.random.RandomState(0).randn(10_001).astype(np.float32)
    want = np.asarray(jflat.clip_to_l2(jnp.asarray(v), clip))
    got = tflat.clip_to_l2(torch.from_numpy(v), clip).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    if clip > 1e5:
        np.testing.assert_array_equal(got, v)
    else:
        assert abs(np.linalg.norm(got) - clip) < 1e-5
    zero = np.zeros(5, np.float32)
    np.testing.assert_array_equal(
        tflat.clip_to_l2(torch.from_numpy(zero), clip).numpy(), zero)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_global_norm_clip_matches_jax(max_norm):
    # torch.nn.utils.clip_grad_norm_'s rule, +1e-6 in the denominator
    v = np.random.RandomState(1).randn(4_099).astype(np.float32)
    want = np.asarray(jflat.global_norm_clip(jnp.asarray(v), max_norm))
    got = tflat.global_norm_clip(torch.from_numpy(v), max_norm).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


@pytest.mark.parametrize("clip", [0.3, 1e6])
def test_clip_table_to_l2_matches_jax(clip):
    t = np.random.RandomState(2).randn(5, 300).astype(np.float32)
    est = np.float32(np.linalg.norm(t) / 2)
    want = np.asarray(jflat.clip_table_to_l2(jnp.asarray(t),
                                             jnp.asarray(est), clip))
    got = tflat.clip_table_to_l2(torch.from_numpy(t), torch.tensor(est),
                                 clip).numpy()
    np.testing.assert_array_equal(got, want)


def test_dp_noise_at_the_server_scale_matches_jax():
    # the server's key: round key folded with num_workers; scale 1
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(21), 2), 4)
    tk = prng.fold_in(prng.fold_in(prng.PRNGKey(21), 2), 4)
    want = np.asarray(jflat.dp_noise(jk, (3, 1_001), 0.25))
    got = tflat.dp_noise(tk, (3, 1_001), 0.25).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------- the quantized sketch wire ---------------------------------

def _wire_table():
    rng = np.random.RandomState(3)
    t = rng.randn(4, 257).astype(np.float32)
    t[1] = 0.0                      # an all-zero row: scale 1, exact zeros
    # row 2: absmax 127 so scale is exactly 1, and .5 ties both ways
    t[2, :8] = [127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    t[2, 8:] = np.round(t[2, 8:] * 10) + 0.5
    t[2] = np.clip(t[2], -127, 127)
    t[3] *= 1e-30                   # a row of tiny values
    return t


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_quantize_and_wire_roundtrip_are_bitwise_jax(dtype):
    t = _wire_table()
    jq, js = jquant.quantize_table(jnp.asarray(t), dtype)
    tq, ts = tquant.quantize_table(torch.from_numpy(t), dtype)
    np.testing.assert_array_equal(
        tq.float().numpy() if dtype == "bf16" else tq.numpy(),
        np.asarray(jq.astype(jnp.float32)) if dtype == "bf16"
        else np.asarray(jq))
    assert (ts is None) == (js is None)
    if ts is not None:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert tq.dtype == torch.int8
        # round half to even, as jnp.round: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
        np.testing.assert_array_equal(tq[2, :8].numpy(),
                                      [127, -127, 0, 2, 2, 0, -2, -2])
        np.testing.assert_array_equal(tq[1].numpy(), 0)
    want = np.asarray(jquant.wire_roundtrip(jnp.asarray(t), dtype))
    got = tquant.wire_roundtrip(torch.from_numpy(t), dtype).numpy()
    np.testing.assert_array_equal(got, want)


def test_f32_wire_is_the_table_itself():
    t = torch.randn(2, 5)
    assert tquant.wire_roundtrip(t, "f32") is t


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_wire_bytes_match_jax(dtype):
    for r, c in ((5, 500_000), (1, 10), (7, 123)):
        assert (tquant.wire_table_bytes(r, c, dtype)
                == jquant.wire_table_bytes(r, c, dtype))
        kw = dict(mode="sketch", num_rows=r, num_cols=c,
                  sketch_table_dtype=dtype, grad_size=1000)
        assert (TConfig(**kw, device="cpu").upload_bytes
                == JConfig(**kw).upload_bytes)
    # config #2's geometry: int8 carries 5 row scales of 4 bytes
    assert tquant.wire_table_bytes(5, 500_000, "int8") == 2_500_020
    assert tquant.wire_table_bytes(5, 500_000, "bf16") == 5_000_000


# ---------------- --bf16 client compute -------------------------------------

def _bf16_case(jm_loss, unravel, flat, jbatch, tm, t_loss_of, tbatch, mask):
    """(JAX bf16 loss, grad), (port bf16 loss, grad), the port's f32
    grad (the mix-up control) and the port's float64 grad."""
    jl, _, jg = jax.jit(j_make_flat_grad_fn(jm_loss, unravel,
                                            jnp.bfloat16))(
        flat, jbatch, jnp.asarray(mask))
    vec, t_unravel = flatten_params(tm)
    out = {}
    for dt in (torch.bfloat16, None):
        l, _, g = t_make_flat_grad_fn(t_loss_of(tm), t_unravel, dt)(
            vec, tbatch, torch.from_numpy(mask))
        out[dt] = (float(l), g.numpy())
    tm64 = copy.deepcopy(tm).double()
    _, unravel64 = flatten_params(tm64)
    tb64 = tuple(b.double() if b.is_floating_point() else b for b in tbatch)
    _, _, g64 = t_make_flat_grad_fn(t_loss_of(tm64), unravel64)(
        vec.double(), tb64, torch.from_numpy(mask).double())
    return ((float(jl), np.asarray(jg)), out[torch.bfloat16],
            out[None][1], g64.numpy())


def _check_bf16(j, t, g32, g64):
    (jl, jg), (tl, tg) = j, t
    assert tg.dtype == np.float32 and np.isfinite(tg).all()
    e_j = _rel(jg, g64)
    assert e_j > 1e-3, "the JAX side did not compute in bf16"
    assert _rel(tg, jg) <= BF16_GRAD_LIMIT * e_j
    lo, hi = BF16_ACCURACY_BAND
    assert lo <= _rel(tg, g64) / e_j <= hi
    np.testing.assert_allclose(tl, jl, rtol=BF16_LOSS_RTOL)
    # the mix-up control: a float32 run, refused by the band at least 2x
    assert _rel(g32, g64) / e_j < lo / 2


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_resnet9_gradient_matches_jax_at_bf16_limits(seed):
    from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9
    from commefficient_tpu.training.cv_train import (
        make_compute_loss as j_loss,
    )
    from commefficient_tpu_torch.models import build_model
    from commefficient_tpu_torch.models.convert import from_jax_params
    from commefficient_tpu_torch.training.cv_train import (
        make_compute_loss as t_loss,
    )
    ch = {"prep": 16, "layer1": 32, "layer2": 32, "layer3": 64}
    jm = JResNet9(num_classes=10, channels=ch)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, 32, 32, 3)))
    flat, unravel = ravel_pytree(params)
    tm = build_model("ResNet9", channels=ch)
    from_jax_params(tm, params)
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int32)
    mask = np.ones(8, np.float32)
    _check_bf16(*_bf16_case(j_loss(jm), unravel, flat,
                            (jnp.asarray(x), jnp.asarray(y)), tm, t_loss,
                            (torch.from_numpy(x), torch.from_numpy(y)),
                            mask))


def test_bf16_gpt2_on_the_flash_path_matches_jax_at_bf16_limits():
    from tests.test_torch_gpt2 import _pair
    from commefficient_tpu.training.gpt2_train import (
        make_compute_loss_train as j_loss,
    )
    from commefficient_tpu_torch.models.gpt2 import FLASH_ATTENTION_MIN_LEN
    from commefficient_tpu_torch.training.gpt2_train import (
        make_compute_loss_train as t_loss,
    )
    L = 260
    assert L >= FLASH_ATTENTION_MIN_LEN
    jm, params, tm, batch = _pair(L=L, n_layer=2, n_embd=64, n_head=2,
                                  seed=0)
    flat, unravel = ravel_pytree(params)
    tcfg = TConfig(device="cpu")
    _check_bf16(*_bf16_case(
        j_loss(jm, JConfig()), unravel, flat,
        tuple(jnp.asarray(b) for b in batch), tm,
        lambda m: t_loss(m, tcfg), tuple(torch.from_numpy(b) for b in batch),
        np.ones(2, np.float32)))


@pytest.mark.parametrize("L", [300, 128])
def test_flash_attention_on_bf16_matches_jax(L):
    # JAX upcasts each tile, folds in f32 and rounds o to bf16: the
    # port's o within one bf16 ulp of JAX's (the f32 accumulators round
    # apart at a few ulps of f32), lse (f32) within 1e-5 relative, and
    # the gradients come back in bf16 within one bf16 ulp of JAX's
    rng = np.random.RandomState(L)
    q, k, v = (jnp.asarray(rng.randn(2, 2, L, 32), jnp.bfloat16)
               for _ in range(3))
    do = jnp.asarray(rng.randn(2, 2, L, 32), jnp.bfloat16)
    jo, jlse = JA._fa_fwd_impl(q, k, v, None)
    tq, tk, tv, tdo = (torch.from_numpy(np.asarray(x.astype(jnp.float32)))
                       .bfloat16() for x in (q, k, v, do))
    from commefficient_tpu_torch.ops.kernels import attention_cuda as ac
    to, tlse = ac.flash_fwd(tq, tk, tv, 1 / np.sqrt(32))
    assert to.dtype == torch.bfloat16 and tlse.dtype == torch.float32
    jo32 = np.asarray(jo.astype(jnp.float32))
    ulp = np.abs(jo32) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(to.float().numpy() - jo32) <= ulp)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-5)

    jg = jax.vjp(lambda a, b, c: JA.flash_attention(a, b, c), q, k, v)[1](do)
    for x in (tq, tk, tv):
        x.requires_grad_(True)
    TA.flash_attention(tq, tk, tv).backward(tdo)
    for name, want, got in zip("qkv", jg, (tq.grad, tk.grad, tv.grad)):
        assert got.dtype == torch.bfloat16, name
        want = np.asarray(want.astype(jnp.float32))
        diff = np.abs(got.float().numpy() - want)
        assert np.all(diff <= np.abs(want) * 2.0 ** -7
                      + 2.0 ** -7 * np.abs(want).max() * 1e-2), name
