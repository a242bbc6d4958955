"""Flash attention parity: the port's ops/attention.py (the plain
forward K4 takes on the CPU, and the tiled backward) against the JAX
package's ops/attention.py on the same numpy inputs — its XLA forward,
its Pallas kernel in interpret mode (as tests/test_attention.py runs
it), its einsum reference and `jax.grad` of its custom VJP. The card
case (the CUDA kernel against its plain version) is in
test_torch_kernels.py, which imports no jax."""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops import attention as A
from commefficient_tpu_torch.ops import attention as T
from commefficient_tpu_torch.ops.kernels import attention_cuda as ac

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# f32 forward: the same online-softmax fold over the same 128-key
# blocks, summed in another order -> 2e-6 absolute on outputs of O(1)
FWD_ATOL = 2e-6
# backward: five products a block and an L-long reduction -> 1e-5
# relative to the gradient's scale
GRAD_RTOL = 1e-5


def _qkv(B=2, H=2, L=256, Dh=32, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, H, L, Dh).astype(np.float32)
                 for _ in range(3))


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("L,Dh", [(256, 64), (384, 32), (64, 16)])
def test_plain_forward_matches_jax_xla_pallas_and_reference(L, Dh):
    q, k, v = _qkv(L=L, Dh=Dh, seed=L)
    scale = 1.0 / math.sqrt(Dh)
    block = min(A.DEFAULT_BLOCK, L)
    o, lse = T._flash_fwd_plain(*_t(q, k, v), scale)
    jo, jlse = A._flash_fwd_xla(*map(jnp.asarray, (q, k, v)), scale, block)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=FWD_ATOL)
    po, plse = A._flash_fwd_pallas(*map(jnp.asarray, (q, k, v)), scale,
                                   block, block, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(po), rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(plse), rtol=0,
                               atol=FWD_ATOL)
    ref = np.asarray(A.reference_attention(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(o.numpy(), ref, rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(
        T.reference_attention(*_t(q, k, v)).numpy(), ref, rtol=0,
        atol=FWD_ATOL)


def test_plain_forward_is_bitwise_across_torch_thread_counts():
    # the [256-64] case above once read 2.3e-5 against its 2e-6 limit at
    # 8 torch threads on a loaded host: the port's forward does not
    # move with torch's intra-op thread count (bitwise at 1, 2 and 8)
    q, k, v = _qkv(L=256, Dh=64, seed=256)
    prev = torch.get_num_threads()
    outs = []
    try:
        for n in (1, 2, 8):
            torch.set_num_threads(n)
            outs.append(T._flash_fwd_plain(*_t(q, k, v), 1.0 / 8.0))
    finally:
        torch.set_num_threads(prev)
    for o, lse in outs[1:]:
        assert torch.equal(o, outs[0][0])
        assert torch.equal(lse, outs[0][1])


@pytest.mark.parametrize("L", [128, 300, 257])
def test_flash_attention_grads_match_jax(L):
    # odd L: the JAX op pads to a block multiple and slices back, the
    # port masks the ragged block; outputs [:L] and gradients agree
    q, k, v = _qkv(L=L, Dh=16, seed=L)
    do = np.random.RandomState(L + 1).randn(*q.shape).astype(np.float32)

    def jloss(a, b, c):
        return (A.flash_attention(a, b, c) * jnp.asarray(do)).sum()

    jo = np.asarray(A.flash_attention(*map(jnp.asarray, (q, k, v))))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    to = T.flash_attention(tq, tk, tv)
    np.testing.assert_allclose(to.detach().numpy(), jo, rtol=0,
                               atol=FWD_ATOL)
    (to * torch.from_numpy(do)).sum().backward()
    for name, want, got in zip("qkv", jg, (tq.grad, tk.grad, tv.grad)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg=f"d{name}, L={L}")


def test_explicit_sm_scale_is_respected():
    # sm_scale=0.0 must not fall back to 1/sqrt(Dh): uniform attention
    # over the causal prefix, in both packages
    q, k, v = _qkv(L=64, Dh=16, seed=3)
    want = np.asarray(A.flash_attention(*map(jnp.asarray, (q, k, v)), 0.0))
    got = T.flash_attention(*_t(q, k, v), 0.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    causal_mean = np.cumsum(v, axis=2) / np.arange(1, 65)[None, None, :,
                                                          None]
    np.testing.assert_allclose(got, causal_mean, rtol=0, atol=1e-5)
    # and an explicit non-default scale
    want = np.asarray(A.flash_attention(*map(jnp.asarray, (q, k, v)), 0.3))
    got = T.flash_attention(*_t(q, k, v), 0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


def test_wrapper_routes_cpu_to_plain_and_checks_arguments():
    q, k, v = _t(*_qkv(L=40, Dh=16))
    ac.reset_launches()
    o, lse = ac.flash_fwd(q, k, v, 0.25)
    po, plse = ac.flash_fwd_plain(q, k, v, 0.25)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert ac.LAUNCHES == {"flash_fwd": 0, "flash_fwd_bf16": 0}
    with pytest.raises(TypeError, match="float32"):
        ac.flash_fwd(q.double(), k, v, 0.25)
    with pytest.raises(ValueError, match="shape"):
        ac.flash_fwd(q, k[:, :, :-1], v, 0.25)
    with pytest.raises(ValueError, match="device"):
        ac.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"), 0.25)


def _head_views(x, H):
    """q, k, v as GPT2's attention makes them: the [B, H, L, Dh] head
    views of a fused [B, L, 3E] projection (row stride 3E, no copy)."""
    B, L, E3 = x.shape
    dh = E3 // (3 * H)
    return tuple(t.reshape(B, L, H, dh).transpose(1, 2)
                 for t in x.split(H * dh, dim=-1))


def test_wrapper_takes_strided_head_views_as_contiguous_copies():
    # the card kernel reads q, k, v through their strides; on the CPU
    # the wrapper's plain route must give the same on the head views of
    # one fused projection as on contiguous copies, forward and backward
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 300, 3 * 3 * 16).astype(np.float32))
    do = torch.from_numpy(rng.randn(2, 3, 300, 16).astype(np.float32))
    views = _head_views(x, 3)
    assert not views[0].is_contiguous() and views[0].stride()[2] == 144
    o, lse = ac.flash_fwd(*views, 0.25)
    oc, lsec = ac.flash_fwd(*(t.contiguous() for t in views), 0.25)
    assert torch.equal(o, oc) and torch.equal(lse, lsec)

    xs = x.clone().requires_grad_(True)
    (T.flash_attention(*_head_views(xs, 3)) * do).sum().backward()
    copies = [t.contiguous().requires_grad_(True) for t in views]
    (T.flash_attention(*copies) * do).sum().backward()
    want = torch.cat([c.grad.transpose(1, 2).reshape(2, 300, 48)
                      for c in copies], dim=-1)
    torch.testing.assert_close(xs.grad, want, rtol=0, atol=0)


# the card kernel's limit against its plain version (chip_smoke.py)
K4_RTOL = 1e-5


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as cvt.rna does: add half of the dropped
    13 bits' unit to the bit pattern (ties away from zero in magnitude)
    and clear them."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _product(a, b, passes):
    """a @ b as the kernel's mma.sync makes it: three TF32 passes
    (small*big + big*small, then big*big) or, for the control, one."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    if passes == 1:
        return ab @ bb
    return (as_ @ bb + ab @ bs) + ab @ bb


def _kernel_model(q, k, v, sm_scale, passes, tile=64):
    """The card kernel's arithmetic on the CPU: scaled q, 64-key tiles up
    to the diagonal, the online-softmax fold, both products in `passes`
    TF32 passes with float32 accumulation."""
    L = q.shape[-2]
    qs = q * sm_scale
    pos = torch.arange(L)
    m = torch.full(q.shape[:-1], T.NEG_INF)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for a in range(0, L, tile):
        b = min(a + tile, L)
        s = _product(qs, k[..., a:b, :].transpose(-1, -2), passes)
        s = torch.where(pos[:, None] >= torch.arange(a, b)[None, :], s,
                        torch.full_like(s, T.NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        r = torch.exp(m - m_new)
        l = l * r + p.sum(dim=-1)
        acc = acc * r[..., None] + _product(p, v[..., a:b, :], passes)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    return acc / l_safe[..., None], m + torch.log(l_safe)


@pytest.mark.parametrize("L", [299, 1024])
def test_three_tf32_passes_hold_the_kernel_limit_and_one_does_not(L):
    # the CUDA kernel's products are 3xTF32 on the tensor cores; modelled
    # here, they stay a tenth of K4_RTOL from the plain version, while a
    # single TF32 pass (the control) does not stay within K4_RTOL
    q, k, v = _t(*_qkv(B=1, H=8, L=L, Dh=64, seed=L))
    po, plse = ac.flash_fwd_plain(q, k, v, 0.125)

    def rel(o, lse):
        return (float((o - po).abs().max() / po.abs().max()),
                float((lse - plse).abs().max() / plse.abs().max()))

    e3 = rel(*_kernel_model(q, k, v, 0.125, passes=3))
    e1 = rel(*_kernel_model(q, k, v, 0.125, passes=1))
    assert max(e3) <= K4_RTOL / 10, e3
    assert max(e1) > K4_RTOL, e1


def test_tf32_rounding_is_cvt_rna():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11),
                      1.0 + 3 * 2 ** -12, 0.0, -0.0], dtype=torch.float32)
    got = _tf32(x)
    # ties (2^-11 is half a TF32 unit at 1.0) round away from zero
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -10),
                         1.0 + 2 ** -10, 0.0, -0.0])
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
