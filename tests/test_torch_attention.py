"""Flash attention parity: the port's ops/attention.py (the plain
forward K4 takes on the CPU, and the tiled backward) against the JAX
package's ops/attention.py on the same numpy inputs — its XLA forward,
its Pallas kernel in interpret mode (as tests/test_attention.py runs
it), its einsum reference and `jax.grad` of its custom VJP. The card
case (the CUDA kernel against its plain version) is in
test_torch_kernels.py, which imports no jax."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops import attention as A
from commefficient_tpu_torch.ops import attention as T
from commefficient_tpu_torch.ops.kernels import attention_cuda as ac

pytestmark = pytest.mark.torch_port

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
    assert ac.LAUNCHES == {"flash_fwd": 0}
    with pytest.raises(TypeError, match="float32"):
        ac.flash_fwd(q.double(), k, v, 0.25)
    with pytest.raises(ValueError, match="shape"):
        ac.flash_fwd(q, k[:, :, :-1], v, 0.25)
    with pytest.raises(ValueError, match="device"):
        ac.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"), 0.25)
