"""Threefry parity: the port's ops/prng.py against `jax.random` (default
threefry, `jax_threefry_partitionable` on, as tests/conftest.py sets it)
on the same seeds, and its `dp_noise` against the JAX package's.

Keys, bits and uniforms are integer arithmetic plus one bitcast, so they
must be equal bit for bit. Normals go through erf_inv, which the port
computes as XLA's float32 polynomial; its log1p and products round as
torch rounds them, so a normal is held to NORMAL_RTOL (measured on the
CPU against jax 0.9: 2.4e-7 relative at most, 3 float32 ulps, 95%
bit-equal over 2**20 draws)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops.flat import dp_noise as j_dp_noise
from commefficient_tpu_torch.ops import prng
from commefficient_tpu_torch.ops.flat import dp_noise as t_dp_noise

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

NORMAL_RTOL = 1e-6
# the lower end of the normal's uniform, nextafter(-1, 0)
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

SEEDS = [0, 21, 42, 12345, 2**31 - 1]


def _key_words(k) -> np.ndarray:
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _key_words(jk))
    for data in (0, 1, 7, 8, 2**31 + 5, 2**32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(tk, data).numpy(),
            _key_words(jax.random.fold_in(jk, data)), err_msg=str(data))
    # the round engine's chain: round key, then client / server keys
    jr = jax.random.fold_in(jax.random.fold_in(jk, 3), 4)
    tr = prng.fold_in(prng.fold_in(tk, 3), 4)
    np.testing.assert_array_equal(tr.numpy(), _key_words(jr))


@pytest.mark.parametrize("shape", [(1,), (7,), (1001,), (3, 5), (2, 3, 7)])
@pytest.mark.parametrize("seed", [0, 21, 12345])
def test_bits_and_uniforms_are_bitwise_jax(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    tk = prng.fold_in(prng.PRNGKey(seed), 5)
    jb = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(tk, shape).numpy(), jb)
    # ranges of a power-of-two width (the normal's is 2), where
    # floats * (hi - lo) is exact: XLA's CPU contracts `* (hi - lo) + lo`
    # into one FMA, the port keeps two operations, and the two agree
    # only where the product needs no rounding
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (2.0, 6.0), (_LO, 1.0)):
        ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        tu = prng.uniform(tk, shape, lo, hi).numpy()
        np.testing.assert_array_equal(tu.view(np.uint32),
                                      ju.view(np.uint32))


def test_bits_past_two_to_the_24():
    # 2**24 + 3 elements: the draw runs in chunks of 2**24, and the
    # counter's low word crosses 2**24; both packages' last elements
    n = 2**24 + 3
    jk = jax.random.PRNGKey(7)
    jb = np.asarray(jax.random.bits(jk, (n,)))
    tb = prng.random_bits(prng.PRNGKey(7), (n,)).numpy()
    np.testing.assert_array_equal(tb, jb.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 21])
def test_normals_within_a_few_ulps_of_jax(seed):
    n = 1 << 18
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    tk = prng.fold_in(prng.PRNGKey(seed), 1)
    jn = np.asarray(jax.random.normal(jk, (n,)))
    tn = prng.normal(tk, (n,)).numpy()
    np.testing.assert_allclose(tn, jn, rtol=NORMAL_RTOL, atol=0)
    # and mostly bit-equal: the polynomial is XLA's, not torch.erfinv
    assert (tn == jn).mean() > 0.9


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 0.0, 1.0, 0.5, -0.999999])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    got = prng.erf_inv(x).numpy()
    assert np.isinf(got[0]) and got[0] < 0 and np.isinf(got[2])
    assert got[1] == 0.0
    np.testing.assert_allclose(got[3:], want[3:], rtol=NORMAL_RTOL)


@pytest.mark.parametrize("W", [4, 8])
def test_dp_noise_at_the_worker_scale(W):
    # worker noise N(0, 1) * noise_multiplier * sqrt(W), from client 2's
    # key of round 3, as forward_grad draws it
    sigma, D = 0.7, 10_007
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(21), 3), 2)
    tk = prng.fold_in(prng.fold_in(prng.PRNGKey(21), 3), 2)
    scale = float(np.sqrt(W))
    jn = np.asarray(j_dp_noise(jk, (D,), sigma, scale=scale))
    tn = t_dp_noise(tk, (D,), sigma, scale=scale).numpy()
    np.testing.assert_allclose(tn, jn, rtol=NORMAL_RTOL, atol=0)
    assert abs(tn.std() / (sigma * scale) - 1) < 0.05


def test_draws_run_on_the_requested_device():
    # keys stay on the host; the draw takes the caller's device
    k = prng.PRNGKey(3)
    assert k.device.type == "cpu" and k.dtype == torch.int64
    assert prng.normal(k, (5,), device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        prng.PRNGKey(-1)
    with pytest.raises(ValueError):
        prng.fold_in(k, 2**32)
