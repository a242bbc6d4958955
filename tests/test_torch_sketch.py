"""Count-sketch parity: the port's CSVec (commefficient_tpu_torch/ops/
sketch.py, plain kernel versions on the CPU) against the JAX CSVec on
the same numpy inputs — the XLA route and the Pallas route (interpret
mode off-TPU, as tests/test_kernels.py runs it)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops.sketch import CSVec as JCSVec
from commefficient_tpu_torch.ops import sketch as tsketch
from commefficient_tpu_torch.ops.sketch import CSVec as TCSVec

pytestmark = pytest.mark.torch_port

# the three tests/test_kernels.py geometries plus one more even r
GEOMETRIES = [
    dict(d=1000, c=200, r=5),   # padded tail, odd r
    dict(d=512, c=128, r=4),    # exact fit, even r
    dict(d=300, c=400, r=3),    # single chunk, c > d
    dict(d=1000, c=200, r=6),   # padded tail, even r
]
BACKENDS = ["xla", "pallas"]


def _pair(geom, backend="xla"):
    return (JCSVec(backend=backend, num_blocks=1, **geom),
            TCSVec(num_blocks=1, **geom))


def _vec(d, seed):
    return np.random.RandomState(seed).randn(d).astype(np.float32)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_hash_tables_identical(geom):
    # the same RandomState draw order (offsets, eps, delta) -> the same
    # tables, bit for bit
    js, ts = _pair(geom)
    np.testing.assert_array_equal(np.asarray(js._offsets), ts._offsets)
    np.testing.assert_array_equal(np.asarray(js._eps), ts._eps)
    np.testing.assert_array_equal(np.asarray(js._delta), ts._delta)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_encode_matches_jax(geom, backend):
    # same additions in the same order (chunks ascending, products of
    # +-1 signs exact) -> exact equality is the tolerance
    js, ts = _pair(geom, backend)
    v = _vec(geom["d"], 1)
    want = np.array(js.encode(jnp.asarray(v)))
    got = ts.encode(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_estimate_all_matches_jax(geom, backend):
    # median of the same signed values, even r averaging the two middles
    # as jnp.median does -> exact equality; the port zeroes the padding
    # tail (the Pallas contract), so the XLA result is compared that way
    js, ts = _pair(geom, backend)
    t = np.array(js.encode(jnp.asarray(_vec(geom["d"], 2))))
    want = np.asarray(js.estimate_all(jnp.asarray(t))).reshape(-1).copy()
    want[geom["d"]:] = 0.0
    got = ts.estimate_all(torch.from_numpy(t)).reshape(-1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_decode_topk_sparse_matches_jax(geom):
    # exact top-k on both sides (approx_max_k is exact on the CPU): the
    # same (index, value) pairs, order aside
    js, ts = _pair(geom)
    t = np.array(js.encode(jnp.asarray(_vec(geom["d"], 3))))
    k = geom["d"] // 7
    ji, jv = js.decode_topk_sparse(jnp.asarray(t), k)
    ti, tv = ts.decode_topk_sparse(torch.from_numpy(t), k)
    want = dict(zip(np.asarray(ji).tolist(), np.asarray(jv).tolist()))
    got = dict(zip(ti.numpy().tolist(), tv.numpy().tolist()))
    assert got == want
    dense_j = np.asarray(js.decode_topk(jnp.asarray(t), k))
    dense_t = ts.decode_topk(torch.from_numpy(t), k).numpy()
    np.testing.assert_array_equal(dense_t, dense_j)


def test_zero_estimates_map_to_index_d():
    # a vector with fewer nonzeros than k: the zero-valued picks report
    # index d (sketch.py:417), which drop-mode scatters ignore
    geom = dict(d=1000, c=200, r=5)
    js, ts = _pair(geom)
    v = np.zeros(geom["d"], np.float32)
    v[[3, 500, 999]] = [5.0, -7.0, 2.0]
    t = np.array(js.encode(jnp.asarray(v)))
    ti, tv = ts.decode_topk_sparse(torch.from_numpy(t), 50)
    zero = tv.numpy() == 0.0
    assert zero.any()
    assert (ti.numpy()[zero] == geom["d"]).all()
    ji, _ = js.decode_topk_sparse(jnp.asarray(t), 50)
    assert sorted(ti.numpy().tolist()) == sorted(np.asarray(ji).tolist())


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_encode_sparse_and_estimate_match_jax(geom):
    # scatter-adds in the same order -> exact
    js, ts = _pair(geom)
    rng = np.random.RandomState(4)
    idx = rng.choice(geom["d"], size=40, replace=False).astype(np.int32)
    idx[0] = geom["d"]          # out of range: dropped by both
    vals = rng.randn(40).astype(np.float32)
    want = np.array(js.encode_sparse(jnp.asarray(idx), jnp.asarray(vals)))
    got = ts.encode_sparse(torch.from_numpy(idx).long(),
                           torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    q = np.arange(0, geom["d"], 7, dtype=np.int32)
    want = np.asarray(js.estimate(jnp.asarray(want), jnp.asarray(q)))
    got = ts.estimate(torch.from_numpy(got), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_l2estimate_matches_jax(geom):
    # row sums of squares reduce in another order: relative 1e-6
    js, ts = _pair(geom)
    t = np.array(js.encode(jnp.asarray(_vec(geom["d"], 5))))
    want = float(js.l2estimate(jnp.asarray(t)))
    got = float(ts.l2estimate(torch.from_numpy(t)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_encode_k_sparse_route_pinned_by_dense():
    # the route gate is a function of (r, k, device): the CPU always
    # scatters; a CUDA device past r*k = 1M encodes `dense`. Both JAX
    # and the port take the scatter route on the CPU, and passing the
    # dense form pins what the dense route would sketch: the same table
    # up to summation order (relative 1e-6 of the table's scale).
    assert tsketch.k_sparse_route(5, 300_000, torch.device("cpu")) == "sparse"
    assert tsketch.k_sparse_route(5, 300_000,
                                  torch.device("cuda")) == "dense"
    assert tsketch.k_sparse_route(5, 50_000, torch.device("cuda")) == "sparse"
    geom = dict(d=1000, c=200, r=5)
    js, ts = _pair(geom)
    rng = np.random.RandomState(6)
    idx = rng.choice(geom["d"], size=60, replace=False).astype(np.int32)
    vals = rng.randn(60).astype(np.float32)
    dense = np.zeros(geom["d"], np.float32)
    dense[idx] = vals
    want = np.asarray(js.encode_k_sparse(jnp.asarray(idx), jnp.asarray(vals),
                                         dense=jnp.asarray(dense)))
    got = ts.encode_k_sparse(torch.from_numpy(idx).long(),
                             torch.from_numpy(vals),
                             dense=torch.from_numpy(dense)).numpy()
    np.testing.assert_array_equal(got, want)
    via_dense = ts.encode(torch.from_numpy(dense)).numpy()
    np.testing.assert_allclose(via_dense, got, rtol=0,
                               atol=1e-6 * np.abs(got).max())


def test_threshold_decode_is_refused_until_k3():
    # d past THRESHOLD_DECODE_MIN_D needs kernel K3 (ROADMAP Queue 2)
    ts = TCSVec(d=tsketch.THRESHOLD_DECODE_MIN_D + 1, c=2 ** 22, r=1)
    assert ts._threshold_decode
    with pytest.raises(NotImplementedError, match="K3"):
        ts.decode_topk_dense(ts.zeros(), 10)


@pytest.mark.parametrize("d,k", [(1000, 37), (4 * 1024 * 1024 + 64, 5000)],
                         ids=["exact-topk", "sampled-threshold"])
def test_masked_topk_matches_jax(d, k):
    # exact top-k below TOPK_THRESHOLD_MIN_D, the sampled threshold
    # above it: the same selected coordinates, exactly
    from commefficient_tpu.ops.flat import masked_topk as j_masked_topk
    from commefficient_tpu_torch.ops.flat import masked_topk
    v = _vec(d, 8)
    v[:10] = v[10]              # ties at one magnitude
    want = np.asarray(j_masked_topk(jnp.asarray(v), k))
    got = masked_topk(torch.from_numpy(v), k).numpy()
    np.testing.assert_array_equal(got, want)
