"""Count-sketch parity: the port's CSVec (commefficient_tpu_torch/ops/
sketch.py, plain kernel versions on the CPU) against the JAX CSVec on
the same numpy inputs — the XLA route and the Pallas route (interpret
mode off-TPU, as tests/test_kernels.py runs it)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops.sketch import CSVec as JCSVec
from commefficient_tpu_torch.ops import sketch as tsketch
from commefficient_tpu_torch.ops.sketch import CSVec as TCSVec

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

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
    # kernel K3 is ported: past THRESHOLD_DECODE_MIN_D (no monkeypatch)
    # decode_topk_dense takes the sampled-threshold route and recovers a
    # 3-sparse vector exactly (the threshold floors at f32 tiny, so
    # exactly the nonzero estimates are kept)
    ts = TCSVec(d=tsketch.THRESHOLD_DECODE_MIN_D + 1, c=2 ** 22, r=3)
    assert ts._threshold_decode
    hot = torch.tensor([5, 20_000_000, ts.d - 1])
    vals = torch.tensor([7.0, -6.0, 5.0])
    out = ts.decode_topk_dense(ts.encode_sparse(hot, vals), 10)
    assert out.shape == (ts.d,)
    assert torch.equal(torch.nonzero(out).reshape(-1), hot)
    assert torch.equal(out[hot], vals)


# threshold-regime geometries: the tests/test_kernels.py heavy-hitter
# and dispatch geometries, an even r, and a ragged last chunk
THRESHOLD_GEOMETRIES = [
    dict(d=40000, c=10000, r=5),
    dict(d=20000, c=5000, r=5),
    dict(d=20000, c=5000, r=4),
    dict(d=30001, c=7000, r=3),
]


def _heavy(d, n_hot, seed):
    rng = np.random.RandomState(seed)
    v = rng.randn(d).astype(np.float32) * 0.01
    hot = rng.choice(d, n_hot, replace=False)
    v[hot] = rng.choice([-1.0, 1.0], n_hot) * (5.0 + rng.rand(n_hot))
    return v, hot


@pytest.fixture
def threshold_regime(monkeypatch):
    # both packages' gate lowered, as tests/test_kernels.py:129-143 does
    import commefficient_tpu.ops.sketch as jsk
    monkeypatch.setattr(jsk, "THRESHOLD_DECODE_MIN_D", 1000)
    monkeypatch.setattr(tsketch, "THRESHOLD_DECODE_MIN_D", 1000)


@pytest.mark.parametrize("geom", THRESHOLD_GEOMETRIES)
def test_threshold_decode_matches_jax_pallas(threshold_regime, geom):
    # the same per-chunk sample (bitwise K2 estimates), the same k-th
    # largest square (exact top-k on the CPU), the same >= select:
    # exact equality with JAX pallas_threshold_decode
    from commefficient_tpu.ops.kernels import pallas_threshold_decode
    js, ts = _pair(geom, "pallas")
    assert js._threshold_decode and js._pallas("estimate")
    assert ts._threshold_decode
    v, _ = _heavy(geom["d"], 50, seed=8)
    t = np.array(js.encode(jnp.asarray(v)))
    k = 2000
    want = np.asarray(pallas_threshold_decode(js, jnp.asarray(t), k))
    got = ts.decode_topk_dense(torch.from_numpy(t), k).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(js.decode_topk_dense(jnp.asarray(t), k)))


@pytest.mark.parametrize("geom", THRESHOLD_GEOMETRIES[:2])
def test_threshold_decode_within_band_of_jax_xla(threshold_regime, geom):
    # the XLA route samples the flat estimate at one global stride, the
    # port per chunk: both keep the hot coordinates, both land within
    # the sampling band of k (tests/test_kernels.py:126), and every
    # coordinate both keep carries the same value
    js, ts = _pair(geom, "xla")
    v, hot = _heavy(geom["d"], 50, seed=8)
    t = np.array(js.encode(jnp.asarray(v)))
    k = 2000
    want = np.asarray(js.decode_topk_dense(jnp.asarray(t), k))
    got = ts.decode_topk_dense(torch.from_numpy(t), k).numpy()
    for out in (want, got):
        nz = np.nonzero(out)[0]
        assert set(hot).issubset(set(nz))
        assert 0.75 * k <= len(nz) <= 1.25 * k, len(nz)
    both = (want != 0) & (got != 0)
    np.testing.assert_array_equal(got[both], want[both])


def test_threshold_decode_stride_clamped_to_chunk(threshold_regime,
                                                  monkeypatch):
    # a chunk narrower than the global sample stride clamps the stride
    # to c (one sample a chunk), in both packages alike
    import commefficient_tpu.ops.kernels.sketch_pallas as sp
    from commefficient_tpu_torch.ops.kernels import sketch_cuda as sc
    monkeypatch.setattr(sp, "_SAMPLE_TARGET", 32)
    monkeypatch.setattr(sc, "_SAMPLE_TARGET", 32)
    geom = dict(d=16384, c=256, r=5)
    js, ts = _pair(geom, "pallas")
    assert sc.threshold_sample_geometry(ts.n_chunks, ts.c) == (256, 1)
    assert sp.threshold_sample_geometry(js) == (256, 1)
    v = np.zeros(geom["d"], np.float32)
    hot = [5, 900, 14000]
    v[hot] = [7.0, -6.0, 5.0]
    t = np.array(js.encode(jnp.asarray(v)))
    want = np.asarray(sp.pallas_threshold_decode(js, jnp.asarray(t), 3))
    got = ts.decode_topk_dense(torch.from_numpy(t), 3).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[hot], v[hot], atol=1e-4)


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
