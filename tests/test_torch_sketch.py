"""Count-sketch parity: the port's CSVec (commefficient_tpu_torch/ops/
sketch.py, plain kernel versions on the CPU) against the JAX CSVec on
the same numpy inputs — the XLA route and the Pallas route (interpret
mode off-TPU, as tests/test_kernels.py runs it), and the blockwise
top-k decode past the materialize gates."""
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


# ---------------- the blockwise decode (past the materialize gates) --------

def _tied_vec(d, seed, zeros=0.3):
    """A vector with exact ties (values from a short list) and zeros."""
    rng = np.random.RandomState(seed)
    v = rng.choice([-3.0, -1.5, 0.5, 1.5, 2.0, 3.0], d).astype(np.float32)
    v *= rng.rand(d) < 0.2                      # ties among few nonzeros
    v += (rng.rand(d) < 0.05) * rng.randn(d).astype(np.float32)
    v[rng.rand(d) < zeros] = 0.0
    return v


BLOCKWISE = {
    # r * B past STATIC_UNROLL_LIMIT (5 x 3,000 > 2,048), odd and even r
    "rB-odd-r": (dict(d=30000, c=10, r=5), 50),
    "rB-even-r": (dict(d=30000, c=10, r=4), 13),
    "rB-k-past-nonzeros": (dict(d=30000, c=10, r=5), 20000),
    # a ragged last chunk
    "rB-ragged": (dict(d=30007, c=13, r=5), 333),
}


@pytest.mark.parametrize("case", sorted(BLOCKWISE))
def test_blockwise_decode_matches_jax_in_order(case):
    # the per-chunk top-min(k, c) and the final top-k in lax.top_k's
    # order on both sides (JAX's approx_max_k is exact off the TPU):
    # (idx, vals) equal element by element, ties and zeros included
    geom, k = BLOCKWISE[case]
    js, ts = _pair(geom)
    assert not ts._static_path
    for seed, v in enumerate((_vec(geom["d"], 4), _tied_vec(geom["d"], 5))):
        t = np.array(js.encode(jnp.asarray(v)))
        ji, jv = js.decode_topk_sparse(jnp.asarray(t), k)
        ti, tv = ts.decode_topk_sparse(torch.from_numpy(t), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        if seed:
            # the tied vector's estimates tie, and some picks are zeros
            assert len(np.unique(np.abs(tv.numpy()))) < k
        np.testing.assert_array_equal(
            ts.decode_topk(torch.from_numpy(t), k).numpy(),
            np.asarray(js.decode_topk(jnp.asarray(t), k)))


@pytest.mark.parametrize("window_chunks", [7, 100])
def test_blockwise_decode_past_the_materialize_limit(monkeypatch,
                                                     window_chunks):
    # a padded d over DECODE_MATERIALIZE_LIMIT (lowered in both modules
    # for the test) with r * B inside the unroll gate; the port's window
    # lowered too, so the decode runs in windows of 7 chunks (the last
    # ragged) or in one
    from commefficient_tpu.ops import sketch as jsketch
    monkeypatch.setattr(jsketch, "DECODE_MATERIALIZE_LIMIT", 4096)
    monkeypatch.setattr(tsketch, "DECODE_MATERIALIZE_LIMIT", 4096)
    monkeypatch.setattr(tsketch, "DECODE_WINDOW_BYTES",
                        window_chunks * 4 * 100)
    geom = dict(d=9950, c=100, r=5)
    js, ts = _pair(geom)
    assert ts._static_path and ts.n_chunks * ts.c > 4096
    assert tsketch.window_chunks(ts.c) == window_chunks
    t = np.array(js.encode(jnp.asarray(_tied_vec(geom["d"], 6, 0.0))))
    for k in (1, 99, 400):
        ji, jv = js.decode_topk_sparse(jnp.asarray(t), k)
        ti, tv = ts.decode_topk_sparse(torch.from_numpy(t), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("geom", [dict(d=30007, c=13, r=5),
                                  dict(d=1000, c=200, r=6),
                                  dict(d=5000, c=301, r=5)])
def test_window_estimates_are_slices_of_the_full_estimate(geom):
    from commefficient_tpu_torch.ops.kernels import sketch_cuda as sc
    ts = TCSVec(num_blocks=1, **geom)
    table = ts.encode(torch.from_numpy(_vec(geom["d"], 8)))
    off, eps, delta = ts.tables("cpu")
    full = sc.estimate_all_plain(table, off, delta, eps, geom["d"])
    B = ts.n_chunks
    eps_bits, delta_bits = ts.sign_bits("cpu")
    for b0, nb in ((0, 1), (0, B), (B // 3, max(B // 4, 1)), (B - 1, 1),
                   (max(B - 5, 0), min(5, B))):
        want = full[b0:b0 + nb]
        assert torch.equal(sc.estimate_all_plain(table, off, delta, eps,
                                                 geom["d"], b0, nb), want)
        assert torch.equal(sc.estimate_window(table, off, delta_bits,
                                              eps_bits, geom["d"], b0, nb),
                           want)
    with pytest.raises(ValueError, match="chunk window"):
        sc.estimate_window(table, off, delta_bits, eps_bits, geom["d"],
                           B - 1, 2)


def test_blockwise_round_matches_jax():
    # two sketched rounds of the tiny ResNet9 at 16 x 60: r * B = 2,160
    # past the unroll gate, so the server decodes blockwise in both
    # packages; the weights and the billed bytes match. (A narrower
    # table is no test: at 5 x 4 each cell sums ~2,000 coordinates,
    # and the cancellation lifts the gradients' rounding to 8% of the
    # second round's update in either package.)
    from commefficient_tpu.config import Config as JConfig
    from commefficient_tpu.federated.api import (
        FedModel as JFedModel, FedOptimizer as JFedOptimizer,
    )
    from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9
    from commefficient_tpu.training.cv_train import (
        make_compute_loss as j_make_compute_loss,
    )
    from commefficient_tpu_torch.config import Config as TConfig
    from commefficient_tpu_torch.federated.api import (
        FedModel as TFedModel, FedOptimizer as TFedOptimizer,
    )
    from commefficient_tpu_torch.models import build_model
    from commefficient_tpu_torch.models.convert import from_jax_params
    from commefficient_tpu_torch.training.cv_train import (
        make_compute_loss as t_make_compute_loss,
    )
    import jax
    tiny = {"prep": 4, "layer1": 8, "layer2": 8, "layer3": 16}
    jm = JResNet9(num_classes=10, channels=tiny)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((2, 32, 32, 3), jnp.float32))
    tm = build_model("ResNet9", channels=tiny)
    from_jax_params(tm, params)
    kw = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=300, num_rows=16, num_cols=60, local_momentum=0.0,
              num_workers=4, num_clients=12, local_batch_size=6)
    jmodel = JFedModel(None, j_make_compute_loss(jm), JConfig(**kw),
                       params=params, num_clients=12)
    tmodel = TFedModel(tm, t_make_compute_loss(tm),
                       TConfig(**kw, device="cpu"), device="cpu",
                       num_clients=12)
    sk = tsketch.cached_sketch(tmodel.cfg.grad_size, 60, 16)
    assert not sk._static_path and not sk._threshold_decode
    jopt, topt = JFedOptimizer(jmodel), TFedOptimizer(tmodel)
    rng = np.random.RandomState(7)
    for i in range(2):
        ids = rng.choice(12, 4, replace=False).astype(np.int32)
        x = rng.randn(4, 6, 32, 32, 3).astype(np.float32)
        y = rng.randint(0, 10, size=(4, 6)).astype(np.int32)
        batch = (ids, (x, y), np.ones((4, 6), np.float32))
        jopt.param_groups[0]["lr"] = topt.param_groups[0]["lr"] = 0.1
        w0 = tmodel.ps_weights.clone()
        jl, _, jd, ju = jmodel(batch)
        tl, _, td, tu = tmodel(batch)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tu, ju)
        jw = np.asarray(jmodel.ps_weights)
        np.testing.assert_allclose(tmodel.ps_weights.numpy(), jw, rtol=0,
                                   atol=1e-5 * np.abs(jw).max(),
                                   err_msg=f"round {i}")
        moved = int((tmodel.ps_weights != w0).sum())
        assert 0 < moved <= kw["k"]
