"""The port's CUDA kernel wrappers (commefficient_tpu_torch/ops/kernels/
sketch_cuda.py and attention_cuda.py): argument checks, the CPU route
to the plain versions, and — on a CUDA card only — each kernel against
its plain version.
The card cases carry the `gpu` marker and skip here with a reason; on
the card: `python -m pytest tests/test_torch_kernels.py -m gpu
--noconftest` (tests/conftest.py imports jax)."""
import numpy as np
import pytest
import torch

from commefficient_tpu_torch.ops.kernels import attention_cuda as ac
from commefficient_tpu_torch.ops.kernels import sketch_cuda as sc
from commefficient_tpu_torch.ops.sketch import CSVec

pytestmark = pytest.mark.torch_port

GEOMETRIES = [
    dict(d=1000, c=200, r=5),       # padded tail, odd r
    dict(d=512, c=128, r=4),        # exact fit, even r
    dict(d=300, c=400, r=3),        # single chunk, c > d
    dict(d=1000, c=200, r=6),       # padded tail, even r
]
MAIN_PATH = dict(d=6_568_640, c=500_000, r=5)   # full-width ResNet9
GPT2_PATH = dict(d=124_444_417, c=500_000, r=5)  # full-width GPT2-small
# the threshold-decode geometries of tests/test_kernels.py:112-160
THRESHOLD_GEOMETRIES = [dict(d=40000, c=10000, r=5),
                        dict(d=20000, c=5000, r=5),
                        dict(d=16384, c=256, r=5)]


def _operands(geom, device="cpu", seed=0):
    sk = CSVec(**geom)
    off, eps, delta = sk.tables(device)
    x = torch.from_numpy(np.random.RandomState(seed).randn(geom["d"])
                         .astype(np.float32)).to(device)
    return sk, x, off, eps, delta


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(their plain versions are tested against JAX in "
                    "test_torch_sketch.py)")
    return torch.device("cuda")


def test_cpu_tensors_take_the_plain_versions():
    sk, x, off, eps, delta = _operands(GEOMETRIES[0])
    sc.reset_launches()
    t = sc.encode(x, off, delta, eps, sk.c)
    torch.testing.assert_close(t, sc.encode_plain(x, off, delta, eps, sk.c),
                               rtol=0, atol=0)
    e = sc.estimate_all(t, off, delta, eps, sk.d)
    torch.testing.assert_close(
        e, sc.estimate_all_plain(t, off, delta, eps, sk.d), rtol=0, atol=0)
    stride, ns = sc.threshold_sample_geometry(sk.n_chunks, sk.c)
    smp = sc.threshold_sample(t, off, delta, eps, sk.d, stride, ns)
    torch.testing.assert_close(
        smp, sc.threshold_sample_plain(t, off, delta, eps, sk.d, stride, ns),
        rtol=0, atol=0)
    thr = torch.tensor(0.5)
    torch.testing.assert_close(
        sc.threshold_mask(t, off, delta, eps, thr, sk.d),
        sc.threshold_mask_plain(t, off, delta, eps, thr, sk.d),
        rtol=0, atol=0)
    # plain-version calls launch nothing and count nothing
    assert sc.LAUNCHES == {name: 0 for name in sc.LAUNCHES}
    assert set(sc.LAUNCHES) == {"sketch_encode", "sketch_estimate_all",
                                "threshold_sample", "threshold_mask"}


def test_wrappers_check_dtype_shape_contiguity_and_device():
    sk, x, off, eps, delta = _operands(GEOMETRIES[0])
    c, d = sk.c, sk.d
    with pytest.raises(TypeError, match="float32"):
        sc.encode(x.double(), off, delta, eps, c)
    with pytest.raises(TypeError, match="int32"):
        sc.encode(x, off.long(), delta, eps, c)
    with pytest.raises(ValueError, match="shape"):
        sc.encode(x, off, delta, eps[:, :-1], c)
    with pytest.raises(ValueError, match="chunks"):
        sc.encode(x[:100].contiguous(), off, delta, eps, c)
    with pytest.raises(ValueError, match="contiguous"):
        sc.estimate_all(torch.zeros(c, sk.r).t(), off, delta, eps, d)
    with pytest.raises(ValueError, match="device"):
        sc.encode(x.to("meta"), off, delta, eps, c)
    with pytest.raises(ValueError, match="rows"):
        big = CSVec(d=100, c=10, r=17)
        o, e, dl = big.tables("cpu")
        sc.estimate_all(torch.zeros(17, 10), o, dl, e, 100)
    with pytest.raises(TypeError, match="Tensor"):
        sc.encode(np.zeros(d, np.float32), off, delta, eps, c)
    table = torch.zeros(sk.r, c)
    with pytest.raises(ValueError, match="stride"):
        sc.threshold_sample(table, off, delta, eps, d, c, 2)
    with pytest.raises(ValueError, match="one-element"):
        sc.threshold_mask(table, off, delta, eps, torch.zeros(2), d)
    with pytest.raises(ValueError, match="float32"):
        sc.threshold_mask(table, off, delta, eps, torch.tensor(0.5).double(),
                          d)


def test_threshold_sample_plain_is_k2_at_the_sampled_positions():
    # K3a's plain version gathers K2's estimate at chunk positions
    # 0, stride, ... (the tail at or past d zeroed): exact
    for geom in GEOMETRIES:
        sk, x, off, eps, delta = _operands(geom, seed=2)
        t = sc.encode(x, off, delta, eps, sk.c)
        est = sc.estimate_all(t, off, delta, eps, sk.d)
        for stride in (1, 3, sk.c):
            ns = sk.c // stride
            got = sc.threshold_sample(t, off, delta, eps, sk.d, stride, ns)
            assert torch.equal(got, est[:, :ns * stride:stride])


def test_build_names_the_library_by_source_hash():
    # edited sources rebuild: the library name carries the source digest
    from commefficient_tpu_torch.ops.kernels import _build
    for name in ("sketch", "flash_fwd"):
        p = _build.lib_path(name)
        assert p.parent == _build.BUILD_DIR
        assert p.name.startswith(f"libcct_{name}_")


@pytest.mark.gpu
@pytest.mark.parametrize("geom", GEOMETRIES + [MAIN_PATH],
                         ids=["tail-odd", "exact-even", "single-chunk",
                              "tail-even", "main-path"])
def test_kernels_match_plain_versions_on_the_card(cuda_device, geom):
    # the same additions in the same order, no FMA contraction: exact
    sk, x, off, eps, delta = _operands(geom, cuda_device, seed=1)
    before = dict(sc.LAUNCHES)
    t = sc.encode(x, off, delta, eps, sk.c)
    assert torch.equal(t, sc.encode_plain(x, off, delta, eps, sk.c))
    e = sc.estimate_all(t, off, delta, eps, sk.d)
    assert torch.equal(e, sc.estimate_all_plain(t, off, delta, eps, sk.d))
    torch.cuda.synchronize()
    assert sc.LAUNCHES["sketch_encode"] == before["sketch_encode"] + 1
    assert (sc.LAUNCHES["sketch_estimate_all"]
            == before["sketch_estimate_all"] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("geom", GEOMETRIES + THRESHOLD_GEOMETRIES
                         + [GPT2_PATH],
                         ids=["tail-odd", "exact-even", "single-chunk",
                              "tail-even", "heavy-hitters", "dispatch",
                              "stride-clamped", "gpt2-path"])
def test_threshold_kernels_match_plain_versions_on_the_card(cuda_device,
                                                            geom):
    # K3a and K3b compute K2's estimate with K2's device code: exact;
    # K1 builds their table, exact at these geometries too
    sk, x, off, eps, delta = _operands(geom, cuda_device, seed=3)
    t = sc.encode(x, off, delta, eps, sk.c)
    assert torch.equal(t, sc.encode_plain(x, off, delta, eps, sk.c))
    stride, ns = sc.threshold_sample_geometry(sk.n_chunks, sk.c)
    if geom["c"] == 256:
        stride, ns = sk.c, 1        # the stride clamped to c
    before = dict(sc.LAUNCHES)
    smp = sc.threshold_sample(t, off, delta, eps, sk.d, stride, ns)
    assert torch.equal(smp, sc.threshold_sample_plain(t, off, delta, eps,
                                                      sk.d, stride, ns))
    thr = (smp.reshape(-1) ** 2).median().reshape(1)
    m = sc.threshold_mask(t, off, delta, eps, thr, sk.d)
    assert torch.equal(m, sc.threshold_mask_plain(t, off, delta, eps, thr,
                                                  sk.d))
    torch.cuda.synchronize()
    for name in ("threshold_sample", "threshold_mask"):
        assert sc.LAUNCHES[name] == before[name] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("BH,L", [(192, 299), (192, 294), (4, 256),
                                  (4, 300), (4, 1024)])
def test_flash_kernel_matches_plain_on_the_card(cuda_device, BH, L):
    # the kernel's own f32 FMAs in 64-key tiles vs the plain 128-key
    # fold: 1e-5 of the output's scale
    g = torch.Generator().manual_seed(L)
    q, k, v = (torch.randn(1, BH, L, 64, generator=g).to(cuda_device)
               for _ in range(3))
    before = ac.LAUNCHES["flash_fwd"]
    o, lse = ac.flash_fwd(q, k, v, 0.125)
    po, plse = ac.flash_fwd_plain(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert ac.LAUNCHES["flash_fwd"] == before + 1
    assert float((o - po).abs().max()) <= 1e-5 * float(po.abs().max())
    assert float((lse - plse).abs().max()) <= 1e-5 * float(plse.abs().max())
