"""The port's CUDA kernel wrappers (commefficient_tpu_torch/ops/kernels/
sketch_cuda.py): argument checks, the CPU route to the plain versions,
and — on a CUDA card only — each kernel against its plain version.
The card cases carry the `gpu` marker and skip here with a reason; on
the card: `python -m pytest tests/test_torch_kernels.py -m gpu
--noconftest` (tests/conftest.py imports jax)."""
import numpy as np
import pytest
import torch

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
    # plain-version calls launch nothing and count nothing
    assert sc.LAUNCHES == {"sketch_encode": 0, "sketch_estimate_all": 0}


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


def test_build_names_the_library_by_source_hash():
    # edited sources rebuild: the library name carries the source digest
    p = sc._lib_path("sketch")
    assert p.parent == sc.BUILD_DIR and p.name.startswith("libcct_sketch_")


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
