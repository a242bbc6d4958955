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

from commefficient_tpu_torch.ops.flat import threshold_from_sq_sample
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
# full-width GPT2-medium, the blockwise decode's geometry (B = 710)
MEDIUM_PATH = dict(d=354_829_313, c=500_000, r=5)
# the threshold-decode geometries of tests/test_kernels.py:112-160
THRESHOLD_GEOMETRIES = [dict(d=40000, c=10000, r=5),
                        dict(d=20000, c=5000, r=5),
                        dict(d=16384, c=256, r=5)]


# the main path's share of coordinates kept: k = 50,000 of GPT2_PATH's d
MAIN_PATH_KEEP = 50_000 / GPT2_PATH["d"]


def _k3_thresholds(sk, sample, mask):
    """The three thresholds K3b is held at: the main path's (its keep
    share priced from the sample as decode_topk_dense prices it), the
    median of the sample squares (about half kept) and the square of a
    value the median keeps (a tie). `mask(thr)` is the plain K3b."""
    k = max(1, round(sk.d * MAIN_PATH_KEEP))
    sq = (sample * sample).reshape(-1)
    main = threshold_from_sq_sample(sq, k, sk.n_chunks * sk.c).reshape(1)
    median = sq.median().reshape(1)
    kept = mask(median)
    kept = kept[kept != 0]
    tie = (kept[kept.numel() // 2] ** 2).reshape(1)
    return {"main-path": main, "median": median, "tie": tie}


def _exact(a, b) -> bool:
    """torch.equal, with NaN matching NaN (an even-r median of -inf and
    +inf is NaN in both versions)"""
    na, nb = torch.isnan(a), torch.isnan(b)
    return (torch.equal(na, nb)
            and torch.equal(a.masked_fill(na, 0.0), b.masked_fill(nb, 0.0)))


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
    eps_bits, delta_bits = sk.sign_bits("cpu")
    sc.reset_launches()
    t = sc.encode(x, off, delta_bits, eps_bits, sk.c)
    torch.testing.assert_close(t, sc.encode_plain(x, off, delta, eps, sk.c),
                               rtol=0, atol=0)
    e = sc.estimate_all(t, off, delta_bits, eps_bits, sk.d)
    torch.testing.assert_close(
        e, sc.estimate_all_plain(t, off, delta, eps, sk.d), rtol=0, atol=0)
    torch.testing.assert_close(
        sc.estimate_window(t, off, delta_bits, eps_bits, sk.d, 1, 3),
        e[1:4], rtol=0, atol=0)
    stride, ns = sc.threshold_sample_geometry(sk.n_chunks, sk.c)
    smp = sc.threshold_sample(t, off, delta_bits, eps_bits, sk.d, stride, ns)
    torch.testing.assert_close(
        smp, sc.threshold_sample_plain(t, off, delta, eps, sk.d, stride, ns),
        rtol=0, atol=0)
    thr = torch.tensor(0.5)
    torch.testing.assert_close(
        sc.threshold_mask(t, off, delta_bits, eps_bits, thr, sk.d),
        sc.threshold_mask_plain(t, off, delta, eps, thr, sk.d),
        rtol=0, atol=0)
    # plain-version calls launch nothing and count nothing
    assert sc.LAUNCHES == {name: 0 for name in sc.LAUNCHES}
    assert set(sc.LAUNCHES) == {"sketch_encode", "sketch_estimate_all",
                                "sketch_estimate_window",
                                "threshold_sample", "threshold_mask"}


def test_wrappers_check_dtype_shape_contiguity_and_device():
    sk, x, off, eps, delta = _operands(GEOMETRIES[0])
    c, d = sk.c, sk.d
    eps_bits, delta_bits = sk.sign_bits("cpu")
    with pytest.raises(TypeError, match="float32"):
        sc.encode(x.double(), off, delta_bits, eps_bits, c)
    with pytest.raises(TypeError, match="int32"):
        sc.encode(x, off.long(), delta_bits, eps_bits, c)
    with pytest.raises(ValueError, match="shape"):
        sc.encode(x, off, delta_bits, eps_bits[:-1], c)
    with pytest.raises(ValueError, match="chunks"):
        sc.encode(x[:100].contiguous(), off, delta_bits, eps_bits, c)
    with pytest.raises(ValueError, match="contiguous"):
        sc.estimate_all(torch.zeros(c, sk.r).t(), off, delta_bits, eps_bits,
                        d)
    with pytest.raises(ValueError, match="device"):
        sc.encode(x.to("meta"), off, delta_bits, eps_bits, c)
    with pytest.raises(ValueError, match="rows"):
        big = CSVec(d=100, c=10, r=17)
        e_bits, dl_bits = big.sign_bits("cpu")
        sc.estimate_all(torch.zeros(17, 10), big.tables("cpu")[0], dl_bits,
                        e_bits, 100)
    with pytest.raises(TypeError, match="Tensor"):
        sc.encode(np.zeros(d, np.float32), off, delta_bits, eps_bits, c)
    table = torch.zeros(sk.r, c)
    with pytest.raises(ValueError, match="stride"):
        sc.threshold_sample(table, off, delta_bits, eps_bits, d, c, 2)
    with pytest.raises(ValueError, match="one-element"):
        sc.threshold_mask(table, off, delta_bits, eps_bits, torch.zeros(2), d)
    with pytest.raises(ValueError, match="float32"):
        sc.threshold_mask(table, off, delta_bits, eps_bits,
                          torch.tensor(0.5).double(), d)


def test_threshold_sample_plain_is_k2_at_the_sampled_positions():
    # K3a's plain version gathers K2's estimate at chunk positions
    # 0, stride, ... (the tail at or past d zeroed): exact
    for geom in GEOMETRIES:
        sk, x, off, eps, delta = _operands(geom, seed=2)
        eps_bits, delta_bits = sk.sign_bits("cpu")
        t = sk.encode(x)
        est = sc.estimate_all(t, off, delta_bits, eps_bits, sk.d)
        for stride in (1, 3, sk.c):
            ns = sk.c // stride
            got = sc.threshold_sample(t, off, delta_bits, eps_bits, sk.d,
                                      stride, ns)
            assert torch.equal(got, est[:, :ns * stride:stride])


@pytest.mark.parametrize("geom", GEOMETRIES + THRESHOLD_GEOMETRIES,
                         ids=["tail-odd", "exact-even", "single-chunk",
                              "tail-even", "heavy-hitters", "dispatch",
                              "stride-clamped"])
def test_threshold_wrappers_read_sign_bits_on_cpu(geom):
    # K3a and K3b take eps and delta as the packed bits K1 takes; a CPU
    # tensor unpacks them for the float-table plain versions: exact
    sk, x, off, eps, delta = _operands(geom, seed=7)
    eps_bits, delta_bits = sk.sign_bits("cpu")
    t = sk.encode(x)
    stride, ns = sc.threshold_sample_geometry(sk.n_chunks, sk.c)
    sc.reset_launches()
    smp = sc.threshold_sample(t, off, delta_bits, eps_bits, sk.d, stride, ns)
    assert torch.equal(smp, sc.threshold_sample_plain(t, off, delta, eps,
                                                      sk.d, stride, ns))

    def plain(thr):
        return sc.threshold_mask_plain(t, off, delta, eps, thr, sk.d)
    for thr in _k3_thresholds(sk, smp, plain).values():
        got = sc.threshold_mask(t, off, delta_bits, eps_bits, thr, sk.d)
        assert torch.equal(got, plain(thr))
    assert sc.LAUNCHES == {name: 0 for name in sc.LAUNCHES}


def test_threshold_wrappers_check_the_sign_bits():
    sk, x, off, eps, delta = _operands(GEOMETRIES[0], seed=8)
    eps_bits, delta_bits = sk.sign_bits("cpu")
    t = sk.encode(x)
    stride, ns = sc.threshold_sample_geometry(sk.n_chunks, sk.c)
    thr = torch.tensor([0.5])
    with pytest.raises(ValueError, match="eps_bits"):
        sc.threshold_sample(t, off, delta_bits, eps_bits[:-1], sk.d, stride,
                            ns)
    with pytest.raises(ValueError, match="delta_bits"):
        sc.threshold_mask(t, off, delta_bits[:0], eps_bits, thr, sk.d)
    with pytest.raises(TypeError, match="delta_bits"):
        sc.threshold_mask(t, off, delta_bits.long(), eps_bits, thr, sk.d)
    with pytest.raises(TypeError, match="eps_bits"):
        sc.threshold_sample(t, off, delta_bits, eps_bits.float(), sk.d,
                            stride, ns)
    with pytest.raises(TypeError, match="int32"):   # the tables, not bits
        sc.threshold_mask(t, off, delta, eps, thr, sk.d)
    with pytest.raises(ValueError, match="device"):
        sc.threshold_sample(t, off, delta_bits.to("meta"), eps_bits, sk.d,
                            stride, ns)


@pytest.mark.parametrize("geom", GEOMETRIES + THRESHOLD_GEOMETRIES,
                         ids=["tail-odd", "exact-even", "single-chunk",
                              "tail-even", "heavy-hitters", "dispatch",
                              "stride-clamped"])
def test_estimate_all_reads_sign_bits_on_cpu(geom):
    # K2 takes eps and delta as the packed bits K1 and K3 take; a CPU
    # tensor unpacks them for the float-table plain version: exact, the
    # padded tail zeroed
    sk, x, off, eps, delta = _operands(geom, seed=9)
    eps_bits, delta_bits = sk.sign_bits("cpu")
    t = sk.encode(x)
    sc.reset_launches()
    est = sc.estimate_all(t, off, delta_bits, eps_bits, sk.d)
    assert est.shape == (sk.n_chunks, sk.c)
    assert torch.equal(est, sc.estimate_all_plain(t, off, delta, eps, sk.d))
    assert torch.equal(sk.estimate_all(t), est)
    assert not est.reshape(-1)[sk.d:].any()
    assert sc.LAUNCHES == {name: 0 for name in sc.LAUNCHES}
    assert sk.sign_packs == 1


def test_estimate_all_checks_the_sign_bits():
    sk, x, off, eps, delta = _operands(GEOMETRIES[0], seed=10)
    eps_bits, delta_bits = sk.sign_bits("cpu")
    t = sk.encode(x)
    with pytest.raises(TypeError, match="int32"):   # the tables, not bits
        sc.estimate_all(t, off, delta, eps, sk.d)
    with pytest.raises(ValueError, match="eps_bits"):
        sc.estimate_all(t, off, delta_bits, eps_bits[:-1], sk.d)
    with pytest.raises(ValueError, match="delta_bits"):
        sc.estimate_all(t, off, delta_bits[:0], eps_bits, sk.d)
    with pytest.raises(TypeError, match="delta_bits"):
        sc.estimate_all(t, off, delta_bits.long(), eps_bits, sk.d)
    with pytest.raises(TypeError, match="eps_bits"):
        sc.estimate_all(t, off, delta_bits, eps_bits.float(), sk.d)
    with pytest.raises(ValueError, match="device"):
        sc.estimate_all(t, off, delta_bits, eps_bits.to("meta"), sk.d)


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
    t = sk.encode(x)
    assert torch.equal(t, sc.encode_plain(x, off, delta, eps, sk.c))
    eps_bits, delta_bits = sk.sign_bits(cuda_device)
    e = sc.estimate_all(t, off, delta_bits, eps_bits, sk.d)
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
    eps_bits, delta_bits = sk.sign_bits(cuda_device)
    t = sk.encode(x)
    assert torch.equal(t, sc.encode_plain(x, off, delta, eps, sk.c))
    stride, ns = sc.threshold_sample_geometry(sk.n_chunks, sk.c)
    if geom["c"] == 256:
        stride, ns = sk.c, 1        # the stride clamped to c
    before = dict(sc.LAUNCHES)
    smp = sc.threshold_sample(t, off, delta_bits, eps_bits, sk.d, stride, ns)
    assert torch.equal(smp, sc.threshold_sample_plain(t, off, delta, eps,
                                                      sk.d, stride, ns))
    thr = (smp.reshape(-1) ** 2).median().reshape(1)
    m = sc.threshold_mask(t, off, delta_bits, eps_bits, thr, sk.d)
    assert torch.equal(m, sc.threshold_mask_plain(t, off, delta, eps, thr,
                                                  sk.d))
    torch.cuda.synchronize()
    for name in ("threshold_sample", "threshold_mask"):
        assert sc.LAUNCHES[name] == before[name] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("BH,L", [(192, 299), (192, 294), (4, 256),
                                  (4, 300), (4, 1024)])
def test_flash_kernel_matches_plain_on_the_card(cuda_device, BH, L):
    # 3xTF32 tensor-core products in 64-key tiles vs the plain 128-key
    # f32 fold: 1e-5 of the output's scale
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


def _bit(words: torch.Tensor, i: int) -> int:
    return (int(words[i // 32]) >> (i % 32)) & 1


@pytest.mark.parametrize("geom", GEOMETRIES, ids=["tail-odd", "exact-even",
                                                  "single-chunk",
                                                  "tail-even"])
def test_sign_bits_pack_eps_and_delta_flat(geom):
    # K1 reads the signs as bits: bit j * c + s iff eps[j, s] < 0, bit
    # j * B + b iff delta[j, b] < 0, 32 to an int32 word
    sk = CSVec(**geom)
    _, eps, delta = sk.tables("cpu")
    eps_bits, delta_bits = sk.sign_bits("cpu")
    r, c, B = sk.r, sk.c, sk.n_chunks
    assert eps_bits.dtype == delta_bits.dtype == torch.int32
    assert eps_bits.shape == (-(-r * c // 32),)
    assert delta_bits.shape == (-(-r * B // 32),)
    for j in range(r):
        for s in range(c):
            assert _bit(eps_bits, j * c + s) == int(eps[j, s] < 0)
        for b in range(B):
            assert _bit(delta_bits, j * B + b) == int(delta[j, b] < 0)
    # the padding bits of the last word are clear
    assert all(_bit(eps_bits, i) == 0
               for i in range(r * c, 32 * eps_bits.numel()))


def test_sign_bits_refuse_values_other_than_plus_minus_one():
    for bad in (0.5, 0.0, -0.0, float("nan"), 2.0):
        t = torch.ones(3, 40)
        t[1, 7] = bad
        with pytest.raises(ValueError, match="exactly"):
            sc.pack_sign_bits(t)
    assert torch.equal(sc.pack_sign_bits(-torch.ones(33)),
                       torch.tensor([-1, 1], dtype=torch.int32))


def test_sign_bits_are_packed_once_per_sketch_and_device():
    sk, x, off, eps, delta = _operands(GEOMETRIES[0])
    assert sk.sign_packs == 0
    first = sk.sign_bits("cpu")
    for _ in range(3):
        sk.encode(x)
    assert sk.sign_packs == 1
    assert sk.sign_bits("cpu")[0] is first[0]


def test_encode_takes_sign_bits_and_checks_them():
    sk, x, off, eps, delta = _operands(GEOMETRIES[0], seed=4)
    x[::7] = 0.0
    x[1::11] = -0.0
    eps_bits, delta_bits = sk.sign_bits("cpu")
    t = sc.encode(x, off, delta_bits, eps_bits, sk.c)
    p = sc.encode_plain(x, off, delta, eps, sk.c)
    assert torch.equal(t, p) and torch.equal(torch.signbit(t),
                                             torch.signbit(p))
    assert torch.equal(sk.encode(x), p)
    # the CPU route reads the bits: they unpack to the tables
    assert torch.equal(sc.unpack_sign_bits(eps_bits, (sk.r, sk.c)), eps)
    assert torch.equal(sc.unpack_sign_bits(delta_bits, (sk.r, sk.n_chunks)),
                       delta)
    with pytest.raises(ValueError, match="eps_bits"):
        sc.encode(x, off, delta_bits, eps_bits[:-1], sk.c)
    with pytest.raises(TypeError, match="delta_bits"):
        sc.encode(x, off, delta_bits.long(), eps_bits, sk.c)
    with pytest.raises(TypeError, match="int32"):   # the tables, not bits
        sc.encode(x, off, delta, eps, sk.c)


# K1 geometries on the card: the existing ones, r = 16 (the largest the
# kernel is instantiated for) and both main paths
K1_CARD_GEOMETRIES = GEOMETRIES + [dict(d=5000, c=300, r=16), MAIN_PATH,
                                   GPT2_PATH]


@pytest.mark.gpu
@pytest.mark.parametrize("geom", K1_CARD_GEOMETRIES,
                         ids=["tail-odd", "exact-even", "single-chunk",
                              "tail-even", "sixteen-rows", "main-path",
                              "gpt2-path"])
def test_encode_kernel_is_exact_on_the_card(cuda_device, geom):
    # one thread a position for all rows, chunks ascending, signs by
    # XOR: bitwise the plain version, signed zeros and subnormals too
    sk, x, off, eps, delta = _operands(geom, cuda_device, seed=6)
    x[::7] = 0.0
    x[1::11] = -0.0
    x[2::13] = 1e-40
    before = sc.LAUNCHES["sketch_encode"]
    t = sk.encode(x)
    p = sc.encode_plain(x, off, delta, eps, sk.c)
    torch.cuda.synchronize()
    assert sc.LAUNCHES["sketch_encode"] == before + 1
    assert torch.equal(t, p)
    assert torch.equal(torch.signbit(t), torch.signbit(p))


@pytest.mark.gpu
def test_encode_kernel_needs_the_sign_bits_built_once(cuda_device):
    sk, x, off, eps, delta = _operands(GEOMETRIES[0], cuda_device)
    with pytest.raises(TypeError, match="int32"):   # the tables, not bits
        sc.encode(x, off, delta, eps, sk.c)
    for _ in range(3):
        sk.encode(x)
    torch.cuda.synchronize()
    assert sk.sign_packs == 1
    sk.sign_bits("cpu")
    assert sk.sign_packs == 2      # one packing per device


def _head_views(x, H):
    B, L, E3 = x.shape
    dh = E3 // (3 * H)
    return tuple(t.reshape(B, L, H, dh).transpose(1, 2)
                 for t in x.split(H * dh, dim=-1))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["head-views", "contiguous"])
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("L", [65, 299])
def test_flash_kernel_on_strided_head_views(cuda_device, layout, dh, L):
    # 3xTF32 tensor-core products vs the plain f32 fold: 1e-5 of the
    # output's scale; L = 65 leaves a last query tile of one row
    g = torch.Generator().manual_seed(L + dh)
    x = torch.randn(2, L, 3 * 3 * dh, generator=g).to(cuda_device)
    q, k, v = _head_views(x, 3)
    if layout == "contiguous":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    before = ac.LAUNCHES["flash_fwd"]
    o, lse = ac.flash_fwd(q, k, v, dh ** -0.5)
    po, plse = ac.flash_fwd_plain(q, k, v, dh ** -0.5)
    torch.cuda.synchronize()
    assert ac.LAUNCHES["flash_fwd"] == before + 1
    assert o.shape == (2, 3, L, dh) and lse.shape == (2, 3, L)
    # o is the view of a head-merged buffer: the head merge is free
    assert o.transpose(1, 2).is_contiguous()
    assert float((o - po).abs().max()) <= 1e-5 * float(po.abs().max())
    assert float((lse - plse).abs().max()) <= 1e-5 * float(plse.abs().max())


def _bf16_within_half_ulp(o, po32, scale_floor=1e-5):
    """o (bf16) within half a bf16 ulp of the plain version's f32 output
    before its cast, plus scale_floor of max|o|: the kernel's f32
    accumulators sit ~1e-6 from the plain ones, then both round."""
    ulp = torch.where(po32 == 0, torch.zeros_like(po32),
                      torch.ldexp(torch.ones_like(po32),
                                  torch.frexp(po32).exponent - 8))
    bound = 0.5 * ulp + scale_floor * float(po32.abs().max())
    return bool(((o.float() - po32).abs() <= bound).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("L", [65, 299, 1024])
def test_flash_kernel_on_bf16_head_views(cuda_device, dh, L):
    # the bf16 instantiation on bf16 head views of a fused QKV: o (bf16)
    # within half a bf16 ulp of the plain version's f32 output, lse (f32)
    # within 1e-5 relative; counted apart from the f32 instantiation
    g = torch.Generator().manual_seed(L + dh)
    x = torch.randn(2, L, 3 * 3 * dh, generator=g).to(cuda_device)
    q, k, v = _head_views(x.bfloat16(), 3)
    before = dict(ac.LAUNCHES)
    o, lse = ac.flash_fwd(q, k, v, dh ** -0.5)
    po32, plse = ac.flash_fwd_plain(q.float(), k.float(), v.float(),
                                    dh ** -0.5)
    torch.cuda.synchronize()
    assert ac.LAUNCHES["flash_fwd_bf16"] == before["flash_fwd_bf16"] + 1
    assert ac.LAUNCHES["flash_fwd"] == before["flash_fwd"]
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert o.transpose(1, 2).is_contiguous()
    assert _bf16_within_half_ulp(o, po32)
    assert float((lse - plse).abs().max()) <= 1e-5 * float(plse.abs().max())
    # the plain bf16 version is that f32 output rounded
    po, _ = ac.flash_fwd_plain(q, k, v, dh ** -0.5)
    assert torch.equal(po, po32.bfloat16())


@pytest.mark.gpu
def test_flash_kernel_refuses_mixed_and_other_dtypes(cuda_device):
    q = torch.randn(1, 2, 64, 16, device=cuda_device)
    with pytest.raises(TypeError):
        ac.flash_fwd(q.bfloat16(), q, q, 0.25)
    with pytest.raises(TypeError):
        ac.flash_fwd(q.half(), q.half(), q.half(), 0.25)
    with pytest.raises(TypeError):
        ac.flash_fwd(q.double(), q.double(), q.double(), 0.25)


@pytest.mark.gpu
def test_flash_kernel_refuses_unaligned_rows(cuda_device):
    x = torch.randn(1, 70, 3 * 2 * 16 + 1, device=cuda_device)
    q, k, v = (t.reshape(1, 70, 2, 16).transpose(1, 2)
               for t in x[..., :96].split(32, dim=-1))
    with pytest.raises(ValueError, match="16-byte"):
        ac.flash_fwd(q, k, v, 0.25)


def _k3_card_check(sk, t, off, eps, delta, cuda_device, sampling=None):
    """K2, K3a and K3b on the card against their plain versions, exact,
    K3b at the three thresholds of `_k3_thresholds`; each launched once a
    call, all from the one packing of the sketch's sign bits."""
    eps_bits, delta_bits = sk.sign_bits(cuda_device)
    stride, ns = sampling or sc.threshold_sample_geometry(sk.n_chunks, sk.c)
    before = dict(sc.LAUNCHES)
    est = sc.estimate_all(t, off, delta_bits, eps_bits, sk.d)
    assert _exact(est, sc.estimate_all_plain(t, off, delta, eps, sk.d))
    smp = sc.threshold_sample(t, off, delta_bits, eps_bits, sk.d, stride, ns)
    plain_smp = sc.threshold_sample_plain(t, off, delta, eps, sk.d, stride,
                                          ns)
    assert _exact(smp, plain_smp)

    def plain(thr):
        return sc.threshold_mask_plain(t, off, delta, eps, thr, sk.d)
    thresholds = _k3_thresholds(sk, plain_smp.nan_to_num(0.0), plain)
    for name, thr in thresholds.items():
        got = sc.threshold_mask(t, off, delta_bits, eps_bits, thr, sk.d)
        assert _exact(got, plain(thr)), name
    torch.cuda.synchronize()
    assert (sc.LAUNCHES["sketch_estimate_all"]
            == before["sketch_estimate_all"] + 1)
    assert sc.LAUNCHES["threshold_sample"] == before["threshold_sample"] + 1
    assert (sc.LAUNCHES["threshold_mask"]
            == before["threshold_mask"] + len(thresholds))
    assert sk.sign_packs == 1


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 8, 16])
def test_threshold_kernels_are_exact_at_every_row_count(cuda_device, r):
    # odd and even r, up to the largest instantiated; d = 5000 leaves a
    # ragged last chunk of c = 300
    sk, x, off, eps, delta = _operands(dict(d=5000, c=300, r=r), cuda_device,
                                       seed=r)
    _k3_card_check(sk, sk.encode(x), off, eps, delta, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [4, 5])
def test_threshold_kernels_with_infinite_cells_and_an_equal_row(cuda_device,
                                                                r):
    # +-inf cells (an even-r median of -inf and +inf is NaN in both
    # versions) and a row of one value, whose estimates tie everywhere
    sk, x, off, eps, delta = _operands(dict(d=5000, c=300, r=r), cuda_device,
                                       seed=10 + r)
    t = sk.encode(x)
    t[0, ::17] = float("inf")
    t[r - 1, 5::23] = float("-inf")
    t[1] = 0.75
    _k3_card_check(sk, t, off, eps, delta, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("geom", [dict(d=5000, c=301, r=5),
                                  dict(d=1999, c=250, r=4)],
                         ids=["c301-odd", "c250-even"])
def test_kernels_are_exact_where_c_is_not_a_multiple_of_four(cuda_device,
                                                             geom):
    # every term of K1 and K3b takes the element-by-element path here,
    # and the last chunk is ragged
    sk, x, off, eps, delta = _operands(geom, cuda_device, seed=12)
    x[::7] = 0.0
    x[1::11] = -0.0
    t = sk.encode(x)
    assert torch.equal(t, sc.encode_plain(x, off, delta, eps, sk.c))
    _k3_card_check(sk, t, off, eps, delta, cuda_device)


@pytest.mark.gpu
def test_threshold_decode_at_the_gpt2_path_threshold(cuda_device):
    # decode_topk_dense at config #5's geometry and k: K3a, the threshold
    # priced on the device, K3b; exact against the plain pipeline
    sk, x, off, eps, delta = _operands(GPT2_PATH, cuda_device, seed=13)
    t = sk.encode(x)
    before = dict(sc.LAUNCHES)
    got = sk.decode_topk_dense(t, 50_000)
    stride, ns = sc.threshold_sample_geometry(sk.n_chunks, sk.c)
    smp = sc.threshold_sample_plain(t, off, delta, eps, sk.d, stride, ns)
    thr = threshold_from_sq_sample((smp * smp).reshape(-1), 50_000,
                                   sk.n_chunks * sk.c)
    want = sc.threshold_mask_plain(t, off, delta, eps, thr, sk.d)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert 40_000 <= int((got != 0).sum()) <= 60_000
    for name in ("threshold_sample", "threshold_mask"):
        assert sc.LAUNCHES[name] == before[name] + 1
    assert sk.sign_packs == 1


@pytest.mark.gpu
@pytest.mark.parametrize("geom", [dict(d=30007, c=13, r=5),
                                  dict(d=1000, c=200, r=6), MEDIUM_PATH],
                         ids=["ragged-c13", "tail-even", "gpt2-medium"])
def test_window_kernel_matches_plain_on_the_card(cuda_device, geom):
    # K2 on a window of chunks: the first, a middle one and the ragged
    # last chunk, each exact against the plain version's rows
    sk = CSVec(**geom)
    off, eps, delta = sk.tables(cuda_device)
    eps_bits, delta_bits = sk.sign_bits(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    t = torch.randn(sk.table_shape, generator=gen, device=cuda_device)
    B = sk.n_chunks
    step = min(134, B)
    before = sc.LAUNCHES["sketch_estimate_window"]
    windows = ((0, step), (B // 2, min(step, B - B // 2)), (B - 1, 1))
    for b0, nb in windows:
        got = sc.estimate_window(t, off, delta_bits, eps_bits, sk.d, b0, nb)
        assert got.shape == (nb, sk.c)
        assert _exact(got, sc.estimate_all_plain(t, off, delta, eps, sk.d,
                                                 b0, nb)), (b0, nb)
    torch.cuda.synchronize()
    assert sc.LAUNCHES["sketch_estimate_window"] == before + len(windows)


@pytest.mark.gpu
def test_blockwise_decode_is_bitwise_its_plain_version_on_the_card(
        cuda_device):
    # the whole blockwise decode, windows by K2 against windows by the
    # plain version on the same table: (idx, vals) equal in order
    from commefficient_tpu_torch.ops import sketch as tsketch
    sk = CSVec(d=30007, c=13, r=5)
    off, eps, delta = sk.tables(cuda_device)
    x = torch.zeros(sk.d, device=cuda_device)
    x[::7] = torch.arange(0, sk.d, 7, device=cuda_device) % 5 - 2.0
    t = sk.encode(x)
    got = sk.decode_topk_sparse(t, 500)
    want = tsketch.blockwise_topk(
        lambda b0, nb: sc.estimate_all_plain(t, off, delta, eps, sk.d, b0,
                                             nb),
        sk.n_chunks, sk.c, sk.d, 500)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
