"""ResNet family parity (models/resnets.py): the port against the flax
nets of commefficient_tpu/models/resnets.py. At full width through
`jax.eval_shape` and torch's meta device (no memory): the same flat
layout and D for every registry name. At a tiny width: the same logits,
loss and flat gradient from the same weights, for each block kind and
each norm, with the ImageNet stem and the small-input stem. Plus the
seeded init, the weight bridge both ways, the registry's filter of the
shared model config and the Fixup learning-rate vector.

PyTorch's CPU convolutions take the native route here, not oneDNN (see
tests/test_torch_model.py: this CPU build's multi-threaded oneDNN
convolution backward aborts on strided blocks)."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.models import build_model as j_build_model
from commefficient_tpu.models import resnets as jresnets
from commefficient_tpu.training.cv_train import (
    _fixup_lr_scales as j_fixup_lr_scales,
    make_compute_loss as j_make_compute_loss,
)
from commefficient_tpu_torch.federated.client import make_flat_grad_fn
from commefficient_tpu_torch.models import build_model, resnets
from commefficient_tpu_torch.models.convert import (
    from_jax_params, ravel_jax_params, to_jax_params,
)
from commefficient_tpu_torch.ops.flat import flatten_params, module_layout
from commefficient_tpu_torch.training import cv_train

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

NEW_NAMES = ["ResNet34", "ResNet50", "ResNet101", "ResNet152",
             "WideResNet50_2", "WideResNet101_2", "ResNet101LN",
             "FixupResNet50"]
# D at 1000 classes and 224 px (FixupResNet50's is
# benchmarks/BENCH_imagenet_tpu.json's grad_size)
FULL_D = {"ResNet50": 25_557_032, "FixupResNet50": 25_504_024}


def _jax_paths_shapes(params):
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    return ([tuple(k.key for k in path) for path, _ in leaves],
            [tuple(v.shape) for _, v in leaves])


def _port_paths_shapes(module):
    layout = module_layout(module)
    return [e.path for e in layout], [e.flat_shape for e in layout]


@pytest.mark.parametrize("name", NEW_NAMES)
def test_full_width_layout_and_d_match_jax(name):
    # exact: the same paths, flat shapes and order (Bottleneck_10 sorts
    # before Bottleneck_2 in both), so the same D
    jm = j_build_model(name, num_classes=1000)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32)))
    with torch.device("meta"):
        tm = build_model(name, num_classes=1000, input_hw=(224, 224))
    jpaths, jshapes = _jax_paths_shapes(shapes)
    tpaths, tshapes = _port_paths_shapes(tm)
    assert tpaths == jpaths
    assert tshapes == jshapes
    d = sum(int(np.prod(s)) for s in jshapes)
    assert sum(e.size for e in module_layout(tm)) == d
    if name in FULL_D:
        assert d == FULL_D[name]
    # over ten blocks of one kind, block 10 sorts before block 2
    owners = [p[0] for p in tpaths]
    kind = owners[0].rsplit("_", 1)[0]
    assert owners.index(f"{kind}_10") < owners.index(f"{kind}_2")


@pytest.mark.parametrize("name", NEW_NAMES)
def test_build_model_passes_num_classes_to_every_factory(name):
    # the factories state their fields, so the registry's filter keeps
    # num_classes (and drops keys no ResNet takes)
    with torch.device("meta"):
        tm = build_model(name, num_classes=1000, channels={"prep": 1},
                         do_batchnorm=True, seed=3)
        assert tm.fc.out_features == 1000
        assert build_model(name, num_classes=7).fc.out_features == 7


def test_layernorm_layout_follows_the_input_size():
    # ResNet101LN's LayerNorm scale/bias are [H, W, C] in flax, sized by
    # the input: the port built for 64 px has JAX's 64-px layout
    jm = j_build_model("ResNet101LN", num_classes=10)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    with torch.device("meta"):
        tm = build_model("ResNet101LN", num_classes=10, input_hw=(64, 64))
    assert _port_paths_shapes(tm) == _jax_paths_shapes(shapes)
    e = next(e for e in module_layout(tm)
             if e.path == ("Bottleneck_0", "bn1", "scale"))
    assert e.flat_shape == (16, 16, 64) and e.to_torch == (2, 0, 1)


# ---- tiny-width parity: every block kind and norm --------------------

# id: (ResNet fields, input size). The ImageNet stem's cases take 64
# px, the small-input ones 16: the last stage keeps 2 x 2 positions, so
# every tap of its 3x3 kernels sees data (and has a gradient)
TINY = {
    "basic-batch-small": (dict(block="basic", norm="batch",
                               small_input=True), 16),
    "basic-none": (dict(block="basic", norm="none"), 64),
    "basic-layer": (dict(block="basic", norm="layer"), 64),
    "basic-group-small": (dict(block="basic", norm="group", width=32,
                               small_input=True), 16),
    "bottleneck-batch": (dict(block="bottleneck", norm="batch"), 64),
    "bottleneck-layer-small": (dict(block="bottleneck", norm="layer",
                                    small_input=True), 16),
    "bottleneck-group": (dict(block="bottleneck", norm="group",
                              width=32), 64),
    "bottleneck-none-small": (dict(block="bottleneck", norm="none",
                                   small_input=True), 16),
    "fixup": (dict(block="fixup_bottleneck"), 64),
    "fixup-small": (dict(block="fixup_bottleneck", small_input=True), 16),
}
STAGES = (2, 1, 1, 1)
NC = 10


@functools.lru_cache(maxsize=None)
def _jax_tiny(case):
    """A case's flax net and its jitted init, compiled once a case for
    every seed."""
    kw, _ = TINY[case]
    jm = jresnets.ResNet(stage_sizes=STAGES, num_classes=NC,
                         **{"width": 4, **kw})
    return jm, jax.jit(jm.init)


def _tiny_pair(case, seed):
    """The flax net and the port's at a tiny width, from the same random
    weights: JAX's init moved by 0.05 x N(0, 1) a leaf, so the Fixup
    net's zero conv3 and head carry gradient too."""
    kw, hw = TINY[case]
    kw = {"width": 4, **kw}
    jm, init = _jax_tiny(case)
    params = init(jax.random.PRNGKey(seed),
                  jnp.zeros((2, hw, hw, 3), jnp.float32))
    flat, unravel = ravel_pytree(params)
    rng = np.random.RandomState(seed + 100)
    params = unravel(flat + 0.05 * rng.randn(flat.shape[0])
                     .astype(np.float32))
    tm = resnets.ResNet(STAGES, num_classes=NC, input_hw=(hw, hw), **kw)
    return jm, params, tm, hw


@pytest.mark.parametrize("case", sorted(TINY))
def test_tiny_forward_and_flat_grad_match_jax(case):
    # float32 convolutions reduce in another order: logits and loss to
    # 1e-5 relative, the flat gradient to 1e-5 of its largest entry, and
    # the port no less accurate than JAX against a float64 port gradient
    jm, params, tm, hw = _tiny_pair(case, seed=2)
    vec = from_jax_params(tm, params)
    rng = np.random.RandomState(2)
    x = rng.randn(4, hw, hw, 3).astype(np.float32)
    y = rng.randint(0, NC, size=4).astype(np.int32)
    mask = np.array([1, 1, 1, 0], np.float32)
    jvec, unravel = ravel_pytree(params)
    jloss_fn = j_make_compute_loss(jm)
    def loss_grad_logits(v):
        # one compile: the loss, its gradient and the logits
        return (jax.value_and_grad(
            lambda u: jloss_fn(unravel(u), (jnp.asarray(x), jnp.asarray(y)),
                               jnp.asarray(mask)), has_aux=True)(v),
            jm.apply(unravel(v), jnp.asarray(x)))

    ((jl, (jacc,)), jg), jlogits = jax.jit(loss_grad_logits)(jvec)
    jlogits = np.asarray(jlogits)
    jg = np.asarray(jg)
    with torch.backends.mkldnn.flags(enabled=False):
        tlogits = tm(torch.from_numpy(x)).detach().numpy()
        out = {}
        for dtype in (torch.float32, torch.float64):
            tm = tm.to(dtype)
            _, t_unravel = flatten_params(tm)
            out[dtype] = make_flat_grad_fn(
                cv_train.make_compute_loss(tm), t_unravel)(
                vec.to(dtype), (torch.from_numpy(x).to(dtype),
                                torch.from_numpy(y)),
                torch.from_numpy(mask).to(dtype))
    tl, (tacc,), tg = out[torch.float32]
    tg, g64 = tg.numpy(), out[torch.float64][2].numpy()
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-5,
                               atol=1e-5 * np.abs(jlogits).max())
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tacc) == float(jacc)
    scale = np.abs(g64).max()
    assert scale > 0 and np.count_nonzero(jg) > 0.5 * jg.size
    assert np.abs(tg - g64).max() <= 3 * max(np.abs(jg - g64).max(),
                                             1e-6 * scale)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * np.abs(jg).max())


@pytest.mark.parametrize("case", ["basic-layer", "bottleneck-group",
                                  "fixup"])
def test_weight_bridge_round_trips(case):
    # exact both ways: tree -> module -> tree (the LayerNorm's [H, W, C]
    # <-> [C, H, W] included), flat -> module -> flat
    _, params, tm, _ = _tiny_pair(case, seed=5)
    from_jax_params(tm, params)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        dict(params), to_jax_params(tm))
    flat = ravel_jax_params(params)
    kw, hw = TINY[case]
    tm2 = resnets.ResNet(STAGES, num_classes=NC, input_hw=(hw, hw), seed=9,
                         **{"width": 4, **kw})
    from_jax_params(tm2, flat)
    np.testing.assert_array_equal(flatten_params(tm2)[0].numpy(), flat)
    if kw.get("norm") == "layer":
        block = "BasicBlock_0" if kw["block"] == "basic" else "Bottleneck_0"
        got = getattr(tm2, block).bn1.scale.detach().numpy()
        want = np.asarray(params["params"][block]["bn1"]["scale"])
        np.testing.assert_array_equal(got, want.transpose(2, 0, 1))


@pytest.mark.parametrize("case", ["bottleneck-batch", "basic-layer",
                                  "fixup"])
def test_seeded_init_follows_the_jax_formulas(case):
    # the numpy-seeded init draws other numbers than JAX's PRNG, from
    # the same formulas: the same exact zeros and ones (Fixup's zero
    # conv3 and head, norm and Mul scales, biases), and per leaf a
    # spread within 10% of the JAX init's
    kw, hw = TINY[case]
    kw = {"width": 16, **kw}
    jm = jresnets.ResNet(stage_sizes=STAGES, num_classes=NC, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((2, hw, hw, 3), jnp.float32))
    tm = resnets.ResNet(STAGES, num_classes=NC, input_hw=(hw, hw), seed=4,
                        **kw)
    jleaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    tparams = dict(tm.named_parameters())
    checked = 0
    for e, (path, jv) in zip(module_layout(tm), jleaves):
        jv = np.asarray(jv)
        tv = tparams[e.name].detach()
        if e.to_flat is not None:
            tv = tv.permute(*e.to_flat)
        tv = tv.numpy()
        np.testing.assert_array_equal(tv == 0, jv == 0, err_msg=str(e.path))
        np.testing.assert_array_equal(tv == 1, jv == 1, err_msg=str(e.path))
        if jv.size >= 1000 and jv.std() > 0:
            assert abs(tv.std() / jv.std() - 1) < 0.1, e.path
            checked += 1
    assert checked >= 5


def test_fixup_resnet50_lr_scales_match_jax():
    # 0.1 on every scalar bias and scale (add1a ... add3b, mul, the
    # head's bias), 1.0 elsewhere, over the full-width flat layout
    jm = j_build_model("FixupResNet50", num_classes=1000)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32)))
    want = j_fixup_lr_scales(shapes)
    with torch.device("meta"):
        tm = build_model("FixupResNet50", num_classes=1000)
    got = cv_train.fixup_lr_scales(tm)
    np.testing.assert_array_equal(got, want)
    assert got.size == FULL_D["FixupResNet50"]
    # 16 blocks x 7 scalars, and the head's 1000 biases
    assert int((got == 0.1).sum()) == 16 * 7 + 1000


def test_unknown_model_is_refused_as_in_jax():
    with pytest.raises(ValueError, match="unknown model"):
        build_model("ResNet77")
    with pytest.raises(ValueError, match="unknown model"):
        j_build_model("ResNet77")
