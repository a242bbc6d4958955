"""ResNet9 parity: the port's model (commefficient_tpu_torch/models)
against the flax ResNet9 on the same weights and inputs, through the
weight bridge (models/convert.py). The port's flat vector must be the
JAX flat vector: the same ravel_pytree order and leaf shapes."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9
from commefficient_tpu.training.cv_train import (
    make_compute_loss as j_make_compute_loss,
)
from commefficient_tpu_torch.federated.client import make_flat_grad_fn
from commefficient_tpu_torch.models import build_model
from commefficient_tpu_torch.models.convert import (
    from_jax_params, ravel_jax_params, to_jax_params,
)
from commefficient_tpu_torch.ops.flat import flatten_params, module_layout
from commefficient_tpu_torch.training.cv_train import (
    make_compute_loss as t_make_compute_loss,
)

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TINY = {"prep": 4, "layer1": 8, "layer2": 8, "layer3": 16}


def _jax_model(channels, bn, seed=0, batch=2):
    m = JResNet9(num_classes=10, channels=channels, do_batchnorm=bn)
    params = m.init(jax.random.PRNGKey(seed),
                    jnp.zeros((batch, 32, 32, 3), jnp.float32))
    return m, params


def _batch(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=n).astype(np.int32)
    mask = np.ones(n, np.float32)
    mask[-1] = 0.0              # one padding row, as the sampler makes
    return x, y, mask


@pytest.mark.parametrize("bn", [False, True])
def test_flat_layout_is_ravel_pytree_order(bn):
    # exact: the bridge only moves bytes
    jm, params = _jax_model(TINY, bn)
    jvec, _ = ravel_pytree(params)
    tm = build_model("ResNet9", channels=TINY, do_batchnorm=bn)
    vec = from_jax_params(tm, params)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jvec))
    port_vec, _ = flatten_params(tm)
    np.testing.assert_array_equal(port_vec.numpy(), np.asarray(jvec))
    # leaf by leaf: the same paths and flat shapes in the same order
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    jpaths = [tuple(k.key for k in path) for path, _ in leaves]
    assert [e.path for e in module_layout(tm)] == jpaths
    assert [e.flat_shape for e in module_layout(tm)] == \
        [tuple(v.shape) for _, v in leaves]


@pytest.mark.parametrize("bn", [False, True])
def test_forward_and_flat_grad_match_tiny(bn):
    # float32 convolutions reduce in another order: logits and loss to
    # 1e-5 relative, the flat gradient to 1e-5 of its largest entry
    jm, params = _jax_model(TINY, bn)
    tm = build_model("ResNet9", channels=TINY, do_batchnorm=bn)
    vec = from_jax_params(tm, params)
    x, y, mask = _batch(6, 1)

    jlogits = np.asarray(jm.apply(params, jnp.asarray(x)))
    tlogits = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-5, atol=1e-6)

    jvec, unravel = ravel_pytree(params)
    jloss_fn = j_make_compute_loss(jm)
    (jl, (jacc,)), jg = jax.value_and_grad(
        lambda v: jloss_fn(unravel(v), (jnp.asarray(x), jnp.asarray(y)),
                           jnp.asarray(mask)), has_aux=True)(jvec)
    _, t_unravel = flatten_params(tm)
    tl, (tacc,), tg = make_flat_grad_fn(t_make_compute_loss(tm), t_unravel)(
        vec, (torch.from_numpy(x), torch.from_numpy(y)),
        torch.from_numpy(mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tacc) == float(jacc)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())


def test_full_width_forward_and_flat_grad_match():
    # the main path's full-width ResNet9 (D = 6,568,640) on a 2-image
    # batch: the same tolerances as the tiny model
    jm, params = _jax_model(None, False, seed=3)
    tm = build_model("ResNet9")
    vec = from_jax_params(tm, params)
    assert vec.shape[0] == 6_568_640
    x, y, _ = _batch(2, 2)
    mask = np.ones(2, np.float32)
    jvec, unravel = ravel_pytree(params)
    jloss_fn = j_make_compute_loss(jm)
    (jl, _), jg = jax.value_and_grad(
        lambda v: jloss_fn(unravel(v), (jnp.asarray(x), jnp.asarray(y)),
                           jnp.asarray(mask)), has_aux=True)(jvec)
    jlogits = np.asarray(jm.apply(params, jnp.asarray(x)))
    tlogits = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-5, atol=1e-6)
    _, t_unravel = flatten_params(tm)
    tl, _, tg = make_flat_grad_fn(t_make_compute_loss(tm), t_unravel)(
        vec, (torch.from_numpy(x), torch.from_numpy(y)),
        torch.from_numpy(mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())


@pytest.mark.parametrize("bn", [False, True])
def test_from_jax_params_round_trips(bn):
    # exact both ways: tree -> module -> tree, and flat -> module -> flat
    _, params = _jax_model(TINY, bn, seed=5)
    tm = build_model("ResNet9", channels=TINY, do_batchnorm=bn)
    from_jax_params(tm, params)
    back = to_jax_params(tm)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        dict(params), back)
    flat = ravel_jax_params(params)
    tm2 = build_model("ResNet9", channels=TINY, do_batchnorm=bn, seed=9)
    from_jax_params(tm2, flat)
    np.testing.assert_array_equal(flatten_params(tm2)[0].numpy(), flat)
    # conv weights land as OIHW, the head transposed
    w = tm2.ConvBlock_0.Conv_0.weight.detach().numpy()
    np.testing.assert_array_equal(
        w, np.asarray(params["params"]["ConvBlock_0"]["Conv_0"]["kernel"])
        .transpose(3, 2, 0, 1))


def test_from_jax_params_rejects_a_foreign_tree():
    _, params = _jax_model(TINY, True)
    tm = build_model("ResNet9", channels=TINY, do_batchnorm=False)
    with pytest.raises(ValueError, match="do not match"):
        from_jax_params(tm, params)


# ---- the ResNet18 family (models/fixup_resnet.py) -----------------------

TINY_WIDTHS = dict(widths=(8, 8, 16, 16))
FAMILY = {
    # name: (model kwargs of the tiny variant, classes)
    "ResNet18": (TINY_WIDTHS, 10),
    "FixupResNet18": (TINY_WIDTHS, 10),
    # FixupResNet9 takes no widths: its tiny case is the full width
    "FixupResNet9": ({}, 10),
}


def _jax_family(name, kw, num_classes, seed=0, noise=0.01):
    """The flax model and its parameters, every leaf moved by `noise`
    x N(0, 1) so the Fixup nets' zero-initialized convs and classifier
    carry gradient through the whole net."""
    from commefficient_tpu.models import fixup_resnet as jfixup
    jm = getattr(jfixup, name)(num_classes=num_classes, **kw)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((2, 32, 32, 3), jnp.float32))
    flat, unravel = ravel_pytree(params)
    rng = np.random.RandomState(seed + 100)
    flat = flat + noise * rng.randn(flat.shape[0]).astype(np.float32)
    return jm, unravel(flat)


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_family_flat_layout_is_ravel_pytree_order(name):
    # exact: the same paths and flat shapes in the same order
    kw, nc = FAMILY[name]
    _, params = _jax_family(name, kw, nc)
    tm = build_model(name, num_classes=nc, **kw)
    jvec, _ = ravel_pytree(params)
    np.testing.assert_array_equal(from_jax_params(tm, params).numpy(),
                                  np.asarray(jvec))
    np.testing.assert_array_equal(flatten_params(tm)[0].numpy(),
                                  np.asarray(jvec))
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert [e.path for e in module_layout(tm)] == \
        [tuple(k.key for k in path) for path, _ in leaves]
    assert [e.flat_shape for e in module_layout(tm)] == \
        [tuple(v.shape) for _, v in leaves]


def _family_grads(name, kw, nc, n, seed):
    """Logits, loss, accuracy and flat gradient of the JAX model and the
    port on one batch of n images (one of them padding when n > 2), and
    the port's float64 gradient as the yardstick of float32 rounding."""
    jm, params = _jax_family(name, kw, nc, seed=seed)
    tm = build_model(name, num_classes=nc, **kw)
    vec = from_jax_params(tm, params)
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, nc, size=n).astype(np.int32)
    mask = np.ones(n, np.float32)
    if n > 2:
        mask[-1] = 0.0
    jvec, unravel = ravel_pytree(params)
    jloss_fn = j_make_compute_loss(jm)
    (jl, (jacc,)), jg = jax.value_and_grad(
        lambda v: jloss_fn(unravel(v), (jnp.asarray(x), jnp.asarray(y)),
                           jnp.asarray(mask)), has_aux=True)(jvec)
    jlogits = np.asarray(jm.apply(params, jnp.asarray(x)))
    # PyTorch's CPU convolutions here take the native route, not oneDNN:
    # this CPU build's multi-threaded oneDNN convolution backward aborts
    # the process ("double free or corruption") on these nets' strided
    # blocks at 4 threads and more
    with torch.backends.mkldnn.flags(enabled=False):
        tlogits = tm(torch.from_numpy(x)).detach().numpy()
        out = {}
        for dtype in (torch.float32, torch.float64):
            tm = tm.to(dtype)
            _, t_unravel = flatten_params(tm)
            out[dtype] = make_flat_grad_fn(
                t_make_compute_loss(tm), t_unravel)(
                vec.to(dtype), (torch.from_numpy(x).to(dtype),
                                torch.from_numpy(y)),
                torch.from_numpy(mask).to(dtype))
    tl, (tacc,), tg = out[torch.float32]
    return ((tlogits, jlogits), (float(tl), float(jl)),
            (float(tacc), float(jacc)), (tg.numpy(), np.asarray(jg)),
            out[torch.float64][2].numpy())


def _check_grads(tg, jg, g64):
    """The port's float32 gradient within 1e-5 of its scale of the JAX
    gradient, and no less accurate than JAX's against the float64 one
    (within 3x JAX's largest error, or 3e-6 of the scale when JAX lands
    closer than that)."""
    scale = np.abs(g64).max()
    assert scale > 0
    j_err = np.abs(jg - g64).max()
    assert np.abs(tg - g64).max() <= 3 * max(j_err, 1e-6 * scale)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * np.abs(jg).max())


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_family_forward_and_flat_grad_match(name):
    # float32 convolutions reduce in another order: logits and loss to
    # 1e-5 relative, the flat gradient to 1e-5 of its largest entry.
    # Batch seed 2: at seed 1 the JAX package's own float32 gradient of
    # the tiny ResNet18 (XLA on the CPU) lies 9.6e-3 of its scale from
    # the float64 one, where the port's lies 5.8e-7, so no port could
    # meet 1e-5 of JAX there.
    kw, nc = FAMILY[name]
    n = 2 if name == "FixupResNet9" else 6
    (tlog, jlog), (tl, jl), (tacc, jacc), (tg, jg), g64 = _family_grads(
        name, kw, nc, n, seed=2)
    np.testing.assert_allclose(tlog, jlog, rtol=1e-5,
                               atol=1e-5 * np.abs(jlog).max())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tacc == jacc
    _check_grads(tg, jg, g64)


def test_resnet18_full_width_cifar100_forward_and_flat_grad_match():
    # config #3's model at its full width (D = 5,252,388) on a 2-image
    # CIFAR100 batch: the same tolerances as the tiny model
    (tlog, jlog), (tl, jl), _, (tg, jg), g64 = _family_grads(
        "ResNet18", {}, 100, 2, seed=2)
    assert tg.shape[0] == 5_252_388
    np.testing.assert_allclose(tlog, jlog, rtol=1e-5,
                               atol=1e-5 * np.abs(jlog).max())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _check_grads(tg, jg, g64)


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_family_from_jax_params_round_trips(name):
    # exact both ways: tree -> module -> tree, flat -> module -> flat
    kw, nc = FAMILY[name]
    _, params = _jax_family(name, kw, nc, seed=5)
    tm = build_model(name, num_classes=nc, **kw)
    from_jax_params(tm, params)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        dict(params), to_jax_params(tm))
    flat = ravel_jax_params(params)
    tm2 = build_model(name, num_classes=nc, seed=9, **kw)
    from_jax_params(tm2, flat)
    np.testing.assert_array_equal(flatten_params(tm2)[0].numpy(), flat)


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_family_seeded_init_follows_the_jax_formulas(name):
    # the numpy-seeded init draws other numbers than JAX's PRNG, from
    # the same formulas: the same exact zeros and ones (Fixup's zero
    # conv2/classifier, BN/Mul scales), and per leaf a spread within 10%
    # of the JAX init's
    kw, nc = FAMILY[name]
    _, params = _jax_family(name, kw, nc, seed=0, noise=0.0)
    tm = build_model(name, num_classes=nc, seed=4, **kw)
    jleaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    tparams = dict(tm.named_parameters())
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
