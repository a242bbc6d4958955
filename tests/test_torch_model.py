"""ResNet9 parity: the port's model (commefficient_tpu_torch/models)
against the flax ResNet9 on the same weights and inputs, through the
weight bridge (models/convert.py). The port's flat vector must be the
JAX flat vector: the same ravel_pytree order and leaf shapes."""
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
