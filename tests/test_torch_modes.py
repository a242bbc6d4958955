"""The remaining modes (true_topk, local_topk, fedavg) of the port against
the JAX package: the server steps, local_topk's residual, the
per-client top-k on both of its routes and fedavg's local SGD, on the
same numpy inputs made from a seed. JAX runs on the CPU, the port on
the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.compress import get_compressor as j_get_compressor
from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.federated import client as jclient
from commefficient_tpu.federated import server as jserver
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9
from commefficient_tpu.ops.flat import masked_topk as j_masked_topk
from commefficient_tpu.training.cv_train import (
    make_compute_loss as j_make_compute_loss,
)
from commefficient_tpu_torch.compress import get_compressor
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.federated import client as tclient
from commefficient_tpu_torch.federated import server as tserver
from commefficient_tpu_torch.models import build_model
from commefficient_tpu_torch.models.convert import from_jax_params
from commefficient_tpu_torch.ops.flat import (
    TOPK_THRESHOLD_MIN_D, flatten_params, masked_topk,
)
from commefficient_tpu_torch.training.cv_train import (
    make_compute_loss as t_make_compute_loss,
)

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TINY = {"prep": 4, "layer1": 8, "layer2": 8, "layer3": 16}


def _vectors(d, n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(d).astype(np.float32) for _ in range(n)]


SERVER_CASES = {
    "true_topk": dict(mode="true_topk", error_type="virtual",
                      local_momentum=0.0),
    "true_topk_local_momentum": dict(mode="true_topk",
                                     error_type="virtual",
                                     local_momentum=0.9),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9),
    "fedavg": dict(mode="fedavg", error_type="none", local_momentum=0.0,
                   local_batch_size=-1),
}


@pytest.mark.parametrize("case", sorted(SERVER_CASES))
def test_server_steps_match_jax(case):
    # the same arithmetic on the same inputs, the same top-k picks:
    # updates and state within rtol 1e-6, the velocity mask equal
    kw = dict(virtual_momentum=0.9, k=50, grad_size=2000,
              **SERVER_CASES[case])
    jcfg, tcfg = JConfig(**kw), TConfig(**kw, device="cpu")
    g, v, e = _vectors(2000, 3, seed=11)
    ju = j_get_compressor(kw["mode"]).decode(
        jcfg, jnp.asarray(g), jnp.asarray(v), jnp.asarray(e), 0.1)
    tu = get_compressor(kw["mode"]).decode(
        tcfg, torch.from_numpy(g), torch.from_numpy(v),
        torch.from_numpy(e), 0.1)
    for name in ("update", "Vvelocity", "Verror"):
        np.testing.assert_allclose(getattr(tu, name).numpy(),
                                   np.asarray(getattr(ju, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
    if ju.velocity_mask is None:
        assert tu.velocity_mask is None
    else:
        np.testing.assert_array_equal(tu.velocity_mask.numpy(),
                                      np.asarray(ju.velocity_mask))
    if kw["mode"] == "true_topk":
        assert np.count_nonzero(tu.update.numpy()) == 50
        # error feedback: the sent coordinates left the virtual error
        sent = tu.update.numpy() != 0
        assert not tu.Verror.numpy()[sent].any()


def test_fedavg_server_step_ignores_lr():
    cfg = TConfig(mode="fedavg", error_type="none", local_momentum=0.0,
                  local_batch_size=-1, virtual_momentum=0.0, grad_size=10,
                  device="cpu")
    g = torch.randn(10)
    for lr in (0.1, 7.0):
        upd = tserver._fedavg(g, torch.zeros(10), torch.zeros(10), cfg, lr)
        assert torch.equal(upd.update, g)


@pytest.mark.parametrize("local_momentum", [0.0, 0.9])
def test_local_topk_residual_matches_jax_on_rows(local_momentum):
    # 2-D rows, each with exact zeros (sent coordinates of an earlier
    # round) and an exact tie at the k-th place: the same selection as
    # JAX's exact route (approx_max_k, exact on the CPU), hence equal
    # results
    kw = dict(mode="local_topk", error_type="local",
              local_momentum=local_momentum, k=40, grad_size=600)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw, device="cpu")
    rng = np.random.RandomState(3)
    x = rng.randn(3, 600).astype(np.float32)
    x[:, rng.rand(600) < 0.5] = 0.0
    x[:, 100:110] = 2.0             # ten equal magnitudes ...
    x[:, 200:205] = -2.0            # ... and five more of the other sign
    x[:, 300:340] = 5.0             # 40 above them: the tie is at k
    x[1, 300:340] = 0.0             # row 1: the tie straddles the k-th
    err, vel = rng.randn(3, 600).astype(np.float32), \
        rng.randn(3, 600).astype(np.float32)
    jt, je, jv = j_get_compressor("local_topk").residual(
        jcfg, jnp.asarray(x), jnp.asarray(err), jnp.asarray(vel))
    tt, te, tv = get_compressor("local_topk").residual(
        tcfg, torch.from_numpy(x), torch.from_numpy(err),
        torch.from_numpy(vel))
    for got, want in ((tt, jt), (te, je), (tv, jv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.count_nonzero(tt.numpy(), axis=1) == 40).all()


def test_masked_topk_threshold_route_selects_jax_support():
    # d above TOPK_THRESHOLD_MIN_D: a strided ~1M sample prices the k-th
    # square, then every coordinate at or above it is kept. The sample's
    # top-ks is exact in both packages, so the selected supports are
    # equal and the values are the input's.
    d = 4_500_000
    assert d > TOPK_THRESHOLD_MIN_D
    rng = np.random.RandomState(5)
    v = rng.randn(d).astype(np.float32)
    v[rng.rand(d) < 0.3] = 0.0
    want = np.asarray(j_masked_topk(jnp.asarray(v), k=50_000))
    got = masked_topk(torch.from_numpy(v), k=50_000).numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_array_equal(got, want)
    assert abs(np.count_nonzero(got) - 50_000) < 0.05 * 50_000


def test_fedavg_step_matches_jax():
    # a tiny ResNet9, 5 examples cut into batches of 2 (the third padded
    # by one) and the client's mask zero on its last three: batch 3 is
    # all padding, yet takes its weight-decay step and counts its zero
    # loss in the mean. Two epochs, lr decay 0.9 a step. The delta (6
    # local steps of float32 convolutions reduced in another order) is
    # within 1e-5 of its scale; loss, metrics and count to 1e-5
    # relative.
    kw = dict(mode="fedavg", error_type="none", local_momentum=0.0,
              local_batch_size=-1, fedavg_batch_size=2,
              num_fedavg_epochs=2, fedavg_lr_decay=0.9, num_workers=2)
    jm = JResNet9(num_classes=10, channels=TINY)
    params = jm.init(jax.random.PRNGKey(2),
                     jnp.zeros((2, 32, 32, 3), jnp.float32))
    jvec, unravel = ravel_pytree(params)
    jcfg = JConfig(**kw, grad_size=int(jvec.shape[0]))
    tm = build_model("ResNet9", channels=TINY)
    vec = from_jax_params(tm, params)
    tcfg = TConfig(**kw, grad_size=int(vec.shape[0]), device="cpu")
    rng = np.random.RandomState(4)
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=8).astype(np.int32)
    x, y = x[:5], y[:5]
    mask = np.array([1, 1, 1, 1, 0], np.float32)
    x[4] = 0.0

    jloss = j_make_compute_loss(jm)

    def j_flat_grad(w, b, m):
        (loss, mets), g = jax.value_and_grad(
            lambda v: jloss(unravel(v), b, m), has_aux=True)(w)
        return loss, mets, g

    jres = jclient.fedavg_step(j_flat_grad, jvec,
                               (jnp.asarray(x), jnp.asarray(y)),
                               jnp.asarray(mask), jcfg, 0.1)
    _, t_unravel = flatten_params(tm)
    t_flat_grad = tclient.make_flat_grad_fn(t_make_compute_loss(tm),
                                            t_unravel)
    tres = tclient.fedavg_step(t_flat_grad, vec,
                               (torch.from_numpy(x), torch.from_numpy(y)),
                               torch.from_numpy(mask), tcfg, 0.1)
    jd = np.asarray(jres.transmit)
    assert np.abs(jd).max() > 0
    np.testing.assert_allclose(tres.transmit.numpy(), jd, rtol=0,
                               atol=1e-5 * np.abs(jd).max())
    np.testing.assert_allclose(float(tres.loss), float(jres.loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tres.metrics[0]),
                               float(jres.metrics[0]), rtol=1e-5)
    assert float(tres.num_examples) == float(jres.num_examples) == 4.0


def test_fedavg_step_runs_every_step():
    # 3 batches x 2 epochs = 6 losses averaged, the all-padding batches'
    # zero losses among them: the reported loss is 4/6 of the mean over
    # the non-empty steps when their losses are all equal
    cfg = TConfig(mode="fedavg", error_type="none", local_momentum=0.0,
                  local_batch_size=-1, fedavg_batch_size=2,
                  num_fedavg_epochs=2, weight_decay=0.0, grad_size=3,
                  device="cpu")
    seen = []

    def flat_grad(w, b, m):
        seen.append(float(m.sum()))
        loss = torch.tensor(1.0) if float(m.sum()) > 0 else torch.tensor(0.)
        return loss, (loss,), torch.zeros_like(w)

    x = torch.zeros(6, 1)
    mask = torch.tensor([1., 1., 1., 1., 0., 0.])
    res = tclient.fedavg_step(flat_grad, torch.ones(3), (x,), mask, cfg,
                              0.1)
    assert seen == [2.0, 2.0, 0.0, 2.0, 2.0, 0.0]
    assert float(res.loss) == pytest.approx(4 / 6)
    assert torch.equal(res.transmit, torch.zeros(3))
