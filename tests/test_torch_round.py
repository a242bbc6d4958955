"""Round parity: the port's server step and FedModel rounds against the
JAX package's, from the same weights and batches (numpy inputs made
from a seed). JAX runs on the CPU test mesh; the port on the CPU with
its kernels' plain versions."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.federated import server as jserver
from commefficient_tpu.federated.api import (
    FedModel as JFedModel, FedOptimizer as JFedOptimizer,
)
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9
from commefficient_tpu.training.cv_train import (
    make_compute_loss as j_make_compute_loss,
)
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.federated import round as tround
from commefficient_tpu_torch.federated import server as tserver
from commefficient_tpu_torch.federated.api import (
    FedModel as TFedModel, FedOptimizer as TFedOptimizer,
)
from commefficient_tpu_torch.federated.accounting import pack_change_bits
from commefficient_tpu_torch.models import build_model
from commefficient_tpu_torch.models.convert import from_jax_params
from commefficient_tpu_torch.ops.sketch import CSVec
from commefficient_tpu_torch.training.cv_train import (
    make_compute_loss as t_make_compute_loss,
)

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TINY = {"prep": 4, "layer1": 8, "layer2": 8, "layer3": 16}


@pytest.mark.parametrize("error_type", ["virtual", "none"])
def test_sketched_server_step_matches_jax(error_type):
    # identical inputs, the same estimate, top-k and scatter-add order:
    # exact equality
    kw = dict(mode="sketch", error_type=error_type, local_momentum=0.0,
              virtual_momentum=0.9, k=60, num_rows=5, num_cols=200,
              grad_size=1000)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw, device="cpu")
    rng = np.random.RandomState(0)
    g, v, e = (rng.randn(5, 200).astype(np.float32) for _ in range(3))
    ju = jserver._sketched(jnp.asarray(g), jnp.asarray(v), jnp.asarray(e),
                           jcfg, 0.1, None)
    tu = tserver._sketched(torch.from_numpy(g), torch.from_numpy(v),
                           torch.from_numpy(e), tcfg, 0.1)
    for name in ("update", "Vvelocity", "Verror"):
        np.testing.assert_array_equal(getattr(tu, name).numpy(),
                                      np.asarray(getattr(ju, name)),
                                      err_msg=name)
    assert np.count_nonzero(tu.update.numpy()) == 60


def test_alive_gate_is_a_no_op_when_dead():
    kw = dict(mode="uncompressed", local_momentum=0.0,
              virtual_momentum=0.9, grad_size=50)
    cfg = TConfig(**kw, device="cpu")
    g, v = torch.randn(50), torch.randn(50)
    upd = tserver.get_server_update(g, v, v, cfg, 0.1,
                                    alive=torch.tensor(False))
    assert torch.equal(upd.update, torch.zeros(50))
    assert torch.equal(upd.Vvelocity, v)


def test_pack_change_bits_matches_jax():
    from commefficient_tpu.federated.accounting import (
        pack_change_bits as j_pack,
    )
    rng = np.random.RandomState(1)
    u = rng.randn(1000).astype(np.float32)
    u[rng.rand(1000) < 0.7] = 0.0
    want = np.asarray(j_pack(jnp.asarray(u)))
    got = pack_change_bits(torch.from_numpy(u)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def _batches(n_rounds, W, B, num_clients, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_rounds):
        ids = rng.choice(num_clients, W, replace=False).astype(np.int32)
        x = rng.randn(W, B, 32, 32, 3).astype(np.float32)
        y = rng.randint(0, 10, size=(W, B)).astype(np.int32)
        mask = np.ones((W, B), np.float32)
        mask[0, -2:] = 0.0       # a short client, as the sampler makes
        out.append((ids, (x, y), mask))
    return out


CASES = {
    # the main path's mode on a tiny model: fused backward, deferred
    # encode, table-space server step
    "sketch": dict(mode="sketch", error_type="virtual",
                   virtual_momentum=0.9, k=300, num_rows=5, num_cols=700),
    # per-client backward path (microbatching gates the fused one off)
    "sketch_microbatch": dict(mode="sketch", error_type="virtual",
                              virtual_momentum=0.9, k=300, num_rows=5,
                              num_cols=700, microbatch_size=3),
    "uncompressed": dict(mode="uncompressed", virtual_momentum=0.9),
    # server-side top-k of the virtual error, fused backward
    "true_topk": dict(mode="true_topk", error_type="virtual",
                      virtual_momentum=0.9, k=300),
    # per-client velocity rows, masked at the sent coordinates
    "true_topk_local_momentum": dict(mode="true_topk", error_type="virtual",
                                     virtual_momentum=0.9, k=300,
                                     local_momentum=0.9),
    # per-client top-k with local error and velocity rows
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, k=300),
    # local SGD over each client's whole batch: 3 steps of 2, 2 epochs
    "fedavg": dict(mode="fedavg", error_type="none", local_batch_size=-1,
                   fedavg_batch_size=2, num_fedavg_epochs=2,
                   fedavg_lr_decay=0.9),
    # per-client stale weight rows, downloads of the top-500 gap
    "uncompressed_topk_down": dict(mode="uncompressed", virtual_momentum=0.9,
                                   do_topk_down=True, down_k=500),
    # config #4's two rounds at a tiny width (models/resnets.py, the
    # ImageNet stem on 32-px images). The sketch keeps config #4's ~50
    # coordinates a cell (D = 99,242 over 2,000 columns; 25.6M over
    # 500,000 there): at 700 columns the odd-r median estimates, each a
    # cell value shared by ~140 coordinates, tie exactly at the k-th
    # place and a last-bit difference of the cells reorders whole groups
    "fixup_resnet50_uncompressed": dict(mode="uncompressed",
                                        virtual_momentum=0.9),
    "resnet50_sketch": dict(mode="sketch", error_type="virtual",
                            virtual_momentum=0.9, k=500, num_rows=5,
                            num_cols=2000),
    # the per-round options (item 6b). --max_grad_norm and --dp turn
    # the deferred encode and the fused backward off: each client's
    # table is encoded (and in sketch mode clipped by its l2estimate)
    # on its own
    "sketch_max_grad_norm": dict(mode="sketch", error_type="virtual",
                                 virtual_momentum=0.9, k=300, num_rows=5,
                                 num_cols=700, max_grad_norm=0.5),
    # worker noise from each client's threefry key, sqrt(W) scaled
    "sketch_dp_worker": dict(mode="sketch", error_type="virtual",
                             virtual_momentum=0.9, k=300, num_rows=5,
                             num_cols=700, do_dp=True, l2_norm_clip=1.0,
                             noise_multiplier=0.01),
    # server noise from the server's key (round key folded with W)
    "uncompressed_dp_server": dict(mode="uncompressed",
                                   virtual_momentum=0.9, do_dp=True,
                                   dp_mode="server", l2_norm_clip=0.5,
                                   noise_multiplier=0.01),
    "true_topk_dp": dict(mode="true_topk", error_type="virtual",
                         virtual_momentum=0.9, k=300, do_dp=True,
                         l2_norm_clip=1.0, noise_multiplier=0.01),
    "local_topk_max_grad_norm": dict(mode="local_topk", error_type="local",
                                     local_momentum=0.9, k=300,
                                     max_grad_norm=0.5),
    # JAX's fedavg_step applies neither option, and neither does the port
    "fedavg_dp_max_grad_norm": dict(mode="fedavg", error_type="none",
                                    local_batch_size=-1,
                                    fedavg_batch_size=2, do_dp=True,
                                    noise_multiplier=0.01,
                                    max_grad_norm=0.5),
    # the quantized wire, held to a one-device JAX mesh (WIRE_CASES)
    "sketch_int8": dict(mode="sketch", error_type="virtual",
                        virtual_momentum=0.9, k=300, num_rows=5,
                        num_cols=700, sketch_table_dtype="int8"),
    "sketch_bf16_wire": dict(mode="sketch", error_type="virtual",
                             virtual_momentum=0.9, k=300, num_rows=5,
                             num_cols=700, sketch_table_dtype="bf16"),
}
# The JAX engine rounds EACH MESH SHARD's client-sum table to the wire
# type before its psum, and the test conftest's 8 CPU devices would put
# the 4 clients on 4 shards (4 roundings of 1-client sums); the port,
# on one device, rounds the one cohort sum. The wire cases therefore
# hold the port to a one-device JAX mesh, the layout it models.
WIRE_CASES = ("sketch_int8", "sketch_bf16_wire")
# the model of a case: the tiny ResNet9 unless named here, as (registry
# name, fields) of both packages' registries
CASE_MODELS = {
    "fixup_resnet50_uncompressed": ("FixupResNet50", dict(width=4)),
    "resnet50_sketch": ("ResNet50", dict(width=4)),
}


@functools.lru_cache(maxsize=None)
def _jax_init(name, **fields):
    """A registry model of the JAX package at 10 classes and its init
    from PRNGKey(0) on 32-px images, built once a process (the ResNet50
    one serves resnet50_sketch and the plain-init test)."""
    from commefficient_tpu.models import build_model as j_build_model
    jm = j_build_model(name, num_classes=10, **fields)
    return jm, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                jnp.zeros((2, 32, 32, 3), jnp.float32))


def _case_models(case):
    """The JAX model, its parameters and the port's model loaded with
    them. FixupResNet50 starts from JAX's init moved by 0.05 x N(0, 1) a
    leaf, so its zero conv3 and head carry gradient. ResNet50 starts
    from JAX's init with each block's last norm scale (bn3) at 0.1, the
    residual branches damped as ResNet inits that zero it do: at the
    plain init the float32 gradient of this 16-block batch-normed net
    sits ~1e-2 (relative L2) from its float64 value in EITHER package
    (the gradients of deep batch-normed nets at init grow through the
    blocks), so no two float32 implementations could agree to 1e-5;
    damped, both sit ~5e-6 from float64."""
    if case not in CASE_MODELS:
        jm = JResNet9(num_classes=10, channels=TINY)
        params = jm.init(jax.random.PRNGKey(0),
                         jnp.zeros((2, 32, 32, 3), jnp.float32))
        tm = build_model("ResNet9", channels=TINY)
        from_jax_params(tm, params)
        return jm, params, tm
    name, fields = CASE_MODELS[case]
    jm, params = _jax_init(name, **fields)
    if name.startswith("Fixup"):
        flat, unravel = ravel_pytree(params)
        rng = np.random.RandomState(1)
        params = unravel(flat + 0.05 * rng.randn(flat.shape[0])
                         .astype(np.float32))
    else:
        params = jax.tree_util.tree_map_with_path(
            lambda path, v: v * 0.1 if path[-2].key == "bn3" else v, params)
    tm = build_model(name, num_classes=10, input_hw=(32, 32), **fields)
    from_jax_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("case", sorted(CASES))
def test_fedmodel_rounds_match_jax(case):
    # 3 rounds, 4 clients x 6 examples, from the same init. Tolerances:
    # the client backward reduces in another order than XLA's, so
    # weights and the per-client rows agree to 1e-5 of their scale and
    # losses to 1e-5 relative; the top-k picks the same coordinates, so
    # the upload/download byte totals are IDENTICAL, and so is
    # local_topk's realized nonzero count.
    kw = {**dict(local_momentum=0.0, num_workers=4, num_clients=12,
                 local_batch_size=6), **CASES[case]}
    jcfg = JConfig(**kw)
    tcfg = TConfig(**kw, device="cpu")
    jm, params, tm = _case_models(case)

    mesh = None
    if case in WIRE_CASES:
        from commefficient_tpu.parallel.mesh import make_client_mesh
        mesh = make_client_mesh(1)
    jmodel = JFedModel(None, j_make_compute_loss(jm), jcfg, params=params,
                       num_clients=12, mesh=mesh)
    jopt = JFedOptimizer(jmodel)
    tmodel = TFedModel(tm, t_make_compute_loss(tm), tcfg, device="cpu",
                       num_clients=12)
    topt = TFedOptimizer(tmodel)
    np.testing.assert_array_equal(
        tmodel.ps_weights.numpy(),
        np.asarray(ravel_pytree(params)[0]))

    j_bytes = np.zeros(2)
    t_bytes = np.zeros(2)
    for i, batch in enumerate(_batches(3, 4, 6, 12, seed=7)):
        jopt.param_groups[0]["lr"] = topt.param_groups[0]["lr"] = 0.1
        jl, _, jd, ju = jmodel(batch)
        jopt.step()
        # the resnets nets take PyTorch's native CPU convolutions (see
        # tests/test_torch_resnets.py)
        with torch.backends.mkldnn.flags(enabled=case not in CASE_MODELS):
            tl, _, td, tu = tmodel(batch)
            topt.step()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        j_bytes += [np.sum(jd), np.sum(ju)]
        t_bytes += [np.sum(td), np.sum(tu)]
        jw = np.asarray(jmodel.ps_weights)
        np.testing.assert_allclose(tmodel.ps_weights.numpy(), jw, rtol=0,
                                   atol=1e-5 * np.abs(jw).max(),
                                   err_msg=f"round {i}")
        for block in ("errors", "velocities", "weights"):
            jrows = np.asarray(getattr(jmodel.clients, block))
            trows = getattr(tmodel.clients, block).numpy()
            if jrows.size == 0:
                assert trows.size == 0, block
                continue
            jrows = jrows[:12]
            assert trows.shape == jrows.shape, block
            np.testing.assert_allclose(
                trows, jrows, rtol=0, atol=1e-5 * np.abs(jrows).max(),
                err_msg=f"{block}, round {i}")
        assert (tmodel.accountant.realized_nonzeros
                == jmodel.accountant.realized_nonzeros)
    np.testing.assert_array_equal(t_bytes, j_bytes)
    assert t_bytes[1] > 0 and t_bytes[0] > 0
    assert (tmodel.accountant.max_realized_nonzeros
            == jmodel.accountant.max_realized_nonzeros)
    if kw["mode"] == "local_topk":
        assert tmodel.accountant.realized_nonzeros > 0


def test_resnet50_plain_init_gradient_no_less_accurate_than_jax():
    # the resnet50_sketch case's net at JAX's plain init, undamped, on
    # the first round's batch: both float32 gradients sit far from the
    # float64 one there (see _case_models), so no closeness to JAX is
    # asked, only that the port's float32 error is within 3x JAX's
    from commefficient_tpu_torch.federated.client import make_flat_grad_fn
    from commefficient_tpu_torch.ops.flat import flatten_params
    jm, params = _jax_init("ResNet50", width=4)
    tm = build_model("ResNet50", num_classes=10, width=4, input_hw=(32, 32))
    vec = from_jax_params(tm, params)
    _, (x, y), mask = _batches(1, 4, 6, 12, seed=7)[0]
    x, y, mask = x[0], y[0], mask[0]
    jvec, unravel = ravel_pytree(params)
    jloss_fn = j_make_compute_loss(jm)
    jg = np.asarray(jax.jit(jax.grad(
        lambda v: jloss_fn(unravel(v), (jnp.asarray(x), jnp.asarray(y)),
                           jnp.asarray(mask))[0]))(jvec))
    tg = {}
    with torch.backends.mkldnn.flags(enabled=False):
        for dtype in (torch.float32, torch.float64):
            tm = tm.to(dtype)
            _, t_unravel = flatten_params(tm)
            tg[dtype] = make_flat_grad_fn(t_make_compute_loss(tm), t_unravel)(
                vec.to(dtype), (torch.from_numpy(x).to(dtype),
                                torch.from_numpy(y).long()),
                torch.from_numpy(mask).to(dtype))[2].numpy()
    g64 = tg[torch.float64]
    scale = np.abs(g64).max()
    assert scale > 0 and np.isfinite(tg[torch.float32]).all()
    j_err = np.abs(jg - g64).max()
    assert np.abs(tg[torch.float32] - g64).max() <= 3 * max(j_err,
                                                            1e-6 * scale)


def test_state_allocators_need_the_callers_device():
    # the port runs on the card unless its caller asks for the CPU, so no
    # internal allocator picks a device of its own
    sk = CSVec(d=100, c=10, r=3)
    with pytest.raises(TypeError, match="device"):
        sk.zeros()
    with pytest.raises(TypeError, match="device"):
        tround.init_client_state(None, 2)
    # --topk_down's rows copy the weights, yet take no device from them
    cfg = TConfig(mode="uncompressed", local_momentum=0.0, do_topk_down=True,
                  grad_size=5, device="cpu")
    with pytest.raises(TypeError, match="device"):
        tround.init_client_state(cfg, 2, ps_weights=torch.ones(5))
    rows = tround.init_client_state(cfg, 2, "cpu", torch.arange(5.0))
    assert torch.equal(rows.weights, torch.arange(5.0).repeat(2, 1))
    assert sk.zeros("cpu").shape == (3, 10)
