"""Tensor parallelism over the model group (commefficient_tpu_torch/
parallel/tp.py): a round on a (clients x model) layout must give the
weights of the one-process round, as tests/test_tp.py holds the JAX
package's (clients, model) mesh to its clients-only mesh. The grids are
CPU subprocesses over gloo:

  * the worker's `tp` scenario (the Megatron MLP sandwich, a span, an
    eval, the checkpoint) on 2 ranks against the port's single process
    and against the JAX FedModel on make_client_model_mesh(1, 2), within
    tests/test_tp.py's limits (losses rtol 2e-5, weights rtol 2e-4 atol
    1e-6); both ranks bitwise equal;
  * the tiny GPT2 round of tests/test_tp.py:23-80 through the port's
    tp_loss on 2 ranks (heads, MLP units and the tied embedding's
    vocabulary split) against the port's single process and the JAX
    FedModel on make_client_mesh(4): losses, weights and eval at those
    limits, and the cohort's flat gradient, whose sharded leaves are
    completed over the group and whose replicated leaves must not be
    doubled, within 1e-5 of the one-process gradient (a model with both
    kinds, tests/test_tp.py:59-80);
  * on the card only (`gpu`), kernel K4 on a rank's 6-head views of
    GPT2-small's fused projection against its plain version.

Run as a script, this file is one rank of the GPT2 grid.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_tp.py's limits
LOSS_RTOL = 2e-5
WEIGHT_RTOL, WEIGHT_ATOL = 2e-4, 1e-6
# the completed flat gradient against the one-process one: the same
# float32 backward with the heads' and units' products in two halves
GRAD_RTOL = 1e-5

# tests/test_tp.py's tiny GPT2 round
W, B, C, L = 4, 2, 2, 8


# ---------------------------------------------------------------------------
# the worker's tp scenario


def test_tp_scenario_matches_single_process_and_jax(tmp_path):
    import jax
    from jax.flatten_util import ravel_pytree

    from commefficient_tpu.parallel import mh_worker as jmw
    from commefficient_tpu.parallel.mesh import make_client_model_mesh
    from commefficient_tpu_torch.parallel import mh_worker as tmw

    jmodel, _, x0 = jmw._make_model_and_rules("tp")
    init = str(tmp_path / "init_tp.npy")
    np.save(init, np.asarray(ravel_pytree(
        jmodel.init(jax.random.PRNGKey(0), x0))[0]))
    out = str(tmp_path / "jax_tp.npz")
    make = jmw._make_mesh
    jmw._make_mesh = lambda v: make_client_model_mesh(1, 2)
    try:
        jmw.run_scenario(out, variant="tp")
    finally:
        jmw._make_mesh = make
    j = dict(np.load(out))

    got = tmw.run_grid(str(tmp_path), "tp", 2, "cpu", init=init,
                       timeout=300)
    grid, single = got["grid"], got["single"]
    assert grid["layout"].tolist() == [[0, 1]]
    assert int(grid["ranks_bitwise_equal"]) == 1
    for ref, name in ((single, "single"), (j, "jax")):
        for key in ("losses", "span_losses", "eval_loss"):
            np.testing.assert_allclose(grid[key], ref[key], rtol=LOSS_RTOL,
                                       err_msg=f"{name}:{key}")
        for key in ("ps_weights", "ckpt_ps_weights", "ckpt_client_weights"):
            np.testing.assert_allclose(grid[key], ref[key],
                                       rtol=WEIGHT_RTOL, atol=WEIGHT_ATOL,
                                       err_msg=f"{name}:{key}")
        for key in ("download", "upload"):
            np.testing.assert_array_equal(grid[key], ref[key])
    # and the worker's own grid limits
    for key in tmw.RESULT_KEYS:
        np.testing.assert_allclose(grid[key], single[key], rtol=tmw.RTOL,
                                   atol=tmw.ATOL, err_msg=key)


# ---------------------------------------------------------------------------
# the tiny GPT2 round


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = np.arange(W)
    input_ids = rng.randint(0, 64, (W, B, C, L)).astype(np.int32)
    mc_tok = rng.randint(0, L, (W, B, C)).astype(np.int32)
    lm_labels = rng.randint(0, 64, (W, B, C, L)).astype(np.int32)
    mc_labels = rng.randint(0, C, (W, B)).astype(np.int32)
    tt = rng.randint(0, 64, (W, B, C, L)).astype(np.int32)
    mask = np.ones((W, B), np.float32)
    return ids, (input_ids, mc_tok, lm_labels, mc_labels, tt), mask


def _gpt2_config(config_cls):
    return config_cls(vocab_size=64, n_positions=L, n_embd=16, n_layer=2,
                      n_head=2)


def gpt2_rank(out: str, process_id: int, num_processes: int, port: int,
              init: str) -> None:
    """One rank (or, with num_processes 1, the single process) of the
    tiny GPT2 round: the cohort gradient before round 0, two rounds,
    an eval; the coordinator writes them to `out`."""
    from commefficient_tpu_torch.config import Config as TConfig
    from commefficient_tpu_torch.federated.api import (
        FedModel, FedOptimizer,
    )
    from commefficient_tpu_torch.models.convert import from_jax_params
    from commefficient_tpu_torch.models.gpt2 import (
        GPT2Config, GPT2DoubleHeads,
    )
    from commefficient_tpu_torch.parallel import mh_worker as tmw
    from commefficient_tpu_torch.parallel import multihost as mh
    from commefficient_tpu_torch.parallel.mesh import make_client_model_mesh
    from commefficient_tpu_torch.parallel.tp import tp_loss
    from commefficient_tpu_torch.training.gpt2_train import (
        make_compute_loss_train, make_compute_loss_val,
    )
    torch.set_num_threads(1)
    layout = None
    if num_processes > 1:
        mh.initialize(f"127.0.0.1:{port}", num_processes, process_id,
                      backend="gloo", device="cpu")
        layout = make_client_model_mesh(num_processes // 2, 2)
    module = GPT2DoubleHeads(_gpt2_config(GPT2Config))
    from_jax_params(module, np.load(init))
    cfg = TConfig(mode="uncompressed", error_type="virtual",
                  virtual_momentum=0.9, local_momentum=0.0,
                  weight_decay=0.0, microbatch_size=-1, num_workers=W,
                  num_clients=W, lm_coef=1.0, mc_coef=1.0)
    loss, loss_val = (make_compute_loss_train(module, cfg),
                      make_compute_loss_val(module))
    if layout is not None:
        loss, loss_val = tp_loss(loss, layout), tp_loss(loss_val, layout)
    model = FedModel(module, loss, cfg, loss_val=loss_val, device="cpu",
                     num_clients=W, layout=layout)
    opt = FedOptimizer(model)
    opt.param_groups[0]["lr"] = 0.1
    sl = mh.local_row_slice(model.layout, W)

    def rows(batch):
        ids, data, mask = batch
        return ids, tuple(d[sl] for d in data), mask[sl]

    grad = model.cohort_transmit(rows(_batch(0))).numpy().copy()
    losses = [model(rows(_batch(r)))[0].numpy() for r in range(2)]
    _, data, mask = _batch(3)
    model.train(False)
    ev = model((tuple(d[sl] for d in data), mask[sl]))
    same = 1 if layout is None else int(tmw.ranks_bitwise_equal(
        model.ps_weights))
    if mh.is_coordinator():
        np.savez(out, grad=grad, losses=np.stack(losses),
                 ps_weights=model.ps_weights.numpy(), eval_loss=ev[0],
                 eval_acc=ev[1], same=same,
                 sharded=int(getattr(module.transformer, "_tp", None)
                             is not None))
    mh.shutdown()


def _run_gpt2(tmp_path, num_processes: int, init: str) -> dict:
    from commefficient_tpu_torch.parallel.mh_worker import free_port
    port = free_port()
    out = str(tmp_path / f"gpt2_{num_processes}.npz")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), out, str(i),
         str(num_processes), str(port), init], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(num_processes)]
    logs = []
    try:
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return dict(np.load(out))


def test_tiny_gpt2_tp_round_matches_dp_and_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from commefficient_tpu.config import Config as JConfig
    from commefficient_tpu.federated.api import (
        FedModel as JFedModel, FedOptimizer as JFedOptimizer,
    )
    from commefficient_tpu.models.gpt2 import (
        GPT2Config as JGPT2Config, GPT2DoubleHeads as JGPT2,
    )
    from commefficient_tpu.parallel.mesh import make_client_mesh
    from commefficient_tpu.training.gpt2_train import (
        make_compute_loss_train as j_loss,
    )

    jmodule = JGPT2(_gpt2_config(JGPT2Config))
    x0 = jnp.zeros((1, C, L), jnp.int32)
    params = jmodule.init(jax.random.PRNGKey(0), x0, x0,
                          jnp.zeros((1, C), jnp.int32))
    init = str(tmp_path / "init_gpt2.npy")
    np.save(init, np.asarray(ravel_pytree(params)[0]))

    tp = _run_gpt2(tmp_path, 2, init)
    dp = _run_gpt2(tmp_path, 1, init)
    assert tp["sharded"] == 1 and dp["sharded"] == 0
    assert int(tp["same"]) == 1

    # the completed gradient: sharded slices summed, replicated leaves
    # once (a doubled leaf would sit 100% off)
    rel = (np.linalg.norm(tp["grad"] - dp["grad"])
           / np.linalg.norm(dp["grad"]))
    assert rel <= GRAD_RTOL, rel
    np.testing.assert_allclose(tp["grad"], dp["grad"], rtol=1e-4,
                               atol=1e-6 * np.abs(dp["grad"]).max())

    jcfg = JConfig(mode="uncompressed", error_type="virtual",
                   virtual_momentum=0.9, local_momentum=0.0,
                   weight_decay=0.0, microbatch_size=-1, num_workers=W,
                   num_clients=W, grad_size=1, lm_coef=1.0, mc_coef=1.0)
    jm = JFedModel(None, j_loss(jmodule, jcfg), jcfg, params=params,
                   mesh=make_client_mesh(4), num_clients=W)
    jopt = JFedOptimizer(jm)
    jopt.param_groups[0]["lr"] = 0.1
    jlosses = [np.asarray(jm(_batch(r))[0]) for r in range(2)]

    for ref, name in ((dp, "dp"), ({"losses": np.stack(jlosses),
                                    "ps_weights": np.asarray(
                                        jm.ps_weights)}, "jax")):
        np.testing.assert_allclose(tp["losses"], ref["losses"],
                                   rtol=LOSS_RTOL, err_msg=name)
        np.testing.assert_allclose(tp["ps_weights"], ref["ps_weights"],
                                   rtol=WEIGHT_RTOL, atol=WEIGHT_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(tp["eval_loss"], dp["eval_loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_array_equal(tp["eval_acc"], dp["eval_acc"])
    # and the TP run trained
    assert float(np.abs(tp["ps_weights"] - np.load(init)).sum()) > 0


# ---------------------------------------------------------------------------
# the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K4 has no CPU mode (its "
                    "plain version is tested against JAX in "
                    "test_torch_attention.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rank", [0, 1])
def test_flash_kernel_on_a_ranks_six_head_views(cuda_device, rank):
    """K4 on rank `rank`'s [16, 6, 299, 64] head views of GPT2-small's
    fused projection under --model_parallel 2 (its heads' columns of
    q, k and v): within 1e-5 of the plain version's scale."""
    from commefficient_tpu_torch.ops.kernels import attention_cuda as ac
    Bq, Lq, E, H, hd = 16, 299, 768, 12, 64
    g = torch.Generator().manual_seed(rank)
    x = torch.randn(Bq, Lq, 3 * E, generator=g).to(cuda_device)
    lo, hi = rank * E // 2, (rank + 1) * E // 2
    local = torch.cat([x[..., o + lo:o + hi] for o in (0, E, 2 * E)], -1)
    q, k, v = (t.reshape(Bq, Lq, H // 2, hd).transpose(1, 2)
               for t in local.split(E // 2, dim=-1))
    before = ac.LAUNCHES["flash_fwd"]
    o, lse = ac.flash_fwd(q, k, v, hd ** -0.5)
    po, plse = ac.flash_fwd_plain(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert ac.LAUNCHES["flash_fwd"] == before + 1
    assert o.shape == (Bq, H // 2, Lq, hd)
    assert float((o - po).abs().max()) <= 1e-5 * float(po.abs().max())
    assert float((lse - plse).abs().max()) <= 1e-5 * float(
        plse.abs().max())


if __name__ == "__main__":
    gpt2_rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
              int(sys.argv[4]), sys.argv[5])
