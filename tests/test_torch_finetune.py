"""Item 7's remainder against the JAX package: the pretrained-artifact
bridge both ways, --remat, checkpoint.transfer_for_finetune, the
frozen-coordinate grad_mask of the round (tests/test_freeze.py's
properties, and one round against the JAX FedModel), and --finetune
through both drivers, at tiny sizes (a 2-layer GPT2 of width 32,
ResNet9 at one channel a layer). Tolerances: the artifacts and the
transfer bitwise; --remat bitwise against the plain step; rows drawn by
the port's threefry (resized embeddings, a fresh MC head) within 1e-6
relative of jax.random.normal's (tests/test_torch_prng.py); the round
at test_fedmodel_rounds_match_jax's limits.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.federated.api import (
    FedModel as JFedModel, FedOptimizer as JFedOptimizer,
)
from commefficient_tpu.models import gpt2 as JG
from commefficient_tpu.utils.checkpoint import (
    transfer_for_finetune as j_transfer,
)
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.config import parse_args
from commefficient_tpu_torch.federated.api import (
    FedModel as TFedModel, FedOptimizer as TFedOptimizer,
)
from commefficient_tpu_torch.models import build_model
from commefficient_tpu_torch.models import gpt2 as TG
from commefficient_tpu_torch.models.convert import (
    from_jax_params, ravel_jax_params, to_jax_params,
)
from commefficient_tpu_torch.ops.flat import flatten_params, module_layout
from commefficient_tpu_torch.utils.checkpoint import transfer_for_finetune

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GCFG = dict(vocab_size=61, n_positions=16, n_embd=32, n_layer=2, n_head=2)


def _jax_gpt2(seed=0):
    """A JAX GPT2Config and a parameter tree in its shapes (random, from
    the port's seeded init: what matters here is the JAX writer's and
    reader's handling, not the JAX init)."""
    tm = TG.GPT2DoubleHeads(TG.GPT2Config(**GCFG), seed=seed)
    return JG.GPT2Config(**GCFG), to_jax_params(tm)


def _flat(tree):
    return ravel_jax_params(jax.tree.map(np.asarray, tree))


# ---------------- the pretrained artifact ---------------------------------

def test_jax_artifact_loads_into_the_port_bitwise(tmp_path):
    jcfg, params = _jax_gpt2()
    JG.save_pretrained(str(tmp_path), params, jcfg)
    tree, cfg = TG.load_pretrained_dir(str(tmp_path))
    assert cfg == TG.GPT2Config(**GCFG)
    np.testing.assert_array_equal(_flat(tree), _flat(params))
    tm = TG.GPT2DoubleHeads(cfg)
    vec = from_jax_params(tm, tree)
    np.testing.assert_array_equal(vec.numpy(), _flat(params))


def test_port_artifact_loads_into_jax_and_the_port_bitwise(tmp_path):
    tm = TG.GPT2DoubleHeads(TG.GPT2Config(**GCFG), seed=3)
    vec, _ = flatten_params(tm)
    TG.save_pretrained(str(tmp_path), to_jax_params(tm), tm.cfg)
    jparams, jcfg = JG.load_pretrained_dir(str(tmp_path))
    assert (jcfg.n_layer, jcfg.n_embd, jcfg.vocab_size) == (2, 32, 61)
    np.testing.assert_array_equal(np.asarray(ravel_pytree(jparams)[0]),
                                  vec.numpy())
    tree, cfg = TG.load_pretrained_dir(str(tmp_path))
    assert cfg == tm.cfg
    np.testing.assert_array_equal(_flat(tree), vec.numpy())
    assert TG.load_pretrained_dir(str(tmp_path / "absent")) is None


def test_lm_only_state_dict_and_resizes_match_jax():
    # an LM-only checkpoint has no MC head: a fresh N(0, 0.02) kernel
    # from the key, then both tables grown with rows from the key
    jcfg, params = _jax_gpt2(seed=1)
    sd = {k: v for k, v in JG.hf_state_dict_from_params(params, jcfg).items()
          if not k.startswith("multiple_choice_head")}
    key = 7
    jt = JG.params_from_hf_state_dict(sd, jcfg, key=jax.random.PRNGKey(key))
    jt = JG.resize_token_embeddings(jt, 70, key=jax.random.PRNGKey(key))
    jt = JG.resize_position_embeddings(jt, 24, key=jax.random.PRNGKey(key))
    from commefficient_tpu_torch.ops import prng
    tcfg = TG.GPT2Config(**GCFG)
    tt = TG.params_from_hf_state_dict(sd, tcfg, key=prng.PRNGKey(key))
    tt = TG.resize_token_embeddings(tt, 70, key=prng.PRNGKey(key))
    tt = TG.resize_position_embeddings(tt, 24, key=prng.PRNGKey(key))
    want, got = _flat(jt), _flat(tt)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    # the copied rows are exact; only the drawn ones may differ
    n_old = 61 * 32
    wte_j = np.asarray(jt["params"]["transformer"]["wte"]["embedding"])
    wte_t = tt["params"]["transformer"]["wte"]["embedding"]
    np.testing.assert_array_equal(wte_t.reshape(-1)[:n_old],
                                  wte_j.reshape(-1)[:n_old])


# ---------------- --remat -------------------------------------------------

@pytest.mark.parametrize("L", [16, 256], ids=["einsum", "flash"])
def test_remat_is_bitwise_the_plain_step(L):
    from commefficient_tpu_torch.training.gpt2_train import (
        make_compute_loss_train,
    )
    cfg = TConfig(num_candidates=2)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 61, (2, 2, L)))
    labels = torch.from_numpy(np.where(rng.rand(2, 2, L) < 0.3, -1,
                                       rng.randint(0, 61, (2, 2, L))))
    mc = torch.from_numpy(rng.randint(0, L, (2, 2)))
    mc_labels = torch.from_numpy(rng.randint(0, 2, (2,)))
    batch = (ids, mc, labels, mc_labels, ids)
    mask = torch.ones(2)
    out = []
    for remat in (False, True):
        tm = TG.GPT2DoubleHeads(TG.GPT2Config(**{**GCFG, "n_positions": L},
                                              remat=remat), seed=2)
        vec, unravel = flatten_params(tm)
        w = vec.detach().requires_grad_(True)
        loss, _ = make_compute_loss_train(tm, cfg)(unravel(w), batch, mask)
        g, = torch.autograd.grad(loss, w)
        out.append((loss.detach(), g))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_remat_round_through_gpt2_train_is_bitwise(tmp_path):
    from commefficient_tpu_torch.data.persona import HashTokenizer
    from commefficient_tpu_torch.training import gpt2_train
    ws = []
    for remat in ((), ("--remat",)):
        cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=[
            "--test", "--device", "cpu", "--dataset_name", "PERSONA",
            "--dataset_dir", str(tmp_path / "data"), "--mode", "sketch",
            "--error_type", "virtual", "--local_momentum", "0",
            "--num_workers", "2", "--local_batch_size", "2",
            "--num_cols", "1000", "--num_rows", "1", "--k", "10",
            "--num_epochs", "0.1", *remat])
        model, opt, sched, loader, _ = gpt2_train.build(
            cfg, HashTokenizer(500), device="cpu",
            synthetic_examples=(4, 2, 4))
        assert model.module.cfg.remat == bool(remat)
        client_ids, data, mask = next(iter(loader.epoch()))
        opt.param_groups[0]["lr"] = 0.04
        model((client_ids, data, mask))
        ws.append(model.ps_weights)
    assert torch.equal(ws[0], ws[1])


# ---------------- transfer_for_finetune and the frozen mask ---------------

ONE = {"prep": 1, "layer1": 1, "layer2": 1, "layer3": 1}


def test_transfer_for_finetune_matches_jax():
    old = build_model("ResNet9", channels=ONE, num_classes=10, seed=1)
    new = build_model("ResNet9", channels=ONE, num_classes=100, seed=2)
    old_vec, _ = flatten_params(old)
    old_vec = old_vec.detach() + 0.5     # "trained"
    new_tree = to_jax_params(new)
    vec, frozen = transfer_for_finetune(old, old_vec, new)
    from commefficient_tpu_torch.models.convert import load_flat
    load_flat(old, old_vec)
    jparams, jmask = j_transfer(jax.tree.map(jnp.asarray,
                                             to_jax_params(old)),
                                jax.tree.map(jnp.asarray, new_tree))
    np.testing.assert_array_equal(vec.numpy(), _flat(jparams))
    np.testing.assert_array_equal(flatten_params(new)[0].detach().numpy(),
                                  vec.numpy())
    # JAX's per-leaf mask, broadcast leaf by leaf (cv_train's
    # _mask_to_lr_scales), is the port's flat mask
    leaves = jax.tree_util.tree_leaves(jparams)
    flags = jax.tree_util.tree_leaves(jmask)
    want = np.concatenate([np.full(l.size, float(f), np.float32)
                           for l, f in zip(leaves, flags)])
    np.testing.assert_array_equal(frozen, want)
    # everything but the 100-class head moved over
    assert 0 < (frozen == 0).sum() < frozen.size


D = 8
FROZEN = np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32)


class Reg(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(D))


def _t_loss(params, batch, mask):
    x, y = batch
    per = 0.5 * (x @ params["w"] - y) ** 2
    loss = (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, (loss,)


def _j_loss(params, batch, mask):
    x, y = batch
    per = 0.5 * (x @ params["w"] - y) ** 2
    loss = (per * mask).sum() / jnp.maximum(mask.sum(), 1.0)
    return loss, (loss,)


FREEZE_MODES = {
    "uncompressed": dict(mode="uncompressed"),
    "fedavg": dict(mode="fedavg", local_batch_size=-1, fedavg_batch_size=2),
    "local_topk": dict(mode="local_topk", k=2, error_type="local"),
    "sketch": dict(mode="sketch", error_type="virtual", k=2, num_rows=3,
                   num_cols=6, virtual_momentum=0.9),
}


@pytest.mark.parametrize("mode", sorted(FREEZE_MODES))
def test_frozen_coordinates_never_move_and_match_jax(mode):
    """test_freeze.py's property (frozen coordinates untouched, the rest
    trains) and the JAX FedModel's round, from an lr scale vector with
    zeros; byte totals identical (the dense modes bill the live
    coordinates only)."""
    kw = {**dict(grad_size=D, weight_decay=1e-2, num_workers=8,
                 local_momentum=0.0, virtual_momentum=0.0,
                 error_type="none", microbatch_size=-1, num_clients=8),
          **FREEZE_MODES[mode]}
    scales = 1.0 - FROZEN
    jmodel = JFedModel(None, _j_loss, JConfig(**kw),
                       params={"w": jnp.zeros(D)}, lr_scale_vec=scales)
    tmodel = TFedModel(Reg(), _t_loss, TConfig(**kw, device="cpu"),
                       device="cpu", num_clients=8, lr_scale_vec=scales)
    assert tmodel.frozen_count == 4
    jopt, topt = JFedOptimizer(jmodel), TFedOptimizer(tmodel)
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4, D).astype(np.float32)
    x[..., :4] *= 100.0              # frozen coordinates: big gradients
    y = rng.randn(8, 4).astype(np.float32)
    batch = (np.arange(8, dtype=np.int32), (x, y), np.ones((8, 4), np.float32))
    for _ in range(3):
        jopt.param_groups[0]["lr"] = topt.param_groups[0]["lr"] = 0.1
        _, _, jd, ju = jmodel(batch)
        _, _, td, tu = tmodel(batch)
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_array_equal(td, jd)
    w = tmodel.ps_weights.numpy()
    jw = np.asarray(jmodel.ps_weights)
    np.testing.assert_array_equal(w[:4], 0.0)
    assert np.abs(w[4:]).sum() > 0
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-5 * np.abs(jw).max())


# ---------------- --finetune through the drivers --------------------------

def _cv_argv(tmp_path, dataset, *extra):
    return ["--test", "--device", "cpu", "--mode", "sketch",
            "--error_type", "virtual", "--local_momentum", "0",
            "--num_workers", "4", "--local_batch_size", "4", "--iid",
            "--num_clients", "8", "--dataset_name", dataset,
            "--dataset_dir", str(tmp_path / dataset), *extra]


def test_cv_train_finetune_freezes_the_transferred_body(tmp_path):
    """ResNet9 trained on CIFAR10 with --checkpoint, then --finetune
    --finetuned_from CIFAR10 on CIFAR100: the body comes over bitwise
    and never moves, the 100-class head trains."""
    from commefficient_tpu_torch.training import cv_train
    ck = str(tmp_path / "ck")
    cfg = parse_args(argv=_cv_argv(tmp_path, "CIFAR10", "--num_epochs", "1",
                                   "--checkpoint", "--checkpoint_path", ck,
                                   "--no_telemetry"))
    model, opt, sched, loader, val = cv_train.build(
        cfg, device="cpu", synthetic_examples=(32, 8))
    assert cv_train.run(model, opt, sched, loader, val, model.cfg,
                        str(tmp_path))
    old = model.ps_weights.clone()
    cfg = parse_args(argv=_cv_argv(
        tmp_path, "CIFAR100", "--num_epochs", "1", "--finetune",
        "--finetune_path", ck, "--finetuned_from", "CIFAR10",
        "--no_telemetry"))
    model, opt, sched, loader, val = cv_train.build(
        cfg, device="cpu", synthetic_examples=(32, 8))
    frozen = (model.lr_scale_vec == 0).numpy()
    assert model.frozen_count == frozen.sum() > 0
    w0 = model.ps_weights.clone()
    # the body comes over leaf for leaf: the old vector at the old
    # layout's matching paths
    old_module = build_model("ResNet9", channels=ONE, num_classes=10)
    old_at = dict(zip(
        [e.path for e in module_layout(old_module)],
        np.split(old.numpy(), np.cumsum(
            [e.size for e in module_layout(old_module)])[:-1])))
    off = 0
    for e in module_layout(model.module):
        seg = slice(off, off + e.size)
        off += e.size
        if frozen[seg].all():
            np.testing.assert_array_equal(w0.numpy()[seg], old_at[e.path])
    assert cv_train.run(model, opt, sched, loader, val, model.cfg,
                        str(tmp_path))
    w = model.ps_weights.numpy()
    np.testing.assert_array_equal(w[frozen], w0.numpy()[frozen])
    assert not np.array_equal(w[~frozen], w0.numpy()[~frozen])


def test_cv_train_finetune_needs_a_checkpoint_and_a_source(tmp_path):
    from commefficient_tpu_torch.training import cv_train
    cfg = parse_args(argv=_cv_argv(tmp_path, "CIFAR100", "--finetune",
                                   "--finetune_path", str(tmp_path / "no")))
    with pytest.raises(ValueError, match="--finetuned_from"):
        cv_train.build(cfg, device="cpu", synthetic_examples=(32, 8))
    cfg = cfg.replace(finetuned_from="CIFAR10")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        cv_train.build(cfg, device="cpu", synthetic_examples=(32, 8))


def test_gpt2_train_finetune_loads_the_saved_artifact(tmp_path):
    """A --test gpt2_train run saves its artifact; --finetune from it
    loads those weights bitwise (and, like the JAX driver, evaluates
    them); a JAX artifact loads the same way."""
    from commefficient_tpu_torch.data.persona import HashTokenizer
    from commefficient_tpu_torch.training import gpt2_train
    art = str(tmp_path / "art")
    tm = TG.GPT2DoubleHeads(TG.GPT2Config(vocab_size=500, n_positions=64,
                                          n_embd=32, n_layer=2, n_head=2),
                            seed=4)
    TG.save_pretrained(art, to_jax_params(tm), tm.cfg)
    argv = ["--test", "--device", "cpu", "--dataset_name", "PERSONA",
            "--dataset_dir", str(tmp_path / "data"), "--mode", "sketch",
            "--error_type", "virtual", "--local_momentum", "0",
            "--num_workers", "2", "--local_batch_size", "2", "--finetune",
            "--finetune_path", art, "--remat"]
    cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=argv)
    module = gpt2_train.build_model_and_params(
        cfg, HashTokenizer(500), 40,
        source=gpt2_train.finetune_source(cfg), require_load=True)
    assert module.cfg.remat
    np.testing.assert_array_equal(flatten_params(module)[0].detach().numpy(),
                                  flatten_params(tm)[0].detach().numpy())
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert gpt2_train.main(argv + ["--no_telemetry"])
    finally:
        os.chdir(cwd)
    with pytest.raises(FileNotFoundError, match="--finetune"):
        gpt2_train.build_model_and_params(
            cfg.replace(finetune_path=str(tmp_path / "none")),
            HashTokenizer(500), 40, source=str(tmp_path / "none"),
            require_load=True)
