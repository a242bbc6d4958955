"""The port's GPT2 driver: the `--test --device cpu` smoke, the loss
callbacks and multi-round FedModel parity against the JAX package in
the threshold-decode regime (the JAX server on its Pallas route,
`pallas_threshold_decode`, whose per-chunk sample the port always
takes), and the refusals of what the GPT2 path leaves unported."""
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
from commefficient_tpu.training import gpt2_train as jtrain
from commefficient_tpu_torch.config import Config as TConfig, parse_args
from commefficient_tpu_torch.data.persona import HashTokenizer
from commefficient_tpu_torch.federated.api import (
    FedModel as TFedModel, FedOptimizer as TFedOptimizer,
)
from commefficient_tpu_torch.models import gpt2 as TG
from commefficient_tpu_torch.models.convert import (
    from_jax_params, to_jax_params,
)
from commefficient_tpu_torch.ops import sketch as tsketch
from commefficient_tpu_torch.training import gpt2_train

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _argv(tmp_path, *extra):
    return ["--test", "--device", "cpu", "--dataset_name", "PERSONA",
            "--dataset_dir", str(tmp_path / "ds"), "--local_momentum", "0",
            "--num_workers", "4", "--local_batch_size", "2",
            "--num_epochs", "1", "--valid_batch_size", "4",
            "--lr_scale", "0.1", *extra]


def test_gpt2_train_test_smoke_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert gpt2_train.main(_argv(tmp_path, "--mode", "sketch",
                                 "--error_type", "virtual",
                                 "--virtual_momentum", "0.9"))
    out = capsys.readouterr().out
    assert "train_loss" in out and "val_nll" in out
    assert "Total Upload (MiB)" in out
    # the HF-style artifact lands in the run directory
    found = [r for r, _, files in os.walk(tmp_path / "runs")
             if "pytorch_model.bin" in files and "config.json" in files]
    assert len(found) == 1


def test_loss_callbacks_match_jax():
    # log-softmax, gather and masked means in f32: 1e-6 relative
    rng = np.random.RandomState(0)
    B, C, L, V = 3, 2, 7, 11
    logits = rng.randn(B, C, L, V).astype(np.float32)
    labels = np.where(rng.rand(B, C, L) < 0.4, -1,
                      rng.randint(0, V, (B, C, L))).astype(np.int32)
    mc_logits = rng.randn(B, C).astype(np.float32)
    mc_labels = rng.randint(0, C, (B,)).astype(np.int32)
    for mask in (np.array([1, 1, 0], np.float32),
                 np.zeros(3, np.float32)):
        want = float(jtrain._lm_nll(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(mask)))
        got = float(gpt2_train._lm_nll(torch.from_numpy(logits),
                                       torch.from_numpy(labels),
                                       torch.from_numpy(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        jl, ja = jtrain._mc_loss_acc(jnp.asarray(mc_logits),
                                     jnp.asarray(mc_labels),
                                     jnp.asarray(mask))
        tl, ta = gpt2_train._mc_loss_acc(torch.from_numpy(mc_logits),
                                         torch.from_numpy(mc_labels),
                                         torch.from_numpy(mask))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        assert float(ta) == float(ja)


def _batches(n_rounds, W, B, C, L, vocab, num_clients, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_rounds):
        ids = rng.choice(num_clients, W, replace=False).astype(np.int32)
        data = (rng.randint(5, vocab, (W, B, C, L)).astype(np.int32),
                rng.randint(0, L, (W, B, C)).astype(np.int32),
                np.where(rng.rand(W, B, C, L) < 0.3, -1,
                         rng.randint(0, vocab, (W, B, C, L))
                         ).astype(np.int32),
                rng.randint(0, C, (W, B)).astype(np.int32),
                rng.randint(5, vocab, (W, B, C, L)).astype(np.int32))
        mask = np.ones((W, B), np.float32)
        mask[0, -1] = 0.0        # a short client, as the sampler makes
        out.append((ids, data, mask))
    return out


def test_fedmodel_rounds_match_jax_in_the_threshold_regime(monkeypatch):
    # 3 rounds of a tiny GPT2 (D = 4,561), 4 clients x 3 examples, with
    # the threshold decode forced by a lowered gate in both packages.
    # The JAX server decodes through pallas_threshold_decode (its Pallas
    # route, interpret mode). Its encodes stay on the XLA route, which
    # is bitwise the Pallas encode (tests/test_kernels.py): the JAX
    # package's Pallas encode inside the round's shard_map is refused
    # by this JAX version's vma check (tests/test_kernels.py's own
    # Pallas round tests fail the same way).
    # Tolerances: the client backward reduces in another order than
    # XLA's, so weights agree to 1e-5 of their scale and losses to 1e-5
    # relative; the threshold picks the same coordinates, so the
    # upload/download byte totals are IDENTICAL.
    import commefficient_tpu.ops.sketch as jsk
    monkeypatch.setattr(jsk, "THRESHOLD_DECODE_MIN_D", 1000)
    monkeypatch.setattr(tsketch, "THRESHOLD_DECODE_MIN_D", 1000)
    monkeypatch.setattr(jsk.CSVec, "_pallas",
                        lambda self, kind: kind == "estimate")
    vocab, C, L = 61, 2, 12
    gk = dict(vocab_size=vocab, n_positions=16, n_embd=16, n_layer=1,
              n_head=2)
    jm = JG.GPT2DoubleHeads(JG.GPT2Config(**gk))
    ids0 = jnp.zeros((1, C, L), jnp.int32)
    params = jm.init(jax.random.PRNGKey(0), ids0, ids0,
                     jnp.zeros((1, C), jnp.int32))
    tm = TG.GPT2DoubleHeads(TG.GPT2Config(**gk))
    from_jax_params(tm, params)
    kw = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              local_momentum=0.0, k=200, num_rows=5, num_cols=500,
              num_workers=4, num_clients=12, local_batch_size=3)
    jcfg = JConfig(**kw)
    tcfg = TConfig(device="cpu", **kw)
    assert tcfg.fused_client_backward

    jmodel = JFedModel(None, jtrain.make_compute_loss_train(jm, jcfg), jcfg,
                       params=params, num_clients=12)
    jopt = JFedOptimizer(jmodel)
    tmodel = TFedModel(tm, gpt2_train.make_compute_loss_train(tm, tcfg),
                       tcfg, device="cpu", num_clients=12)
    topt = TFedOptimizer(tmodel)
    D = tmodel.cfg.grad_size
    assert D == 4561 and D > tsketch.THRESHOLD_DECODE_MIN_D
    assert tsketch.cached_sketch(D, 500, 5)._threshold_decode
    import commefficient_tpu.ops.kernels as jkernels
    from commefficient_tpu.federated.server import args2sketch
    calls = []
    real = jkernels.pallas_threshold_decode
    monkeypatch.setattr(jkernels, "pallas_threshold_decode",
                        lambda *a: calls.append(1) or real(*a))
    assert args2sketch(jmodel.cfg)._threshold_decode
    np.testing.assert_array_equal(tmodel.ps_weights.numpy(),
                                  np.asarray(ravel_pytree(params)[0]))

    j_bytes, t_bytes = np.zeros(2), np.zeros(2)
    for i, batch in enumerate(_batches(3, 4, 3, C, L, vocab, 12, seed=7)):
        jopt.param_groups[0]["lr"] = topt.param_groups[0]["lr"] = 0.1
        jl, _, _, jd, ju = jmodel(batch)
        jopt.step()
        tl, _, _, td, tu = tmodel(batch)
        topt.step()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        j_bytes += [np.sum(jd), np.sum(ju)]
        t_bytes += [np.sum(td), np.sum(tu)]
        jw = np.asarray(jmodel.ps_weights)
        np.testing.assert_allclose(tmodel.ps_weights.numpy(), jw, rtol=0,
                                   atol=1e-5 * np.abs(jw).max(),
                                   err_msg=f"round {i}")
    np.testing.assert_array_equal(t_bytes, j_bytes)
    assert t_bytes[0] > 0 and t_bytes[1] > 0
    assert calls      # the JAX round traced its Pallas threshold decode


@pytest.mark.parametrize("flags,needle", [
    (("--remat",), "--remat"),
    (("--model_parallel", "2"), "--model_parallel"),
    (("--finetune",), "--finetune"),
])
def test_what_the_gpt2_path_leaves_is_refused(tmp_path, flags, needle):
    # item 7 is ported: --remat and --finetune parse; so does
    # --model_parallel > 1 since item 9g's tensor parallelism, as the
    # JAX package's parse_args takes it (tests/test_torch_tp.py runs it)
    argv = _argv(tmp_path, *flags)
    cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=argv)
    if needle != "--model_parallel":
        assert cfg.do_remat or cfg.do_finetune
        return
    from commefficient_tpu.config import parse_args as j_parse_args
    jcfg = j_parse_args(default_lr=gpt2_train.DEFAULT_LR,
                        argv=[a for a in argv if a not in ("--device", "cpu")])
    assert cfg.model_parallel == jcfg.model_parallel == 2


def test_pretrained_artifact_is_refused_not_loaded(tmp_path):
    # a directory with config.json but no weights is not an artifact:
    # the --test model is built from the seed; with the weights beside
    # it, the artifact is loaded
    (tmp_path / "config.json").write_text("{}")
    cfg = TConfig(device="cpu", model_checkpoint=str(tmp_path),
                  do_test=True)
    module = gpt2_train.build_model_and_params(cfg, HashTokenizer(100), 32)
    assert module.cfg.n_embd == 32 and module.cfg.vocab_size == 100
    saved = TG.GPT2DoubleHeads(TG.GPT2Config(
        vocab_size=100, n_positions=32, n_embd=16, n_layer=1, n_head=2),
        seed=9)
    TG.save_pretrained(str(tmp_path), to_jax_params(saved), saved.cfg)
    module = gpt2_train.build_model_and_params(cfg, HashTokenizer(100), 32)
    assert module.cfg.n_embd == 16
    for a, b in zip(module.parameters(), saved.parameters()):
        assert torch.equal(a, b)


def test_defaults_are_config5_and_the_card(tmp_path):
    cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR,
                     argv=["--dataset_name", "PERSONA", "--local_momentum",
                           "0"])
    assert cfg.lr_scale == 4e-2 and cfg.device == "cuda"
    assert (cfg.k, cfg.num_rows, cfg.num_cols) == (50000, 5, 500000)
    if not torch.cuda.is_available():
        cfg = cfg.replace(dataset_dir=str(tmp_path / "ds"), do_test=True,
                          local_momentum=0.0, num_workers=2)
        with pytest.raises(RuntimeError, match="cuda"):
            gpt2_train.build(cfg, HashTokenizer(100))
