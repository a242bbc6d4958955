"""The port's CV driver end to end on the CPU (`--test --device cpu`),
the refusal of unported options, and the port's import isolation: no
module of commefficient_tpu_torch may pull in jax or commefficient_tpu."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.config import Config, parse_args
from commefficient_tpu_torch.device import resolve_device
from commefficient_tpu_torch.training import cv_train

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _argv(tmp_path, *extra):
    return ["--test", "--device", "cpu", "--local_momentum", "0",
            "--num_workers", "4", "--num_epochs", "1",
            "--dataset_dir", str(tmp_path / "ds"), *extra]


@pytest.mark.parametrize("mode_flags", [
    ("--mode", "sketch", "--error_type", "virtual",
     "--virtual_momentum", "0.9"),
    ("--mode", "uncompressed"),
    ("--mode", "true_topk", "--error_type", "virtual",
     "--virtual_momentum", "0.9", "--local_momentum", "0.9"),
    ("--mode", "local_topk", "--error_type", "local",
     "--local_momentum", "0.9"),
    ("--mode", "fedavg", "--local_batch_size", "-1",
     "--fedavg_batch_size", "8", "--num_fedavg_epochs", "2"),
], ids=["sketch", "uncompressed", "true_topk", "local_topk", "fedavg"])
def test_cv_train_test_smoke_on_cpu(tmp_path, capsys, mode_flags):
    assert cv_train.main(_argv(tmp_path, *mode_flags))
    out = capsys.readouterr().out
    assert "train_loss" in out and "up (MiB)" in out


def test_train_loop_reports_finite_losses_and_bytes(tmp_path):
    cfg = parse_args(argv=_argv(tmp_path, "--mode", "sketch",
                                "--error_type", "virtual"))
    model, opt, sched, train_loader, val_loader = cv_train.build(
        cfg, device="cpu")
    w0 = model.ps_weights.clone()
    seen = []
    assert cv_train.train(model, opt, sched, train_loader, val_loader,
                          model.cfg, on_round=lambda i, out: seen.append(
                              (i, float(out[0].mean()), float(out[3].sum()))))
    assert len(seen) == train_loader.steps_per_epoch
    assert all(np.isfinite(loss) for _, loss, _ in seen)
    # upload: 4 clients x a 1 x 10 f32 table a round
    assert all(up == 4 * 10 * 4 for _, _, up in seen)
    assert not np.array_equal(model.ps_weights.numpy(), w0.numpy())


@pytest.mark.parametrize("flags,needle", [
    (("--debug_transfer_guard",), "--debug_transfer_guard"),
    (("--multihost",), "--multihost"),
    (("--model_parallel", "2"), "--model_parallel"),
    (("--plan_transport", "emulated"), "--plan_transport"),
])
def test_unported_options_are_refused_loudly(tmp_path, flags, needle):
    # every option is ported now (the last, --debug_transfer_guard, is
    # item 10f's guard): each parses and validates as the JAX package's
    # parse_args does, and Config refuses none for want of a port
    from commefficient_tpu.config import parse_args as j_parse_args
    argv = _argv(tmp_path, *flags)
    cfg = parse_args(argv=argv)
    jcfg = j_parse_args(argv=[a for a in argv
                              if a not in ("--device", "cpu")])
    assert (cfg.multihost, cfg.model_parallel, cfg.plan_transport,
            cfg.plan_controllers, cfg.debug_transfer_guard) == (
        jcfg.multihost, jcfg.model_parallel, jcfg.plan_transport,
        jcfg.plan_controllers, jcfg.debug_transfer_guard)
    assert (cfg.multihost or cfg.model_parallel == 2
            or cfg.plan_transport == "emulated" or cfg.debug_transfer_guard)
    assert not hasattr(Config, "_refuse_unported")
    try:
        parse_args(argv=argv)
    except NotImplementedError as e:
        assert needle in str(e)


@pytest.mark.parametrize("flags", [
    ("--scan_rounds", "--scan_span_palette", "2,1,4"),
    ("--update_screen", "norm", "--target_screened_rate", "0.1"),
    ("--async_admit_rounds", "1", "--speed_match"),
    ("--async_admit_rounds", "1", "--adapt_staleness"),
], ids=["scan_span_palette", "target_screened_rate", "speed_match",
        "adapt_staleness"])
def test_controller_options_parse_as_jax(tmp_path, flags):
    # item 9f's four flags parse into the same config as the JAX
    # package's parser gives, and validate
    from commefficient_tpu.config import parse_args as j_parse_args
    argv = _argv(tmp_path, *flags)
    cfg = parse_args(argv=argv)
    jcfg = j_parse_args(argv=[a for a in argv if a not in ("--device",
                                                            "cpu")])
    for name in ("target_screened_rate", "speed_match",
                 "scan_span_palette", "adapt_staleness",
                 "async_admit_rounds"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert cfg.span_palette == jcfg.span_palette
    assert cfg.adaptive_screen == jcfg.adaptive_screen
    from commefficient_tpu.control import make_bank as j_make_bank
    from commefficient_tpu_torch.control import make_bank
    bank, jbank = make_bank(cfg), j_make_bank(jcfg)
    assert (bank and bank.names) == (jbank and jbank.names)
    assert cfg.control_loop == jcfg.control_loop == (bank is not None)


@pytest.mark.parametrize("flags", [
    ("--checkpoint_every", "1"),
    ("--resume",),
    ("--trace",),
    ("--journal_path", "j.jsonl"),
    ("--profile",),
    ("--checkpoint", "--tensorboard"),
], ids=["checkpoint_every", "resume", "trace", "journal_path", "profile",
        "checkpoint-tensorboard"])
def test_item_6c_flags_are_accepted(tmp_path, flags):
    cfg = parse_args(argv=_argv(tmp_path, *flags))
    assert cfg.telemetry
    with pytest.raises(ValueError, match="--trace requires telemetry"):
        parse_args(argv=_argv(tmp_path, "--trace", "--no_telemetry"))


@pytest.mark.parametrize("flags", [
    ("--mode", "true_topk", "--error_type", "virtual"),
    ("--mode", "local_topk", "--error_type", "local"),
    ("--mode", "fedavg", "--local_batch_size", "-1"),
    ("--mode", "true_topk", "--error_type", "virtual",
     "--local_momentum", "0.9"),
    ("--mode", "uncompressed", "--topk_down", "--down_k", "7"),
    ("--model", "ResNet18", "--dataset_name", "CIFAR100"),
    ("--model", "FixupResNet18"),
    ("--model", "FixupResNet9"),
    ("--model", "FixupResNet50", "--dataset_name", "ImageNet", "--mode",
     "uncompressed", "--iid", "--num_clients", "7"),
    ("--model", "ResNet50", "--dataset_name", "ImageNet", "--iid",
     "--num_clients", "256"),
    ("--model", "ResNet34", "--dataset_name", "EMNIST"),
    ("--mode", "sketch", "--error_type", "virtual", "--dp",
     "--noise_multiplier", "0.1", "--max_grad_norm", "1.0"),
    ("--mode", "uncompressed", "--dp", "--dp_mode", "server"),
    ("--bf16",),
    ("--sketch_table_dtype", "int8"),
], ids=["true_topk", "local_topk", "fedavg", "local_momentum",
        "topk_down", "ResNet18", "FixupResNet18", "FixupResNet9",
        "FixupResNet50", "ResNet50", "ResNet34-EMNIST", "dp-max_grad_norm",
        "dp-server", "bf16", "int8-wire"])
def test_ported_options_build_a_fedmodel_on_cpu(tmp_path, flags):
    cfg = parse_args(argv=_argv(tmp_path, *flags))
    model, *_ = cv_train.build(cfg, device="cpu")
    assert model.cfg.mode == cfg.mode and model.cfg.model == cfg.model
    rows = model.clients
    for block, tracked in ((rows.errors, cfg.error_type == "local"),
                           (rows.velocities, cfg.local_momentum > 0),
                           (rows.weights, cfg.do_topk_down)):
        want = (model.num_clients, model.cfg.grad_size) if tracked else (0,)
        assert tuple(block.shape) == want
    if cfg.do_topk_down:
        assert torch.equal(rows.weights[3], model.ps_weights)
    assert (model.lr_scale_vec is not None) == cfg.model.startswith("Fixup")
    if cfg.dataset_name in ("ImageNet", "EMNIST"):
        # the dataset's classes reach the head, its image size the model
        module = model.module
        assert module.fc.out_features == {"ImageNet": 1000, "EMNIST": 62}[
            cfg.dataset_name]
        assert module.conv1.in_channels == (
            1 if cfg.dataset_name == "EMNIST" else 3)
        assert model.num_clients == (cfg.num_clients or 64)


@pytest.mark.parametrize("flags", [
    ("--mode", "sketch", "--error_type", "virtual", "--dp",
     "--noise_multiplier", "0.05", "--max_grad_norm", "1.0"),
    ("--mode", "uncompressed", "--dp", "--dp_mode", "server",
     "--noise_multiplier", "0.05"),
    ("--mode", "sketch", "--error_type", "virtual", "--bf16"),
    ("--mode", "sketch", "--error_type", "virtual",
     "--sketch_table_dtype", "int8"),
], ids=["dp-worker-max_grad_norm", "dp-server", "bf16", "int8-wire"])
def test_per_round_options_run_through_cv_train(tmp_path, flags):
    # item 6b's options end to end on the CPU, over a tenth of an epoch:
    # finite losses, the wire's bytes billed (int8: 1 x 10 cells of 1
    # byte plus one 4-byte row scale a client), bf16 reaching the eval
    # path too
    cfg = parse_args(argv=_argv(tmp_path, *flags, "--num_epochs", "0.1"))
    model, opt, sched, train_loader, val_loader = cv_train.build(
        cfg, device="cpu")
    ups = []
    assert cv_train.train(model, opt, sched, train_loader, val_loader,
                          model.cfg, on_round=lambda i, out: ups.append(
                              (float(out[0].mean()), float(out[3].sum()))))
    assert ups and all(np.isfinite(loss) for loss, _ in ups)
    if cfg.sketch_table_dtype == "int8":
        assert all(up == 4 * (10 * 1 + 4) for _, up in ups)
    # the eval path computes in the train round's type
    seen = []
    handle = model.module.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    model.train(False)
    loss, *_ = model(next(val_loader.batches()))
    handle.remove()
    assert np.isfinite(loss).all()
    want = torch.bfloat16 if cfg.do_bf16 else torch.float32
    assert seen and all(d == want for d in seen)


@pytest.mark.parametrize("flags", [
    ("--dataset_name", "ImageNet", "--iid", "--num_clients", "256"),
    ("--dataset_name", "ImageNet", "--num_clients", "32"),
    ("--dataset_name", "EMNIST"),
    ("--dataset_name", "CIFAR10", "--num_clients", "100"),
], ids=["ImageNet-iid", "ImageNet", "EMNIST", "CIFAR10"])
def test_num_clients_resolve_as_in_jax(flags):
    from commefficient_tpu.config import parse_args as j_parse_args
    argv = ["--test", "--local_momentum", "0", *flags]
    jcfg, tcfg = j_parse_args(argv=argv), parse_args(argv=argv)
    assert tcfg.do_iid == jcfg.do_iid
    for n in (None, 16):
        assert tcfg.resolved_num_clients(n) == jcfg.resolved_num_clients(n)


@pytest.mark.parametrize("name", ["FixupResNet18", "FixupResNet9"])
def test_fixup_lr_scales_match_jax(name):
    # the same 0.1 / 1.0 vector over the same flat layout
    import jax
    import jax.numpy as jnp
    from commefficient_tpu.models import build_model as j_build_model
    from commefficient_tpu.training.cv_train import _fixup_lr_scales
    from commefficient_tpu_torch.models import build_model
    jm = j_build_model(name, num_classes=10)
    params = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3), jnp.float32)))
    want = _fixup_lr_scales(params)
    got = cv_train.fixup_lr_scales(build_model(name, num_classes=10))
    np.testing.assert_array_equal(got, want)
    assert 0 < (got == 0.1).sum() < got.size


def test_reference_invariants_still_raise_value_error():
    with pytest.raises(ValueError, match="local momentum"):
        Config(mode="sketch", local_momentum=0.9).validate()


def test_entry_points_default_to_cuda_and_raise_without_it():
    import torch
    assert Config().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    # a fresh interpreter imports every module of the port (walking the
    # package; the plugins, the span loop, the writer threads, the
    # controllers, the analysis tiers and the journal summary named),
    # runs one round of cv_train's model with the fault operands on, one
    # powersgd and one dp_sketch round and a pipelined span, then checks
    # sys.modules (the resume is held by tests/test_torch_checkpoint.py)
    code = r"""
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import commefficient_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from commefficient_tpu_torch.config import parse_args
from commefficient_tpu_torch.training import cv_train
cfg = parse_args(argv=["--test", "--device", "cpu", "--mode", "sketch",
                       "--error_type", "virtual", "--local_momentum", "0",
                       "--num_workers", "4", "--local_batch_size", "8",
                       "--client_dropout", "0.25", "--update_screen",
                       "finite", "--dataset_dir", "ds"])
model, opt, sched, loader, _ = cv_train.build(cfg, device="cpu",
                                              synthetic_examples=(64, 8))
opt.param_groups[0]["lr"] = 0.1
out = model(next(iter(loader.epoch())))
assert torch.isfinite(out[0]).all()
for flags in (["--mode", "powersgd", "--error_type", "local"],
              ["--mode", "dp_sketch", "--error_type", "virtual",
               "--dp_noise_mult", "0.5", "--scan_rounds", "--pipeline"]):
    cfg = parse_args(argv=["--test", "--device", "cpu", "--local_momentum",
                           "0", "--num_workers", "4", "--local_batch_size",
                           "8", "--dataset_dir", "ds", *flags])
    model, opt, sched, loader, _ = cv_train.build(cfg, device="cpu",
                                                  synthetic_examples=(64, 8))
    it = iter(loader.epoch())
    if cfg.scan_rounds:
        from commefficient_tpu_torch.training.scanloop import (
            run_scanned_rounds)
        stream = [(i, *next(it), 0.1) for i in range(2)]
        assert run_scanned_rounds(model, iter(stream), 1,
                                  lambda t, l, a: bool(torch.isfinite(
                                      torch.as_tensor(l)).all()),
                                  pipeline=True)
        model.close_persistence()
    else:
        opt.param_groups[0]["lr"] = 0.1
        assert torch.isfinite(model(next(it))[0]).all()
for name in ("compress.powersgd", "compress.dp_sketch", "compress.privacy",
             "training.scanloop", "utils.retry", "utils.watchdog",
             "control.base", "control.screen", "control.speed",
             "control.span", "control.staleness", "parallel.mesh",
             "parallel.multihost", "parallel.tp", "parallel.mh_worker",
             "analysis", "analysis.domains", "analysis.engine",
             "analysis.rules", "analysis.syncaudit", "analysis.runtime",
             "analysis.__main__", "analysis.recorder",
             "analysis.costmodel", "analysis.audit", "analysis.numaudit",
             "analysis.shardaudit", "telemetry.journal_summary",
             "hooks"):
    assert "commefficient_tpu_torch." + name in sys.modules, name
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n == "commefficient_tpu" or n.startswith("commefficient_tpu."))
print("BAD", bad)
print("N", sum(1 for n in sys.modules if n.startswith("commefficient_tpu_torch")))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("N ")[1].split()[0])
    assert n >= 20


def test_data_pipeline_matches_jax(tmp_path):
    # the same numpy draws in the same order: synthetic corpus, client
    # partition, sampler rounds and augmented batches are identical
    from commefficient_tpu.data import FedCIFAR10 as JCIFAR, FedLoader as JLoader
    from commefficient_tpu.data import transforms as jtransforms
    from commefficient_tpu.data.cifar import _synthetic_cifar as j_synth
    from commefficient_tpu_torch.data import FedCIFAR10, FedLoader, transforms
    from commefficient_tpu_torch.data.cifar import _synthetic_cifar

    for a, b in zip(j_synth(10, 300, 50, 3), _synthetic_cifar(10, 300, 50, 3)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    kw = dict(num_clients=20, synthetic_examples=(400, 40), seed=5)
    jset = JCIFAR(str(tmp_path / "j"),
                  transform=jtransforms.cifar10_transforms(5)[0], **kw)
    tset = FedCIFAR10(str(tmp_path / "t"),
                      transform=transforms.cifar10_transforms(5)[0], **kw)
    np.testing.assert_array_equal(tset.data_per_client, jset.data_per_client)
    jl, tl = JLoader(jset, 4, 8, seed=5), FedLoader(tset, 4, 8, seed=5)
    assert tl.steps_per_epoch == jl.steps_per_epoch
    jrounds, trounds = list(jl.epoch()), list(tl.epoch())
    assert len(trounds) == len(jrounds) > 0
    for (jid, jd, jm), (tid, td, tm) in zip(jrounds, trounds):
        np.testing.assert_array_equal(tid, jid)
        np.testing.assert_array_equal(tm, jm)
        for a, b in zip(jd, td):
            np.testing.assert_array_equal(b, a)
