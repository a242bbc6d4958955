"""Checkpoints and --profile on a CUDA card: a checkpoint written from
the card's tensors loads bitwise on the CPU and back, and `--profile`
writes a Chrome trace holding CUDA kernels. The cases carry the `gpu`
marker and skip without a card; on the card: `python -m pytest
tests/test_torch_checkpoint_gpu.py -m gpu --noconftest` (this file
imports no jax; tests/conftest.py does)."""
import glob
import json

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.config import parse_args
from commefficient_tpu_torch.training import cv_train
from commefficient_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_rotating,
)

pytestmark = pytest.mark.torch_port


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the card half of the checkpoint "
                    "round trip; the CPU half is tests/test_torch_checkpoint"
                    ".py)")
    return torch.device("cuda")


def _argv(tmp_path, device, *extra):
    return ["--test", "--device", device, "--mode", "local_topk",
            "--error_type", "local", "--local_momentum", "0.9",
            "--num_workers", "4", "--local_batch_size", "8",
            "--num_epochs", "0.05", "--dataset_dir", str(tmp_path / "ds"),
            *extra]


def _build(tmp_path, device):
    cfg = parse_args(argv=_argv(tmp_path, device))
    return cv_train.build(cfg, device=device)


def _state_kwargs(model):
    return dict(scheduler_step=3, accountant=model.accountant,
                prev_change_words=model._prev_change_words,
                fingerprint=model.checkpoint_fingerprint,
                throughput=model.throughput.state_dict(),
                sampler=model.sampler_state(),
                client_rows=model.client_rows_payload())


def _assert_same_state(a, b):
    for x, y in zip(a.server[:3], b.server[:3]):
        assert torch.equal(x.cpu(), y.cpu())
    assert a.server.round_idx == b.server.round_idx
    for x, y in zip(a.clients, b.clients):
        assert torch.equal(x.cpu(), y.cpu())
    assert np.array_equal(a._prev_change_words, b._prev_change_words)


@pytest.mark.gpu
def test_card_checkpoint_loads_bitwise_on_the_cpu_and_back(cuda_device,
                                                           tmp_path):
    card, opt, sched, loader, _ = _build(tmp_path, "cuda")
    opt.param_groups[0]["lr"] = 0.1
    for _, batch in zip(range(3), loader.epoch()):
        card(batch)
    path = save_rotating(str(tmp_path / "card" / "ResNet9"), card.server,
                         card.clients, **_state_kwargs(card))
    cpu, *_ = _build(tmp_path, "cpu")
    assert cpu.load_state(load_checkpoint(path)) == 3
    _assert_same_state(card, cpu)
    back_path = save_rotating(str(tmp_path / "cpu" / "ResNet9"), cpu.server,
                              cpu.clients, **_state_kwargs(cpu))
    back, *_ = _build(tmp_path, "cuda")
    back.load_state(load_checkpoint(back_path))
    assert back.server.ps_weights.is_cuda
    _assert_same_state(card, back)
    with np.load(path) as za, np.load(back_path) as zb:
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.gpu
def test_profile_writes_a_trace_with_cuda_kernels(cuda_device, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cv_train.main(_argv(tmp_path, "cuda", "--profile"))
    (trace,) = glob.glob(str(tmp_path / "runs" / "**" / "profile"
                             / "trace.json"), recursive=True)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels, "the profile holds no CUDA kernel"
