"""The implicit-sync guard behind --debug_transfer_guard, the program
counter and the round recorder (analysis/runtime.py, analysis/
recorder.py), on the CPU: the guard raises on an implicit read and lets
an explicit one pass, a guarded cv_train run is bitwise its unguarded
twin, three round variants dispatch three programs, the recorder sees
each kernel as one entry."""
import os

import numpy as np
import pytest
import torch

from commefficient_tpu_torch import hooks
from commefficient_tpu_torch.analysis import audit, recorder, runtime
from commefficient_tpu_torch.config import parse_args
from commefficient_tpu_torch.training import cv_train, gpt2_train

pytestmark = pytest.mark.torch_port

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _flags(tmp_path, *extra):
    return ["--test", "--device", "cpu", "--mode", "sketch", "--error_type",
            "virtual", "--virtual_momentum", "0.9", "--local_momentum", "0",
            "--num_workers", "4", "--local_batch_size", "8",
            "--dataset_dir", str(tmp_path / "ds"), *extra]


@pytest.mark.parametrize("read", [
    lambda x: x.sum().item(), lambda x: float(x.sum()),
    lambda x: bool(x.any()), lambda x: int(x.argmax()),
    lambda x: x[x > 0.5], lambda x: torch.nonzero(x),
    lambda x: torch.unique(x),
], ids=["item", "float", "bool", "int", "mask_index", "nonzero", "unique"])
def test_guard_raises_on_implicit_reads_and_passes_explicit_ones(read):
    x = torch.rand(8)
    with runtime.forbid_transfers("cpu") as guard:
        with pytest.raises(runtime.TransferGuardError,
                           match="implicit device-to-host sync"):
            read(x)
        with runtime.explicit_transfer("a test's boundary"):
            read(x)
        x * 2 + 1                       # device work passes
    assert guard.explicit == {"a test's boundary": 1}
    read(x)                             # disarmed: nothing raises


def test_guard_names_the_op_and_frame_and_skips_kernel_regions():
    x = torch.rand(4)
    with runtime.forbid_transfers("cpu"):
        with pytest.raises(runtime.TransferGuardError,
                           match=r"_local_scalar_dense.*test_torch_guard"):
            x.max().item()
        with hooks.kernel_region("k", x.device, (x.shape,), 0, 0):
            x.min().item()              # a plain version's host read
        # a card wrapper's body stays under the guard
        with hooks.kernel_region("k", "cuda", (x.shape,), 0, 0):
            with pytest.raises(runtime.TransferGuardError):
                x.min().item()


def test_sync_kind_reads_the_card_copies():
    cuda = (((4,), "float32", "cuda"),)
    assert runtime.sync_kind("_to_copy.default", cuda, (), {"device": "cpu"},
                             "cuda") == "device-to-host copy"
    assert runtime.sync_kind("_to_copy.default", cuda, (),
                             {"device": "cpu", "non_blocking": True},
                             "cuda") is None
    assert runtime.sync_kind("_local_scalar_dense.default",
                             (((), "float32", "cpu"),), (), {},
                             "cuda") is None   # a host tensor's read
    assert runtime.sync_kind("repeat_interleave.Tensor", cuda, (),
                             {"output_size": 8}, "cuda") is None


def _weights_and_bytes(flags):
    cfg = parse_args(argv=flags)
    model, opt, sched, loader, val = cv_train.build(
        cfg, device="cpu", synthetic_examples=(128, 8))
    bytes_ = []
    ok = cv_train.train(model, opt, sched, loader, val, model.cfg,
                        on_round=lambda i, out: bytes_.append(
                            (np.asarray(out[-2]).tolist(),
                             np.asarray(out[-1]).tolist())))
    assert ok
    return model.ps_weights.clone(), bytes_, model.accountant.state_dict()


@pytest.mark.parametrize("extra", [(), ("--scan_rounds", "--scan_span", "2")],
                         ids=["rounds", "spans"])
def test_guarded_cv_train_is_bitwise_its_unguarded_twin(tmp_path, extra,
                                                        monkeypatch):
    made = []
    orig = runtime.forbid_transfers

    def counting(device="cuda"):
        g = orig(device)
        made.append(g)
        return g

    monkeypatch.setattr(runtime, "forbid_transfers", counting)
    flags = _flags(tmp_path, "--num_epochs", "1", *extra)
    w_g, b_g, a_g = _weights_and_bytes(flags + ["--debug_transfer_guard"])
    guarded = len(made)
    w_t, b_t, a_t = _weights_and_bytes(flags)
    # 4 rounds: 3 guarded, or spans of 2: the second span guarded; the
    # twin arms none
    assert guarded == (1 if extra else 3) and len(made) == guarded
    assert torch.equal(w_g, w_t) and b_g == b_t
    assert sorted(a_g) == sorted(a_t) and all(
        np.array_equal(np.asarray(a_g[k]), np.asarray(a_t[k])) for k in a_t)


def test_gpt2_driver_runs_guarded(tmp_path, monkeypatch):
    made = []
    orig = runtime.forbid_transfers
    monkeypatch.setattr(runtime, "forbid_transfers",
                        lambda *a, **k: made.append(orig(*a, **k))
                        or made[-1])
    monkeypatch.chdir(tmp_path)
    assert gpt2_train.main([
        "--test", "--device", "cpu", "--dataset_name", "PERSONA",
        "--dataset_dir", str(tmp_path / "ds"), "--mode", "sketch",
        "--error_type", "virtual", "--virtual_momentum", "0.9",
        "--local_momentum", "0", "--num_workers", "4",
        "--local_batch_size", "2", "--num_epochs", "0.3",
        "--debug_transfer_guard"])
    assert made


def test_three_variants_are_three_programs():
    cfg = dict(audit.audit_configs())["sketch-cuda"]
    train_round, server, clients, variants, lr, key = audit.build_workload(
        cfg)
    with runtime.assert_program_count(3) as c:
        for name in audit.PROGRAM_VARIANTS:
            for _ in range(2):
                server, clients, _m = train_round(server, clients,
                                                  variants[name], lr, key)
    assert c.rounds == 6 and c.builds == 0


def test_a_shape_drift_is_a_fourth_program():
    cfg = dict(audit.audit_configs())["sketch-cuda"]
    train_round, server, clients, variants, lr, key = audit.build_workload(
        cfg)
    batch = variants["mask_free"]
    short = batch._replace(data=tuple(d[:, :3] for d in batch.data),
                           mask=batch.mask[:, :3])
    with pytest.raises(AssertionError, match="observed 2"):
        with runtime.assert_program_count(1):
            train_round(server, clients, batch, lr, key)
            train_round(server, clients, short, lr, key)


def test_recorder_sees_each_kernel_once_with_its_bound():
    cfg = dict(audit.audit_configs())["sketch-cuda"]
    rec = audit.record_round(cfg, "mask_free")
    kernels = rec.kernels()
    assert audit.AUDIT_GEOMETRY["D"] == 1024
    assert [k.name for k in kernels] == ["sketch_encode",
                                        "sketch_estimate_all"]
    # d = 1024 into r = 3 rows of c = 256, B = 4 chunks. K1 reads x (4096
    # bytes), off [3, 4] (48), the sign bits of eps [3, 256] (24 words,
    # 96) and of delta [3, 4] (1 word, 4), writes the table (3072):
    # 7316 bytes; 3 operations a row and coordinate: 9216. K2 reads the
    # table, off and both sign tables (3220), writes the [4, 256]
    # estimate (4096): 7316 bytes; 14 operations an estimate (6 sign
    # flips, 3 compare-exchanges of 2, the middle's 2): 14336
    assert [(k.shapes, k.bytes, k.flops) for k in kernels] == [
        (((1024,), (3, 4)), 7316, 9216), (((3, 256), (3, 4)), 7316, 14336)]
    # the plain versions' ops stay out of the tally: no roll of a row
    assert not any(r.op.startswith("roll") for r in rec.ops())
    # sketch-cuda tracks no client rows: its scatter dispatches nothing
    assert {r.stage for r in rec.records} == {"gather", "round"}
    assert rec.names and all(n.startswith(("server.", "clients.", "batch."))
                             for n in rec.names.values())


def test_recorder_counts_other_threads_ops():
    import threading
    with recorder.RoundRecorder(count_foreign=True) as rec:
        t = threading.Thread(target=lambda: torch.ones(3) + 1,
                             name="foreign-ops")
        t.start()
        t.join()
        torch.ones(2) * 2
    assert [r.op for r in rec.ops()] == ["ones.default", "mul.Tensor"]
    if rec.foreign_ops is not None:
        assert rec.foreign_ops >= 2
