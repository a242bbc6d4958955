"""The port's checkpoint format (commefficient_tpu_torch/utils/
checkpoint.py): the format cases of tests/test_checkpoint.py on the
port's module, checkpoints cross-loaded both ways between the packages
(the next round held to test_fedmodel_rounds_match_jax's limits: weights
within 1e-5 of scale, byte totals identical; the carried state bitwise),
and the port's own resume through cv_train.main and gpt2_train.main
bitwise equal to the uninterrupted run."""
import glob
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.data.sampler import FedSampler as JFedSampler
from commefficient_tpu.federated.api import (
    FedModel as JFedModel, FedOptimizer as JFedOptimizer,
)
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9
from commefficient_tpu.training.cv_train import (
    make_compute_loss as j_make_compute_loss,
)
from commefficient_tpu.utils import checkpoint as jck
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.data.loader import FedLoader
from commefficient_tpu_torch.data.sampler import FedSampler
from commefficient_tpu_torch.federated.api import (
    FedModel as TFedModel, FedOptimizer as TFedOptimizer,
)
from commefficient_tpu_torch.federated.round import ClientState, ServerState
from commefficient_tpu_torch.models import build_model
from commefficient_tpu_torch.models.convert import from_jax_params
from commefficient_tpu_torch.training import cv_train, gpt2_train
from commefficient_tpu_torch.training.cv_train import (
    make_compute_loss as t_make_compute_loss,
)
from commefficient_tpu_torch.utils import checkpoint as tck
from commefficient_tpu_torch.utils.checkpoint import (
    CheckpointMismatchError, config_fingerprint, latest_checkpoint_path,
    load_checkpoint, load_latest, load_resilient, save_checkpoint,
    save_final, save_rotating,
)

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

D = 8


def _server(round_idx=0, fill=1.0):
    return ServerState(torch.full((D,), fill), torch.zeros(D),
                       torch.zeros(D), round_idx)


def _cfg(**kw):
    base = dict(mode="uncompressed", grad_size=D, num_workers=8,
                local_momentum=0.0, virtual_momentum=0.0,
                error_type="none", num_clients=8)
    base.update(kw)
    return TConfig(**base)


def _stamped(d, prefix="run"):
    return sorted(f for f in os.listdir(d)
                  if f.startswith(prefix + "-r") and f.endswith(".npz"))


# ---------------- tests/test_checkpoint.py's format cases -------------------

def test_save_is_atomic_no_tmp_left(tmp_path):
    path = save_checkpoint(str(tmp_path / "ck"), _server())
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    with np.load(path) as z:
        assert z["round_idx"].dtype == np.int32


def test_truncated_tmp_does_not_corrupt_previous(tmp_path):
    path = save_checkpoint(str(tmp_path / "ck"), _server(3, 7.0))
    with open(path + ".tmp", "wb") as f:
        f.write(b"PK\x03\x04 truncated npz junk")
    ckpt = load_checkpoint(path)
    assert ckpt.server.round_idx == 3
    np.testing.assert_array_equal(ckpt.server.ps_weights.numpy(), 7.0)
    save_checkpoint(str(tmp_path / "ck"), _server(4, 9.0))
    assert load_checkpoint(path).server.round_idx == 4
    assert not os.path.exists(path + ".tmp")


def test_rotation_keeps_last_k_and_manifest(tmp_path):
    prefix = str(tmp_path / "run")
    for r in range(5):
        save_rotating(prefix, _server(r, float(r)), keep_last=3)
    assert _stamped(tmp_path) == ["run-r00000002.npz", "run-r00000003.npz",
                                  "run-r00000004.npz"]
    with open(prefix + ".latest") as f:
        manifest = json.load(f)
    assert manifest["latest"] == "run-r00000004.npz"
    assert manifest["history"] == ["run-r00000004.npz",
                                   "run-r00000003.npz",
                                   "run-r00000002.npz"]
    assert set(manifest["checksums"]) == set(manifest["history"])
    assert all(manifest["finite"].values())
    ckpt = load_latest(prefix)
    assert ckpt.server.round_idx == 4
    np.testing.assert_array_equal(ckpt.server.ps_weights.numpy(), 4.0)


def test_load_latest_survives_lost_manifest(tmp_path):
    prefix = str(tmp_path / "run")
    for r in (1, 2):
        save_rotating(prefix, _server(r, float(r)))
    os.remove(prefix + ".latest")
    assert latest_checkpoint_path(prefix).endswith("run-r00000002.npz")
    assert load_latest(prefix).server.round_idx == 2


def test_rotation_prunes_orphans_after_lost_manifest(tmp_path):
    prefix = str(tmp_path / "run")
    for r in range(3):
        save_rotating(prefix, _server(r), keep_last=2)
    os.remove(prefix + ".latest")
    save_rotating(prefix, _server(3), keep_last=2)
    assert _stamped(tmp_path) == ["run-r00000003.npz"]


def test_rotation_prunes_abandoned_higher_round_timeline(tmp_path):
    prefix = str(tmp_path / "run")
    for r in (8, 9, 10):
        save_rotating(prefix, _server(r), keep_last=3)
    save_rotating(prefix, _server(1, 5.0), keep_last=3)
    assert _stamped(tmp_path) == ["run-r00000001.npz"]
    os.remove(prefix + ".latest")
    assert load_latest(prefix).server.round_idx == 1


def test_save_final_fixed_name_and_manifest_agree(tmp_path):
    prefix = str(tmp_path / "fin")
    save_rotating(prefix, _server(2, 1.0), keep_last=2)
    path = save_final(prefix, _server(5, 2.0), keep_last=2)
    assert path == prefix + ".npz"
    assert load_checkpoint(path).server.round_idx == 5
    resumed = load_latest(prefix)
    assert resumed.server.round_idx == 5
    np.testing.assert_array_equal(resumed.server.ps_weights.numpy(), 2.0)


def _backdate(d, basename, hours):
    past = time.time() - hours * 3600.0
    os.utime(os.path.join(d, basename), (past, past))


def test_age_pruning_removes_backdated_stamps(tmp_path):
    prefix = str(tmp_path / "run")
    for r in range(3):
        save_rotating(prefix, _server(r), keep_last=5)
    _backdate(tmp_path, "run-r00000000.npz", 10)
    _backdate(tmp_path, "run-r00000001.npz", 10)
    save_rotating(prefix, _server(3), keep_last=5, max_age_hours=1.0)
    assert _stamped(tmp_path) == ["run-r00000002.npz", "run-r00000003.npz"]
    with open(prefix + ".latest") as f:
        manifest = json.load(f)
    assert manifest["history"] == ["run-r00000003.npz",
                                   "run-r00000002.npz"]


def test_age_pruning_never_dangles_latest(tmp_path):
    prefix = str(tmp_path / "run")
    save_rotating(prefix, _server(0), keep_last=3)
    _backdate(tmp_path, "run-r00000000.npz", 100)
    save_rotating(prefix, _server(1, 4.0), keep_last=3, max_age_hours=1e-9)
    with open(prefix + ".latest") as f:
        manifest = json.load(f)
    assert manifest["history"] == ["run-r00000001.npz"]
    np.testing.assert_array_equal(
        load_latest(prefix).server.ps_weights.numpy(), 4.0)


def test_age_pruning_off_by_default(tmp_path):
    prefix = str(tmp_path / "run")
    save_rotating(prefix, _server(0), keep_last=3)
    _backdate(tmp_path, "run-r00000000.npz", 1000)
    save_rotating(prefix, _server(1), keep_last=3)
    assert _stamped(tmp_path) == ["run-r00000000.npz", "run-r00000001.npz"]


def test_save_final_forwards_age_pruning(tmp_path):
    prefix = str(tmp_path / "fin")
    save_rotating(prefix, _server(0), keep_last=5)
    _backdate(tmp_path, "fin-r00000000.npz", 10)
    save_final(prefix, _server(2, 2.0), keep_last=5, max_age_hours=1.0)
    assert _stamped(tmp_path, "fin") == ["fin-r00000002.npz"]


def test_load_latest_legacy_fixed_name_fallback(tmp_path):
    prefix = str(tmp_path / "legacy")
    save_checkpoint(prefix, _server(9))
    assert load_latest(prefix).server.round_idx == 9
    assert load_latest(str(tmp_path / "absent")) is None


def test_fingerprint_roundtrip_and_mismatch(tmp_path):
    fp = config_fingerprint(_cfg(mode="sketch", error_type="virtual"), 8)
    path = save_checkpoint(str(tmp_path / "fp"), _server(), fingerprint=fp)
    assert load_checkpoint(path, expect_fingerprint=fp).fingerprint[
        "mode"] == "sketch"
    other = config_fingerprint(_cfg(mode="fedavg"), 8)
    with pytest.raises(CheckpointMismatchError) as exc:
        load_checkpoint(path, expect_fingerprint=other)
    assert exc.value.field == "mode"
    # a fingerprint-less file of another model size names grad_size
    old = save_checkpoint(str(tmp_path / "old"), _server())
    with pytest.raises(CheckpointMismatchError) as exc:
        load_checkpoint(old, expect_fingerprint=config_fingerprint(
            _cfg(grad_size=12345), 8))
    assert exc.value.field == "grad_size" and "12345" in str(exc.value)


def test_fed_model_load_state_rejects_mismatch(tmp_path):
    class Linear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(D))

    model = TFedModel(Linear(), None, _cfg(device="cpu"), device="cpu")
    path = save_checkpoint(str(tmp_path / "wrong"), _server(),
                           fingerprint=config_fingerprint(
                               _cfg(mode="fedavg"), 8))
    with pytest.raises(CheckpointMismatchError) as exc:
        model.load_state(load_checkpoint(path))
    assert exc.value.field == "mode"


def test_client_state_roundtrips_through_rotation(tmp_path):
    clients = ClientState(torch.arange(2 * D, dtype=torch.float32)
                          .reshape(2, D), torch.full((2, D), 3.5),
                          torch.zeros(0))
    prefix = str(tmp_path / "cs")
    save_rotating(prefix, _server(2), clients)
    out = load_latest(prefix)
    assert torch.equal(out.clients.errors, clients.errors)
    assert torch.equal(out.clients.velocities, clients.velocities)


def test_load_resilient_falls_back_past_a_corrupt_newest(tmp_path):
    prefix = str(tmp_path / "run")
    for r in range(3):
        save_rotating(prefix, _server(r, float(r)), keep_last=3)
    newest = prefix + "-r00000002.npz"
    with open(newest, "r+b") as f:       # flip bytes inside the archive
        f.seek(200)
        f.write(b"\xff" * 16)
    seen = []
    path, ckpt = load_resilient(prefix, on_fallback=lambda p, why:
                                seen.append(p))
    assert path.endswith("run-r00000001.npz") and seen == [newest]
    assert ckpt.server.round_idx == 1
    # require_finite walks past a file the manifest records non-finite
    save_rotating(prefix, _server(3, float("nan")), keep_last=4)
    path, ckpt = load_resilient(prefix, require_finite=True)
    assert ckpt.server.round_idx == 1
    with open(prefix + ".latest") as f:
        assert json.load(f)["finite"]["run-r00000003.npz"] is False
    # a fingerprint mismatch is not corruption: it raises
    save_rotating(prefix, _server(4), fingerprint=config_fingerprint(
        _cfg(mode="fedavg"), 8))
    with pytest.raises(CheckpointMismatchError):
        load_resilient(prefix, expect_fingerprint=config_fingerprint(
            _cfg(), 8))


def test_write_failure_on_a_full_disk_names_the_checkpoint(tmp_path,
                                                           monkeypatch):
    import errno

    def full(*a, **k):
        raise OSError(errno.ENOSPC, "No space left on device")
    monkeypatch.setattr(tck.np, "savez", full)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(str(tmp_path / "ck"), _server())


# ---------------- cross-loading between the packages ------------------------

TINY = {"prep": 4, "layer1": 8, "layer2": 8, "layer3": 16}
CROSS = {
    "sketch-virtual": dict(mode="sketch", error_type="virtual",
                           virtual_momentum=0.9, k=300, num_rows=5,
                           num_cols=700),
    "true_topk-local_momentum": dict(mode="true_topk", error_type="virtual",
                                     virtual_momentum=0.9, k=300,
                                     local_momentum=0.9),
    "local_topk-local_error": dict(mode="local_topk", error_type="local",
                                   local_momentum=0.9, k=300),
    "uncompressed-topk_down": dict(mode="uncompressed",
                                   virtual_momentum=0.9, do_topk_down=True,
                                   down_k=500),
    "sketch-dp-max_grad_norm": dict(mode="sketch", error_type="virtual",
                                    virtual_momentum=0.9, k=300, num_rows=5,
                                    num_cols=700, do_dp=True,
                                    noise_multiplier=0.01,
                                    max_grad_norm=1.0),
}
# keys the carried state must keep bit for bit across the packages
CARRIED = ("thr_", "smp_", "acct_")


def _batches(n, seed=7):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.choice(12, 4, replace=False).astype(np.int32)
        x = rng.randn(4, 6, 32, 32, 3).astype(np.float32)
        y = rng.randint(0, 10, size=(4, 6)).astype(np.int32)
        mask = np.ones((4, 6), np.float32)
        mask[0, -2:] = 0.0
        out.append((ids, (x, y), mask))
    return out


def _make(pkg, case, params, **extra):
    kw = {**dict(local_momentum=0.0, num_workers=4, num_clients=12,
                 local_batch_size=6), **CROSS[case], **extra}
    if pkg == "jax":
        jm = JResNet9(num_classes=10, channels=TINY)
        model = JFedModel(None, j_make_compute_loss(jm), JConfig(**kw),
                          params=params, num_clients=12)
        opt = JFedOptimizer(model)
        sampler = JFedSampler(np.full(12, 6), 4, 6, seed=1)
    else:
        tm = build_model("ResNet9", channels=TINY)
        from_jax_params(tm, params)
        model = TFedModel(tm, t_make_compute_loss(tm),
                          TConfig(**kw, device="cpu"), device="cpu",
                          num_clients=12)
        opt = TFedOptimizer(model)
        sampler = FedSampler(np.full(12, 6), 4, 6, seed=1)
    opt.param_groups[0]["lr"] = 0.1
    model.attach_data_sampler(sampler)
    return model, sampler


def _save_kwargs(model):
    return dict(scheduler_step=2, accountant=model.accountant,
                prev_change_words=model._prev_change_words,
                fingerprint=model.checkpoint_fingerprint,
                throughput=model.throughput.state_dict(),
                sampler=model.sampler_state(),
                client_rows=model.client_rows_payload())


def _round(model, batch):
    _, _, d, u = model(batch)
    return np.asarray(model.ps_weights), float(np.sum(d)), float(np.sum(u))


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("case", sorted(CROSS))
def test_checkpoints_cross_load_both_ways(tmp_path, case, direction):
    # package P runs 2 rounds and saves with save_rotating; package Q
    # loads with load_resilient + load_state, writes it back (the
    # carried state bitwise P's), and runs round 3 from the same batch
    # as P's own round 3
    jm = JResNet9(num_classes=10, channels=TINY)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((2, 32, 32, 3), jnp.float32))
    P, Q = direction.split("-to-")
    save_p, load_q, save_q, load_p = (
        (jck.save_rotating, tck.load_resilient, tck.save_rotating,
         jck.load_checkpoint) if P == "jax" else
        (tck.save_rotating, jck.load_resilient, jck.save_rotating,
         tck.load_checkpoint))
    p_model, p_sampler = _make(P, case, params)
    batches = _batches(3)
    for batch in batches[:2]:
        p_model(batch)
    # the sampler and the throughput tracker have state to carry
    list(zip(range(2), p_sampler.epoch()))
    p_model.throughput.update_round(batches[0][0], [6, 6, 6, 4], 0.25)
    prefix = str(tmp_path / "p" / "ResNet9")
    written = save_p(prefix, p_model.server, p_model.clients,
                     **_save_kwargs(p_model))

    q_model, _ = _make(Q, case, params)
    path, ckpt = load_q(prefix, expect_fingerprint=q_model
                        .checkpoint_fingerprint)
    assert path == written
    assert q_model.load_state(ckpt) == 2
    rewritten = save_q(str(tmp_path / "q" / "ResNet9"), q_model.server,
                       q_model.clients, **_save_kwargs(q_model))
    with np.load(written) as zp, np.load(rewritten) as zq:
        assert sorted(zp.files) == sorted(zq.files)
        for k in zp.files:
            assert zp[k].dtype == zq[k].dtype, k
            np.testing.assert_array_equal(zq[k], zp[k], err_msg=k)
        assert any(k.startswith(c) for k in zp.files for c in CARRIED)
    assert load_p(rewritten).server.round_idx == 2

    pw, pd, pu = _round(p_model, batches[2])
    qw, qd, qu = _round(q_model, batches[2])
    np.testing.assert_allclose(qw, pw, rtol=0, atol=1e-5 * np.abs(pw).max())
    assert (qd, qu) == (pd, pu) and qd > 0 and qu > 0


def test_dense_client_blocks_turn_sparse_saves_off(tmp_path):
    # a legacy dense save loses the touched-row set: the loading model's
    # own saves fall back to the dense blocks
    jm = JResNet9(num_classes=10, channels=TINY)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((2, 32, 32, 3), jnp.float32))
    p_model, _ = _make("port", "local_topk-local_error", params)
    p_model(_batches(1)[0])
    path = save_checkpoint(str(tmp_path / "dense"), p_model.server,
                           p_model.clients)
    q_model, _ = _make("port", "local_topk-local_error", params)
    q_model.load_state(load_checkpoint(path))
    assert q_model.client_rows_payload() is None
    assert torch.equal(q_model.clients.errors, p_model.clients.errors)


def test_unported_scheduler_state_is_refused(tmp_path):
    # (the name is the refusal this test held until the controllers were
    # ported) the scheduler's counters, the adaptive screen's screen_*
    # keys and the controller bank's ctl_* keys, all under sched_*, load
    # into the other package's scheduler and controllers, both ways, and
    # come back out bitwise
    from commefficient_tpu.scheduler import RoundScheduler as JSched
    from commefficient_tpu_torch.scheduler import RoundScheduler as TSched
    jm = JResNet9(num_classes=10, channels=TINY)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((2, 32, 32, 3), jnp.float32))
    ctl = dict(update_screen="norm", target_screened_rate=0.1,
               speed_match=True, adapt_staleness=True,
               async_admit_rounds=1)
    counters = dict(rounds_scheduled=np.int64(3), clients_sampled=np.int64(
        12), deadline_rounds=np.int64(1), truncated_slots=np.int64(2),
        last_deadline_s=np.float64(0.5), rounds_committed=np.int64(3))
    models = {}
    for pkg, sched_cls in (("jax", JSched), ("port", TSched)):
        model, _ = _make(pkg, "sketch-virtual", params, **ctl)
        model.attach_scheduler(sched_cls(model.cfg, 12, model.throughput))
        models[pkg] = model
    # moved controllers on the saving side: a screen multiplier, a speed
    # ratio, and a staleness ring of three commits
    for pkg, model in models.items():
        model.screen_ctl.observe(0, 3, 4)
        bank = model.control_bank
        bank.controllers[0].ratio = 0.37
        for r, resid in enumerate((0.9, 0.1, 0.5)):
            bank.observe_commit(r, {"estimate_residual": resid})
    for P, Q in (("port", "jax"), ("jax", "port")):
        save_p, load_q = ((tck.save_checkpoint, jck.load_checkpoint)
                          if P == "port" else
                          (jck.save_checkpoint, tck.load_checkpoint))
        saved = {**counters, **models[P].scheduler_state()}
        assert {"screen_mult", "screen_rounds_observed",
                "ctl_speed_match_ratio",
                "ctl_staleness_decay_ring"} <= set(saved)
        path = save_p(str(tmp_path / P), models[P].server,
                      scheduler=saved)
        q_model, _ = _make(Q, "sketch-virtual", params, **ctl)
        q_model.attach_scheduler((JSched if Q == "jax" else TSched)(
            q_model.cfg, 12, q_model.throughput))
        q_model.load_state(load_q(path))
        got = q_model.scheduler_state()
        assert sorted(got) == sorted(saved)
        for k, v in saved.items():
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(v), err_msg=k)
        assert (q_model.screen_ctl.plan_mult()
                == models[P].screen_ctl.plan_mult())


# ---------------- the port's own resume, bitwise ----------------------------

class Preempted(Exception):
    """The simulated preemption: raised as the third epoch's stream is
    opened, after the second epoch's checkpoint."""


def _preempt_at_epoch(monkeypatch, n):
    real = FedLoader.epoch
    calls = [0]

    def epoch(self, skip=0):
        calls[0] += 1
        if calls[0] == n:
            raise Preempted()
        return real(self, skip)
    monkeypatch.setattr(FedLoader, "epoch", epoch)


def _resume_matches_uninterrupted(tmp_path, monkeypatch, main, argv,
                                  name):
    """`main(argv)` uninterrupted (3 epochs, a checkpoint each) against
    the same run preempted after its second epoch's checkpoint and
    resumed with --resume: the final checkpoints bitwise equal but for
    the wall-clock throughput EMAs (thr_*)."""
    assert main(argv("A", "a.jsonl"))
    _preempt_at_epoch(monkeypatch, 3)
    with pytest.raises(Preempted):
        main(argv("B", "b.jsonl"))
    monkeypatch.undo()
    assert main(argv("B", "b.jsonl") + ["--resume"])
    finals = [sorted(glob.glob(str(tmp_path / d / f"{name}-r*.npz")))[-1]
              for d in ("A", "B")]
    assert os.path.basename(finals[0]) == os.path.basename(finals[1])
    with np.load(finals[0]) as za, np.load(finals[1]) as zb:
        assert sorted(za.files) == sorted(zb.files)
        assert "smp_aug_rng_key" in za.files or name == "gpt2"
        for k in za.files:
            if not k.startswith("thr_"):
                np.testing.assert_array_equal(zb[k], za[k], err_msg=k)
    # the resumed segment starts where the checkpoint stopped
    from commefficient_tpu.telemetry.journal import validate_journal
    records, problems = validate_journal(str(tmp_path / "b.jsonl"))
    assert problems == []
    starts = [r for r in records if r["event"] == "run_start"]
    ends = [r for r in records if r["event"] == "run_end"]
    assert [s["resumed_round"] > 0 for s in starts] == [False, True]
    assert [e["ok"] for e in ends] == [False, True]


def test_cv_train_resume_is_bitwise_the_uninterrupted_run(tmp_path,
                                                          monkeypatch):
    def argv(ck, journal):
        return ["--test", "--device", "cpu", "--mode", "sketch",
                "--error_type", "virtual", "--virtual_momentum", "0.9",
                "--local_momentum", "0", "--num_workers", "8",
                "--local_batch_size", "16", "--num_epochs", "3",
                "--dataset_dir", str(tmp_path / "ds"),
                "--checkpoint_every", "1", "--checkpoint_path",
                str(tmp_path / ck), "--journal_path",
                str(tmp_path / journal)]
    _resume_matches_uninterrupted(tmp_path, monkeypatch, cv_train.main,
                                  argv, "ResNet9")


def test_gpt2_train_resume_is_bitwise_the_uninterrupted_run(tmp_path,
                                                            monkeypatch):
    # the --test GPT2 (2 layers); 8 personas, all in every round, so an
    # epoch is exactly its 3 rounds
    monkeypatch.chdir(tmp_path)

    def argv(ck, journal):
        return ["--test", "--device", "cpu", "--dataset_name", "PERSONA",
                "--mode", "sketch", "--error_type", "virtual",
                "--virtual_momentum", "0.9", "--local_momentum", "0",
                "--num_workers", "8", "--local_batch_size", "2",
                "--num_epochs", "3", "--dataset_dir", str(tmp_path / "ds"),
                "--checkpoint_every", "1", "--checkpoint_path",
                str(tmp_path / ck), "--journal_path",
                str(tmp_path / journal)]
    _resume_matches_uninterrupted(tmp_path, monkeypatch, gpt2_train.main,
                                  argv, "gpt2")
