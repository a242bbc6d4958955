"""Spans and the pipelined engine: the port's training/scanloop.py,
FedModel.dispatch_rounds / collect_rounds, the checkpoint writer thread,
the journal's writer thread, the span dispatch's retry guard and
--profile_spans; the counterparts of tests/test_pipeline.py and
tests/test_scanloop_faults.py. The port runs on the CPU (its kernels'
plain versions); JAX on the CPU test mesh where a case compares them.

The contract: a spanned run and a pipelined run give the plain loop's
per-round losses and metrics, weights, client rows and billed bytes
BITWISE (a span's rounds are the per-round path's, operation for
operation), under faults and with a tail span."""
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.federated.api import (
    FedModel as JFedModel, FedOptimizer as JFedOptimizer,
)
from commefficient_tpu.telemetry.journal import validate_journal
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.config import parse_args
from commefficient_tpu_torch.federated.api import (
    FedModel as TFedModel, FedOptimizer as TFedOptimizer,
)
from commefficient_tpu_torch.telemetry import (
    RunJournal, TelemetrySession, parse_profile_spans,
)
from commefficient_tpu_torch.telemetry.journal import read_journal
from commefficient_tpu_torch.training import cv_train, gpt2_train
from commefficient_tpu_torch.training.scanloop import (
    make_span_checkpoint, run_scanned_rounds,
)
from commefficient_tpu_torch.utils import checkpoint as tck
from commefficient_tpu_torch.utils.checkpoint import AsyncCheckpointWriter
from commefficient_tpu_torch.utils.faults import FaultSchedule, InjectedFault
from commefficient_tpu_torch.utils.retry import with_retries
from commefficient_tpu_torch.utils.schedules import LambdaLR
from commefficient_tpu_torch.utils.watchdog import drain_queue
from tests.test_torch_round import _batches, _case_models

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

D = 8
W = 8


class Linear(torch.nn.Module):
    """The JAX tests' linear model: one [D] weight named `w`."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(D))


def loss_fn(params, batch, mask):
    x, y = batch
    per_ex = 0.5 * (x @ params["w"] - y) ** 2
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (per_ex * mask).sum() / denom
    return loss, (loss,)


def j_loss_fn(params, batch, mask):
    x, y = batch
    per_ex = 0.5 * (x @ params["w"] - y) ** 2
    denom = jnp.maximum(mask.sum(), 1.0)
    loss = (per_ex * mask).sum() / denom
    return loss, (loss,)


LINEAR_BASE = dict(mode="uncompressed", weight_decay=0.0, num_workers=W,
                   local_momentum=0.0, virtual_momentum=0.9,
                   error_type="none", num_clients=W)


def _linear_model(**kw):
    model = TFedModel(Linear(), loss_fn,
                      TConfig(**{**LINEAR_BASE, **kw}, device="cpu"),
                      device="cpu", num_clients=W)
    opt = TFedOptimizer(model)
    opt.param_groups[0]["lr"] = 0.1
    return model, opt


def _rounds(R, seed=0):
    """R rounds of the linear problem as the span stream's items
    (tag, ids, data, mask, lr)."""
    rng = np.random.RandomState(seed)
    out = []
    for r in range(R):
        x = rng.randn(W, 4, D).astype(np.float32)
        y = rng.randn(W, 4).astype(np.float32)
        ids = np.arange(W, dtype=np.int32)
        mask = np.ones((W, 4), np.float32)
        out.append((r, ids, (x, y), mask, 0.1))
    return out


def _drive(model, stream, span_cap, pipeline=False, checkpoint=None):
    rows = []

    def emit(tag, *metric_rows):
        rows.append((tag, *[np.asarray(m).copy() for m in metric_rows]))
        return True

    ok = run_scanned_rounds(model, iter(stream), span_cap, emit,
                            checkpoint=checkpoint, pipeline=pipeline)
    return ok, rows


def _state(model):
    return [t.clone() for t in (*model.server[:3], *model.clients)]


def _assert_state_equal(a, b, what=""):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), f"{what}: state tensor {i} differs"


# ---------------- spans bitwise the plain loop --------------------------------

# tiny-ResNet9 configs: the main path's mode, client rows, the two
# plugins, and faults riding every round
SPAN_CASES = {
    "sketch_dropout_stragglers": dict(
        mode="sketch", error_type="virtual", virtual_momentum=0.9, k=300,
        num_rows=5, num_cols=700, client_dropout=0.25, straggler_rate=0.5,
        straggler_cutoff=0.2),
    "local_topk_rows": dict(mode="local_topk", error_type="local",
                            local_momentum=0.9, k=300),
    "powersgd_screened": dict(mode="powersgd", error_type="local",
                              powersgd_rank=2, update_screen="norm",
                              poison_rate=0.25),
    "dp_sketch": dict(mode="dp_sketch", error_type="virtual",
                      virtual_momentum=0.9, k=300, num_rows=5, num_cols=700,
                      dp_noise_mult=0.5),
}


def _resnet_model(case):
    _, params, tm = _case_models("tiny")
    kw = {**dict(local_momentum=0.0, num_workers=4, num_clients=12,
                 local_batch_size=6), **SPAN_CASES[case]}
    model = TFedModel(tm, cv_train.make_compute_loss(tm),
                      TConfig(**kw, device="cpu"), device="cpu",
                      num_clients=12)
    opt = TFedOptimizer(model)
    opt.param_groups[0]["lr"] = 0.1
    return model, opt


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["spanned", "pipelined"])
@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_spans_are_bitwise_the_plain_loop(case, pipeline):
    # 5 rounds in spans of 2 (2 + 2 + a tail span of 1): per-round
    # losses and metrics, weights, client rows, accountant state and
    # every round's billed bytes equal the plain loop's bit for bit
    batches = _batches(5, 4, 6, 12, seed=7)
    plain, _ = _resnet_model(case)
    want_rows, want_bytes = [], []
    for ids, data, mask in batches:
        loss, acc, d, u = plain((ids, data, mask))
        want_rows.append((loss.numpy(), acc.numpy()))
        want_bytes.append((float(d.sum()), float(u.sum())))
    spanned, _ = _resnet_model(case)
    comms = []
    ok = run_scanned_rounds(
        spanned, iter([(i, *b, 0.1) for i, b in enumerate(batches)]), 2,
        lambda tag, loss, acc: want_rows[tag][0].tobytes() == loss.tobytes()
        and want_rows[tag][1].tobytes() == acc.tobytes(),
        on_comm=lambda d, u: comms.append((d, u)), pipeline=pipeline)
    assert ok, "a round's losses or metrics differ from the plain loop's"
    _assert_state_equal(_state(plain), _state(spanned), case)
    assert spanned.server.round_idx == 5
    span_bytes = [tuple(map(sum, zip(*want_bytes[a:b])))
                  for a, b in ((0, 2), (2, 4), (4, 5))]
    assert comms == span_bytes
    for k, v in plain.accountant.state_dict().items():
        np.testing.assert_array_equal(spanned.accountant.state_dict()[k], v)
    assert spanned._prev_change_words.tobytes() == \
        plain._prev_change_words.tobytes()
    spanned.close_persistence()


def test_span_bills_round_n_against_round_n_minus_1():
    # one span, then plain rounds: the span's first round bills against
    # the bits before it, and the plain round after the span against the
    # span's last
    stream = _rounds(5)
    a, _ = _linear_model()
    for _, ids, data, mask, _ in stream:
        a((ids, data, mask))
    b, _ = _linear_model()
    b((stream[0][1], stream[0][2], stream[0][3]))
    _drive(b, stream[1:4], 3)
    b((stream[4][1], stream[4][2], stream[4][3]))
    _assert_state_equal(_state(a), _state(b))
    for k, v in a.accountant.state_dict().items():
        np.testing.assert_array_equal(b.accountant.state_dict()[k], v)


def test_spanned_run_matches_the_jax_scanned_run():
    # the JAX package's run_rounds (one scanned program a span) against
    # the port's span of per-round rounds, at the round limits: weights
    # within 1e-5 of their scale, span byte totals equal
    stream = _rounds(6, seed=3)
    cfg = dict(LINEAR_BASE, mode="sketch", error_type="virtual", k=4,
               num_rows=2, num_cols=32, num_blocks=1, grad_size=D,
               client_dropout=0.25)
    jmodel = JFedModel(None, j_loss_fn, JConfig(**cfg),
                       params={"w": jnp.zeros(D)})
    JFedOptimizer(jmodel).param_groups[0]["lr"] = 0.1
    tmodel, _ = _linear_model(**{k: v for k, v in cfg.items()
                                 if k != "grad_size"})
    for a, b in ((0, 3), (3, 6)):
        span = stream[a:b]
        args = (np.stack([r[1] for r in span]),
                tuple(np.stack([r[2][i] for r in span]) for i in range(2)),
                np.stack([r[3] for r in span]))
        jl, _, jd, ju = jmodel.run_rounds(*args,
                                          np.full(b - a, 0.1, np.float32))
        tl, _, td, tu = tmodel.run_rounds(*args, [0.1] * (b - a))
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5)
        assert (float(td), float(tu)) == (float(jd), float(ju))
        jw = np.asarray(jmodel.ps_weights)
        np.testing.assert_allclose(tmodel.ps_weights.numpy(), jw, rtol=0,
                                   atol=1e-5 * np.abs(jw).max())


# ---------------- faults inside spans -----------------------------------------

def test_crash_after_in_the_tail_span_commits_its_rounds():
    model, _ = _linear_model()
    model.set_fault_schedule(FaultSchedule(crash_after=4))
    with pytest.raises(InjectedFault) as exc:
        _drive(model, _rounds(5), 2)
    assert exc.value.round_idx == 4
    assert model.server.round_idx == 5
    assert model.accountant.rounds_seen == 5


def test_crash_after_truncates_the_span_at_that_round():
    model, _ = _linear_model()
    model.set_fault_schedule(FaultSchedule(crash_after=1))
    with pytest.raises(InjectedFault) as exc:
        _drive(model, _rounds(6), 4)
    assert exc.value.round_idx == 1
    # rounds 2 and 3 of the span never ran
    assert model.server.round_idx == 2
    assert model.accountant.rounds_seen == 2


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["spanned", "pipelined"])
def test_crash_in_span_commits_nothing(pipeline):
    model, _ = _linear_model()
    model.set_fault_schedule(FaultSchedule(crash_in_span=3))
    boundaries = []

    def checkpoint(snapshot=None):
        boundaries.append(model.server.ps_weights.clone())
    checkpoint.snapshot = lambda: {}
    with pytest.raises(InjectedFault) as exc:
        _drive(model, _rounds(6), 2, pipeline=pipeline,
               checkpoint=checkpoint)
    assert exc.value.round_idx == 1       # the last span boundary
    # the crashing span left nothing: the state is span 0's
    assert model.server.round_idx == 2
    if pipeline:
        # span 0 was still in flight (the double buffer): its commit,
        # accounting and boundary save are lost with the crash too
        assert model.accountant.rounds_seen == 0
        assert boundaries == []
    else:
        assert model.accountant.rounds_seen == 2
        assert len(boundaries) == 1
        assert torch.equal(model.server.ps_weights, boundaries[0])


def test_crash_in_span_on_the_per_round_path_commits_nothing():
    model, _ = _linear_model()
    model.set_fault_schedule(FaultSchedule(crash_in_span=2))
    stream = _rounds(3)
    for _, ids, data, mask, _ in stream[:2]:
        model((ids, data, mask))
    before = model.server.ps_weights.clone()
    with pytest.raises(InjectedFault) as exc:
        model((stream[2][1], stream[2][2], stream[2][3]))
    assert exc.value.round_idx == 1
    assert model.server.round_idx == 2
    assert torch.equal(model.server.ps_weights, before)


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["spanned", "pipelined"])
def test_midspan_crash_resumes_bitwise(tmp_path, pipeline):
    # span-boundary checkpoints (make_span_checkpoint), a kill inside a
    # span, a resume from the newest checkpoint: bitwise the
    # uninterrupted run, with random dropout and stragglers across the
    # boundary. Pipelined, two spans are in flight at the kill, so the
    # persisted boundary is one span earlier
    R, SPAN = 8, 2
    common = dict(client_dropout=0.2, straggler_rate=0.4,
                  straggler_min_work=0.3, checkpoint_every=1,
                  ckpt_every_spans=1, pipeline=pipeline, mode="local_topk",
                  error_type="local", local_momentum=0.9, k=3)
    stream = _rounds(R, seed=9)
    a, _ = _linear_model(**common)
    assert _drive(a, stream, SPAN, pipeline=pipeline)[0]
    a.close_persistence()

    prefix = str(tmp_path / "ck" / "linear")
    b, opt_b = _linear_model(**common)
    b.set_fault_schedule(FaultSchedule(crash_in_span=5))
    hook = make_span_checkpoint(prefix, b, b.cfg,
                                LambdaLR(opt_b, lambda s: 1.0))
    with pytest.raises(InjectedFault):
        _drive(b, stream, SPAN, pipeline=pipeline, checkpoint=hook)
    b.close_persistence()      # the drivers' crash path drains it

    c, _ = _linear_model(**common)
    path, ckpt = tck.load_resilient(
        prefix, expect_fingerprint=c.checkpoint_fingerprint)
    c.load_state(ckpt)
    done = c.server.round_idx
    assert done == (2 if pipeline else 4)
    assert _drive(c, stream[done:], SPAN, pipeline=pipeline)[0]
    c.close_persistence()
    _assert_state_equal(_state(a), _state(c), "resumed")
    for k, v in a.accountant.state_dict().items():
        np.testing.assert_array_equal(c.accountant.state_dict()[k], v)


def test_pipelined_snapshot_copies_the_client_rows(tmp_path):
    # the next span writes the live client rows in place before the
    # one-span-late save: each save holds its own boundary's rows
    common = dict(mode="local_topk", error_type="local", local_momentum=0.9,
                  k=3, checkpoint_every=1, ckpt_every_spans=1)
    stream = _rounds(6, seed=2)
    ref, _ = _linear_model(**common)
    want = {}
    for i, (_, ids, data, mask, _) in enumerate(stream):
        ref((ids, data, mask))
        if i % 2 == 1:
            want[i + 1] = ref.client_rows_payload()
    model, opt = _linear_model(**common, pipeline=True)
    prefix = str(tmp_path / "ck" / "linear")
    hook = make_span_checkpoint(prefix, model, model.cfg,
                                LambdaLR(opt, lambda s: 1.0))
    assert _drive(model, stream, 2, pipeline=True, checkpoint=hook)[0]
    model.close_persistence()
    for r, rows in want.items():
        ck = tck.load_checkpoint(f"{prefix}-r{r:08d}.npz")
        for k in ("ids", "errors", "velocities"):
            np.testing.assert_array_equal(ck.client_rows[k], rows[k],
                                          err_msg=f"round {r} {k}")


def test_pipelined_snapshot_takes_the_stream_cursor_at_its_draws():
    # the staging thread runs one span ahead: each boundary's snapshot
    # carries the stream's cursor as its span's last round was drawn,
    # not the live one
    drawn = []

    def stream():
        for item in _rounds(7):
            drawn.append(item[0])
            yield item
    snaps = []

    def hook(snapshot=None):
        snaps.append(snapshot)
    hook.snapshot = lambda: {"state": "now"}
    hook.cursor = lambda: {"drawn": len(drawn)}
    model, _ = _linear_model(pipeline=True)
    assert run_scanned_rounds(model, stream(), 3, lambda *a: True,
                              checkpoint=hook, pipeline=True)
    assert [s["drawn"] for s in snaps] == [3, 6, 7]
    assert all(s["state"] == "now" and "throughput" in s for s in snaps)


class _Preempted(Exception):
    pass


def test_a_stream_error_reraises_on_the_loop_thread():
    def stream():
        yield from _rounds(3)
        raise _Preempted("the stream died")
    model, _ = _linear_model(pipeline=True)
    with pytest.raises(_Preempted, match="stream died"):
        run_scanned_rounds(model, stream(), 2, lambda *a: True,
                           pipeline=True)
    # the first span ran; the staging thread is gone
    assert model.server.round_idx >= 2
    assert not any(t.name == "span-staging" and t.is_alive()
                   for t in threading.enumerate())


def test_pipelined_cv_train_crash_resumes_bitwise(tmp_path):
    # a pipelined cv_train run with a checkpoint every span, killed
    # inside a span while the staging thread has drawn ahead, resumed
    # from its newest checkpoint: bitwise the uninterrupted run (the
    # sampler's cursor came from the span's own draws)
    def run(sub, crash=None, resume=False):
        argv = _cv_argv(tmp_path, "--num_clients", "40", "--scan_rounds",
                        "--scan_span", "3", "--pipeline", "--no_telemetry",
                        "--checkpoint_every", "1", "--checkpoint_path",
                        str(tmp_path / sub), "--num_epochs", "0.4",
                        *(["--resume"] if resume else []))
        cfg = parse_args(argv=argv)
        model, opt, sched, loader, val = cv_train.build(cfg, device="cpu")
        if crash is not None:
            model.set_fault_schedule(FaultSchedule(crash_in_span=crash))
        try:
            assert cv_train.run(model, opt, sched, loader, val, model.cfg,
                                str(tmp_path / sub / "log"))
        finally:
            model.close_persistence()
        return model

    want = run("a")
    with pytest.raises(InjectedFault):
        run("b", crash=13)
    got = run("b", resume=True)
    assert got.server.round_idx == want.server.round_idx > 13
    _assert_state_equal(_state(want), _state(got), "resumed")
    for k, v in want.accountant.state_dict().items():
        np.testing.assert_array_equal(got.accountant.state_dict()[k], v)


def test_emit_abort_stops_mid_span():
    model, _ = _linear_model()
    emitted = []

    def emit(tag, loss, aux):
        emitted.append(tag)
        return tag != 2
    assert not run_scanned_rounds(model, iter(_rounds(6)), 2, emit)
    assert emitted == [0, 1, 2]
    assert model.server.round_idx == 4


def test_pipelined_abort_drains_the_pending_span():
    # the abort surfaces one span late with the next span already run:
    # it is collected (accounting, on_comm) but neither emitted nor
    # checkpointed
    model, _ = _linear_model(pipeline=True)
    emitted, boundaries, comms = [], [], []

    def emit(tag, loss, aux):
        emitted.append(tag)
        return tag != 2

    def hook(snapshot=None):
        boundaries.append(model.server.round_idx)
    hook.snapshot = lambda: {}
    ok = run_scanned_rounds(model, iter(_rounds(6)), 2, emit,
                            on_comm=lambda d, u: comms.append(u),
                            checkpoint=hook, pipeline=True)
    model.close_persistence()
    assert not ok
    assert emitted == [0, 1, 2]
    assert model.server.round_idx == 6
    assert model.accountant.rounds_seen == 6
    assert len(comms) == 3
    assert len(boundaries) == 2


def test_checkpoint_hook_is_called_once_a_span():
    saves = []
    model, _ = _linear_model()
    ok, _ = _drive(model, _rounds(5), 2,
                   checkpoint=lambda: saves.append(model.server.round_idx))
    assert ok
    assert saves == [2, 4, 5]


@pytest.mark.parametrize("every,want", [(1, [2, 4, 5]), (2, [4]),
                                        (0, [])])
def test_span_checkpoint_cadence(tmp_path, every, want):
    model, opt = _linear_model(checkpoint_every=1, ckpt_every_spans=every)
    prefix = str(tmp_path / "linear")
    hook = make_span_checkpoint(prefix, model, model.cfg,
                                LambdaLR(opt, lambda s: 1.0))
    assert (hook is None) == (every == 0)
    assert _drive(model, _rounds(5), 2, checkpoint=hook)[0]
    stamped = sorted(int(p[-12:-4]) for p in os.listdir(tmp_path)
                     if p.endswith(".npz"))
    assert stamped == want[-3:]


# ---------------- the retry guard of the span dispatch --------------------------

def _flaky_round(model, fail_after_rounds):
    """Make the model's round raise a transient error once, after
    `fail_after_rounds` rounds of the span have run."""
    real = model._train_round
    calls = []

    def flaky(*args):
        calls.append(1)
        if len(calls) == fail_after_rounds + 1:
            raise TimeoutError("deadline exceeded waiting for the span")
        return real(*args)
    model._train_round = flaky
    return calls


def _span_args(stream):
    return (np.stack([r[1] for r in stream]),
            tuple(np.stack([r[2][i] for r in stream]) for i in range(2)),
            np.stack([r[3] for r in stream]), [r[4] for r in stream])


def test_span_retry_refuses_a_consumed_state(monkeypatch):
    # a round wrote the client rows in place before the failure: the
    # original error raises at once, with no backoff and no replay
    model, _ = _linear_model(mode="local_topk", error_type="local",
                             local_momentum=0.9, k=3)
    sleeps = []
    monkeypatch.setattr("time.sleep", sleeps.append)
    calls = _flaky_round(model, fail_after_rounds=1)
    with pytest.raises(TimeoutError, match="deadline exceeded"):
        model.run_rounds(*_span_args(_rounds(2)))
    assert sleeps == [] and len(calls) == 2


def test_span_retry_replays_an_intact_state(monkeypatch):
    # the same failure before any round wrote state (stateless clients,
    # the server state functional): replayed, bitwise the clean run
    stream = _rounds(3)
    clean, _ = _linear_model(mode="local_topk", error_type="local",
                             local_momentum=0.9, k=3)
    clean.run_rounds(*_span_args(stream))
    model, _ = _linear_model(mode="local_topk", error_type="local",
                             local_momentum=0.9, k=3)
    sleeps = []
    monkeypatch.setattr("time.sleep", sleeps.append)
    calls = _flaky_round(model, fail_after_rounds=0)
    model.run_rounds(*_span_args(stream))
    assert sleeps == [0.5] and len(calls) == 4
    _assert_state_equal(_state(clean), _state(model))
    stateless, _ = _linear_model()
    calls = _flaky_round(stateless, fail_after_rounds=2)
    stateless.run_rounds(*_span_args(stream))
    assert len(calls) == 6


def test_with_retries_bounds_and_classifies():
    sleeps = []
    attempts = []

    def always():
        attempts.append(1)
        raise ConnectionError("connection reset")
    with pytest.raises(ConnectionError):
        with_retries(always, retries=2, sleep=sleeps.append)
    assert len(attempts) == 3 and sleeps == [0.5, 1.0]
    with pytest.raises(InjectedFault):
        with_retries(lambda: (_ for _ in ()).throw(InjectedFault(3)),
                     sleep=sleeps.append)
    with pytest.raises(ValueError):
        with_retries(lambda: (_ for _ in ()).throw(ValueError("shape")),
                     sleep=sleeps.append)
    assert sleeps == [0.5, 1.0]


# ---------------- the writer threads ----------------------------------------

def _ckpt_kwargs(model):
    return dict(scheduler_step=3, accountant=model.accountant,
                prev_change_words=model._prev_change_words,
                fingerprint=model.checkpoint_fingerprint,
                client_rows=model.client_rows_payload())


def test_async_checkpoint_writer_equals_the_sync_one(tmp_path):
    model, _ = _linear_model(mode="local_topk", error_type="local",
                             local_momentum=0.9, k=3)
    for _, ids, data, mask, _ in _rounds(3):
        model((ids, data, mask))
    sync = tck.save_rotating(str(tmp_path / "s" / "m"), model.server,
                             model.clients, **_ckpt_kwargs(model))
    writer = AsyncCheckpointWriter()
    asyn = tck.save_rotating(str(tmp_path / "a" / "m"), model.server,
                             model.clients, writer=writer,
                             **_ckpt_kwargs(model))
    writer.drain()
    with np.load(sync) as zs, np.load(asyn) as za:
        assert sorted(zs.files) == sorted(za.files)
        for k in zs.files:
            np.testing.assert_array_equal(za[k], zs[k], err_msg=k)
    ms = json.load(open(str(tmp_path / "s" / "m.latest")))
    ma = json.load(open(str(tmp_path / "a" / "m.latest")))
    assert ms == ma
    final = tck.save_final(str(tmp_path / "a" / "m"), model.server,
                           model.clients, writer=writer,
                           **_ckpt_kwargs(model))
    assert os.path.exists(final)
    writer.close()
    writer.close()


def test_checkpoint_writer_bounded_queue_and_error_surfacing():
    writer = AsyncCheckpointWriter(max_pending=1)
    gate = threading.Event()
    order = []

    def slow():
        gate.wait(5)
        order.append("slow")
    writer.submit(slow)              # running
    writer.submit(lambda: order.append("queued"))   # the one queued slot
    t = threading.Thread(target=writer.submit,
                         args=(lambda: order.append("blocked"),))
    t.start()
    t.join(0.2)
    assert t.is_alive(), "a full queue must back-pressure the submitter"
    gate.set()
    t.join(5)
    writer.drain()
    assert order == ["slow", "queued", "blocked"]

    def boom():
        raise OSError(28, "No space left on device")
    writer.submit(boom)
    with pytest.raises(OSError, match="No space"):
        writer.drain()
    writer.drain()                   # reported once
    writer.submit(boom)
    writer.submit(lambda: None)
    with pytest.raises(OSError):
        writer.submit(lambda: None)  # an earlier failure at the next save
    writer.close()
    with pytest.raises(RuntimeError, match="closed"):
        writer.submit(lambda: None)


def test_writer_drain_timeout_names_the_writer():
    writer = AsyncCheckpointWriter(drain_timeout=0.2, name="checkpoint")
    gate = threading.Event()
    writer.submit(lambda: gate.wait(5))
    with pytest.raises(TimeoutError, match="checkpoint writer"):
        writer.drain()
    gate.set()
    writer.close()
    import queue
    q = queue.Queue()
    q.put(1)
    with pytest.raises(TimeoutError, match="journal writer"):
        drain_queue(q, 0.05, "journal")


def _journal_records(path, async_writer):
    j = RunJournal(path, run_id="r", clock=lambda: 1.0,
                   mono_clock=lambda: 2.0, async_writer=async_writer)
    j.event("run_start", mode="sketch")
    j.events([("span", {"first_round": 0, "rounds": 2}),
              ("round", {"round": 0, "metrics": {"x": float("nan")}}),
              ("round", {"round": 1, "seconds": 0.5})])
    j.event("screened", round=1, kind="finite", n_screened=1)
    j.close()
    with open(path) as f:
        return f.read()


def test_async_journal_writes_identical_records(tmp_path):
    sync = _journal_records(str(tmp_path / "s.jsonl"), False)
    asyn = _journal_records(str(tmp_path / "a.jsonl"), True)
    assert asyn == sync
    recs, problems = read_journal(str(tmp_path / "a.jsonl"))
    assert problems == [] and len(recs) == 5


def test_async_journal_flush_is_a_barrier(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = RunJournal(path, async_writer=True)
    for i in range(50):
        j.event("round", round=i)
    j.flush()
    recs, _ = read_journal(path)
    assert [r["round"] for r in recs] == list(range(50))
    j.close()
    j.close()


def test_async_journal_seals_a_torn_tail(tmp_path):
    # a preemption tore the last line: the writer thread's first append
    # seals it, as the synchronous writer's does
    path = str(tmp_path / "j.jsonl")
    RunJournal(path).event("round", round=0)
    with open(path, "a") as f:
        f.write('{"v": 1, "event": "round", "ro')
    j = RunJournal(path, async_writer=True)
    j.event("round", round=1)
    j.close()
    recs, problems = read_journal(path)
    assert [r["round"] for r in recs] == [0, 1]
    counters = {}
    read_journal(path, counters)
    assert counters["corrupt_interior"] == 1


# ---------------- --profile_spans --------------------------------------------

@pytest.mark.parametrize("spec,want", [("", None), ("0:1", (0, 1)),
                                       ("2:5", (2, 5))])
def test_parse_profile_spans(spec, want):
    assert parse_profile_spans(spec) == want


@pytest.mark.parametrize("spec", ["1", "a:b", "3:3", "-1:2", "2:1"])
def test_parse_profile_spans_refuses_malformed(spec):
    from commefficient_tpu.telemetry import (
        parse_profile_spans as j_parse_profile_spans,
    )
    with pytest.raises(ValueError, match="--profile_spans"):
        parse_profile_spans(spec)
    with pytest.raises(ValueError, match="--profile_spans"):
        j_parse_profile_spans(spec)


def test_profile_spans_capture_the_window(tmp_path):
    model, _ = _linear_model()
    jpath = str(tmp_path / "j.jsonl")
    tele = TelemetrySession(journal=RunJournal(jpath), profile_spans="1:2",
                            profile_dir=str(tmp_path / "profile_spans"))
    model.attach_telemetry(tele)
    assert _drive(model, _rounds(6), 2)[0]
    tele.close(ok=True)
    trace = tmp_path / "profile_spans" / "spans_1_2.json"
    assert trace.exists() and trace.stat().st_size > 0
    recs, problems = validate_journal(jpath)
    assert not problems, problems
    starts = [r for r in recs if r["event"] == "profile_start"]
    stops = [r for r in recs if r["event"] == "profile_stop"]
    assert [r["span"] for r in starts] == [1]
    assert [r["span"] for r in stops] == [1]
    spans = [r for r in recs if r["event"] == "span"]
    assert [r["first_round"] for r in spans] == [0, 2, 4]
    rounds = [r["round"] for r in recs if r["event"] == "round"]
    assert rounds == list(range(6))


# ---------------- the flags and the drivers ----------------------------------

def _cv_argv(tmp_path, *extra):
    return ["--test", "--device", "cpu", "--mode", "sketch", "--error_type",
            "virtual", "--local_momentum", "0", "--num_workers", "4",
            "--num_epochs", "1", "--dataset_dir", str(tmp_path / "ds"),
            *extra]


@pytest.mark.parametrize("flags", [
    ("--scan_rounds", "--scan_span", "3"),
    ("--scan_rounds", "--scan_span", "3", "--pipeline"),
    ("--scan_rounds", "--profile_spans", "0:1"),
    ("--scan_rounds", "--ckpt_every_spans", "2", "--checkpoint_every", "1"),
    ("--pipeline", "--writer_drain_timeout_s", "30"),
], ids=["scan_span", "pipeline", "profile_spans", "ckpt_every_spans",
        "writer_drain_timeout_s"])
def test_item_9c_flags_are_accepted(tmp_path, flags):
    cfg = parse_args(argv=_cv_argv(tmp_path, *flags))
    assert cfg.scan_rounds or cfg.pipeline


@pytest.mark.parametrize("flags,match", [
    (("--profile_spans", "0:1"), "requires --scan_rounds"),
    (("--scan_rounds", "--profile_spans", "0:1", "--no_telemetry"),
     "requires telemetry"),
    (("--scan_rounds", "--profile_spans", "2"), "expects 'A:B'"),
    (("--ckpt_every_spans", "-1"), "ckpt_every_spans"),
    (("--writer_drain_timeout_s", "-1"), "writer_drain_timeout_s"),
])
def test_item_9c_flag_checks_match_jax(tmp_path, flags, match):
    from commefficient_tpu.config import parse_args as j_parse_args
    argv = _cv_argv(tmp_path, *flags)
    with pytest.raises(ValueError, match=match):
        parse_args(argv=argv)
    with pytest.raises(ValueError, match=match):
        j_parse_args(argv=[a for a in argv if a not in ("--device", "cpu")])


def _cv_main(tmp_path, sub, *extra):
    """cv_train.main from the CLI with a journal, the tracer and a
    checkpoint every epoch; returns (the final checkpoint's arrays but
    the wall-clock thr_* EMAs, the journal's records)."""
    root = tmp_path / sub
    root.mkdir()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        ck, jp = str(root / "ck"), str(root / "j.jsonl")
        assert cv_train.main(_cv_argv(
            tmp_path, "--num_clients", "40", "--checkpoint",
            "--checkpoint_every", "1", "--checkpoint_path", ck,
            "--journal_path", jp, "--trace", *extra))
    finally:
        os.chdir(cwd)
    recs, problems = validate_journal(jp)
    assert not problems, problems
    with np.load(os.path.join(ck, "ResNet9.npz")) as z:
        return {k: z[k] for k in z.files if not k.startswith("thr_")}, recs


@pytest.mark.parametrize("extra", [
    ("--scan_rounds", "--scan_span", "3"),
    ("--scan_rounds", "--scan_span", "3", "--pipeline")],
    ids=["spanned", "pipelined"])
def test_cv_train_spans_through_main(tmp_path, extra):
    # the final checkpoint of a spanned / pipelined run with a span
    # checkpoint every span and --profile_spans is the plain run's bit
    # for bit, and both journals read clean in the JAX package's
    # validate_journal
    want, _ = _cv_main(tmp_path, "plain")
    got, recs = _cv_main(tmp_path, "spans", *extra, "--profile_spans",
                         "1:2")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rounds = [r["round"] for r in recs if r["event"] == "round"]
    assert rounds == list(range(len(rounds))) and len(rounds) > 3
    assert any(r["event"] == "span" for r in recs)
    assert [r["span"] for r in recs if r["event"] == "profile_stop"] == [1]


@pytest.mark.parametrize("extra", [
    ("--scan_rounds", "--scan_span", "2"),
    ("--scan_rounds", "--scan_span", "2", "--pipeline",
     "--checkpoint_every", "1")], ids=["spanned", "pipelined"])
def test_gpt2_train_spans_are_bitwise_the_plain_loop(tmp_path, extra):
    from commefficient_tpu_torch.data.persona import HashTokenizer

    def run(flags, sub):
        argv = ["--test", "--device", "cpu", "--dataset_name", "PERSONA",
                "--dataset_dir", str(tmp_path / "ds"), "--mode", "sketch",
                "--error_type", "virtual", "--virtual_momentum", "0.9",
                "--local_momentum", "0", "--num_workers", "4",
                "--local_batch_size", "2", "--num_epochs", "1",
                "--checkpoint_path", str(tmp_path / sub), "--no_telemetry",
                *flags]
        cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=argv)
        cfg = cfg.replace(num_rows=1, num_cols=1000, k=10, num_blocks=1)
        model, opt, sched, loader, _ = gpt2_train.build(
            cfg, HashTokenizer(500), device="cpu")
        seen = []
        ok = gpt2_train.train_gpt2(
            model, opt, sched, loader, model.cfg, logger=_Quiet(),
            on_round=lambda i, out: seen.append(
                (i, np.asarray(out[0]).tobytes())))
        model.close_persistence()
        return ok, model, seen

    ok_a, a, seen_a = run((), "a")
    ok_b, b, seen_b = run(extra, "b")
    assert ok_a and ok_b
    assert seen_a == seen_b and len(seen_a) > 2
    _assert_state_equal(_state(a), _state(b), "gpt2 spans")


class _Quiet:
    def append(self, row):
        pass
