"""The port's telemetry (commefficient_tpu_torch/telemetry/): the round
metric vector and the rounds' named metrics against the JAX package's,
state bitwise the same with telemetry on and off, the journal held to
the JAX package's validate_journal and scripts/journal_summary.py and
to a JAX journal of the same rounds, the numeric trip, the throughput
tracker's state against JAX's, the tracer cases of tests/test_trace.py,
and the spans as profiler ranges: a profiled CPU GPT2 round's host
events, the round recorder unchanged under them, the data fetch's bytes
and the benchmark's four span metrics. Tolerances: float metrics within
1e-5 relative (the reductions run in another order), counts and bytes
exact."""
import importlib.util
import json
import os
import subprocess
import sys
import threading
import tracemalloc
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.federated.api import (
    FedModel as JFedModel, FedOptimizer as JFedOptimizer,
)
from commefficient_tpu.telemetry import (
    attach_run_telemetry as j_attach_run_telemetry,
)
from commefficient_tpu.telemetry import metrics as jmetrics
from commefficient_tpu.telemetry.clients import (
    ClientThroughputTracker as JTracker,
)
from commefficient_tpu.telemetry.journal import validate_journal
from commefficient_tpu_torch import hooks
from commefficient_tpu_torch.analysis.recorder import RoundRecorder
from commefficient_tpu_torch.config import Config as TConfig, parse_args
from commefficient_tpu_torch.data.persona import HashTokenizer
from commefficient_tpu_torch.federated.api import (
    FedModel as TFedModel, FedOptimizer as TFedOptimizer,
)
from commefficient_tpu_torch.telemetry import (
    NumericTripError, RunJournal, TelemetrySession, attach_run_telemetry,
)
from commefficient_tpu_torch.telemetry import metrics as tmetrics
from commefficient_tpu_torch.telemetry import trace as trace_mod
from commefficient_tpu_torch.telemetry.clients import ClientThroughputTracker
from commefficient_tpu_torch.telemetry.journal import read_journal
from commefficient_tpu_torch.telemetry.trace import (
    TRACE, Tracer, overlap_efficiency, stage_stats,
)
from commefficient_tpu_torch.training import cv_train, gpt2_train
from commefficient_tpu_torch.utils.logging import SilentLogger

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 64
W = 8
NUM_CLIENTS = 12
FLOAT_METRICS = ("train_loss", "update_l2", "error_l2", "velocity_l2",
                 "estimate_residual")
COUNT_METRICS = ("survivors", "examples", "realized_k")


@pytest.fixture(autouse=True)
def _trace_off_after():
    """TRACE is process-global: never let an enable leak across tests."""
    yield
    TRACE.disable()


# ---------------- a linear model in both packages --------------------------

def j_loss(params, batch, mask):
    x, y = batch
    per_ex = 0.5 * (x @ params["w"] - y) ** 2
    loss = (per_ex * mask).sum() / jnp.maximum(mask.sum(), 1.0)
    return loss, (loss,)


def t_loss(params, batch, mask):
    x, y = batch
    per_ex = 0.5 * (x @ params["w"] - y) ** 2
    loss = (per_ex * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, (loss,)


class Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(D))


MODES = {
    "uncompressed": dict(mode="uncompressed", virtual_momentum=0.9),
    "sketch": dict(mode="sketch", error_type="virtual",
                   virtual_momentum=0.9, k=8, num_rows=5, num_cols=32),
    "true_topk": dict(mode="true_topk", error_type="virtual",
                      virtual_momentum=0.9, k=8),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, k=8),
}


def _kw(mode, **extra):
    return {**dict(weight_decay=0.0, num_workers=W, local_momentum=0.0,
                   microbatch_size=-1, num_clients=NUM_CLIENTS,
                   local_batch_size=4), **MODES[mode], **extra}


def _models(mode, telemetry=True, jax_too=True, **extra):
    kw = _kw(mode, telemetry=telemetry, **extra)
    tm = TFedModel(Linear(), t_loss, TConfig(**kw, device="cpu"),
                   device="cpu", num_clients=NUM_CLIENTS)
    topt = TFedOptimizer(tm)
    topt.param_groups[0]["lr"] = 0.1
    if not jax_too:
        return tm, None
    jm = JFedModel(None, j_loss, JConfig(**kw),
                   params={"w": jnp.zeros(D)}, num_clients=NUM_CLIENTS)
    jopt = JFedOptimizer(jm)
    jopt.param_groups[0]["lr"] = 0.1
    return tm, jm


def _rounds(n, seed=0):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(D).astype(np.float32)
    out = []
    for _ in range(n):
        ids = rng.choice(NUM_CLIENTS, W, replace=False).astype(np.int32)
        x = rng.randn(W, 4, D).astype(np.float32)
        y = np.einsum("wbd,d->wb", x, w_true).astype(np.float32)
        mask = np.ones((W, 4), np.float32)
        mask[0, -1] = 0.0
        out.append((ids, (x, y), mask))
    return out


# ---------------- the metric vector -----------------------------------------

@pytest.mark.parametrize("state", ["dense", "table", "empty"])
def test_round_vector_matches_jax(state):
    rng = np.random.RandomState(3)
    losses = rng.rand(W).astype(np.float32)
    counts = rng.randint(0, 5, W).astype(np.float32)
    delta = rng.randn(1000).astype(np.float32)
    delta[rng.rand(1000) < 0.7] = 0.0
    shape = {"dense": (1000,), "table": (5, 40), "empty": (0,)}[state]
    verror = rng.randn(*shape).astype(np.float32)
    vvel = rng.randn(*shape).astype(np.float32)
    want = np.asarray(jmetrics.round_vector(
        jnp.asarray(losses), jnp.asarray(counts), jnp.asarray(delta),
        jnp.asarray(verror), jnp.asarray(vvel), jnp.float32(7.0)))
    got = tmetrics.round_vector(
        torch.from_numpy(losses), torch.from_numpy(counts),
        torch.from_numpy(delta), torch.from_numpy(verror),
        torch.from_numpy(vvel), 7).numpy()
    assert got.dtype == np.float32 and got.shape == (tmetrics.NUM_METRICS,)
    assert tmetrics.METRIC_NAMES == jmetrics.METRIC_NAMES
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert tmetrics.named(got).keys() == jmetrics.named(want).keys()
    assert tmetrics.named(tmetrics.empty_vector().numpy()) == {}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_round_metrics_match_jax_rounds(mode):
    # each round's vector, collected at the round engine's return
    tm, jm = _models(mode)
    t_vecs, j_vecs = [], []
    t_round, j_round = tm._train_round, jm._train_round

    def t_hook(*a, **k):
        out = t_round(*a, **k)
        t_vecs.append(out[2].telemetry.numpy())
        return out

    def j_hook(*a, **k):
        out = j_round(*a, **k)
        j_vecs.append(np.asarray(out[2].telemetry))
        return out

    tm._train_round, jm._train_round = t_hook, j_hook
    for batch in _rounds(3, seed=1):
        jm(batch)
        tm(batch)
    assert len(t_vecs) == len(j_vecs) == 3
    for i, (tv, jv) in enumerate(zip(t_vecs, j_vecs)):
        t_named, j_named = tmetrics.named(tv), jmetrics.named(jv)
        for k in FLOAT_METRICS:
            np.testing.assert_allclose(t_named[k], j_named[k], rtol=1e-5,
                                       atol=1e-30, err_msg=f"{k} round {i}")
        for k in COUNT_METRICS:
            assert t_named[k] == j_named[k], (k, i)
        assert t_named["update_l2"] > 0


@pytest.mark.parametrize("mode", ["sketch", "local_topk"])
def test_state_bitwise_same_with_telemetry_on_and_off(mode):
    on, _ = _models(mode, telemetry=True, jax_too=False)
    off, _ = _models(mode, telemetry=False, jax_too=False)
    for batch in _rounds(3, seed=2):
        out_on, out_off = on(batch), off(batch)
        for a, b in zip(out_on[:-2], out_off[:-2]):
            assert torch.equal(a, b)
    for a, b in zip(on.server[:3], off.server[:3]):
        assert torch.equal(a, b)
    assert on.server.round_idx == off.server.round_idx == 3
    for a, b in zip(on.clients, off.clients):
        assert torch.equal(a, b)
    assert np.array_equal(on._prev_change_words, off._prev_change_words)


# ---------------- the journal -----------------------------------------------

def _journal_events(path, drop=("compile", "compile_warning")):
    records, problems = validate_journal(path)
    assert problems == [], problems
    return [r for r in records if r["event"] not in drop]


@pytest.mark.parametrize("mode", ["sketch", "local_topk"])
def test_journal_event_sequence_matches_jax(tmp_path, mode):
    # the same rounds through both packages' sessions: the same kinds in
    # the same order, equal round indices and byte fields (JAX also
    # journals its XLA compiles, which the port does not have)
    tm, jm = _models(mode)
    paths = {}
    for name, model, attach in (("port", tm, attach_run_telemetry),
                                ("jax", jm, j_attach_run_telemetry)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        cfg = model.cfg.replace(journal_path=paths[name])
        if name == "port":
            tele = attach(model, cfg, str(tmp_path), driver="cv_train")
        else:
            tele = attach(model, cfg, str(tmp_path), True,
                          driver="cv_train")
        for batch in _rounds(4, seed=4):
            model(batch)
        tele.close(ok=True)
    t_ev, j_ev = (_journal_events(paths[n]) for n in ("port", "jax"))
    assert [r["event"] for r in t_ev] == [r["event"] for r in j_ev]
    fields = ("round", "down_bytes", "up_bytes", "wire_bytes", "mode",
              "down_bytes_total", "up_bytes_total", "resumed_round",
              "num_clients", "grad_size", "ok")
    for t, j in zip(t_ev, j_ev):
        for f in fields:
            assert t.get(f) == j.get(f), (t["event"], f)
        if t["event"] == "round" and "metrics" in j:
            for k in COUNT_METRICS:
                assert t["metrics"][k] == j["metrics"][k], k
    kinds = [r["event"] for r in t_ev]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count("round") == kinds.count("compressor") == 4


def test_driver_journal_validates_and_summarizes(tmp_path):
    # a traced cv_train run with a checkpoint a epoch: JAX's
    # validate_journal finds no problem and scripts/journal_summary.py
    # exits 0 on it, with the stage spans in its summary
    jpath = str(tmp_path / "j.jsonl")
    assert cv_train.main([
        "--test", "--device", "cpu", "--mode", "sketch", "--error_type",
        "virtual", "--virtual_momentum", "0.9", "--local_momentum", "0",
        "--num_workers", "8", "--local_batch_size", "16", "--num_epochs",
        "1.25", "--dataset_dir", str(tmp_path / "ds"), "--trace",
        "--checkpoint_every", "1", "--checkpoint_path",
        str(tmp_path / "ck"), "--journal_path", jpath])
    records = _journal_events(jpath, drop=())
    kinds = [r["event"] for r in records]
    for kind in ("run_start", "round", "compressor", "epoch",
                 "checkpoint", "trace", "run_end"):
        assert kind in kinds, kind
    assert records[-1]["ok"] is True
    rounds = [r["round"] for r in records if r["event"] == "round"]
    assert rounds == list(range(len(rounds))) and len(rounds) == 20
    spans = {s["name"] for r in records if r["event"] == "trace"
             for s in r["spans"]}
    assert {"stage", "dispatch", "collect", "gather", "round_dispatch",
            "scatter", "checkpoint", "journal_write"} <= spans
    out = subprocess.run([sys.executable, "scripts/journal_summary.py",
                          jpath], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"trace_stages"' in out.stdout


def test_nonfinite_metrics_stay_strict_json(tmp_path):
    p = str(tmp_path / "j.jsonl")
    RunJournal(p).event("round", round=0, metrics={
        "update_l2": float("nan"), "error_l2": float("inf"),
        "train_loss": np.float32(-np.inf)})
    with open(p) as f:
        line = f.read()
    assert "NaN" in line and "Infinity" in line
    import json
    json.loads(line, parse_constant=lambda c: pytest.fail(c))
    (rec,), problems = read_journal(p)
    assert problems == []
    assert np.isnan(rec["metrics"]["update_l2"])
    assert rec["metrics"]["train_loss"] == -np.inf


def test_async_journal_writer_names_item_9(tmp_path):
    # item 9's writer thread (--pipeline) is ported: it writes the
    # synchronous writer's records (tests/test_torch_pipeline.py holds
    # them byte for byte)
    j = RunJournal(str(tmp_path / "j.jsonl"), async_writer=True)
    j.event("round", round=0)
    j.flush()
    (rec,), problems = read_journal(str(tmp_path / "j.jsonl"))
    assert problems == [] and rec["round"] == 0
    j.close()


def _nan_argv(tmp_path, *extra):
    return ["--test", "--device", "cpu", "--mode", "uncompressed",
            "--local_momentum", "0", "--num_workers", "8",
            "--local_batch_size", "16", "--dataset_dir",
            str(tmp_path / "ds"), "--checkpoint_path", str(tmp_path / "ck"),
            "--journal_path", str(tmp_path / "j.jsonl"),
            "--pivot_epoch", "1", *extra]


@pytest.mark.parametrize("finite_checkpoint", [False, True],
                         ids=["no-checkpoint", "finite-checkpoint"])
def test_numeric_trip_journals_and_raises(tmp_path, finite_checkpoint):
    # a NaN learning rate makes round 0's update non-finite; the session
    # journals `numeric_trip` when round 1 arrives and raises. With a
    # finite checkpoint to return to, the driver rolls back with forced
    # screening and replays; the NaN rate is no client's fault, so the
    # replay trips again, and past --max_numeric_rollbacks (2) the trip
    # re-raises
    extra = ()
    if finite_checkpoint:
        assert cv_train.main(_nan_argv(tmp_path, "--num_epochs", "1",
                                       "--checkpoint_every", "1"))
        extra = ("--resume",)
    argv = _nan_argv(tmp_path, "--num_epochs", "2", "--lr_scale", "nan",
                     *extra)
    with pytest.raises(NumericTripError, match="update_l2"):
        cv_train.main(argv)
    records, problems = validate_journal(str(tmp_path / "j.jsonl"))
    assert problems == []
    trips = [r for r in records if r["event"] == "numeric_trip"]
    assert len(trips) == (3 if finite_checkpoint else 1)
    assert all("update_l2" in t["metrics"] for t in trips)
    assert records[-1]["event"] == "run_end"
    assert records[-1]["ok"] is False


# ---------------- the throughput tracker ------------------------------------

def _feed(tracker):
    rng = np.random.RandomState(5)
    for r in range(12):
        ids = rng.choice(40, 6, replace=False)
        ex = rng.randint(0, 9, 6).astype(np.float64)
        surv = (rng.rand(6) > 0.2).astype(np.float32)
        sched = (rng.rand(6) > 0.1).astype(np.float32)
        tracker.update_round(ids, ex, 0.05 + 0.01 * r,
                             survivors=surv if r % 2 else None,
                             scheduled=sched if r % 3 == 0 else None)
    tracker.update_round([1, 2], [3, 4], 0.0)       # no timing: skipped


def test_throughput_tracker_state_bitwise_equals_jax():
    t, j = ClientThroughputTracker(40), JTracker(40)
    _feed(t)
    _feed(j)
    ts, js = t.state_dict(), j.state_dict()
    assert list(ts) == list(js)
    for k in js:
        assert ts[k].dtype == js[k].dtype, k
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    assert (t.total_participations, t.total_completions) == (
        j.total_participations, j.total_completions)
    # JAX's state loads into the port and is written back bit for bit;
    # the legacy dense capture too
    t2 = ClientThroughputTracker(40)
    t2.load_state_dict(js)
    for k, v in t2.state_dict().items():
        np.testing.assert_array_equal(v, js[k])
    dense = {k: np.zeros(40, js[k].dtype) for k in js if k != "ids"}
    for k in dense:
        dense[k][js["ids"]] = js[k]
    t3, j3 = ClientThroughputTracker(40), JTracker(40)
    t3.load_state_dict(dense)
    j3.load_state_dict(dense)
    for k, v in j3.state_dict().items():
        np.testing.assert_array_equal(t3.state_dict()[k], v)
    with pytest.raises(ValueError, match="out of range"):
        t.update_round([40], [1], 1.0)


# ---------------- the tracer (tests/test_trace.py's cases) ------------------

def test_disabled_tracer_is_inert_and_allocation_free():
    tr = Tracer(enabled=False)
    s1 = tr.span("stage")
    assert s1 is tr.span("other", round=3)
    with s1:
        pass
    tr.instant("mark")
    tr.record("device_execute", 0.0, 1.0)
    tr.add("bytes_read", 8)
    assert tr.drain() == ([], 0)
    assert tr.current_tags() == {}
    # the global tracer off and nothing armed: the round path's span and
    # kernel region are the shared no-ops. Calling them allocates no more
    # than calling a no-op function, and entering them no more than a
    # `with` of an object that exists already
    assert not TRACE.enabled and not hooks.OBSERVERS
    assert TRACE.span("client_forward") is trace_mod._NULL_SPAN
    shapes = ((4, 8),)
    assert hooks.kernel_region("sketch_encode", "cpu", shapes, 8,
                               1) is hooks._NULL
    null = trace_mod._NULL_SPAN

    def noop(name, device=None, shapes=None, nbytes=None, flops=None):
        return None

    def noops():
        for _ in range(1000):
            noop("sketch_encode", "cpu", shapes, 8, 1)

    def span_calls():
        for _ in range(1000):
            tr.span("client_forward")

    def region_calls():
        for _ in range(1000):
            hooks.kernel_region("sketch_encode", "cpu", shapes, 8, 1)

    def spans():
        for _ in range(1000):
            with TRACE.span("client_forward"):
                pass

    def regions():
        for _ in range(1000):
            with hooks.kernel_region("sketch_encode", "cpu", shapes, 8, 1):
                pass

    def withs():
        for _ in range(1000):
            with null:
                pass

    def peak(fn):
        tracemalloc.start()
        try:
            fn()
            base = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            fn()
            return tracemalloc.get_traced_memory()[1] - base
        finally:
            tracemalloc.stop()

    assert peak(span_calls) <= peak(noops)
    assert peak(region_calls) <= peak(noops)
    assert peak(spans) <= peak(withs)
    assert peak(regions) <= peak(withs)


def test_span_records_duration_and_tags():
    t = [100.0]
    tr = Tracer(enabled=True, clock=lambda: t[0])
    with tr.span("dispatch", round=4, span=2):
        t[0] = 100.25
    (rec,), dropped = tr.drain()
    assert dropped == 0
    assert rec["name"] == "dispatch" and rec["round"] == 4
    assert rec["span"] == 2 and rec["t0"] == 100.0 and rec["dur"] == 0.25
    assert rec["thread"] == threading.current_thread().name


def test_nested_spans_inherit_correlation_tags():
    tr = Tracer(enabled=True)
    with tr.span("plan", round=7, span=1):
        assert tr.current_tags() == {"round": 7, "span": 1}
        with tr.span("plan_install"):
            pass
        tr.instant("journal_enqueue", seq=0, q=2)
    spans, _ = tr.drain()
    by_name = {r["name"]: r for r in spans}
    assert by_name["plan_install"]["round"] == 7
    assert by_name["plan_install"]["span"] == 1
    assert by_name["journal_enqueue"]["round"] == 7
    assert by_name["journal_enqueue"]["seq"] == 0
    assert by_name["journal_enqueue"]["q"] == 2
    assert tr.current_tags() == {}


def test_ring_overflow_drops_and_counts():
    tr = Tracer(enabled=True, ring_size=3)
    for i in range(5):
        tr.instant("m", i=i)
    spans, dropped = tr.drain()
    assert len(spans) == 3 and dropped == 2
    assert tr.drain() == ([], 0)


def test_drain_sorts_across_threads_by_t0():
    tr = Tracer(enabled=True)
    tr.record("b", 2.0, 3.0)
    th = threading.Thread(target=lambda: tr.record("a", 1.0, 1.5),
                          name="other-thread")
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    spans, _ = tr.drain()
    assert [r["name"] for r in spans] == ["a", "b"]
    assert {r["thread"] for r in spans} == {
        threading.current_thread().name, "other-thread"}


def test_stage_stats_p50_p95():
    spans = [{"name": "stage", "dur": d / 100.0} for d in range(1, 101)]
    spans.append({"name": "junk", "dur": "not-a-number"})
    stats = stage_stats(spans)
    assert set(stats) == {"stage"}
    assert stats["stage"]["n"] == 100
    assert stats["stage"]["p50_s"] == pytest.approx(0.51)
    assert stats["stage"]["p95_s"] == pytest.approx(0.96)
    assert stats["stage"]["total_s"] == pytest.approx(50.5)


def test_overlap_efficiency_takes_interval_union():
    spans = [{"name": "device_execute", "t0": 0.0, "dur": 2.0},
             {"name": "device_execute", "t0": 1.0, "dur": 2.0},
             {"name": "collect", "t0": 3.0, "dur": 1.0}]
    assert overlap_efficiency(spans) == pytest.approx(0.75)
    assert overlap_efficiency([{"name": "collect", "t0": 0.0,
                                "dur": 1.0}]) is None
    assert overlap_efficiency([]) is None


def test_overlap_efficiency_leaves_the_loops_spans_out_of_the_wall():
    # the training loop's train_round and data_fetch take in the batch's
    # fetch and the round's tail around the stages: the wall is the
    # stages' alone
    spans = [{"name": "train_round", "t0": -2.0, "dur": 9.0, "round": 0},
             {"name": "data_fetch", "t0": -2.0, "dur": 1.5, "round": 0},
             {"name": "device_execute", "t0": 0.0, "dur": 2.0},
             {"name": "device_execute", "t0": 1.0, "dur": 2.0},
             {"name": "collect", "t0": 3.0, "dur": 1.0}]
    assert overlap_efficiency(spans) == pytest.approx(0.75)
    assert overlap_efficiency(spans[:2]) is None


def test_trace_event_schema_valid(tmp_path):
    p = str(tmp_path / "j.jsonl")
    RunJournal(p).event("trace", controller=0, spans=[
        {"name": "dispatch", "thread": "MainThread", "t0": 1.5,
         "dur": 0.25, "round": 3}])
    records, problems = validate_journal(p)
    assert problems == []
    assert all(isinstance(r.get("mono"), float) for r in records)


@pytest.mark.parametrize("bad", [
    {"spans": "not-a-list"},
    {"spans": [{"thread": "t", "t0": 0.0, "dur": 0.1}]},
    {"spans": [{"name": "x", "t0": 0.0, "dur": 0.1}]},
    {"spans": [{"name": "x", "thread": "t", "dur": 0.1}]},
    {"spans": [{"name": "x", "thread": "t", "t0": -1.0, "dur": 0.1}]},
    {"spans": [], "dropped": -3},
    {"spans": ["not-an-object"]},
])
def test_trace_event_schema_rejects_malformed(tmp_path, bad):
    p = str(tmp_path / "j.jsonl")
    RunJournal(p).event("trace", controller=0, **bad)
    _, problems = validate_journal(p)
    assert problems, f"malformed trace record passed: {bad}"


def test_negative_mono_rejected(tmp_path):
    p = str(tmp_path / "j.jsonl")
    RunJournal(p, mono_clock=lambda: -5.0).event("x")
    _, problems = validate_journal(p)
    assert any("mono" in pr for pr in problems)


def test_session_flushes_spans_and_disables_the_tracer(tmp_path):
    p = str(tmp_path / "j.jsonl")
    tele = TelemetrySession(journal=RunJournal(p), trace=True)
    assert TRACE.enabled
    with TRACE.span("stage", round=0):
        pass
    tele.on_round(0, np.arange(2), None, torch.ones(2))
    tele.close(ok=True)
    assert not TRACE.enabled
    records, problems = validate_journal(p)
    assert problems == []
    assert [r["event"] for r in records] == ["round", "trace", "run_end"]
    assert records[1]["spans"][0]["name"] == "stage"


# ---------------- program spans on the profiler's clock --------------------

ROUND_SPANS = ("train_round", "data_fetch", "client_forward",
               "client_backward", "server_update", "decode", "collect",
               "account")


def _gpt2(tmp_path, workers=3):
    argv = ["--test", "--device", "cpu", "--dataset_name", "PERSONA",
            "--dataset_dir", str(tmp_path / "ds"), "--local_momentum", "0",
            "--num_workers", str(workers), "--local_batch_size", "2",
            "--num_epochs", "1", "--mode", "sketch", "--error_type",
            "virtual", "--virtual_momentum", "0.9", "--lr_scale", "0.1"]
    cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=argv)
    return gpt2_train.build(cfg, HashTokenizer(100), device="cpu")


class _Stop(Exception):
    pass


def _train(built, rounds):
    model, opt, sched, loader, _ = built

    def on_round(i, out):
        if i == rounds - 1:
            raise _Stop

    with pytest.raises(_Stop):
        gpt2_train.train_gpt2(model, opt, sched, loader, model.cfg,
                              logger=SilentLogger(), on_round=on_round)


def test_profiled_gpt2_rounds_name_their_spans_on_the_rounds_thread(
        tmp_path):
    W, rounds = 3, 2
    built = _gpt2(tmp_path, W)
    TRACE.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _train(built, rounds)
    recs, dropped = TRACE.drain()
    assert dropped == 0
    recs = [r for r in recs if r["name"] in ROUND_SPANS]
    evs = sorted((e for e in prof.profiler.kineto_results.events()
                  if e.name() in ROUND_SPANS
                  or e.name().startswith("kernel.")),
                 key=lambda e: e.start_ns())
    # host events of one thread, the round's, one for each TRACE record
    assert len({e.start_thread_id() for e in evs}) == 1
    assert not any(e.is_user_annotation() for e in evs)
    for name in ROUND_SPANS:
        mine = [r for r in recs if r["name"] == name]
        assert len(mine) == len([e for e in evs if e.name() == name]), name
    want = {"train_round": rounds, "data_fetch": rounds,
            "client_forward": W * rounds, "client_backward": rounds,
            "server_update": rounds, "decode": rounds, "collect": rounds,
            "account": rounds}
    assert {n: sum(r["name"] == n for r in recs) for n in want} == want
    assert [r["client"] for r in recs if r["name"] == "client_forward"] == (
        list(range(W)) * rounds)
    assert [r["round"] for r in recs if r["name"] == "client_backward"] == (
        list(range(rounds)))
    assert all(r["clients"] == W for r in recs if r["name"] == "data_fetch")

    def span(e):
        return e.start_ns(), e.start_ns() + e.duration_ns()

    def within(e, outer):
        (a, b), (lo, hi) = span(e), span(outer)
        return lo <= a and b <= hi

    def only(name, parent):
        return [e for e in evs if e.name() == name and within(e, parent)]

    kernels = [e for e in evs if e.name().startswith("kernel.")]
    assert {e.name() for e in kernels} >= {"kernel.sketch_encode"}
    for tr in (e for e in evs if e.name() == "train_round"):
        (fetch,) = only("data_fetch", tr)
        fwds = only("client_forward", tr)
        (bwd,) = only("client_backward", tr)
        (upd,) = only("server_update", tr)
        (dec,) = only("decode", upd)
        (collect,) = only("collect", tr)
        (account,) = only("account", collect)
        assert len(fwds) == W
        # in the round's order: the fetch, the forwards one after
        # another, the backward, then the server's step and its decode
        seq = [fetch, *fwds, bwd, upd]
        assert all(span(a)[1] <= span(b)[0] for a, b in zip(seq, seq[1:]))
        assert within(dec, upd)
        assert any(within(k, dec) for k in kernels)
    assert all(any(within(k, tr) for tr in evs if tr.name() == "train_round")
               for k in kernels)


def test_profile_trace_names_the_spans_under_trace(tmp_path, monkeypatch,
                                                  capsys):
    # the operator's use: --profile's Chrome trace of a --trace run holds
    # the program's spans and kernel regions as named ranges
    monkeypatch.chdir(tmp_path)
    assert gpt2_train.main([
        "--test", "--device", "cpu", "--dataset_name", "PERSONA",
        "--dataset_dir", str(tmp_path / "ds"), "--local_momentum", "0",
        "--num_workers", "3", "--local_batch_size", "2", "--num_epochs", "1",
        "--valid_batch_size", "4", "--lr_scale", "0.1", "--mode", "sketch",
        "--error_type", "virtual", "--virtual_momentum", "0.9", "--trace",
        "--profile"])
    out = capsys.readouterr().out
    path = out.split("profile trace written to ", 1)[1].splitlines()[0]
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(ROUND_SPANS) <= names
    assert "kernel.sketch_encode" in names


def test_recorded_round_is_the_same_with_spans_under_a_profiler():
    batch = _rounds(1)[0]

    def recorded():
        tm, _ = _models("sketch", telemetry=False, jax_too=False)
        with RoundRecorder() as rec:
            tm(batch)
        return [r.signature for r in rec.records], rec.digest()

    ops, digest = recorded()
    assert any(r is not None for r in ops)
    TRACE.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ops_on, digest_on = recorded()
    TRACE.disable()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"dispatch", "round_dispatch", "server_update", "decode",
            "kernel.sketch_encode"} <= names
    assert ops_on == ops and digest_on == digest


def test_data_fetch_counts_the_members_it_reads(tmp_path):
    W = 3
    built = _gpt2(tmp_path, W)
    loader = built[3]
    z = np.load(loader.dataset._npz_path("train"))
    members = sum(z[k].nbytes for k in z.files)
    assert set(z.files) == {"offsets", "input_ids", "mc_token_ids",
                            "lm_labels", "mc_labels", "token_type_ids"}
    it = loader.epoch()
    next(it)                        # tracing off: no record, no count
    TRACE.enable()
    next(it)
    next(it)
    recs, _ = TRACE.drain()
    assert [r["name"] for r in recs] == ["data_fetch"] * 2
    assert all(r["bytes_read"] == W * members and r["clients"] == W
               for r in recs)


def test_tracer_add_counts_into_the_innermost_open_span():
    tr = Tracer(enabled=True)
    tr.add("bytes_read", 5)                     # outside every span
    with tr.span("data_fetch", bytes_read=0):
        tr.add("bytes_read", 5)
        with tr.span("inner"):
            tr.add("bytes_read", 2)
        tr.add("bytes_read", 7)
    recs, _ = tr.drain()
    by = {r["name"]: r for r in recs}
    assert by["data_fetch"]["bytes_read"] == 12
    assert by["inner"]["bytes_read"] == 2


def _metric(name):
    path = os.path.join(REPO, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,want", [
    ("data.fetch_ms", 1e3 * (0.010 + 0.030) / 2),
    ("data.read_mib", 2 * 3 * 2 ** 20 / 2 ** 20 / 2),
    ("host.client_forwards_ms", 1e3 * (0.001 + 0.002 + 0.003) / 2),
    ("host.server_update_ms", 1e3 * 0.050 / 2),
])
def test_span_metrics_read_a_hand_built_run(name, want):
    spans = [
        {"name": "data_fetch", "dur": 0.010, "bytes_read": 3 * 2 ** 20},
        {"name": "data_fetch", "dur": 0.030, "bytes_read": 3 * 2 ** 20},
        {"name": "client_forward", "dur": 0.001},
        {"name": "client_forward", "dur": 0.002},
        {"name": "client_forward", "dur": 0.003},
        {"name": "server_update", "dur": 0.050},
        {"name": "round_dispatch", "dur": 0.500}]
    mod = _metric(name)
    assert mod.SOURCE == "program_span" and mod.MOVES == "round_ms"
    got = mod.read(types.SimpleNamespace(spans=spans, host_rounds=2))
    assert got == pytest.approx(want)
    assert mod.read(types.SimpleNamespace(spans=[], host_rounds=2)) is None
    assert mod.read(types.SimpleNamespace(spans=spans,
                                          host_rounds=0)) is None


def test_trace_and_hooks_import_without_torch():
    path = os.path.join(REPO, "commefficient_tpu_torch", "telemetry",
                        "trace.py")
    code = (
        "import importlib.util, sys\n"
        "sys.modules['torch'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from commefficient_tpu_torch import hooks\n"
        "spec = importlib.util.spec_from_file_location('trace_alone', "
        f"{path!r})\n"
        "trace = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(trace)\n"
        "trace.TRACE.enable()\n"
        "with trace.TRACE.span('train_round', round=0):\n"
        "    with hooks.kernel_region('k', 'cpu', ((2,),), 8, 1):\n"
        "        pass\n"
        "spans, dropped = trace.TRACE.drain()\n"
        "assert [s['name'] for s in spans] == ['train_round'], spans\n"
        "assert hooks.profiler_range('k') is None\n"
        "assert 'torch' not in [m for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
