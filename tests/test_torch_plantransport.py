"""The control plane's plan transport (commefficient_tpu_torch/parallel/
plantransport.py) against the JAX package's, and the port's
counterparts of tests/test_controlplane.py:190-630.

  * The wire: the port's serialize_plan bytes are JAX's for the same
    RoundPlan (with and without screen_mult / controls), and each
    package deserializes the other's; install_digest is JAX's on the
    same operands; each package's journaled_plan_stream reads a journal
    the other wrote into the same two maps.
  * N controllers == one: the emulated N-controller runs (followers'
    trackers never fed, every plan installed from the bus) are bitwise
    the single-controller run, per mode; the write-ahead digests are
    journaled before their rounds and equal the JAX run's on the same
    pinned-clock inputs.
  * Divergence raises PlanDigestError: a controller's other digest, a
    doctored journal digest on a replay, a skewed follower draw.
  * Faults: a dropped, a duplicated and a slow broadcast ridden out
    bitwise; the coordinator killed mid-broadcast, then the takeover
    (promote, the shared checkpoint, the journaled plans replayed and
    their digests consumed) bitwise the uninterrupted run, with
    --pipeline too; async admission carried by the digests.
  * Config: --plan_transport validates where JAX's does, and refuses
    with JAX's messages where JAX's does.

The model is a linear regression on a host pool (test_controlplane's);
the tracker is fed scripted seconds, and the sessions' clocks are
pinned, never the wall clock.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu import scheduler as jsched
from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.data.sampler import FedSampler as JFedSampler
from commefficient_tpu.federated.api import (
    FedModel as JFedModel, FedOptimizer as JFedOptimizer,
)
from commefficient_tpu.parallel import plantransport as jpt
from commefficient_tpu.telemetry import (
    RunJournal as JRunJournal, TelemetrySession as JTelemetrySession,
)
from commefficient_tpu.utils import faults as jfaults
from commefficient_tpu_torch import scheduler as tsched
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.data.sampler import FedSampler
from commefficient_tpu_torch.federated.api import FedModel, FedOptimizer
from commefficient_tpu_torch.parallel import plantransport as tpt
from commefficient_tpu_torch.parallel.plantransport import (
    EmulatedPlanNetwork, EmulatedTransport, HostCollectiveTransport,
    PLAN_WIRE_VERSION, PlanDigestError, attach_emulated_cluster,
    deserialize_plan, install_digest, journaled_schedule_digests,
    plan_digest, serialize_plan,
)
from commefficient_tpu_torch.telemetry import RunJournal, TelemetrySession
from commefficient_tpu_torch.utils.checkpoint import load_latest, save_rotating
from commefficient_tpu_torch.utils.faults import FaultSchedule, InjectedFault

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

D = 8
W = 8
B = 4
NC = 16  # client population


class Lin(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(D))


def _t_loss(params, batch, mask):
    x, y = batch
    per_ex = 0.5 * (x @ params["w"] - y) ** 2
    loss = (per_ex * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, (loss,)


def _j_loss(params, batch, mask):
    x, y = batch
    per_ex = 0.5 * (x @ params["w"] - y) ** 2
    loss = (per_ex * mask).sum() / jnp.maximum(mask.sum(), 1.0)
    return loss, (loss,)


def _kw(**kw):
    return {**dict(mode="uncompressed", grad_size=D, weight_decay=0.0,
                   num_workers=W, local_momentum=0.0, virtual_momentum=0.9,
                   error_type="none", microbatch_size=-1, num_clients=NC,
                   sampler="throughput"), **kw}


def _cfg(**kw):
    return TConfig(**_kw(**kw), device="cpu").validate()


def _fed_model(cfg):
    model = FedModel(Lin(), _t_loss, cfg, device="cpu", num_clients=NC)
    opt = FedOptimizer(model)
    opt.param_groups[0]["lr"] = 0.1
    return model, opt


def _j_fed_model(**kw):
    cfg = JConfig(**_kw(**kw)).validate()
    model = JFedModel(None, _j_loss, cfg, params={"w": jnp.zeros(D)})
    JFedOptimizer(model).param_groups[0]["lr"] = 0.1
    return model


def _client_pool(seed=0):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(D).astype(np.float32)
    x = rng.randn(NC, B, D).astype(np.float32)
    y = np.einsum("cbd,d->cb", x, w_true).astype(np.float32)
    return x, y


class _Loader:
    """attach_emulated_cluster reads only `.sampler`."""

    def __init__(self, sampler):
        self.sampler = sampler


def _sampler(cls=FedSampler):
    return cls(np.full(NC, B), W, B, seed=7)


def _attach_single(model):
    """One RoundScheduler over the model's tracker, no transport."""
    smp = _sampler()
    sched = tsched.RoundScheduler(model.cfg, model.num_clients,
                                  model.throughput)
    smp.scheduler = sched
    model.attach_scheduler(sched)
    model.attach_data_sampler(smp)
    return smp


def _attach_emulated(model, num=3, schedule=None, network=None,
                     coordinator=0, pkg=tpt, smp_cls=FedSampler):
    smp = _sampler(smp_cls)
    mirror, net = pkg.attach_emulated_cluster(
        model, _Loader(smp), num_controllers=num, coordinator=coordinator,
        schedule=schedule, network=network)
    return smp, mirror, net


def _save(model, prefix):
    save_rotating(prefix, model.server, model.clients, scheduler_step=0,
                  accountant=model.accountant,
                  prev_change_words=model._prev_change_words,
                  fingerprint=model.checkpoint_fingerprint,
                  throughput=model.throughput.state_dict(),
                  scheduler=model.scheduler_state(),
                  sampler=model.sampler_state(),
                  async_admit=model.async_admit_state(),
                  client_rows=model.client_rows_payload())


def _drive(model, smp, pool, total_rounds, start=0, save_after=None,
           ckpt_prefix=None, feed_tracker=True):
    """test_controlplane's driver loop: begin_epoch, the sampler's
    stream, a round each, the tracker fed seconds that are a pure
    function of the round, and a rotated save after `save_after`."""
    x, y = pool
    done = start
    ids_log = []
    while done < total_rounds:
        if model.scheduler is not None:
            model.scheduler.begin_epoch(done)
        for ids, idx, mask in smp.epoch():
            ids_arr = np.asarray(ids)
            model((ids_arr, (x[ids_arr[:, None], idx],
                             y[ids_arr[:, None], idx]), mask))
            ids_log.append(ids_arr.copy())
            if feed_tracker:
                secs = 1.0 + 0.5 * (done % 3)
                model.throughput.update_round(ids_arr, mask.sum(axis=1),
                                              secs)
            done += 1
            if save_after is not None and done == save_after + 1:
                _save(model, ckpt_prefix)
            if done >= total_rounds:
                break
    return ids_log


def _server_bits(model):
    out = []
    for t in model.server:
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)
        out.append(a)
    return out


def _assert_servers_equal(a, b):
    for x, y in zip(_server_bits(a), _server_bits(b)):
        np.testing.assert_array_equal(x, y)


# ---------------- the wire, against the JAX package ------------------------

def _plans(make):
    rng = np.random.RandomState(3)
    return [
        make(0, W, None, None, None, None, None, "uniform"),
        make(7, 5, (rng.rand(W) > 0.5).astype(np.float32),
             rng.rand(W).astype(np.float32), 1.2345678, 0.1, 9.87,
             "throughput", np.array([3, 1, 4, 1, 5], np.int64)),
        # awkward f32 values survive the JSON wire bitwise
        make(1, W, None,
             np.array([np.float32(1 / 3), np.float32(1e-30),
                       np.float32(0.1)] + [1.0] * (W - 3), np.float32),
             None, None, None, "throughput", np.arange(W, dtype=np.int64)),
        make(4, 6, None, None, None, None, None, "throughput",
             np.arange(6, dtype=np.int64), screen_mult=np.float32(3.7)),
        make(5, W, None, None, 2.5, 1.0, 2.0, "throughput",
             np.arange(W, dtype=np.int64), screen_mult=5.0,
             controls={"span_pick": 4, "staleness_decay": 0.123456789,
                       "speed_ratio": np.float32(0.3)}),
    ]


@pytest.mark.parametrize("i", range(5))
def test_plan_wire_is_jax_bytes_and_roundtrips(i):
    plan = _plans(tsched.RoundPlan)[i]
    jplan = _plans(jsched.RoundPlan)[i]
    wire = serialize_plan(plan)
    assert wire == jpt.serialize_plan(jplan)
    assert plan_digest(plan) == jpt.plan_digest(jplan)
    back = deserialize_plan(wire)
    assert serialize_plan(back) == wire
    for a, b in zip(plan, back):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, np.asarray(b))
        elif a is None:
            assert b is None
    # each package installs the other's bytes
    assert jpt.serialize_plan(jpt.deserialize_plan(wire)) == wire
    assert serialize_plan(deserialize_plan(jpt.serialize_plan(jplan))) \
        == wire


def test_plan_wire_version_skew_fails_loud():
    wire = serialize_plan(tsched.RoundPlan(0, W, None, None, None, None,
                                           None, "uniform"))
    obj = json.loads(wire)
    obj["v"] = PLAN_WIRE_VERSION + 1
    with pytest.raises(PlanDigestError, match="wire version"):
        deserialize_plan(json.dumps(obj).encode())
    assert (PLAN_WIRE_VERSION, tpt.PLAN_MAX_BYTES) == (
        jpt.PLAN_WIRE_VERSION, jpt.PLAN_MAX_BYTES)


def test_host_collective_pack_unpack_and_degenerate_broadcast():
    t = HostCollectiveTransport(max_bytes=1 << 12)
    payload = serialize_plan(tsched.RoundPlan(
        2, 3, None, None, None, None, None, "throughput",
        np.array([9, 2, 11], np.int64)))
    assert t.unpack(t.pack(payload)) == payload
    np.testing.assert_array_equal(
        t.pack(payload), jpt.HostCollectiveTransport(1 << 12).pack(payload))
    assert t.unpack(t.pack(None)) == b""
    with pytest.raises(ValueError, match="transport max"):
        t.pack(b"x" * ((1 << 12) + 1))
    # out of torch.distributed: the identity, and verify a no-op
    assert t.is_coordinator
    assert t.broadcast(2, payload) == payload
    t.verify(2, plan_digest(deserialize_plan(payload)))
    assert t.group is None and t.stats.calls == 0


DIGEST_CASES = {
    "plain": (3, np.arange(W), np.ones(W, np.float32), None, ()),
    "no-survivors": (3, np.arange(W), None, None, ()),
    "admits": (3, np.arange(W), np.ones(W, np.float32),
               np.linspace(0.2, 1.0, W).astype(np.float32),
               [(2, 9, 0.25, 1), (5, 3, float(np.float32(1 / 3)), 0)]),
    "screened": (9, np.arange(W)[::-1], (np.arange(W) % 2).astype(
        np.float32), None, ()),
}


@pytest.mark.parametrize("case", sorted(DIGEST_CASES))
def test_install_digest_is_jax_and_covers_every_operand(case):
    r, ids, surv, work, admits = DIGEST_CASES[case]
    kw = {}
    if case == "screened":
        kw = dict(poison=(np.arange(W) == 3).astype(np.float32),
                  screen_on=np.float32(2.5))
    d = install_digest(r, ids, surv, work, admits, **kw)
    assert d == jpt.install_digest(r, ids, surv, work, admits, **kw)
    assert d != install_digest(r + 1, ids, surv, work, admits, **kw)
    if surv is not None:
        assert d != install_digest(r, ids, None, work, admits, **kw)
    # f32 quantization: the same f32 fraction written two ways
    assert install_digest(3, np.arange(W), None, None,
                          [(2, 9, 0.25, 1)]) == install_digest(
        3, np.arange(W), None, None, [(2, 9, float(np.float32(0.25)), 1)])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journaled_plan_stream_reads_the_other_packages_journal(
        tmp_path, writer):
    path = str(tmp_path / "j.jsonl")
    journal = (JRunJournal if writer == "jax" else RunJournal)(path)
    plans = _plans(tsched.RoundPlan)
    for p in plans:
        fields = p.journal_fields()
        fields["plan"] = serialize_plan(p).decode()
        fields["digest"] = plan_digest(p)
        journal.event("schedule", **fields)
    # a later record of a round replaces the earlier one
    journal.event("schedule", round=7, sampler="throughput", n_sampled=5,
                   digest="e" * 64)
    journal.event("round", round=7)
    journal.close()
    t_d, t_p = tpt.journaled_plan_stream(path)
    j_d, j_p = jpt.journaled_plan_stream(path)
    assert (t_d, t_p) == (j_d, j_p)
    assert sorted(t_p) == sorted(p.round_idx for p in plans)
    assert t_d[7] == "e" * 64
    for p in plans:
        assert t_p[p.round_idx] == serialize_plan(p)
    assert tpt.journaled_plans(path) == t_p
    assert journaled_schedule_digests(path) == t_d
    assert tpt.journaled_plan_stream(str(tmp_path / "none")) == ({}, {})


def test_fault_schedule_control_plane_members_are_jax():
    t, j = FaultSchedule(), jfaults.FaultSchedule()
    for name in ("coordinator_crash_at", "broadcast_drop",
                 "broadcast_dup", "broadcast_slow"):
        assert getattr(t, name) == getattr(j, name), name
    kw = dict(coordinator_crash_at=4, broadcast_drop=(1,),
              broadcast_dup=[2], broadcast_slow={3: 2})
    t, j = FaultSchedule(**kw), jfaults.FaultSchedule(**kw)
    for r in range(6):
        assert t.should_crash_coordinator(r) == j.should_crash_coordinator(r)
        assert t.broadcast_duplicated(r) == j.broadcast_duplicated(r)
        assert t.broadcast_slow_attempts(r) == j.broadcast_slow_attempts(r)
        for att in range(3):
            assert t.broadcast_dropped(r, att) == j.broadcast_dropped(r,
                                                                      att)
    assert t.broadcast_slow_attempts(3) == 2
    assert t.broadcast_dropped(1, 0) and not t.broadcast_dropped(1, 1)
    # the coordinator's crash is the last completed round's fault, and
    # fires again while the schedule stays installed
    net = EmulatedPlanNetwork(2, schedule=t)
    for _ in range(2):
        net.dead.clear()
        with pytest.raises(InjectedFault) as exc:
            EmulatedTransport(net, 0).broadcast(4, b"{}")
        assert exc.value.round_idx == 3 and 0 in net.dead


# ---------------- N controllers == one -------------------------------------

MODE_CFGS = {
    "sketch": dict(mode="sketch", error_type="virtual", k=4,
                   num_rows=2, num_cols=32, num_blocks=1),
    "true_topk": dict(mode="true_topk", error_type="virtual", k=4),
    "fedavg": dict(mode="fedavg", local_batch_size=-1,
                   virtual_momentum=0.0),
}


@pytest.mark.parametrize("mode", sorted(MODE_CFGS))
def test_ncontroller_bit_identical_to_single(mode):
    R = 6
    cfg = _cfg(**MODE_CFGS[mode])
    model_a, _ = _fed_model(cfg)
    ids_a = _drive(model_a, _attach_single(model_a), _client_pool(), R)

    model_b, _ = _fed_model(cfg)
    smp_b, mirror, net = _attach_emulated(model_b, num=3)
    ids_b = _drive(model_b, smp_b, _client_pool(), R)

    assert len(ids_a) == len(ids_b) == R
    for a, b in zip(ids_a, ids_b):
        np.testing.assert_array_equal(a, b)
    _assert_servers_equal(model_a, model_b)
    # each round broadcast once, every controller's plan digest
    # registered, and the model's install digest (the coordinator's)
    assert sorted(net.deliveries) == list(range(R))
    assert all(v == 1 for v in net.deliveries.values())
    assert all(len(net._digests[(r, "plan")]) == 3
               and len(net._digests[(r, "install")]) == 1
               for r in range(R))


def _journaled_run(tmp_path, name, pkg, R, **kw):
    """An emulated 2-controller run of `pkg` ("port" or "jax") with a
    journal on a pinned clock; returns the journal's path."""
    path = str(tmp_path / f"{name}.jsonl")
    if pkg == "port":
        model, _ = _fed_model(_cfg(**kw))
        smp, _, _ = _attach_emulated(model, num=2)
        tele = TelemetrySession(journal=RunJournal(path),
                                tracker=model.throughput, clock=lambda: 0.0)
    else:
        model = _j_fed_model(**kw)
        smp, _, _ = _attach_emulated(model, num=2, pkg=jpt,
                                     smp_cls=JFedSampler)
        tele = JTelemetrySession(journal=JRunJournal(path),
                                 tracker=model.throughput,
                                 clock=lambda: 0.0)
    model.attach_telemetry(tele)
    _drive(model, smp, _client_pool(), R)
    tele.close()
    return path, model


def test_write_ahead_digests_journaled_and_equal_to_jax(tmp_path):
    R = 4
    jpath, _ = _journaled_run(tmp_path, "port", "port", R)
    digests = journaled_schedule_digests(jpath)
    assert sorted(digests) == list(range(R))
    assert all(len(d) == 64 for d in digests.values())
    # a round's schedule event precedes its round record (write-ahead)
    events = [(r.get("event"), r.get("round"))
              for r in (json.loads(line) for line in open(jpath))
              if r.get("event") in ("schedule", "round")]
    for r in range(R):
        assert events.index(("schedule", r)) < events.index(("round", r))
    # the same inputs through the JAX package: the same digests and plans
    j_path, _ = _journaled_run(tmp_path, "jax", "jax", R)
    assert jpt.journaled_plan_stream(j_path) == \
        tpt.journaled_plan_stream(jpath)


# ---------------- divergence raises ---------------------------------------

def test_plan_digest_divergence_fails_loud():
    net = EmulatedPlanNetwork(2)
    t0, t1 = EmulatedTransport(net, 0), EmulatedTransport(net, 1)
    t0.verify(3, "a" * 64)
    t0.verify(3, "b" * 64, scope="install")  # another scope: no clash
    with pytest.raises(PlanDigestError, match="diverged"):
        t1.verify(3, "c" * 64)


def test_injected_install_divergence_fails_loud():
    """A doctored journal digest fails the replay at its round."""
    model, _ = _fed_model(_cfg())
    smp, _, _ = _attach_emulated(model, num=2)
    model._replay_digests = {1: "f" * 64}
    with pytest.raises(PlanDigestError, match="diverged"):
        _drive(model, smp, _client_pool(), 2)


def test_follower_shared_stream_divergence_fails_loud():
    model, _ = _fed_model(_cfg(sampler="uniform", deadline_quantile=0.5))
    smp, mirror, _ = _attach_emulated(model, num=2)
    follower = mirror.schedulers[1]
    orig = follower.policy.select

    def skewed(alive, num_slots, rng, round_idx):
        return np.asarray(orig(alive, num_slots, rng, round_idx))[::-1]

    follower.policy.select = skewed
    with pytest.raises(PlanDigestError):
        _drive(model, smp, _client_pool(), 2, feed_tracker=False)


# ---------------- the broadcast's faults -----------------------------------

def test_broadcast_drop_dup_slow_ride_retry():
    R = 5
    cfg = _cfg()
    model_a, _ = _fed_model(cfg)
    _drive(model_a, _attach_single(model_a), _client_pool(), R)

    sched = FaultSchedule(broadcast_drop=(1,), broadcast_dup=(2,),
                          broadcast_slow={3: 2})
    model_b, _ = _fed_model(cfg)
    smp_b, _, net = _attach_emulated(model_b, num=2, schedule=sched)
    _drive(model_b, smp_b, _client_pool(), R)

    assert net._send_attempts[1] == 2       # the first send lost
    assert net.deliveries[2] == 2           # delivered twice
    assert net._recv_attempts[(2, 1)] >= 2  # and installed again
    assert net._recv_attempts[(3, 1)] >= 3  # the slow receive retried
    _assert_servers_equal(model_a, model_b)


# ---------------- the coordinator killed, the takeover ---------------------

def test_coordinator_crash_takeover_resume_bit_exact(tmp_path):
    """A checkpoint after round 1, the coordinator dies broadcasting
    round 4 (rounds 2-3 ran and were journaled, not checkpointed);
    controller 1 is promoted, loads the checkpoint, replays rounds 2-3
    from the journaled plans against their digests and runs 4-5:
    bitwise the uninterrupted 3-controller run."""
    R = 6
    jpath = str(tmp_path / "journal.jsonl")
    prefix = str(tmp_path / "ckpt" / "model")
    cfg = _cfg()

    model_a, _ = _fed_model(cfg)
    smp_a, _, _ = _attach_emulated(model_a, num=3)
    ids_a = _drive(model_a, smp_a, _client_pool(), R)

    model_b, _ = _fed_model(cfg)
    smp_b, _, net = _attach_emulated(
        model_b, num=3, schedule=FaultSchedule(coordinator_crash_at=4))
    tele_b = TelemetrySession(journal=RunJournal(jpath),
                              tracker=model_b.throughput, clock=lambda: 0.0)
    model_b.attach_telemetry(tele_b)
    with pytest.raises(InjectedFault) as exc:
        _drive(model_b, smp_b, _client_pool(), R, save_after=1,
               ckpt_prefix=prefix)
    assert exc.value.round_idx == 3
    tele_b.close()
    assert 0 in net.dead

    assert net.promote() == 1
    net.schedule = None
    model_c, _ = _fed_model(cfg)
    smp_c, mirror_c, _ = _attach_emulated(model_c, network=net)
    assert mirror_c.transports[1].is_coordinator
    ckpt = load_latest(prefix,
                       expect_fingerprint=model_c.checkpoint_fingerprint)
    model_c.load_state(ckpt)
    model_c.load_plan_stream(jpath)
    done = int(np.asarray(ckpt.server.round_idx))
    assert done == 2
    assert {2, 3} <= set(model_c._replay_digests)
    ids_c = _drive(model_c, smp_c, _client_pool(), R, start=done)
    # the replayed digests were checked and consumed
    assert not {2, 3} & set(model_c._replay_digests)
    np.testing.assert_array_equal(np.stack(ids_a[done:]), np.stack(ids_c))
    _assert_servers_equal(model_a, model_c)


def test_coordinator_crash_with_pipeline_prefetch(tmp_path):
    """--pipeline: the crash fires in the staging thread's draw of the
    next span while a span is in flight; the resume from the last span
    boundary saved is bitwise the uninterrupted pipelined run."""
    from commefficient_tpu_torch.training.scanloop import (
        make_span_checkpoint, run_scanned_rounds,
    )
    from commefficient_tpu_torch.utils.schedules import LambdaLR

    R = 6
    prefix = str(tmp_path / "pipe" / "model")
    cfg = _cfg(pipeline=True, checkpoint_every=1, ckpt_every_spans=1,
               scan_rounds=True, scan_span=1)
    pool = _client_pool()

    def scan_drive(model, smp, total, start=0, checkpoint=None):
        x, y = pool
        done = [start]

        def stream():
            while done[0] < total:
                if model.scheduler is not None:
                    model.scheduler.begin_epoch(done[0])
                for ids, idx, mask in smp.epoch():
                    ids_arr = np.asarray(ids)
                    yield (done[0], ids_arr, (x[ids_arr[:, None], idx],
                                              y[ids_arr[:, None], idx]),
                           mask, 0.1)
                    done[0] += 1
                    if done[0] >= total:
                        return

        return run_scanned_rounds(model, stream(), 1, lambda *a: True,
                                  checkpoint=checkpoint, pipeline=True)

    model_a, _ = _fed_model(cfg)
    assert scan_drive(model_a, _attach_single(model_a), R)
    model_a.close_persistence()

    model_b, opt_b = _fed_model(cfg)
    smp_b, _, net = _attach_emulated(
        model_b, num=2, schedule=FaultSchedule(coordinator_crash_at=4))
    hook = make_span_checkpoint(prefix, model_b, cfg,
                                LambdaLR(opt_b, lr_lambda=lambda s: 1.0))
    with pytest.raises(InjectedFault):
        scan_drive(model_b, smp_b, R, checkpoint=hook)
    model_b.close_persistence()

    net.promote()
    net.schedule = None
    model_c, _ = _fed_model(cfg)
    smp_c, _, _ = _attach_emulated(model_c, network=net)
    ckpt = load_latest(prefix,
                       expect_fingerprint=model_c.checkpoint_fingerprint)
    model_c.load_state(ckpt)
    done = int(np.asarray(ckpt.server.round_idx))
    # round 4's draw crashed while span 3 was in flight: the last
    # boundary saved is span 2's at the latest
    assert done <= 3
    assert scan_drive(model_c, smp_c, R, start=done)
    _assert_servers_equal(model_a, model_c)
    model_c.close_persistence()


# ---------------- async admission rides the digests ------------------------

def test_async_admit_plan_carried_identity(tmp_path):
    """k = 1 admission under 2 controllers: bitwise the one-controller
    run, a digest for every round, the same digest stream from a second
    transport run and from the JAX package on the same inputs."""
    R = 5
    kw = dict(async_admit_rounds=1, straggler_rate=0.5,
              straggler_min_work=0.4)
    model_a, _ = _fed_model(_cfg(**kw))
    _drive(model_a, _attach_single(model_a), _client_pool(), R)

    jb, model_b = _journaled_run(tmp_path, "b", "port", R, **kw)
    _assert_servers_equal(model_a, model_b)
    digests = journaled_schedule_digests(jb)
    assert sorted(digests) == list(range(R))
    recs = [json.loads(line) for line in open(jb)]
    assert any(r.get("event") == "schedule" for r in recs)

    jc, _ = _journaled_run(tmp_path, "c", "port", R, **kw)
    assert journaled_schedule_digests(jc) == digests
    jj, _ = _journaled_run(tmp_path, "j", "jax", R, **kw)
    assert jpt.journaled_schedule_digests(jj) == digests


def test_emulated_driver_crash_from_the_environment(tmp_path, monkeypatch):
    """cv_train --plan_transport emulated: CCTPU_EMU_COORD_CRASH kills
    the coordinator broadcasting that round."""
    from commefficient_tpu_torch.training import cv_train
    monkeypatch.setenv("CCTPU_EMU_COORD_CRASH", "2")
    monkeypatch.chdir(tmp_path)
    argv = ["--test", "--device", "cpu", "--mode", "sketch",
            "--error_type", "virtual", "--local_momentum", "0",
            "--num_workers", "4", "--num_epochs", "0.25",
            "--dataset_dir", str(tmp_path / "ds"), "--sampler",
            "throughput", "--plan_transport", "emulated",
            "--plan_controllers", "3", "--journal_path",
            str(tmp_path / "j.jsonl")]
    with pytest.raises(InjectedFault) as exc:
        cv_train.main(argv)
    assert exc.value.round_idx == 1
    assert sorted(journaled_schedule_digests(str(tmp_path / "j.jsonl"))) \
        == [0, 1]


# ---------------- Config ---------------------------------------------------

MH = dict(mode="uncompressed", local_momentum=0.0, error_type="none",
          multihost=True, num_workers=4)
VALIDATES = {
    "throughput": dict(MH, sampler="throughput",
                       plan_transport="collective"),
    "deadline": dict(MH, deadline_quantile=0.5,
                     plan_transport="collective"),
    "target": dict(MH, target_survivors=2, plan_transport="collective"),
    "async": dict(MH, async_admit_rounds=1, plan_transport="collective"),
    "checkpoint-journal": dict(mode="uncompressed", local_momentum=0.0,
                               error_type="none", plan_transport="emulated",
                               do_checkpoint=True, checkpoint_path="/tmp/ck",
                               journal_path="/tmp/j.jsonl"),
}
REFUSES = {
    "throughput-no-transport": dict(MH, sampler="throughput"),
    "deadline-no-transport": dict(MH, deadline_quantile=0.5),
    "target-no-transport": dict(MH, target_survivors=2),
    "emulated-multihost": dict(MH, plan_transport="emulated"),
    "one-controller": dict(mode="uncompressed", local_momentum=0.0,
                           error_type="none", plan_transport="emulated",
                           plan_controllers=1),
    "no-controllers": dict(mode="uncompressed", local_momentum=0.0,
                           error_type="none", plan_transport="collective",
                           plan_controllers=0),
    "checkpoint-no-journal": dict(mode="uncompressed", local_momentum=0.0,
                                  error_type="none",
                                  plan_transport="emulated",
                                  do_checkpoint=True,
                                  checkpoint_path="/tmp/ck"),
    "unknown": dict(mode="uncompressed", local_momentum=0.0,
                    error_type="none", plan_transport="smoke"),
}


@pytest.mark.parametrize("case", sorted(VALIDATES))
def test_validate_lifts_with_transport(case):
    cfg = TConfig(**VALIDATES[case])
    assert cfg.validate() is cfg
    jcfg = JConfig(**VALIDATES[case]).validate()
    assert (cfg.plan_transport, cfg.plan_controllers) == (
        jcfg.plan_transport, jcfg.plan_controllers)


@pytest.mark.parametrize("case", sorted(REFUSES))
def test_transport_refusals_are_jax_word_for_word(case):
    with pytest.raises(ValueError) as want:
        JConfig(**REFUSES[case]).validate()
    with pytest.raises(ValueError) as got:
        TConfig(**REFUSES[case]).validate()
    assert str(got.value) == str(want.value)
