"""The controller bank (ROADMAP item 9f): the port's controllers and bank
(commefficient_tpu_torch/control) against the JAX package's on the same
numpy streams, bitwise; the adaptive screen's round against the JAX
FedModel; the controllers through the port's rounds, resumed bitwise
per round and in pipelined palette spans.

The controllers are host arithmetic on float32-rounded values, so the
same observation stream must give the same values, moves and work
fractions, bit for bit. Rounds compare as the fault variants do
(test_torch_faults.py): the JAX side on a one-device mesh with its round
module's `shard_map` under check_vma=False, weights within 1e-5 of their
scale, billed bytes identical. The trackers are fed scripted seconds,
never the wall clock.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu import control as jctl
from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.data.sampler import FedSampler as JFedSampler
from commefficient_tpu.federated import round as jround
from commefficient_tpu.federated.api import (
    FedModel as JFedModel, FedOptimizer as JFedOptimizer,
)
from commefficient_tpu.parallel.mesh import make_client_mesh
from commefficient_tpu.scheduler import (
    RoundPlan as JRoundPlan, RoundScheduler as JRoundScheduler,
)
from commefficient_tpu.telemetry import (
    RunJournal as JRunJournal, TelemetrySession as JTelemetrySession,
)
from commefficient_tpu.telemetry.journal import summarize, validate_journal
from commefficient_tpu_torch import control as tctl
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.data.sampler import FedSampler
from commefficient_tpu_torch.federated.api import (
    FedModel as TFedModel, FedOptimizer as TFedOptimizer,
)
from commefficient_tpu_torch.scheduler import RoundPlan, RoundScheduler
from commefficient_tpu_torch.telemetry import RunJournal, TelemetrySession
from commefficient_tpu_torch.training.scanloop import (
    make_span_checkpoint, run_scanned_rounds,
)
from commefficient_tpu_torch.utils.checkpoint import (
    load_latest, save_rotating,
)
from commefficient_tpu_torch.utils.faults import FaultSchedule, InjectedFault
from commefficient_tpu_torch.utils.schedules import LambdaLR

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

D, W, B, NC = 8, 8, 4, 16
CTL_KW = dict(speed_match=True, adapt_staleness=True, async_admit_rounds=1,
              straggler_rate=0.5, straggler_min_work=0.4)


def _kw(**kw):
    return {**dict(mode="uncompressed", grad_size=D, weight_decay=0.0,
                   num_workers=W, local_momentum=0.0, virtual_momentum=0.9,
                   error_type="none", microbatch_size=-1, num_clients=NC,
                   sampler="throughput"), **kw}


def _cfgs(**kw):
    """The same flags validated by each package: (port, JAX)."""
    return (TConfig(**_kw(**kw), device="cpu").validate(),
            JConfig(**_kw(**kw)).validate())


class _Tracker:
    def __init__(self, rates):
        self.rates = np.asarray(rates, np.float64)

    def examples_per_sec(self, ids=None):
        return self.rates


def _same(a, b):
    """Equal values, or equal arrays bit for bit (None alike)."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b))
    return a == b and type(a) is type(b)


def _same_adj(a, b):
    return (a is None and b is None) or tuple(a) == tuple(b)


# ---------------- the registry and the controllers, bitwise ----------------

def test_control_fields_are_jax():
    from commefficient_tpu.analysis.domains import CONTROL_FIELDS
    assert tctl.CONTROL_FIELDS == CONTROL_FIELDS
    for name in CONTROL_FIELDS:
        assert tctl.control_field(name) == CONTROL_FIELDS[name]
    with pytest.raises(KeyError, match="unknown controller"):
        tctl.control_field("rogue")
    for t, j in ((tctl.AdaptiveScreenController,
                  jctl.AdaptiveScreenController),
                 (tctl.SpeedMatchController, jctl.SpeedMatchController),
                 (tctl.SpanCadenceController, jctl.SpanCadenceController),
                 (tctl.StalenessDecayController,
                  jctl.StalenessDecayController)):
        assert (t.NAME, t.WIRE_FIELD, t.STATE_KEYS, t.COMMIT_STATE,
                t.provides_span_cap) == (j.NAME, j.WIRE_FIELD,
                                         j.STATE_KEYS, j.COMMIT_STATE,
                                         j.provides_span_cap)


def test_speed_match_stream_is_bitwise_jax():
    tcfg, jcfg = _cfgs(**CTL_KW)
    t, j = tctl.SpeedMatchController(tcfg), jctl.SpeedMatchController(jcfg)
    rng = np.random.RandomState(11)
    for r in range(60):
        # measured and unmeasured clients, idle slots, bands of rates
        rates = np.where(rng.rand(W) < 0.2, 0.0,
                         rng.choice([0.5, 1.0, 2.0, 4.0, 8.0], W)
                         * (1.0 + 0.1 * rng.rand(W)))
        ex = np.where(rng.rand(W) < 0.15, 0.0, float(B))
        ids = rng.choice(NC, W, replace=False)
        vt, wt, at = t.stamp(r, ids, ex, _Tracker(rates))
        vj, wj, aj = j.stamp(r, ids, ex, _Tracker(rates))
        assert vt == vj and _same(wt, wj) and _same_adj(at, aj), r
        if r % 13 == 5:
            t.install(0.33)
            j.install(0.33)
    assert t.rounds_observed == j.rounds_observed > 20
    for k, v in j.state_dict().items():
        assert _same(t.state_dict()[k], v), k


def test_speed_match_flags_slow_tightens_and_clamps():
    tcfg, _ = _cfgs(**CTL_KW)
    ctl = tctl.SpeedMatchController(tcfg)
    ids, ex = np.arange(W), np.full(W, float(B))
    # median 4, bar 0.5 x 4: 3 of 8 slow > target 0.25, so the ratio
    # tightens to 0.4 and the three keep work max(1/4, 0.25)
    value, work, adj = ctl.stamp(3, ids, ex,
                                 _Tracker([1, 1, 1, 4, 4, 4, 4, 4]))
    want = float(np.float32(0.5 / 1.25))
    assert value == want and adj == tctl.Adjustment(
        "speed_match", 3, 0.375, float(np.float32(0.5)), want, False)
    np.testing.assert_array_equal(work, [0.25] * 3 + [1.0] * 5)
    # one measured client: no median, no move
    assert tctl.SpeedMatchController(tcfg).stamp(
        0, ids, ex, _Tracker([2.0] + [0.0] * (W - 1))) == (
        float(np.float32(0.5)), None, None)
    # uniform rates loosen up to the clamp, which is reported
    clamps = [a.clamped for a in (ctl.stamp(r, ids, ex,
                                            _Tracker(np.full(W, 2.0)))[2]
                                  for r in range(12)) if a is not None]
    assert clamps[-1] is True and not any(clamps[:-1])
    assert ctl.plan_value() == np.float32(tcfg.speed_ratio_max)


def test_span_cadence_stream_is_bitwise_jax():
    tcfg, jcfg = _cfgs(scan_rounds=True, scan_span_palette="4,1,2")
    t, j = tctl.SpanCadenceController(tcfg), jctl.SpanCadenceController(jcfg)
    assert t.palette == j.palette == (1, 2, 4)
    rng = np.random.RandomState(5)
    for r in range(40):
        n = int(rng.choice([0, 1, 2, 3, 4]))   # 0 and 3: off the palette
        sec = float(rng.rand() * n + 0.01)
        assert _same_adj(t.feed_span(r, n, sec), j.feed_span(r, n, sec))
        assert t.span_cap() == j.span_cap()
        np.testing.assert_array_equal(t.ema, j.ema)
    assert [t.tail_cap(n) for n in range(9)] == [j.tail_cap(n)
                                                 for n in range(9)]


def test_span_cadence_warms_up_then_takes_the_least_ema():
    tcfg, _ = _cfgs(scan_rounds=True, scan_span_palette="4,1,2")
    ctl = tctl.SpanCadenceController(tcfg)
    assert ctl.plan_value() == 1
    assert (ctl.feed_span(0, 1, 1.0).new, ctl.feed_span(1, 2, 4.0).new) == (
        2.0, 4.0)
    assert ctl.feed_span(2, 4, 2.0) is None      # 4 at 0.5 s a round wins
    adj = ctl.feed_span(3, 4, 8.0)               # its EMA 1.25: 1 wins
    assert (adj.old, adj.new, adj.clamped) == (4.0, 1.0, False)
    np.testing.assert_allclose(ctl.ema, [1.0, 2.0, 1.25])
    assert [ctl.tail_cap(n) for n in (7, 3, 1, 0)] == [4, 2, 1, 1]


STALENESS_CASES = {
    "per_round": dict(),
    "spans": dict(scan_rounds=True, scan_span=3),
    "pipelined_palette": dict(scan_rounds=True, pipeline=True,
                              checkpoint_every=1,
                              scan_span_palette="1,2"),
}


@pytest.mark.parametrize("case", sorted(STALENESS_CASES))
def test_staleness_stream_is_bitwise_jax(case):
    tcfg, jcfg = _cfgs(**CTL_KW, **STALENESS_CASES[case])
    t = tctl.StalenessDecayController(tcfg)
    j = jctl.StalenessDecayController(jcfg)
    assert t.lag == j.lag == {"per_round": 1, "spans": 3,
                              "pipelined_palette": 4}[case]
    rng = np.random.RandomState(9)
    for r in range(50):
        sig = ({} if rng.rand() < 0.1 else
               {"estimate_residual": float(rng.choice([0.0, 0.3, 0.9])
                                           * rng.rand() * 2)})
        assert _same_adj(t.observe_commit(r, sig), j.observe_commit(r, sig))
        s = int(r + rng.randint(0, t.lag + 1))
        assert t.stamp(s, None, None, None) == j.stamp(s, None, None, None)
        if r % 11 == 3:
            t.install(0.123)
            j.install(0.123)
            assert t.plan_value() == j.plan_value()
        np.testing.assert_array_equal(t.ring, j.ring)
        assert t.decay == j.decay
    assert len(t.ring) <= 4 * t.lag + 4


def test_screen_stream_is_bitwise_jax_and_the_golden_trajectory():
    kw = dict(update_screen="norm", screen_norm_mult=3.0,
              target_screened_rate=0.25, screen_adapt_step=0.5,
              screen_mult_min=1.5, screen_mult_max=10.0)
    tcfg, jcfg = _cfgs(**kw)
    t = tctl.AdaptiveScreenController(tcfg)
    j = jctl.AdaptiveScreenController(jcfg)
    stream = [(4, 8), (0, 8), (0, 8), (2, 8), (8, 8), (0, 8), (2, 8)]
    rng = np.random.RandomState(2)
    stream += [(int(rng.randint(0, 9)), 8) for _ in range(30)] + [(0, 0)]
    got = [t.observe(r, s, c) for r, (s, c) in enumerate(stream)]
    assert got == [j.observe(r, s, c) for r, (s, c) in enumerate(stream)]
    # the JAX package's frozen f32 step and clamp, recomputed inline
    mult, want = 3.0, []
    for n_screened, n_cohort in stream[:7]:
        rate = n_screened / n_cohort
        new = (min(mult * 1.5, 10.0) if rate > 0.25 else
               max(mult / 1.5, 1.5) if rate < 0.25 else mult)
        new = float(np.float32(new))
        want.append(None if new == mult else (mult, new, rate))
        mult = new
    assert got[:7] == want
    assert set(t.state_dict()) == {"screen_mult", "screen_rounds_observed"}
    for k, v in j.state_dict().items():
        assert _same(t.state_dict()[k], v), k


def test_screen_controller_is_the_scheduler_export():
    from commefficient_tpu_torch.scheduler import AdaptiveScreenController
    assert AdaptiveScreenController is tctl.AdaptiveScreenController
    assert issubclass(AdaptiveScreenController, tctl.Controller)


# ---------------- the bank ------------------------------------------------

def test_bank_rejects_unregistered_and_colliding_fields():
    class Rogue(tctl.Controller):
        NAME = "rogue"
        WIRE_FIELD = "rogue_knob"

    with pytest.raises(ValueError, match="CONTROL_FIELDS"):
        tctl.ControllerBank([Rogue()])
    tcfg, _ = _cfgs(**CTL_KW)
    with pytest.raises(ValueError, match="share wire field"):
        tctl.ControllerBank([tctl.SpeedMatchController(tcfg),
                             tctl.SpeedMatchController(tcfg)])


def test_bank_stamp_and_install_are_jax():
    tcfg, jcfg = _cfgs(**CTL_KW)
    banks = [tctl.ControllerBank([tctl.SpeedMatchController(tcfg),
                                  tctl.StalenessDecayController(tcfg)]),
             jctl.ControllerBank([jctl.SpeedMatchController(jcfg),
                                  jctl.StalenessDecayController(jcfg)])]
    ids, ex = np.arange(W), np.full(W, float(B))
    work = np.full(W, 0.2, np.float32)
    work[5:] = 1.0
    plans = [RoundPlan(5, W, None, work, None, None, None, "throughput"),
             JRoundPlan(5, W, None, work, None, None, None, "throughput")]
    stamped = [b.stamp_plan(p, ids, ex, _Tracker([1, 1, 1, 4, 4, 4, 4, 4]))
               for b, p in zip(banks, plans)]
    assert stamped[0].controls == stamped[1].controls
    assert set(stamped[0].controls) == {"speed_ratio", "staleness_decay"}
    # the existing 0.2 wins over the speed matcher's 0.25 (min)
    assert _same(stamped[0].work, stamped[1].work)
    np.testing.assert_array_equal(stamped[0].work[:3], np.float32(0.2))
    ev = [b.take_events() for b in banks]
    assert [tuple(e) for e in ev[0]] == [tuple(e) for e in ev[1]]
    assert len(ev[0]) == 1 and banks[0].take_events() == []
    assert (stamped[0].journal_fields()["speed_ratio"]
            == stamped[1].journal_fields()["speed_ratio"])
    for b in banks:
        b.install({"speed_ratio": 0.33, "staleness_decay": 0.77,
                   "unknown_field": 9.9})
    assert banks[0].controllers[0].ratio == banks[1].controllers[0].ratio
    assert (banks[0].controllers[1].plan_value()
            == banks[1].controllers[1].plan_value()
            == float(np.float32(0.77)))
    assert banks[0].controllers[1].decay != 0.77   # the fold is untouched


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_bank_state_round_trips_both_ways(direction):
    tcfg, jcfg = _cfgs(**CTL_KW, scan_rounds=True, scan_span_palette="1,2")
    src, dst = ((tctl.make_bank(tcfg), jctl.make_bank(jcfg))
                if direction == "port_to_jax"
                else (jctl.make_bank(jcfg), tctl.make_bank(tcfg)))
    assert src.names == dst.names == ["speed_match", "span_cadence",
                                      "staleness_decay"]
    src.controllers[0].ratio = 0.37
    src.controllers[1].feed_span(0, 1, 1.0)
    for r in range(5):
        src.observe_commit(r, {"estimate_residual": 0.1 * r})
    state = src.state_dict()
    assert {"ctl_speed_match_ratio", "ctl_span_cadence_ema",
            "ctl_staleness_decay_ring"} <= set(state)
    dst.load_state_dict(state)
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(dst.state_dict()[k]),
                                      np.asarray(v), err_msg=k)
    assert set(dst.commit_state_dict()) == set(src.commit_state_dict()) == {
        "ctl_staleness_decay_decay", "ctl_staleness_decay_rounds_observed",
        "ctl_staleness_decay_ring"}
    # a file without ctl_* keys keeps the config's start point
    fresh = tctl.make_bank(tcfg)
    fresh.load_state_dict({"rounds_scheduled": 4})
    assert fresh.controllers[0].ratio == np.float32(tcfg.speed_ratio)


def test_no_flag_no_bank_and_default_plans_unchanged():
    tcfg, jcfg = _cfgs()
    assert tctl.make_bank(tcfg) is None and jctl.make_bank(jcfg) is None
    model = _t_model()
    assert model.control_bank is None and model.screen_ctl is None
    # a throughput-sampled plan with no controller carries none
    for cls, cfg in ((RoundScheduler, tcfg), (JRoundScheduler, jcfg)):
        sched = cls(cfg, NC, model.throughput)
        sched.commit_round(np.arange(W), np.full(W, float(B)))
        plan = sched.take_plan(0)
        assert plan.controls is None and plan.screen_mult is None
    # the scheduler shares the model's controllers (none here)
    sched = RoundScheduler(tcfg, NC, model.throughput)
    model.attach_scheduler(sched)
    assert sched.screen_ctl is None and sched.control_bank is None
    assert sched.is_default is False


# ---------------- the adaptive screen's round vs the JAX FedModel ----------

F, C = 12, 5


class Linear(torch.nn.Module):
    """x @ w + b, the parameters in the JAX tree's sorted order (b, w)."""

    def __init__(self):
        super().__init__()
        self.b = torch.nn.Parameter(torch.zeros(C))
        self.w = torch.nn.Parameter(torch.zeros(F, C))


def _cls_t_loss(params, batch, mask):
    x, y = batch
    logits = x @ params["w"] + params["b"]
    nll = -torch.log_softmax(logits, -1).gather(1, y.long()[:, None])[:, 0]
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, (loss,)


def _cls_j_loss(params, batch, mask):
    x, y = batch
    logits = x @ params["w"] + params["b"]
    nll = -jnp.take_along_axis(jax.nn.log_softmax(logits, -1),
                               y[:, None], 1)[:, 0]
    loss = (nll * mask).sum() / jnp.maximum(mask.sum(), 1.0)
    return loss, (loss,)


def _j_shard_map(f, *, mesh, in_specs, out_specs, axis_names=None):
    kw = {} if axis_names is None else {"axis_names": frozenset(axis_names)}
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False, **kw)


SCREEN_VARIANTS = {
    # a scaled poison past any multiplier, and honest clients' spread
    "poison": dict(poison_rate=0.3, poison_kind="scale"),
    # the colluding attack sized to 0.9 x the live multiplier
    "colluding": dict(byzantine_rate=0.25, attack="colluding"),
}


@pytest.mark.parametrize("variant", sorted(SCREEN_VARIANTS))
def test_adaptive_screen_round_matches_jax(variant, monkeypatch):
    # the multiplier starts at 1.6 and moves after every round (target
    # 0.1); rounds 1 and 2 screen at a multiplier other than
    # screen_norm_mult, through the round's screen operand
    monkeypatch.setattr(jround, "shard_map", _j_shard_map)
    kw = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=20, num_rows=3, num_cols=40, local_momentum=0.0,
              num_workers=4, num_clients=8, local_batch_size=6, seed=5,
              update_screen="norm", screen_norm_mult=1.6,
              target_screened_rate=0.1, screen_adapt_step=0.5,
              **SCREEN_VARIANTS[variant])
    rng = np.random.RandomState(0)
    params = {"b": 0.1 * rng.randn(C).astype(np.float32),
              "w": 0.1 * rng.randn(F, C).astype(np.float32)}
    jmodel = JFedModel(None, _cls_j_loss, JConfig(**kw),
                       params=jax.tree.map(jnp.asarray, params),
                       num_clients=8, mesh=make_client_mesh(1))
    tm = Linear()
    with torch.no_grad():
        tm.b.copy_(torch.from_numpy(params["b"]))
        tm.w.copy_(torch.from_numpy(params["w"]))
    tmodel = TFedModel(tm, _cls_t_loss, TConfig(**kw, device="cpu"),
                       device="cpu", num_clients=8)
    jopt, topt = JFedOptimizer(jmodel), TFedOptimizer(tmodel)
    mults, bytes_ = [], np.zeros(2)
    brng = np.random.RandomState(3)
    for i in range(4):
        ids = brng.choice(8, 4, replace=False).astype(np.int32)
        x = brng.randn(4, 6, F).astype(np.float32)
        x[2] *= 1.0 + i              # a spread of update norms
        y = brng.randint(0, C, size=(4, 6)).astype(np.int32)
        batch = (ids, (x, y), np.ones((4, 6), np.float32))
        assert tmodel.screen_ctl.plan_mult() == jmodel.screen_ctl.plan_mult()
        mults.append(tmodel.screen_ctl.plan_mult())
        jopt.param_groups[0]["lr"] = topt.param_groups[0]["lr"] = 0.3
        jl, _, jd, ju = jmodel(batch)
        tl, _, td, tu = tmodel(batch)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tu, ju)
        bytes_ += [td.sum(), tu.sum()]
        jw = np.asarray(jmodel.ps_weights)
        np.testing.assert_allclose(tmodel.ps_weights.numpy(), jw, rtol=0,
                                   atol=1e-5 * np.abs(jw).max(),
                                   err_msg=f"round {i}")
    assert (tmodel.screen_ctl.rounds_observed
            == jmodel.screen_ctl.rounds_observed == 4)
    assert any(m != np.float32(kw["screen_norm_mult"]) for m in mults)
    assert bytes_[1] > 0


# ---------------- the controllers through the port's rounds ---------------

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


def _t_model(**kw):
    kw = _kw(**kw)
    model = TFedModel(Lin(), _t_loss, TConfig(**kw, device="cpu"),
                      device="cpu", num_clients=kw["num_clients"])
    TFedOptimizer(model).param_groups[0]["lr"] = 0.1
    return model


def _j_model(**kw):
    model = JFedModel(None, _j_loss, JConfig(**_kw(**kw)).validate(),
                      params={"w": jnp.zeros(D)})
    JFedOptimizer(model).param_groups[0]["lr"] = 0.1
    return model


def _pool(seed=0, nc=NC):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(D).astype(np.float32)
    x = rng.randn(nc, B, D).astype(np.float32)
    return x, np.einsum("cbd,d->cb", x, w_true).astype(np.float32)


def _attach(model, sampler_cls, sched_cls):
    smp = sampler_cls(np.full(model.num_clients, B), W, B, seed=7)
    sched = sched_cls(model.cfg, model.num_clients, model.throughput)
    smp.scheduler = sched
    model.attach_scheduler(sched)
    model.attach_data_sampler(smp)
    return smp


def _feed_split(model, ids_arr, mask):
    """Scripted seconds: the first half of the slots report rounds of
    1 s, the second half 4 s, so speed matching sees a spread."""
    ex = mask.sum(axis=1)
    half = ids_arr.shape[0] // 2
    model.throughput.update_round(ids_arr[:half], ex[:half], 1.0)
    model.throughput.update_round(ids_arr[half:], ex[half:], 4.0)


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


def _drive(model, smp, pool, total, start=0, save_after=None, prefix=None,
           decays=None):
    """Rounds start .. total - 1 through the sampler's epochs; with
    `decays`, each round's admission decay as it is composed, beside
    its plan's staleness_decay."""
    x, y = pool
    done = start
    while done < total:
        model.scheduler.begin_epoch(done)
        for ids, idx, mask in smp.epoch():
            ids_arr = np.asarray(ids)
            if decays is not None:
                plan = model.scheduler._plans.get(done)
                model(_record_decay(model, decays, done, plan,
                                    (ids_arr, (x[ids_arr[:, None], idx],
                                               y[ids_arr[:, None], idx]),
                                     mask)))
            else:
                model((ids_arr, (x[ids_arr[:, None], idx],
                                 y[ids_arr[:, None], idx]), mask))
            _feed_split(model, ids_arr, mask)
            done += 1
            if save_after is not None and done == save_after + 1:
                _save(model, prefix)
            if done >= total:
                return


def _record_decay(model, decays, round_idx, plan, batch):
    buf = model.async_admit
    real = buf.compose

    def compose(*args, **kw):
        decays.append((round_idx, buf.decay,
                       plan.controls["staleness_decay"]))
        buf.compose = real
        return real(*args, **kw)

    buf.compose = compose
    return batch


def _trajectory(path):
    out = {}
    for line in open(path):
        rec = json.loads(line)
        if rec.get("event") == "control":
            out[(rec["controller"], rec["round"])] = (
                rec["old"], rec["new"], rec["clamped"])
    return out


def test_controller_rounds_match_jax(tmp_path):
    # the same six rounds of speed matching and staleness decay in both
    # packages: the same `control` moves, weights within rounding
    pool = _pool()
    models, journals = {}, {}
    for pkg, make, smp_cls, sched_cls, tele, journal in (
            ("port", _t_model, FedSampler, RoundScheduler, TelemetrySession,
             RunJournal),
            ("jax", _j_model, JFedSampler, JRoundScheduler,
             JTelemetrySession, JRunJournal)):
        model = make(**CTL_KW)
        smp = _attach(model, smp_cls, sched_cls)
        journals[pkg] = str(tmp_path / f"{pkg}.jsonl")
        session = tele(journal=journal(journals[pkg]),
                       tracker=model.throughput, clock=lambda: 0.0)
        model.attach_telemetry(session)
        session.journal_event("run_start")
        _drive(model, smp, pool, 6)
        session.close()
        models[pkg] = model
    traj = _trajectory(journals["port"])
    assert traj == _trajectory(journals["jax"])
    assert {c for c, _ in traj} == {"speed_match", "staleness_decay"}
    jw = np.asarray(models["jax"].ps_weights)
    np.testing.assert_allclose(models["port"].ps_weights.numpy(), jw,
                               rtol=0, atol=1e-5 * np.abs(jw).max())
    # the port's journal reads clean in the JAX package's reader
    records, problems = validate_journal(journals["port"])
    assert problems == []
    assert set(summarize(records)["controllers"]) == {"speed_match",
                                                      "staleness_decay"}


def test_each_round_composes_with_its_plans_decay():
    model = _t_model(**CTL_KW)
    smp = _attach(model, FedSampler, RoundScheduler)
    decays = []
    _drive(model, smp, _pool(), 6, decays=decays)
    assert [r for r, _, _ in decays] == list(range(6))
    assert all(applied == np.float32(stamped)
               for _, applied, stamped in decays)
    assert len({stamped for _, _, stamped in decays}) > 1


def test_controllers_crash_resume_is_bitwise(tmp_path):
    # the adaptive screen, speed matching and staleness decay across an
    # injected crash: weights, client rows and every controller's state
    # of the resumed run bitwise the uninterrupted one's, and the same
    # `control` moves journaled
    kw = dict(CTL_KW, update_screen="norm", target_screened_rate=0.2)
    R, K = 6, 3
    pool = _pool()
    ja = str(tmp_path / "a.jsonl")
    model_a = _t_model(**kw)
    smp_a = _attach(model_a, FedSampler, RoundScheduler)
    tele = TelemetrySession(journal=RunJournal(ja),
                            tracker=model_a.throughput, clock=lambda: 0.0)
    model_a.attach_telemetry(tele)
    tele.journal_event("run_start")
    _drive(model_a, smp_a, pool, R)
    tele.close()

    jb, prefix = str(tmp_path / "b.jsonl"), str(tmp_path / "ck" / "m")
    model_b = _t_model(**kw)
    smp_b = _attach(model_b, FedSampler, RoundScheduler)
    model_b.set_fault_schedule(FaultSchedule(crash_after=K))
    tele = TelemetrySession(journal=RunJournal(jb),
                            tracker=model_b.throughput, clock=lambda: 0.0)
    model_b.attach_telemetry(tele)
    tele.journal_event("run_start")
    with pytest.raises(InjectedFault):
        _drive(model_b, smp_b, pool, R, save_after=1, prefix=prefix)
    tele.close()

    model_c = _t_model(**kw)
    smp_c = _attach(model_c, FedSampler, RoundScheduler)
    tele = TelemetrySession(journal=RunJournal(jb),
                            tracker=model_c.throughput, clock=lambda: 0.0)
    model_c.attach_telemetry(tele)
    tele.journal_event("run_start")
    ckpt = load_latest(prefix,
                       expect_fingerprint=model_c.checkpoint_fingerprint)
    model_c.load_state(ckpt)
    assert ckpt.server.round_idx == 2
    assert {"screen_mult", "ctl_speed_match_ratio",
            "ctl_staleness_decay_ring"} <= set(ckpt.scheduler)
    _drive(model_c, smp_c, pool, R, start=2)
    tele.close()
    assert torch.equal(model_c.ps_weights, model_a.ps_weights)
    for k, v in model_a.scheduler_state().items():
        np.testing.assert_array_equal(np.asarray(model_c.scheduler_state()
                                                 [k]), np.asarray(v),
                                      err_msg=k)
    assert _trajectory(jb) == _trajectory(ja) != {}


def _scan_drive(model, smp, pool, total, start=0, checkpoint=None,
                span_cap=None):
    """Pipelined spans over the sampler's epochs, one span loop an epoch
    as the drivers run them. The tracker is not fed: the span tests pin
    its rates (_pinned), since a feed at collect, a driver's, is seen by
    a draw or not depending on where the spans were cut, and a feed in
    the stream would race the span checkpoint's snapshot of the tracker
    (the staging thread draws ahead)."""
    x, y = pool
    done = [start]

    def stream():
        for ids, idx, mask in smp.epoch():
            ids_arr = np.asarray(ids)
            yield (done[0], ids_arr, (x[ids_arr[:, None], idx],
                                      y[ids_arr[:, None], idx]),
                   mask, 0.1)
            done[0] += 1
            if done[0] >= total:
                return

    while done[0] < total:
        model.scheduler.begin_epoch(done[0])
        if not run_scanned_rounds(
                model, stream(),
                model.control_bank if span_cap is None else span_cap,
                lambda tag, *rows: True, checkpoint=checkpoint,
                pipeline=True):
            return False
    return True


SPAN_KW = dict(CTL_KW, pipeline=True, checkpoint_every=1,
               ckpt_every_spans=1, scan_rounds=True)


SPAN_NC = 48      # 6 rounds an epoch


def _pinned(**kw):
    """A model of SPAN_NC clients whose tracker holds the rates 4 (even
    clients) and 1 (odd clients), each measured once."""
    model = _t_model(num_clients=SPAN_NC, **kw)
    n = SPAN_NC
    model.throughput.force(np.arange(n),
                           rate=np.where(np.arange(n) % 2, 1.0, 4.0),
                           participations=np.ones(n), completions=np.ones(n))
    return model


def test_palette_spans_are_bitwise_fixed_spans():
    # spans never change a round: the palette's picks give the weights
    # of fixed spans of 2, every bank controller on (the staleness lag is
    # 4 for both)
    finals = []
    for extra, cap in ((dict(scan_span_palette="1,2"), None),
                       (dict(scan_span=2), 2)):
        model = _pinned(**SPAN_KW, **extra)
        smp = _attach(model, FedSampler, RoundScheduler)
        assert _scan_drive(model, smp, _pool(nc=SPAN_NC), 9, span_cap=cap)
        assert model.control_bank.controllers[-1].lag == 4
        finals.append(model.ps_weights.clone())
        model.close_persistence()
    assert torch.equal(finals[0], finals[1])


def test_pipelined_palette_crash_resume_is_bitwise(tmp_path):
    # all three bank controllers, pipelined spans of the palette's picks
    # with a checkpoint a span: a crash mid-run resumes from a span
    # boundary to the uninterrupted run's weights, and the journal of
    # the uninterrupted run holds each controller's moves
    R = 8
    prefix = str(tmp_path / "pipe" / "m")
    cfg_kw = dict(SPAN_KW, scan_span_palette="1,2")
    ja = str(tmp_path / "a.jsonl")
    model_a = _pinned(**cfg_kw)
    smp_a = _attach(model_a, FedSampler, RoundScheduler)

    class _NoFeed:
        def update_round(self, *args, **kw):
            pass

    tele = TelemetrySession(journal=RunJournal(ja), tracker=_NoFeed())
    model_a.attach_telemetry(tele)
    tele.journal_event("run_start")
    assert _scan_drive(model_a, smp_a, _pool(nc=SPAN_NC), R)
    tele.close()
    model_a.close_persistence()
    records, problems = validate_journal(ja)
    assert problems == []
    assert set(summarize(records)["controllers"]) == {
        "span_cadence", "speed_match", "staleness_decay"}

    model_b = _pinned(**cfg_kw)
    smp_b = _attach(model_b, FedSampler, RoundScheduler)
    model_b.set_fault_schedule(FaultSchedule(crash_after=4))
    hook = make_span_checkpoint(prefix, model_b, model_b.cfg,
                                LambdaLR(TFedOptimizer(model_b),
                                         lr_lambda=lambda s: 1.0))
    with pytest.raises(InjectedFault):
        _scan_drive(model_b, smp_b, _pool(nc=SPAN_NC), R, checkpoint=hook)
    model_b.close_persistence()

    model_c = _pinned(**cfg_kw)
    smp_c = _attach(model_c, FedSampler, RoundScheduler)
    ckpt = load_latest(prefix,
                       expect_fingerprint=model_c.checkpoint_fingerprint)
    model_c.load_state(ckpt)
    done = int(ckpt.server.round_idx)
    assert 0 < done <= 5
    assert _scan_drive(model_c, smp_c, _pool(nc=SPAN_NC), R, start=done)
    model_c.close_persistence()
    assert torch.equal(model_c.ps_weights, model_a.ps_weights)


def test_scanloop_latches_the_pick_and_cuts_the_tail():
    class _Model:
        _spans_dispatched = 0

        def run_rounds(self, ids, data, mask, lrs):
            lens.append(len(ids))
            n = len(ids)
            return [np.zeros((n, 1)), 0.0, 0.0]

    class _Caps:
        def __init__(self, picks):
            self.picks = list(picks)

        def span_cap(self, default):
            return self.picks.pop(0) if len(self.picks) > 1 else self.picks[0]

        def tail_cap(self, leftover):
            return max(p for p in (1, 2, 4) if p <= leftover)

    def stream(n):
        for i in range(n):
            yield (i, np.array([i]), (np.zeros((1, 1)),), np.ones((1, 1)),
                   0.1)

    lens = []
    assert run_scanned_rounds(_Model(), stream(7), 3, lambda *a: True)
    assert lens == [3, 3, 1]
    lens = []
    assert run_scanned_rounds(_Model(), stream(12), _Caps([4, 1, 2, 4]),
                              lambda *a: True)
    # picks 4, 1, 2, then 4 with 5 left: 4, and the tail of 1
    assert lens == [4, 1, 2, 4, 1]
    lens = []
    assert run_scanned_rounds(_Model(), stream(7), _Caps([4]),
                              lambda *a: True)
    assert lens == [4, 2, 1]


def test_pipelined_draws_wait_for_the_collect_two_spans_back():
    # with controllers, span s is drawn only once span s - 2 is
    # collected (the JAX loop's order), however slow the collects are;
    # without, the staging thread runs ahead of them
    import time
    from types import SimpleNamespace

    def run(bank):
        seen, collected = [], [0]

        class _Model:
            _spans_dispatched = 0
            control_bank = bank
            screen_ctl = None

            def dispatch_rounds(self, ids, data, mask, lrs):
                return SimpleNamespace(crash_at=None, n=len(ids))

            def collect_rounds(self, handle):
                time.sleep(0.1)
                collected[0] += 1
                return [np.zeros((handle.n, 1)), 0.0, 0.0]

        def stream():
            for i in range(8):
                seen.append((i, collected[0]))
                yield (i, np.array([i]), (np.zeros((1, 1)),),
                       np.ones((1, 1)), 0.1)

        assert run_scanned_rounds(_Model(), stream(), 2, lambda *a: True,
                                  pipeline=True)
        return seen

    # spans of 2: rounds 2s and 2s + 1 open span s
    gated = run(object())
    assert all(c >= i // 2 - 1 for i, c in gated), gated
    assert [c for i, c in gated if i % 2 == 0] == [0, 0, 1, 2]
    free = run(None)
    assert any(c < i // 2 - 1 for i, c in free), free
