"""The round scheduler (ROADMAP item 9d): the port's tracker reader,
samplers, alias table, deadline policy, over-provisioning and
RoundScheduler against the JAX package's on the same numpy inputs, and
scheduled rounds of the port against the JAX FedModel.

The host pieces are compared bitwise: the same numpy calls in the same
order, so the same seed and tracker state choose the same ids. Rounds
compare as test_fedmodel_rounds_match_jax does (weights within 1e-5 of
their scale, losses 1e-5 relative, billed bytes identical), with the JAX
side on a one-device mesh and its round module's `shard_map` under
check_vma=False for the test (test_torch_faults.py's setup for its fault
variants, whose straggler and dropout programs the plans ride). The
tracker is fed scripted seconds or pinned with `force`, never the wall
clock.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu import scheduler as jsched
from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.federated import round as jround
from commefficient_tpu.federated.api import (
    FedModel as JFedModel, FedOptimizer as JFedOptimizer,
)
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9
from commefficient_tpu.parallel.mesh import make_client_mesh
from commefficient_tpu.telemetry.clients import (
    ClientThroughputTracker as JTracker,
)
from commefficient_tpu.training.cv_train import (
    make_compute_loss as j_make_compute_loss,
)
from commefficient_tpu.utils import checkpoint as jckpt
from commefficient_tpu_torch import scheduler as tsched
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.data.sampler import FedSampler
from commefficient_tpu_torch.federated.api import (
    FedModel as TFedModel, FedOptimizer as TFedOptimizer,
)
from commefficient_tpu_torch.models import build_model
from commefficient_tpu_torch.models.convert import from_jax_params
from commefficient_tpu_torch.telemetry.clients import (
    ClientThroughputTracker as TTracker,
)
from commefficient_tpu_torch.training.cv_train import (
    make_compute_loss as t_make_compute_loss,
)
from commefficient_tpu_torch.utils import checkpoint as tckpt
from commefficient_tpu_torch.utils.faults import (
    FaultSchedule, InjectedFault,
)

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

D, W, B = 8, 8, 4
TINY = {"prep": 4, "layer1": 8, "layer2": 8, "layer3": 16}


def _j_shard_map(f, *, mesh, in_specs, out_specs, axis_names=None):
    kw = {} if axis_names is None else {"axis_names": frozenset(axis_names)}
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False, **kw)


def _trackers(n, rate=None, participations=None, completions=None):
    """A port tracker and a JAX tracker with the same forced records."""
    out = []
    for cls in (TTracker, JTracker):
        tr = cls(n)
        if rate is not None or participations is not None:
            tr.force(np.arange(n), rate=rate,
                     participations=participations,
                     completions=completions)
        out.append(tr)
    return out


# ---------------- the host pieces, bitwise ---------------------------------

def test_tracker_reader_matches_jax():
    t, j = _trackers(10)
    rng = np.random.RandomState(0)
    for r in range(6):
        ids = rng.choice(10, 4, replace=False)
        ex = rng.randint(0, 9, size=4).astype(np.float64)
        sched = (rng.rand(4) > 0.2).astype(np.float32)
        for tr in (t, j):
            tr.update_round(ids, ex, 1.0 + 0.25 * r, scheduled=sched)
    t.force([7, 8], rate=[0.0, 3.5], completions=[0, 2])
    j.force([7, 8], rate=[0.0, 3.5], completions=[0, 2])
    ids = np.arange(10)
    np.testing.assert_array_equal(t.examples_per_sec(),
                                  j.examples_per_sec())
    np.testing.assert_array_equal(t.examples_per_sec(ids[::2]),
                                  j.examples_per_sec(ids[::2]))
    for name in ("participation_counts", "completion_counts"):
        np.testing.assert_array_equal(getattr(t, name)(ids),
                                      getattr(j, name)(ids))
    for a, b in zip(t.measured(), j.measured()):
        np.testing.assert_array_equal(a, b)
    ex = np.array([8.0, 0.0, 3.0, 5.0, 1.0, 8.0, 2.0, 4.0, 6.0, 0.0])
    for cold in (None, 30.0):
        np.testing.assert_array_equal(
            t.estimate_round_seconds(ids, ex, cold),
            j.estimate_round_seconds(ids, ex, cold))
    assert (t.total_participations, t.total_completions, t.version) == (
        j.total_participations, j.total_completions, j.version)
    for k, v in j.state_dict().items():
        np.testing.assert_array_equal(t.state_dict()[k], v, err_msg=k)


def test_alias_table_matches_jax():
    rng = np.random.RandomState(3)
    ids = rng.choice(1000, 57, replace=False)
    w = rng.rand(57) ** 3 + 1e-3
    t, j = tsched.policy.AliasTable(ids, w), jsched.policy.AliasTable(ids, w)
    np.testing.assert_array_equal(t.prob, j.prob)
    np.testing.assert_array_equal(t.alias, j.alias)
    gt, gj = np.random.default_rng(5), np.random.default_rng(5)
    assert [t.draw(gt) for _ in range(500)] == [j.draw(gj)
                                                for _ in range(500)]


THROUGHPUT_CASES = {
    # measured and unmeasured clients, the floor on
    "mixed": (40, dict(rate=np.where(np.arange(40) % 5 == 0, 0.0,
                                     1.0 + np.arange(40) % 7)), 0.1, 8),
    # nothing measured: the uniform rejection draw
    "cold": (30, None, 0.2, 6),
    # a cohort close to the alive set: the exact fallback
    "fallback": (12, dict(rate=np.linspace(0.1, 9.0, 12)), 0.0, 11),
    # the floor at 1: uniform over alive
    "floor_one": (20, dict(rate=np.linspace(1.0, 2.0, 20)), 1.0, 5),
}


@pytest.mark.parametrize("case", sorted(THROUGHPUT_CASES))
def test_throughput_sampler_matches_jax(case):
    n, forced, floor, slots = THROUGHPUT_CASES[case]
    t_tr, j_tr = _trackers(n, **(forced or {}))
    t = tsched.ThroughputAwareSampler(21, t_tr, explore_floor=floor)
    j = jsched.ThroughputAwareSampler(21, j_tr, explore_floor=floor)
    rng = np.random.RandomState(1)
    for r in range(40):
        alive = np.sort(rng.choice(n, rng.randint(slots, n + 1),
                                   replace=False))
        got, want = (s.select(alive, slots, None, r) for s in (t, j))
        np.testing.assert_array_equal(got, want, err_msg=f"round {r}")
        np.testing.assert_array_equal(t.weights(alive), j.weights(alive))
        if r % 7 == 3 and forced:
            # a material rate change rebuilds both tables
            bump = rng.rand(n) + 0.5
            t_tr.force(np.arange(n), rate=t_tr.examples_per_sec() * bump)
            j_tr.force(np.arange(n), rate=j_tr.examples_per_sec() * bump)
    assert t.rebuilds == j.rebuilds
    for k, v in j.state_dict().items():
        np.testing.assert_array_equal(t.state_dict()[k], v, err_msg=k)


def test_uniform_sampler_and_make_sampler_match_jax():
    alive = np.arange(20)
    r1, r2 = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(30):
        np.testing.assert_array_equal(
            tsched.UniformSampler().select(alive, 6, r1, 0),
            jsched.UniformSampler().select(alive, 6, r2, 0))
    for sampler in tsched.SAMPLERS:
        kw = dict(mode="uncompressed", local_momentum=0.0,
                  sampler=sampler, explore_floor=0.3)
        t = tsched.make_sampler(TConfig(**kw), TTracker(4))
        j = jsched.make_sampler(JConfig(**kw), JTracker(4))
        assert t.name == j.name == sampler
        assert getattr(t, "explore_floor", 0.3) == 0.3


def test_overprovision_matches_jax():
    for target in range(0, 9):
        for slots in (1, 4, 8):
            for alive in (1, 5, 100):
                for s in (-1.0, 0.0, 0.01, 0.3, 0.5, 0.77, 1.0, 2.0):
                    assert (tsched.overprovision(target, slots, alive, s)
                            == jsched.overprovision(target, slots, alive,
                                                    s))


def test_deadline_policy_matches_jax():
    rng = np.random.RandomState(9)
    for trial in range(25):
        rate = rng.rand(12) * 8.0
        rate[rng.rand(12) < 0.2] = 0.0
        if trial == 0:
            rate[:] = 0.0                  # cold start: no deadline
        t_tr, j_tr = _trackers(12, rate=rate)
        q = float(rng.choice([0.25, 0.5, 0.8, 1.0]))
        mw = float(rng.choice([0.1, 0.25, 1.0]))
        t = tsched.DeadlinePolicy(t_tr, q, min_work=mw)
        j = jsched.DeadlinePolicy(j_tr, q, min_work=mw)
        ids = rng.choice(12, 6, replace=False)
        ex = rng.randint(0, 9, size=6).astype(np.float64)
        got, want = t.decide(ids, ex), j.decide(ids, ex)
        assert got[1:] == want[1:]
        assert (got.work is None) == (want.work is None)
        if want.work is not None:
            np.testing.assert_array_equal(got.work, want.work)
    with pytest.raises(ValueError, match="quantile"):
        tsched.DeadlinePolicy(TTracker(2), 0.0)


def _select_and_commit(sched, num_clients, rng, W_, B_):
    """The FedSampler's select, pad and commit (data/sampler.py's rule:
    distinct unchosen pad ids, zero masks)."""
    chosen = np.asarray(sched.select(np.arange(num_clients), W_, rng))
    slot_ids = chosen
    if len(chosen) < W_:
        pad = np.setdiff1d(np.arange(num_clients), chosen)[:W_ - len(chosen)]
        slot_ids = np.concatenate([chosen, pad])
    active = (np.arange(W_) < len(chosen)).astype(np.float32)
    sched.commit_round(slot_ids, active * B_)
    return slot_ids, active


SCHED_KW = dict(sampler="throughput", explore_floor=0.1,
                deadline_quantile=0.8, deadline_min_work=0.25,
                target_survivors=3, client_dropout=0.1)


def test_round_scheduler_plans_match_jax():
    kw = dict(mode="uncompressed", local_momentum=0.0, num_workers=4,
              num_clients=12, **SCHED_KW)
    rate = np.linspace(1.0, 6.0, 12)
    t_tr, j_tr = _trackers(12, rate=rate, participations=np.ones(12),
                           completions=np.ones(12))
    t = tsched.RoundScheduler(TConfig(**kw), 12, t_tr)
    j = jsched.RoundScheduler(JConfig(**kw), 12, j_tr)
    assert not t.is_default and not j.is_default
    rt, rj = np.random.RandomState(2), np.random.RandomState(2)
    t.begin_epoch(0)
    j.begin_epoch(0)
    for r in range(12):
        ids_t, act_t = _select_and_commit(t, 12, rt, 4, B)
        ids_j, act_j = _select_and_commit(j, 12, rj, 4, B)
        np.testing.assert_array_equal(ids_t, ids_j)
        pt, pj = t.take_plan(r), j.take_plan(r)
        assert pt.journal_fields() == pj.journal_fields()
        for name in ("active", "work"):
            a, b = getattr(pt, name), getattr(pj, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, b)
        if r == 5:
            # the tracker moves: the survival estimate and the table
            for tr in (t_tr, j_tr):
                tr.update_round(ids_t, act_t * B, 1.3, scheduled=act_t)
    assert t.take_plan(0) is None
    for k, v in j.state_dict().items():
        np.testing.assert_array_equal(t.state_dict()[k], v, err_msg=k)
    assert set(t.state_dict()) == set(j.state_dict())


def test_default_scheduler_plans_nothing_and_keeps_the_stream():
    kw = dict(mode="uncompressed", local_momentum=0.0, num_workers=4,
              num_clients=20)
    cfg = TConfig(**kw)
    sched = tsched.RoundScheduler(cfg, 20, TTracker(20))
    assert sched.is_default
    dpc = np.arange(20) % 5 + 3
    plain = FedSampler(dpc, 4, 2, seed=5)
    with_sched = FedSampler(dpc, 4, 2, seed=5, scheduler=sched)
    sched.begin_epoch(0)
    for epoch in range(2):
        a, b = list(plain.epoch()), list(with_sched.epoch())
        assert len(a) == len(b) > 0
        for ra, rb in zip(a, b):
            for x, y in zip(ra, rb):
                np.testing.assert_array_equal(x, y)
    assert sched.take_plan(0) is None
    assert sched.rounds_scheduled == len(a) * 2


def test_sampler_pads_idle_slots_as_jax():
    from commefficient_tpu.data.sampler import FedSampler as JFedSampler
    kw = dict(mode="uncompressed", local_momentum=0.0, num_workers=4,
              num_clients=10, target_survivors=2)
    t_tr, j_tr = _trackers(10, rate=np.ones(10), participations=np.ones(10),
                           completions=np.ones(10))
    ts = tsched.RoundScheduler(TConfig(**kw), 10, t_tr)
    js = jsched.RoundScheduler(JConfig(**kw), 10, j_tr)
    dpc = np.arange(10) + 4
    a = FedSampler(dpc, 4, 3, seed=2, scheduler=ts)
    b = JFedSampler(dpc, 4, 3, seed=2, scheduler=js)
    ts.begin_epoch(0)
    js.begin_epoch(0)
    n = 0
    for ra, rb in zip(a.epoch(), b.epoch()):
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(x, y)
        assert (ra.mask[2:] == 0).all() and ra.mask[:2].sum() > 0
        n += 1
    assert n > 3


# ---------------- scheduled rounds against the JAX FedModel ----------------

def _resnet_pool(num_clients, Bn, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(num_clients, Bn, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, size=(num_clients, Bn)).astype(np.int32))


def test_scheduled_rounds_match_jax(monkeypatch):
    # 3 rounds, 4 slots over 12 clients of the tiny ResNet9: throughput
    # sampling from forced rates, one idle slot a round (target 3 at a
    # completion ratio of 1), a deadline truncation and the dropout draw
    monkeypatch.setattr(jround, "shard_map", _j_shard_map)
    Bn = 6
    kw = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=300, num_rows=5, num_cols=700, local_momentum=0.0,
              num_workers=4, num_clients=12, local_batch_size=Bn, seed=5,
              **SCHED_KW)
    jm = JResNet9(num_classes=10, channels=TINY)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((2, 32, 32, 3), jnp.float32))
    tm = build_model("ResNet9", channels=TINY)
    from_jax_params(tm, params)
    jmodel = JFedModel(None, j_make_compute_loss(jm), JConfig(**kw),
                       params=params, num_clients=12,
                       mesh=make_client_mesh(1))
    tmodel = TFedModel(tm, t_make_compute_loss(tm),
                       TConfig(**kw, device="cpu"), device="cpu",
                       num_clients=12)
    rate = np.linspace(1.0, 6.0, 12)
    for m in (jmodel, tmodel):
        m.throughput.force(np.arange(12), rate=rate,
                           participations=np.ones(12),
                           completions=np.ones(12))
    ts = tsched.RoundScheduler(tmodel.cfg, 12, tmodel.throughput)
    js = jsched.RoundScheduler(jmodel.cfg, 12, jmodel.throughput)
    tmodel.attach_scheduler(ts)
    jmodel.attach_scheduler(js)
    ts.begin_epoch(0)
    js.begin_epoch(0)
    jopt, topt = JFedOptimizer(jmodel), TFedOptimizer(tmodel)
    x, y = _resnet_pool(12, Bn)
    rt, rj = np.random.RandomState(2), np.random.RandomState(2)
    truncated = idle = 0
    t_bytes, j_bytes = np.zeros(2), np.zeros(2)
    for i in range(3):
        ids, active = _select_and_commit(ts, 12, rt, 4, Bn)
        ids_j, _ = _select_and_commit(js, 12, rj, 4, Bn)
        np.testing.assert_array_equal(ids, ids_j)
        truncated += int(ts._plans[i].work is not None)
        idle += int((active == 0).sum())
        mask = np.ones((4, Bn), np.float32) * active[:, None]
        batch = (ids.astype(np.int32), (x[ids], y[ids]), mask)
        jopt.param_groups[0]["lr"] = topt.param_groups[0]["lr"] = 0.1
        jl, _, jd, ju = jmodel(batch)
        tl, _, td, tu = tmodel(batch)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tu, ju)
        # an idle slot is billed nothing
        assert (tu[active == 0] == 0).all()
        t_bytes += [td.sum(), tu.sum()]
        j_bytes += [np.sum(jd), np.sum(ju)]
        jw = np.asarray(jmodel.ps_weights)
        np.testing.assert_allclose(tmodel.ps_weights.numpy(), jw, rtol=0,
                                   atol=1e-5 * np.abs(jw).max(),
                                   err_msg=f"round {i}")
    np.testing.assert_array_equal(t_bytes, j_bytes)
    assert truncated > 0 and idle == 3 and t_bytes[1] > 0
    for k, v in js.state_dict().items():
        np.testing.assert_array_equal(ts.state_dict()[k], v, err_msg=k)


# ---------------- the port's own identities, on a linear model -------------

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


def _lin_kw(**kw):
    return {**dict(mode="uncompressed", grad_size=D, weight_decay=0.0,
                   num_workers=W, local_momentum=0.0, virtual_momentum=0.9,
                   error_type="none", microbatch_size=-1, num_clients=W),
            **kw}


def _t_model(**kw):
    model = TFedModel(Lin(), _t_loss, TConfig(**_lin_kw(**kw),
                                              device="cpu"),
                      device="cpu", num_clients=kw.get("num_clients", W))
    TFedOptimizer(model).param_groups[0]["lr"] = 0.1
    return model


def _pool(num_clients, seed=0):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(D).astype(np.float32)
    x = rng.randn(num_clients, B, D).astype(np.float32)
    return x, np.einsum("cbd,d->cb", x, w_true).astype(np.float32)


def _batch_for(slot_ids, pool, active=None):
    x, y = pool
    ids = np.asarray(slot_ids)
    mask = np.ones((len(ids), B), np.float32)
    if active is not None:
        mask *= np.asarray(active)[:, None]
    return ids.astype(np.int32), (x[ids], y[ids]), mask


@pytest.mark.parametrize("mode", ["sketch", "true_topk", "fedavg"])
def test_default_scheduler_is_the_scheduler_free_round(mode):
    extra = {"sketch": dict(mode="sketch", error_type="virtual", k=4,
                            num_rows=2, num_cols=32, num_blocks=1),
             "true_topk": dict(mode="true_topk", error_type="virtual", k=4),
             "fedavg": dict(mode="fedavg", local_batch_size=-1,
                            virtual_momentum=0.0)}[mode]
    pool = _pool(W)
    finals = []
    for with_sched in (False, True):
        model = _t_model(**extra)
        rng = np.random.RandomState(1)
        if with_sched:
            sched = tsched.RoundScheduler(model.cfg, W, model.throughput)
            model.attach_scheduler(sched)
            sched.begin_epoch(0)
        for _ in range(4):
            if with_sched:
                ids, _ = _select_and_commit(sched, W, rng, W, B)
            else:
                ids = rng.choice(np.arange(W), W, replace=False)
            model(_batch_for(ids, pool))
        finals.append(model.ps_weights.clone())
    assert torch.equal(finals[0], finals[1])


def test_idle_slots_are_bitwise_a_dropped_client():
    pool = _pool(12)
    model_s = _t_model(num_clients=12, target_survivors=4)
    sched = tsched.RoundScheduler(model_s.cfg, 12, model_s.throughput)
    model_s.attach_scheduler(sched)
    sched.begin_epoch(0)
    slot_ids, active = _select_and_commit(sched, 12,
                                          np.random.RandomState(4), W, B)
    assert active.sum() == 4 and (active[4:] == 0).all()
    out_s = model_s(_batch_for(slot_ids, pool, active))
    model_r = _t_model(num_clients=12)
    model_r.set_fault_schedule(FaultSchedule(
        drop_slots={0: list(np.where(active == 0)[0])}))
    out_r = model_r(_batch_for(slot_ids, pool, active))
    assert torch.equal(model_s.ps_weights, model_r.ps_weights)
    np.testing.assert_array_equal(out_s[-1], out_r[-1])
    np.testing.assert_array_equal(out_s[-2], out_r[-2])
    assert (out_s[-1][active == 0] == 0).all()
    assert model_s.server.round_idx == 1


def _drive_scheduled(model, sched, pool, first, last, rng, checkpoint=None):
    """Scheduled rounds with the tracker fed scripted seconds, so round
    r's selection sees the tracker an uninterrupted run had there."""
    sched.begin_epoch(first)
    for r in range(first, last):
        slot_ids, active = _select_and_commit(sched, model.num_clients,
                                              rng, W, B)
        model(_batch_for(slot_ids, pool, active))
        model.throughput.update_round(slot_ids, np.full(W, float(B)) * active,
                                      round_seconds=1.0 + 0.1 * r,
                                      scheduled=active)
        if checkpoint is not None:
            checkpoint()


def _sched_model(**kw):
    model = _t_model(**kw)
    sched = tsched.RoundScheduler(model.cfg, model.num_clients,
                                  model.throughput)
    model.attach_scheduler(sched)
    return model, sched


def test_scheduled_crash_resume_is_bitwise(tmp_path):
    R = 8
    kw = dict(sampler="throughput", deadline_quantile=0.8,
              target_survivors=2, client_dropout=0.2, num_clients=12)
    pool = _pool(12)
    model_a, sched_a = _sched_model(**kw)
    _drive_scheduled(model_a, sched_a, pool, 0, R, np.random.RandomState(2))

    prefix = str(tmp_path / "sched")
    model_b, sched_b = _sched_model(**kw)
    model_b.set_fault_schedule(FaultSchedule(crash_after=4))

    def save_b():
        tckpt.save_rotating(prefix, model_b.server, model_b.clients,
                            keep_last=2,
                            fingerprint=model_b.checkpoint_fingerprint,
                            throughput=model_b.throughput.state_dict(),
                            scheduler=model_b.scheduler_state())

    with pytest.raises(InjectedFault):
        _drive_scheduled(model_b, sched_b, pool, 0, R,
                         np.random.RandomState(2), checkpoint=save_b)
    model_c, sched_c = _sched_model(**kw)
    ckpt = tckpt.load_latest(prefix,
                             expect_fingerprint=model_c.checkpoint_fingerprint)
    model_c.load_state(ckpt)
    done = int(np.asarray(ckpt.server.round_idx))
    assert done == 4
    _drive_scheduled(model_c, sched_c, pool, done, R,
                     np.random.RandomState(2))
    assert torch.equal(model_c.ps_weights, model_a.ps_weights)
    assert sched_a.truncated_slots > 0 and sched_a.deadline_rounds > 0
    for k, v in model_a.throughput.state_dict().items():
        np.testing.assert_array_equal(
            v, model_c.throughput.state_dict()[k], err_msg=f"thr {k}")
    for k, v in sched_a.state_dict().items():
        np.testing.assert_array_equal(v, sched_c.state_dict()[k],
                                      err_msg=f"sched {k}")


def test_skip_replay_does_not_recount():
    cfg = TConfig(**_lin_kw(sampler="throughput", deadline_quantile=0.8,
                            num_clients=12, num_workers=4))
    tracker = TTracker(12)
    tracker.force(np.arange(12), rate=np.linspace(1.0, 4.0, 12),
                  completions=np.ones(12))

    def commit(sched, r0, n):
        rng = np.random.RandomState(3)
        sched.begin_epoch(r0)
        for _ in range(n):
            ids = sched.select(np.arange(12), 4, rng)
            sched.commit_round(ids, np.full(len(ids), float(B)))

    ref = tsched.RoundScheduler(cfg, 12, tracker)
    commit(ref, 0, 10)
    first = tsched.RoundScheduler(cfg, 12, tracker)
    commit(first, 0, 6)
    resumed = tsched.RoundScheduler(cfg, 12, tracker)
    resumed.load_state_dict(first.state_dict())
    commit(resumed, 0, 10)
    for k, v in ref.state_dict().items():
        np.testing.assert_array_equal(v, resumed.state_dict()[k], err_msg=k)
    assert resumed.rounds_scheduled == 10


def _j_sched_model(**kw):
    cfg = JConfig(**_lin_kw(**kw))
    model = JFedModel(None, _j_loss, cfg, params={"w": jnp.zeros(D)},
                      num_clients=kw.get("num_clients", W))
    JFedOptimizer(model).param_groups[0]["lr"] = 0.1
    sched = jsched.RoundScheduler(cfg, model.num_clients, model.throughput)
    model.attach_scheduler(sched)
    return model, sched


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_sched_checkpoints_cross_load(tmp_path, direction):
    kw = dict(sampler="throughput", deadline_quantile=0.5,
              target_survivors=3, num_clients=12)
    pool = _pool(12)
    src, src_sched = (_sched_model(**kw) if direction == "port_to_jax"
                      else _j_sched_model(**kw))
    src.throughput.force(np.arange(12), rate=np.linspace(1.0, 3.0, 12),
                         participations=np.ones(12), completions=np.ones(12))
    rng = np.random.RandomState(6)
    src_sched.begin_epoch(0)
    for _ in range(3):
        ids, active = _select_and_commit(src_sched, 12, rng, W, B)
        src(_batch_for(ids, pool, active))
    assert src_sched.state_dict()["alias_ids"].size
    save, load = ((tckpt.save_checkpoint, jckpt.load_checkpoint)
                  if direction == "port_to_jax"
                  else (jckpt.save_checkpoint, tckpt.load_checkpoint))
    path = save(str(tmp_path / "s"), src.server, src.clients,
                fingerprint=src.checkpoint_fingerprint,
                throughput=src.throughput.state_dict(),
                scheduler=src.scheduler_state())
    dst, dst_sched = (_j_sched_model(**kw) if direction == "port_to_jax"
                      else _sched_model(**kw))
    dst.load_state(load(path, expect_fingerprint=dst.checkpoint_fingerprint))
    assert set(dst_sched.state_dict()) == set(src_sched.state_dict())
    for k, v in src_sched.state_dict().items():
        np.testing.assert_array_equal(dst_sched.state_dict()[k], v,
                                      err_msg=k)
    # both continue with the same draw
    dst_sched.begin_epoch(3)
    r1, r2 = np.random.RandomState(8), np.random.RandomState(8)
    a, _ = _select_and_commit(src_sched, 12, r1, W, B)
    b, _ = _select_and_commit(dst_sched, 12, r2, W, B)
    np.testing.assert_array_equal(a, b)
