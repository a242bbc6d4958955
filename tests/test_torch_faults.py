"""Fault-tolerant rounds: the port's utils/faults.py, the screened
round's pieces (corrupt, attack, the admission screen, the robust
aggregators) and one round of each fault variant against the JAX
package, on the same numpy inputs.

The JAX engine's pieces are inline in its shard_map body
(commefficient_tpu/federated/round.py:630-860), so `j_*` below are
verbatim jnp copies of those expressions, jitted and run outside
shard_map.

The JAX robust-aggregator round does not trace under the JAX version
the tests run: jax.shard_map's replication (vma) check refuses its
all_gather'd outputs (tests/test_byzantine.py fails the same way). The
round cases therefore run the JAX FedModel on a one-device mesh with the
check off, by patching the name `shard_map` in the JAX round module for
the test's duration (pytest's monkeypatch); with one shard, the
cross-shard reductions the check guards are identities. Tolerances are
test_fedmodel_rounds_match_jax's: weights within 1e-5 of their scale,
losses 1e-5 relative, byte totals identical; the pieces within 1e-6
relative (the reductions sum in another order than XLA's).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.federated import round as jround
from commefficient_tpu.federated.api import (
    FedModel as JFedModel, FedOptimizer as JFedOptimizer,
)
from commefficient_tpu.parallel.mesh import make_client_mesh
from commefficient_tpu.utils import faults as jfaults
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.config import parse_args
from commefficient_tpu_torch.federated import round as tround
from commefficient_tpu_torch.federated.api import (
    FedModel as TFedModel, FedOptimizer as TFedOptimizer,
)
from commefficient_tpu_torch.utils import faults as tfaults

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


# ---------------- the draws ----------------------------------------------

DRAWS = {
    "dropout": lambda m, s, r, W: m.bernoulli_survivors(s, r, W, 0.25),
    "straggler": lambda m, s, r, W: m.straggler_work_fractions(
        s, r, W, 0.5, 0.1),
    "poison": lambda m, s, r, W: m.poison_mask(s, r, W, 0.3),
    "byzantine": lambda m, s, r, W: m.byzantine_mask(s, r, W, 0.25),
}


@pytest.mark.parametrize("draw", sorted(DRAWS))
def test_fault_draws_are_bitwise_jax(draw):
    fn = DRAWS[draw]
    for seed in (0, 1, 21, 12345, 2 ** 31 - 1):
        for round_idx in (0, 1, 7, 100, 99_999):
            for W in (1, 4, 8, 256):
                got = fn(tfaults, seed, round_idx, W)
                want = fn(jfaults, seed, round_idx, W)
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(got, want)


def test_domains_and_schedule_match_jax():
    from commefficient_tpu.analysis.domains import DOMAINS
    assert tfaults.DOMAINS == DOMAINS
    spec = dict(drop={2: [5, 9]}, drop_slots={2: [0], 3: [1]},
                drop_all=[4], slow={1: {0: 0.3, 2: 0.9}},
                poison={5: [1, 3]}, byzantine={6: [0]}, crash_after=7,
                crash_in_span=3)
    t, j = tfaults.FaultSchedule(**spec), jfaults.FaultSchedule(**spec)
    ids = np.array([5, 9, 11, 3])
    for r in range(9):
        for name in ("survival_mask",):
            a, b = getattr(t, name)(r, ids), getattr(j, name)(r, ids)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        for name in ("work_fractions", "poison_mask_for",
                     "byzantine_mask_for"):
            a, b = getattr(t, name)(r, 4), getattr(j, name)(r, 4)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert t.should_crash(r) == j.should_crash(r)
        for n in (1, 3):
            assert (t.should_crash_in_span(r, n)
                    == j.should_crash_in_span(r, n))
    with pytest.raises(ValueError, match="work-fraction domain"):
        tfaults.FaultSchedule(slow={0: {1: 0.0}}).work_fractions(0, 4)


# ---------------- the pieces, as the JAX round computes them --------------

def j_corrupt(t, pois, kind):
    # round.py:630-639
    flag = pois.reshape(pois.shape + (1,) * (t.ndim - 1)) > 0
    if kind == "scale":
        return t * jnp.where(flag, jnp.asarray(jround.POISON_SCALE, t.dtype),
                             jnp.ones((), t.dtype))
    bad = jnp.inf if kind == "inf" else jnp.nan
    return jnp.where(flag, jnp.asarray(bad, t.dtype), t)


def j_attack(t, pois, surv, attack, mult):
    # round.py:641-711, one shard (all_gather the identity)
    W = t.shape[0]
    V = t.reshape(W, -1).astype(jnp.float32)
    if attack == "sign_flip":
        A = -V
    elif attack == "scaled":
        A = V * jnp.float32(100.0)
    else:
        honest = (~(pois > 0)) & (surv > 0) & jnp.isfinite(V).all(axis=1)
        nh = jnp.maximum(honest.sum(), 1)
        hmean = jnp.where(honest[:, None], V, 0.0).sum(0) / nh
        if attack == "little_is_enough":
            hvar = jnp.where(honest[:, None],
                             jnp.square(V - hmean[None, :]), 0.0).sum(0) / nh
            crafted = hmean - jnp.sqrt(hvar)
        else:
            hnorm = jnp.sqrt(jnp.square(V).sum(1))
            med = jnp.nanmedian(jnp.where(honest, hnorm, jnp.nan))
            med = jnp.where(honest.sum() > 0, med, jnp.float32(1.0))
            amult = jnp.maximum(jnp.float32(mult), jnp.float32(1.0))
            d = -hmean
            crafted = d * (jnp.float32(0.9) * amult * med / jnp.maximum(
                jnp.sqrt(jnp.square(d).sum()), jnp.float32(1e-12)))
        A = jnp.broadcast_to(crafted[None, :], V.shape)
    return jnp.where(pois[:, None] > 0, A, V).reshape(t.shape)


def j_admission(t, surv, screen, norm, mult):
    # round.py:725-764, one shard
    W = t.shape[0]
    ok = jnp.isfinite(t).reshape(W, -1).all(axis=1)
    if norm:
        l2 = jnp.sqrt(jnp.square(t.astype(jnp.float32)).reshape(W, -1)
                      .sum(axis=1))
        elig = (surv > 0) & jnp.isfinite(l2) & (l2 > 0)
        med = jnp.nanmedian(jnp.where(elig, l2, jnp.nan))
        ok = ok & jnp.where(elig.sum() > 0, l2 <= mult * med, True)
    return jnp.where(screen > 0, ok.astype(jnp.float32), 1.0)


def j_robust(allV, n_w, surv_eff, aggregator, trim_beta):
    # round.py:795-858, one shard
    adm = surv_eff > 0
    E = adm[:, None] & jnp.isfinite(allV)
    wcol = n_w[:, None]
    total_w = n_w.sum()
    U = allV / jnp.maximum(n_w, 1.0)[:, None]
    mean_agg = jnp.where(E, allV, 0.0).sum(0) / jnp.maximum(total_w, 1.0)
    n_trim = n_clip = jnp.float32(0.0)
    keep = E
    if aggregator == "coord_median":
        med = jnp.nanmedian(jnp.where(E, U, jnp.nan), axis=0)
        agg = jnp.where(E.any(axis=0), med, 0.0)
    elif aggregator == "trimmed_mean":
        vals = jnp.where(E, U, jnp.inf)
        order = jnp.argsort(vals, axis=0)
        ranks = jnp.argsort(order, axis=0)
        n_e = E.sum(axis=0)
        m = jnp.minimum(jnp.floor(trim_beta * n_e).astype(jnp.int32),
                        jnp.maximum(n_e - 1, 0) // 2)
        keep = (E & (ranks >= m[None, :]) & (ranks < (n_e - m)[None, :]))
        ksum = jnp.where(keep, wcol, 0.0).sum(0)
        agg = jnp.where(keep, allV, 0.0).sum(0) / jnp.maximum(ksum, 1.0)
        n_trim = (jnp.where(E & ~keep, 1.0, 0.0).sum()
                  / jnp.float32(allV.shape[1]))
    else:
        l2u = jnp.sqrt(jnp.where(E, jnp.square(U), 0.0).sum(1))
        elign = adm & (l2u > 0) & jnp.isfinite(l2u)
        medn = jnp.nanmedian(jnp.where(elign, l2u, jnp.nan))
        clip = jnp.where(elign & (l2u > medn),
                         medn / jnp.maximum(l2u, jnp.float32(1e-30)),
                         jnp.float32(1.0))
        n_clip = (clip < 1.0).sum().astype(jnp.float32)
        agg = (jnp.where(E, allV * clip[:, None], 0.0).sum(0)
               / jnp.maximum(total_w, 1.0))
    resid = jnp.sqrt(jnp.square(agg - mean_agg).sum())
    contrib = (adm & keep.any(axis=1)).astype(jnp.float32)
    return agg, contrib, jnp.stack([n_trim, n_clip, resid, contrib.sum()])


def _tables(W, seed, r=3, c=17):
    """[W, r, c] client tables: client 1 poisoned with NaN cells, client
    W-1 ten times larger, client 0 dropped (survivor 0), example counts
    2..7."""
    rng = np.random.RandomState(seed)
    t = rng.randn(W, r, c).astype(np.float32)
    t[1, 0, :3] = np.nan
    t[W - 1] *= 10.0
    surv = np.ones(W, np.float32)
    surv[0] = 0.0
    counts = rng.randint(2, 8, size=W).astype(np.float32)
    pois = np.zeros(W, np.float32)
    pois[2] = 1.0
    return t, surv, counts, pois


def _close(got, want, rtol=1e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    scale = max(np.abs(want[ok & np.isfinite(want)]).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol,
                               atol=rtol * scale)


T = torch.from_numpy


@pytest.mark.parametrize("W", [5, 8])
def test_masked_median_is_jnp_nanmedian(W):
    rng = np.random.RandomState(W)
    x = rng.randn(W, 40).astype(np.float32)
    valid = rng.rand(W, 40) > 0.3
    valid[:, 0] = False              # no valid entry: NaN
    valid[:, 1] = True               # all W: the even/odd middle
    valid[:2, 2] = False
    want = jnp.nanmedian(jnp.where(valid, x, jnp.nan), axis=0)
    got = tround.masked_median(T(x), T(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # torch.median takes the lower middle: the JAX convention differs at
    # an even count, which is why the port writes it out
    if W % 2 == 0:
        assert not np.array_equal(torch.median(T(x[:, 1]))[None].numpy(),
                                  np.asarray(want)[1:2])


@pytest.mark.parametrize("kind", ["nan", "inf", "scale"])
def test_corrupt_matches_jax(kind):
    t, _, _, pois = _tables(6, 0)
    want = jax.jit(j_corrupt, static_argnums=2)(t, pois, kind)
    got = tround.corrupt(T(t), T(pois), kind)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("W", [5, 8])
@pytest.mark.parametrize("attack", ["sign_flip", "scaled", "colluding",
                                    "little_is_enough"])
def test_attack_matches_jax(attack, W):
    t, surv, _, pois = _tables(W, 1)
    pois[W - 2] = 1.0
    cfg = TConfig(attack=attack, byzantine_rate=0.25, screen_norm_mult=5.0)
    want = jax.jit(j_attack, static_argnums=(3, 4))(t, pois, surv, attack,
                                                    5.0)
    got = tround.attack(T(t), T(pois), T(surv), cfg)
    _close(got.numpy(), want)


@pytest.mark.parametrize("W", [5, 8])
@pytest.mark.parametrize("screen_mode", ["finite", "norm"])
def test_admission_screen_matches_jax(screen_mode, W):
    t, surv, _, _ = _tables(W, 2)
    t[3] = 0.0                       # zero l2: not median material
    cfg = TConfig(update_screen=screen_mode, screen_norm_mult=5.0)
    for screen in (1.0, 0.0):
        want = jax.jit(j_admission, static_argnums=(3, 4))(
            t, surv, np.float32(screen), screen_mode == "norm", 5.0)
        got = tround.admission(T(t), T(surv), torch.tensor(screen),
                               cfg).numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
        # the NaN client fails the finite bit, and in the cohort of 8
        # the 10x one the norm check (in that of 5 two of the eligible
        # three are the zero and the 10x client); a screen of 0 applies
        # neither
        refused = ({1, W - 1} if screen_mode == "norm" and W == 8
                   else {1})
        assert {i for i in range(W) if got[i] == 0} == (
            refused if screen else set())


@pytest.mark.parametrize("W", [5, 8])
@pytest.mark.parametrize("aggregator,beta", [
    ("coord_median", 0.2), ("trimmed_mean", 0.2), ("trimmed_mean", 0.4),
    ("norm_clip", 0.2)])
def test_robust_aggregators_match_jax(aggregator, beta, W):
    t, surv, counts, _ = _tables(W, 3)
    V = (t * counts[:, None, None]).reshape(W, -1)
    surv[W // 2] = 0.0               # a screened client
    want = jax.jit(j_robust, static_argnums=(3, 4))(V, counts * surv, surv,
                                                    aggregator, beta)
    cfg = TConfig(aggregator=aggregator, trim_beta=beta)
    got = tround.robust_aggregate(T(V), T(counts * surv), T(surv), cfg)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_straggler_budget_is_a_prefix_of_valid_examples():
    mask = np.ones((3, 6), np.float32)
    mask[1, 4:] = 0.0
    work = np.array([0.5, 0.3, 1.0], np.float32)
    got = tround.straggler_budget(T(mask), T(work)).numpy()
    np.testing.assert_array_equal(got.sum(1), [3, 2, 6])
    np.testing.assert_array_equal(got[1], [1, 1, 0, 0, 0, 0])


# ---------------- one round of each variant vs the JAX FedModel ----------

F, C = 12, 5      # features, classes: a linear classifier


class Linear(torch.nn.Module):
    """x @ w + b, the parameters in the JAX tree's sorted order (b, w)."""

    def __init__(self):
        super().__init__()
        self.b = torch.nn.Parameter(torch.zeros(C))
        self.w = torch.nn.Parameter(torch.zeros(F, C))


def _t_loss(params, batch, mask):
    x, y = batch
    logits = x @ params["w"] + params["b"]
    nll = -torch.log_softmax(logits, -1).gather(1, y.long()[:, None])[:, 0]
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, (loss,)


def _j_loss(params, batch, mask):
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


SKETCH = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=20, num_rows=3, num_cols=40)
VARIANTS = {
    # per-client error rows: a dropped client's rows come back as
    # gathered, and round 1 drops everyone (a no-op round)
    "dropout_local_topk": (dict(mode="local_topk", error_type="local",
                                local_momentum=0.9, k=15),
                           dict(drop_slots={0: [1], 2: [0, 3]},
                                drop_all=[1])),
    # the fused backward with drops and a straggler prefix (the faults
    # path of config #2); a fraction under the cutoff drops its client
    "stragglers_sketch": ({**SKETCH, "client_dropout": 0.3,
                           "straggler_cutoff": 0.2},
                          dict(slow={0: {1: 0.5, 2: 0.1}, 1: {0: 0.34},
                                     2: {3: 0.7}})),
    # a straggler's local steps under fedavg
    "stragglers_fedavg": (dict(mode="fedavg", error_type="none",
                               local_batch_size=-1, fedavg_batch_size=2),
                          dict(slow={0: {1: 0.5}, 1: {0: 0.2, 3: 0.9}})),
    # NaN poison screened out by the finite bit, and a scaled one by
    # the norm screen: screened clients are billed as dropped ones
    "screened_poison": ({**SKETCH, "update_screen": "norm",
                         "poison_kind": "scale"},
                        dict(poison={0: [1], 2: [0, 2]})),
    # the even cohort's coordinate median over per-client K1 tables
    "byzantine_coord_median": ({**SKETCH, "update_screen": "norm",
                                "byzantine_rate": 0.25,
                                "attack": "colluding",
                                "aggregator": "coord_median"}, {}),
}


def _variant_batches(W=4, B=6, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        ids = rng.choice(8, W, replace=False).astype(np.int32)
        x = rng.randn(W, B, F).astype(np.float32)
        y = rng.randint(0, C, size=(W, B)).astype(np.int32)
        mask = np.ones((W, B), np.float32)
        mask[0, -1] = 0.0
        out.append((ids, (x, y), mask))
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fault_variant_round_matches_jax(variant, monkeypatch):
    monkeypatch.setattr(jround, "shard_map", _j_shard_map)
    kw, sched = VARIANTS[variant]
    kw = {**dict(local_momentum=0.0, num_workers=4, num_clients=8,
                 local_batch_size=6, seed=5), **kw}
    rng = np.random.RandomState(0)
    params = {"b": 0.1 * rng.randn(C).astype(np.float32),
              "w": 0.1 * rng.randn(F, C).astype(np.float32)}
    jmodel = JFedModel(None, _j_loss, JConfig(**kw),
                       params=jax.tree.map(jnp.asarray, params),
                       num_clients=8, mesh=make_client_mesh(1))
    tm = Linear()
    with torch.no_grad():
        tm.b.copy_(T(params["b"]))
        tm.w.copy_(T(params["w"]))
    tmodel = TFedModel(tm, _t_loss, TConfig(**kw, device="cpu"),
                       device="cpu", num_clients=8)
    if sched:
        jmodel.set_fault_schedule(jfaults.FaultSchedule(**sched))
        tmodel.set_fault_schedule(tfaults.FaultSchedule(**sched))
    jopt, topt = JFedOptimizer(jmodel), TFedOptimizer(tmodel)
    j_bytes, t_bytes = np.zeros(2), np.zeros(2)
    for i, batch in enumerate(_variant_batches()):
        jopt.param_groups[0]["lr"] = topt.param_groups[0]["lr"] = 0.3
        jl, _, jd, ju = jmodel(batch)
        tl, _, td, tu = tmodel(batch)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        # per slot: a dropped or screened client is billed nothing
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tu, ju)
        j_bytes += [jd.sum(), ju.sum()]
        t_bytes += [td.sum(), tu.sum()]
        jw = np.asarray(jmodel.ps_weights)
        np.testing.assert_allclose(tmodel.ps_weights.numpy(), jw, rtol=0,
                                   atol=1e-5 * np.abs(jw).max(),
                                   err_msg=f"round {i}")
        for block in ("errors", "velocities"):
            jrows = np.asarray(getattr(jmodel.clients, block))
            if jrows.size:
                trows = getattr(tmodel.clients, block).numpy()
                np.testing.assert_allclose(
                    trows, jrows[:8], rtol=0,
                    atol=1e-5 * max(np.abs(jrows).max(), 1e-30))
    np.testing.assert_array_equal(t_bytes, j_bytes)
    assert t_bytes[1] > 0


def test_dropped_and_screened_slots_are_charged_nothing():
    # a zero-survivor round leaves the weights bitwise and bills no
    # byte; a screened slot is billed as a dropped one; crash_after
    # raises once its round has completed
    kw = dict(SKETCH, local_momentum=0.0, num_workers=4, num_clients=8,
              local_batch_size=6, update_screen="finite",
              poison_kind="nan")
    tmodel = TFedModel(Linear(), _t_loss, TConfig(**kw, device="cpu"),
                       device="cpu", num_clients=8)
    tmodel.set_fault_schedule(tfaults.FaultSchedule(
        drop_all=[0], poison={1: [2]}, crash_after=2))
    opt = TFedOptimizer(tmodel)
    opt.param_groups[0]["lr"] = 0.3
    batches = _variant_batches()
    w0 = tmodel.ps_weights.clone()
    _, _, down, up = tmodel(batches[0])
    assert torch.equal(tmodel.ps_weights, w0)
    assert up.sum() == 0 and down.sum() == 0
    _, _, down, up = tmodel(batches[1])
    assert up[2] == 0 and (up[[0, 1, 3]] > 0).all()
    assert torch.isfinite(tmodel.ps_weights).all()
    assert not torch.equal(tmodel.ps_weights, w0)
    with pytest.raises(tfaults.InjectedFault) as e:
        tmodel(batches[2])
    assert e.value.round_idx == 2 and tmodel.server.round_idx == 3


# ---------------- the drivers: faults, the rollback drill -----------------

def _cv_argv(tmp_path, *extra):
    return ["--test", "--device", "cpu", "--mode", "uncompressed",
            "--local_momentum", "0", "--num_workers", "4",
            "--local_batch_size", "8", "--num_clients", "20",
            "--dataset_dir", str(tmp_path / "data"), "--seed", "21",
            *extra]


def test_poison_trip_rolls_back_and_screens_the_replay(tmp_path):
    """The rollback drill through cv_train: NaN poison with the screen
    off trips the numeric watch, the driver loads the newest finite
    checkpoint, replays with screening forced on and finishes finite;
    the journal holds the trip, the screened replay and validates with
    the JAX package's reader. A survivor target of every slot
    (--target_survivors 4) makes the scheduler plan each round without
    changing it, so each round journals its `schedule` record (only
    planned rounds do, as in the JAX package)."""
    from commefficient_tpu.telemetry.journal import validate_journal
    from commefficient_tpu_torch.training import cv_train
    ck, jr = tmp_path / "ck", tmp_path / "j.jsonl"
    cfg = parse_args(argv=_cv_argv(
        tmp_path, "--num_epochs", "3", "--checkpoint_every", "1",
        "--checkpoint_path", str(ck), "--journal_path", str(jr),
        "--rollback_screen_rounds", "64", "--target_survivors", "4"))
    model, opt, sched, loader, val = cv_train.build(
        cfg, device="cpu", synthetic_examples=(160, 32))
    # poison slot 1 of round 8, inside the second epoch (the non-IID
    # epochs draw 5 or 6 rounds), past the first epoch's checkpoint
    poisoned = 8
    model.set_fault_schedule(tfaults.FaultSchedule(poison={poisoned: [1]}))
    assert cv_train.run(model, opt, sched, loader, val, model.cfg,
                        str(tmp_path))
    assert torch.isfinite(model.ps_weights).all()
    assert model.server.round_idx == 3 * loader.steps_per_epoch
    records, problems = validate_journal(str(jr))
    assert not problems, problems
    kinds = [r["event"] for r in records]
    assert kinds.count("numeric_trip") == 1
    trip = kinds.index("numeric_trip")
    assert records[trip]["round"] == poisoned
    assert "checkpoint" in kinds[:trip]
    after = records[trip + 1:]
    assert [r["round"] for r in after if r["event"] == "screened"] == [
        poisoned]
    replay = [r for r in after if r["event"] == "schedule"
              and r["round"] == poisoned]
    assert replay and replay[0]["screen_on"] == 1.0
    assert replay[0]["n_poisoned"] == 1


def test_poison_rate_drill_screens_every_poisoned_round_of_the_replay(
        tmp_path):
    """The drill on the live draw: --poison_rate 0.1 at seed 13 first
    poisons round 9 (then 10, 11 and 14), past the first epoch's
    checkpoint. The trip at round 9 rolls back and the 64-round window
    covers the rest of the run, so every poisoned round of the replay
    is screened and the run ends finite with one trip."""
    from commefficient_tpu.telemetry.journal import validate_journal
    from commefficient_tpu_torch.training import cv_train
    seed, rate = 13, 0.1
    poisoned = [r for r in range(15)
                if tfaults.poison_mask(seed, r, 4, rate).any()]
    assert poisoned[0] == 9
    jr = tmp_path / "j.jsonl"
    argv = _cv_argv(tmp_path, "--num_epochs", "3", "--checkpoint_every",
                    "1", "--checkpoint_path", str(tmp_path / "ck"),
                    "--journal_path", str(jr), "--poison_rate", str(rate),
                    "--rollback_screen_rounds", "64")
    argv[argv.index("--seed") + 1] = str(seed)
    model, opt, sched, loader, val = cv_train.build(
        parse_args(argv=argv), device="cpu", synthetic_examples=(160, 32))
    assert cv_train.run(model, opt, sched, loader, val, model.cfg,
                        str(tmp_path))
    assert torch.isfinite(model.ps_weights).all()
    records, problems = validate_journal(str(jr))
    assert not problems, problems
    trips = [i for i, r in enumerate(records)
             if r["event"] == "numeric_trip"]
    assert len(trips) == 1 and records[trips[0]]["round"] == 9
    assert [r["round"] for r in records[trips[0]:]
            if r["event"] == "screened"] == poisoned


def test_trip_without_a_finite_checkpoint_re_raises(tmp_path):
    from commefficient_tpu_torch.telemetry import NumericTripError
    from commefficient_tpu_torch.training import cv_train
    cfg = parse_args(argv=_cv_argv(
        tmp_path, "--num_epochs", "1", "--checkpoint_path",
        str(tmp_path / "ck"), "--journal_path", str(tmp_path / "j.jsonl"),
        "--poison_rate", "0.9"))
    model, opt, sched, loader, val = cv_train.build(
        cfg, device="cpu", synthetic_examples=(160, 32))
    with pytest.raises(NumericTripError):
        cv_train.run(model, opt, sched, loader, val, model.cfg,
                     str(tmp_path))


@pytest.mark.parametrize("flags", [
    ("--client_dropout", "0.25", "--straggler_rate", "0.5",
     "--straggler_cutoff", "0.2"),
    ("--update_screen", "norm", "--byzantine_rate", "0.25", "--attack",
     "colluding", "--aggregator", "trimmed_mean", "--trim_beta", "0.25"),
    ("--update_screen", "finite", "--poison_rate", "0.3",
     "--poison_kind", "inf", "--aggregator", "norm_clip"),
], ids=["dropout-stragglers", "byzantine-trimmed_mean", "poison-norm_clip"])
def test_fault_flags_run_through_cv_train(tmp_path, flags):
    from commefficient_tpu.telemetry.journal import validate_journal
    from commefficient_tpu_torch.training import cv_train
    jr = tmp_path / "j.jsonl"
    cfg = parse_args(argv=_cv_argv(tmp_path, "--num_epochs", "0.2",
                                   "--journal_path", str(jr), *flags))
    model, opt, sched, loader, val = cv_train.build(
        cfg, device="cpu", synthetic_examples=(160, 32))
    assert cv_train.run(model, opt, sched, loader, val, model.cfg,
                        str(tmp_path))
    assert torch.isfinite(model.ps_weights).all()
    records, problems = validate_journal(str(jr))
    assert not problems, problems
    # no scheduler plan, no `schedule` record (the JAX rule)
    assert not any(r["event"] == "schedule" for r in records)
    assert any(r["event"] == "round" for r in records)


@pytest.mark.parametrize("flags,match", [
    (("--byzantine_rate", "0.2", "--poison_rate", "0.2"),
     "mutually exclusive"),
    (("--screen_norm_mult", "1.0"), "screen_norm_mult"),
    (("--trim_beta", "0.5"), "trim_beta"),
    (("--straggler_min_work", "0"), "straggler_min_work"),
    (("--rollback_screen_rounds", "0"), "rollback_screen_rounds"),
    (("--target_screened_rate", "0.1"), "requires --update_screen norm"),
])
def test_fault_flag_invariants_are_jax_validate(tmp_path, flags, match):
    from commefficient_tpu.config import parse_args as j_parse_args
    argv = _cv_argv(tmp_path, *flags)
    with pytest.raises(ValueError, match=match):
        parse_args(argv=argv)
    with pytest.raises(ValueError, match=match):
        j_parse_args(argv=[a for a in argv if a not in ("--device", "cpu")])


# the options of item 9's multi-device step (9g): --model_parallel > 1,
# --multihost, --num_slices > 1 and the plan transport are ported and
# validate as in JAX
ITEM_9_REFUSED = {
    "--model_parallel > 1": dict(model_parallel=2),
    "--plan_transport": dict(plan_transport="emulated"),
    "--multihost": dict(multihost=True),
    "--num_slices > 1": dict(num_slices=2),
}
# the options items 9d and 9e brought, which now validate
ITEM_9DE_PORTED = {
    "--sampler": dict(sampler="throughput", explore_floor=0.2),
    "--deadline_quantile": dict(deadline_quantile=0.9,
                                deadline_min_work=0.25),
    "--target_survivors": dict(target_survivors=6),
    "--async_admit_rounds": dict(async_admit_rounds=1,
                                 async_staleness_decay=0.7),
    "--state_tier host": dict(mode="local_topk", error_type="local",
                              state_tier="host", state_working_set=8),
    "--state_spill_dir": dict(mode="local_topk", error_type="local",
                              state_tier="host", state_working_set=8,
                              state_spill_dir="tail"),
}


# the controllers item 9f brought, which now validate as in JAX
ITEM_9F_PORTED = {
    "--target_screened_rate": dict(update_screen="norm",
                                   target_screened_rate=0.1),
    "--speed_match": dict(speed_match=True, async_admit_rounds=1),
    "--scan_span_palette": dict(scan_rounds=True,
                                scan_span_palette="1,2"),
    "--adapt_staleness": dict(adapt_staleness=True, async_admit_rounds=1),
}
# and what JAX's validate refuses of them, refused word for word
ITEM_9F_REFUSED = {
    "screen-needs-norm": dict(target_screened_rate=0.1),
    "screen-rate-below-1": dict(update_screen="norm",
                                target_screened_rate=1.0),
    "speed-needs-async": dict(speed_match=True),
    "speed-ratio-below-1": dict(speed_match=True, async_admit_rounds=1,
                                speed_ratio_max=1.0),
    "palette-needs-scan": dict(scan_span_palette="1,2"),
    "palette-needs-1": dict(scan_rounds=True, scan_span_palette="2,4"),
    "palette-positive": dict(scan_rounds=True, scan_span_palette="1,-2"),
    "palette-or-span": dict(scan_rounds=True, scan_span=2,
                            scan_span_palette="1,2"),
    "staleness-needs-async": dict(adapt_staleness=True),
    "staleness-bounds": dict(adapt_staleness=True, async_admit_rounds=1,
                             staleness_decay_min=0.0),
    "screen-step": dict(update_screen="norm", target_screened_rate=0.1,
                        screen_adapt_step=0.0),
    "screen-mult-floor": dict(update_screen="norm",
                              target_screened_rate=0.1,
                              screen_mult_min=1.0),
    "staleness-bounded-span": dict(adapt_staleness=True,
                                   async_admit_rounds=1, scan_rounds=True,
                                   pipeline=True),
}


@pytest.mark.parametrize("flag", sorted(ITEM_9F_PORTED))
def test_what_item_9f_ported_validates_as_jax(flag):
    kw = {**dict(mode="uncompressed", local_momentum=0.0, num_workers=8),
          **ITEM_9F_PORTED[flag]}
    cfg = TConfig(**kw)
    assert cfg.validate() is cfg
    jcfg = JConfig(**kw).validate()
    assert (cfg.adaptive_screen, cfg.span_palette, cfg.control_loop) == (
        jcfg.adaptive_screen, jcfg.span_palette, jcfg.control_loop)


@pytest.mark.parametrize("case", sorted(ITEM_9F_REFUSED))
def test_item_9f_refusals_are_jax_validate(case):
    kw = {**dict(mode="uncompressed", local_momentum=0.0, num_workers=8),
          **ITEM_9F_REFUSED[case]}
    with pytest.raises(ValueError) as want:
        JConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        TConfig(**kw).validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flag", sorted(ITEM_9DE_PORTED))
def test_what_items_9d_9e_ported_validates(flag):
    cfg = TConfig(**{**dict(mode="uncompressed", local_momentum=0.0,
                            num_workers=8), **ITEM_9DE_PORTED[flag]})
    assert cfg.validate() is cfg


@pytest.mark.parametrize("flag", sorted(ITEM_9_REFUSED))
def test_what_item_9_still_holds_is_refused_naming_it(flag):
    kw = {**dict(mode="uncompressed", local_momentum=0.0),
          **ITEM_9_REFUSED[flag]}
    cfg = TConfig(**kw)
    # ported in item 9g: validates as JAX's Config
    assert cfg.validate() is cfg
    jcfg = JConfig(**kw).validate()
    assert (cfg.model_parallel, cfg.multihost, cfg.num_slices,
            cfg.plan_transport, cfg.plan_controllers) == (
        jcfg.model_parallel, jcfg.multihost, jcfg.num_slices,
        jcfg.plan_transport, jcfg.plan_controllers)
