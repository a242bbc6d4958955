"""Compressor plugin parity: the port's compress/ package (powersgd,
dp_sketch, the RDP accountant and the registry) against the JAX
package's, on the same numpy inputs; the counterparts of
tests/test_compress.py. JAX runs on the CPU test mesh; the port on the
CPU with its kernels' plain versions."""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu import compress as jcompress
from commefficient_tpu.compress import powersgd as jpowersgd
from commefficient_tpu.config import MODES as J_MODES
from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.telemetry.journal import validate_journal
from commefficient_tpu.utils import checkpoint as jck
from commefficient_tpu_torch import compress as tcompress
from commefficient_tpu_torch.compress import powersgd as tpowersgd
from commefficient_tpu_torch.config import MODES as T_MODES
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.federated.api import (
    FedModel as TFedModel, FedOptimizer as TFedOptimizer,
)
from commefficient_tpu_torch.ops import prng
from commefficient_tpu_torch.telemetry import RunJournal, TelemetrySession
from commefficient_tpu_torch.utils import checkpoint as tck
from commefficient_tpu_torch.utils.faults import DOMAINS, FaultSchedule
from tests.test_torch_round import (
    JFedModel, JFedOptimizer, _batches, _case_models, j_make_compute_loss,
    t_make_compute_loss,
)

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# config #2's flat size: its PowerSGD matrix is [2,564, 2,562]
CONFIG2_D = 6_568_640

# the plugins on the tiny ResNet9 of tests/test_torch_round.py
PLUGIN_CASES = {
    "powersgd": dict(mode="powersgd", error_type="local", powersgd_rank=2),
    "powersgd_rank1_momentum": dict(mode="powersgd", error_type="local",
                                    powersgd_rank=1, virtual_momentum=0.9),
    "dp_sketch": dict(mode="dp_sketch", error_type="virtual",
                      virtual_momentum=0.9, k=300, num_rows=5, num_cols=700,
                      dp_clip=1.0, dp_noise_mult=0.5),
    "dp_sketch_no_error": dict(mode="dp_sketch", error_type="none",
                               virtual_momentum=0.9, k=300, num_rows=5,
                               num_cols=700, dp_clip=0.5, dp_noise_mult=1.0),
}
# the two modes of the drills below, on the tiny ResNet9
DRILL_CASES = ("powersgd", "dp_sketch")


def _kw(case, **extra):
    return {**dict(local_momentum=0.0, num_workers=4, num_clients=12,
                   local_batch_size=6), **PLUGIN_CASES[case], **extra}


def _port_model(case, **extra):
    _, params, tm = _case_models("tiny")
    model = TFedModel(tm, t_make_compute_loss(tm),
                      TConfig(**_kw(case, **extra), device="cpu"),
                      device="cpu", num_clients=12)
    opt = TFedOptimizer(model)
    opt.param_groups[0]["lr"] = 0.1
    return model, opt


def _jax_model(case, **extra):
    jm, params, _ = _case_models("tiny")
    model = JFedModel(None, j_make_compute_loss(jm),
                      JConfig(**_kw(case, **extra)), params=params,
                      num_clients=12)
    opt = JFedOptimizer(model)
    opt.param_groups[0]["lr"] = 0.1
    return model, opt


def _state(model):
    return [t.clone() for t in (*model.server[:3], *model.clients)]


def _assert_state_equal(a, b, what):
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), f"{what}: state tensor {i} differs"


# ---------------- registry and specs ---------------------------------------

def test_registry_covers_modes():
    assert set(tcompress.registered_modes()) == set(T_MODES) == set(J_MODES)
    assert tcompress.registered_modes() == jcompress.registered_modes()
    with pytest.raises(KeyError, match="no compressor registered"):
        tcompress.get_compressor("no_such_mode")


SPEC_CASES = {
    "sketch": dict(mode="sketch", error_type="virtual", k=4, num_rows=3,
                   num_cols=16),
    "sketch_int8": dict(mode="sketch", error_type="virtual", k=4,
                        num_rows=3, num_cols=16, sketch_table_dtype="int8"),
    "true_topk": dict(mode="true_topk", error_type="virtual", k=3),
    "local_topk": dict(mode="local_topk", error_type="local", k=3),
    "fedavg": dict(mode="fedavg", local_batch_size=-1),
    "uncompressed": dict(mode="uncompressed"),
    "powersgd": dict(mode="powersgd", error_type="local", powersgd_rank=3),
    "dp_sketch": dict(mode="dp_sketch", error_type="virtual", k=4,
                      num_rows=2, num_cols=64, dp_noise_mult=1.0),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_plugin_specs_match_jax(case):
    # the static specs the round engine, the accountant and the
    # checkpoint read: state shape, wire floats and bytes, tracked rows
    kw = dict(grad_size=1000, num_workers=8, num_clients=8,
              local_momentum=0.0, **SPEC_CASES[case])
    jcfg = JConfig(**kw).validate()
    tcfg = TConfig(**kw, device="cpu").validate()
    jc, tc = jcfg.compressor, tcfg.compressor
    assert tc.name == jc.name == kw["mode"]
    assert tuple(tc.state_shape(tcfg)) == tuple(jc.state_shape(jcfg))
    assert tcfg.upload_floats == jcfg.upload_floats
    assert tcfg.upload_bytes == jcfg.upload_bytes
    assert tc.has_errors(tcfg) == jc.has_errors(jcfg)
    assert tc.has_velocities(tcfg) == jc.has_velocities(jcfg)
    assert (tc.sketch_like, tc.local_sgd) == (jc.sketch_like, jc.local_sgd)
    assert tcfg.defer_sketch_encode == jcfg.defer_sketch_encode
    assert tcfg.fused_client_backward == jcfg.fused_client_backward


def test_dp_sketch_encodes_each_client_never_the_cohort_sum():
    # the clip is nonlinear: no deferred encode, no fused backward
    cfg = TConfig(**_kw("dp_sketch"), device="cpu").validate()
    assert not cfg.defer_sketch_encode
    assert not cfg.fused_client_backward


@pytest.mark.parametrize("d", [1, 2, 17, 1000, 99_242, CONFIG2_D])
def test_factor_shape_and_wire_geometry_match_jax(d):
    m, n = tpowersgd.factor_shape(d)
    assert (m, n) == jpowersgd.factor_shape(d)
    assert m * n >= d >= n * n and (m - 1) * n < d
    if d == CONFIG2_D:
        # config #2 uploads (2,564 + 2,562) x rank 2 floats a client
        assert (m, n) == (2564, 2562)
        cfg = TConfig(mode="powersgd", error_type="local",
                      local_momentum=0.0, powersgd_rank=2, grad_size=d)
        assert cfg.upload_bytes == (2564 + 2562) * 2 * 4


# ---------------- Gram-Schmidt ---------------------------------------------

@pytest.mark.parametrize("shape", [(32, 4), (2564, 2), (7, 1)])
def test_orthonormalize_matches_jax(shape):
    # the same column order and eps guard; the dot products and norms
    # reduce in another order than XLA's, so 1e-6 of the O(1) entries
    P = np.random.RandomState(shape[0]).randn(*shape).astype(np.float32)
    Q = tpowersgd.orthonormalize(torch.from_numpy(P))
    JQ = np.asarray(jpowersgd.orthonormalize(jnp.asarray(P)))
    np.testing.assert_allclose(Q.numpy(), JQ, rtol=0, atol=1e-6)
    np.testing.assert_allclose((Q.T @ Q).numpy(), np.eye(shape[1]),
                               atol=1e-5)
    # the same span: projecting P onto Q loses nothing
    np.testing.assert_allclose((Q @ (Q.T @ torch.from_numpy(P))).numpy(),
                               P, atol=1e-4)


def test_orthonormalize_rank_deficient_is_finite_and_matches_jax():
    # duplicate and zero columns: the eps guard keeps every entry finite
    col = np.random.RandomState(4).randn(16, 1).astype(np.float32)
    P = np.concatenate([col, col, 0.0 * col], axis=1)
    Q = tpowersgd.orthonormalize(torch.from_numpy(P))
    assert bool(torch.isfinite(Q).all())
    JQ = np.asarray(jpowersgd.orthonormalize(jnp.asarray(P)))
    np.testing.assert_allclose(Q.numpy()[:, 0], JQ[:, 0], rtol=0,
                               atol=1e-6)
    assert np.isfinite(JQ).all()


# ---------------- the plugins' seams against the JAX plugins -----------------

def test_powersgd_residual_matches_jax_fresh_and_warm():
    # one client's residual seam, from a zero Q row (the "powersgd"
    # domain's normal draw on the client key) and from a warm one
    D, r = 1000, 2
    m, n = tpowersgd.factor_shape(D)
    kw = dict(mode="powersgd", error_type="local", local_momentum=0.0,
              powersgd_rank=r, grad_size=D)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw, device="cpu")
    rng = np.random.RandomState(11)
    g = rng.randn(D).astype(np.float32)
    err = rng.randn(D).astype(np.float32)
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(21),
                                                 3), 2)
    tkey = prng.fold_in(prng.fold_in(prng.PRNGKey(21), 3), 2)
    warm = np.zeros(D, np.float32)
    warm[:n * r] = rng.randn(n * r)
    for vel in (np.zeros(D, np.float32), warm):
        ja, je, jv = jcfg.compressor.residual(
            jcfg, jnp.asarray(g), jnp.asarray(err), jnp.asarray(vel), jkey)
        ta, te, tv = tcfg.compressor.residual(
            tcfg, torch.from_numpy(g), torch.from_numpy(err),
            torch.from_numpy(vel), tkey)
        for t, j in ((ta, ja), (te, je), (tv, jv)):
            j = np.asarray(j)
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=1e-5 * np.abs(j).max())
        # the Q factor rides the velocity row, the rest of it zero
        assert np.abs(tv.numpy()[:n * r]).sum() > 0
        assert not tv.numpy()[n * r:].any()
        # transmitted + residual = the accumulator, exactly the carry
        np.testing.assert_allclose((ta + te).numpy(), g, atol=1e-5)


def test_dp_sketch_clip_is_the_frobenius_norm_of_the_table():
    # torch.linalg.vector_norm of the [r, c] table is jnp.linalg.norm's
    # 2-D Frobenius norm; every clipped table sits at norm <= dp_clip
    kw = dict(mode="dp_sketch", error_type="virtual", local_momentum=0.0,
              num_rows=5, num_cols=700, dp_noise_mult=0.5, dp_clip=1.0,
              grad_size=3000)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw, device="cpu")
    rng = np.random.RandomState(3)
    for scale in (1e-3, 1.0, 50.0):
        t = (scale * rng.randn(5, 700)).astype(np.float32)
        out, _, _ = tcfg.compressor.residual(tcfg, torch.from_numpy(t),
                                             None, None)
        jout, _, _ = jcfg.compressor.residual(jcfg, jnp.asarray(t),
                                              None, None)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                                   atol=0)
        norm = float(torch.linalg.vector_norm(out.double()))
        assert norm <= 1.0 + 1e-6
        if np.linalg.norm(t) <= 1.0:
            assert torch.equal(out, torch.from_numpy(t))


def test_dp_sketch_noise_matches_jax_draw():
    # once a round on the aggregate: std dp_noise_mult * dp_clip on the
    # "dp" domain of the round key; the port's normals sit within 1e-6
    # relative of jax.random's (tests/test_torch_prng.py), so the noisy
    # table within 1e-6 of its scale
    kw = dict(mode="dp_sketch", error_type="virtual", local_momentum=0.0,
              num_rows=5, num_cols=700, dp_noise_mult=0.7, dp_clip=2.0,
              grad_size=3000)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw, device="cpu")
    agg = np.random.RandomState(5).randn(5, 700).astype(np.float32)
    jround_key = jax.random.fold_in(jax.random.PRNGKey(21), 4)
    tround_key = prng.fold_in(prng.PRNGKey(21), 4)
    j = np.asarray(jcfg.compressor.post_aggregate(
        jcfg, jnp.asarray(agg), jround_key))
    t = tcfg.compressor.post_aggregate(tcfg, torch.from_numpy(agg),
                                       tround_key).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6 * np.abs(j).max())
    noise = t - agg
    assert abs(float(noise.std()) - 1.4) < 0.05
    assert DOMAINS["dp"] == 0xD9A05 and DOMAINS["powersgd"] == 0x909D0


# ---------------- rounds against the JAX FedModel ----------------------------

@pytest.mark.parametrize("case", sorted(PLUGIN_CASES))
def test_plugin_rounds_match_jax(case):
    # 3 rounds, 4 clients x 6 examples, at test_fedmodel_rounds_match_
    # jax's limits: weights and client rows (PowerSGD's error residual
    # and Q factor) within 1e-5 of their scale, losses 1e-5 relative,
    # the billed bytes IDENTICAL. dp_sketch's normals sit within 1e-6
    # relative of JAX's, so the top-k could pick another coordinate only
    # where JAX's estimate lies within that of the k-th; these rounds
    # pick the same ones (the weights agree to 1e-5 of their scale)
    jmodel, jopt = _jax_model(case)
    tmodel, topt = _port_model(case)
    j_bytes, t_bytes = np.zeros(2), np.zeros(2)
    for i, batch in enumerate(_batches(3, 4, 6, 12, seed=7)):
        jl, _, jd, ju = jmodel(batch)
        tl, _, td, tu = tmodel(batch)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(tu), np.asarray(ju))
        j_bytes += [np.sum(jd), np.sum(ju)]
        t_bytes += [np.sum(td), np.sum(tu)]
        jw = np.asarray(jmodel.ps_weights)
        np.testing.assert_allclose(tmodel.ps_weights.numpy(), jw, rtol=0,
                                   atol=1e-5 * np.abs(jw).max(),
                                   err_msg=f"round {i}")
        for block in ("errors", "velocities"):
            jrows = np.asarray(getattr(jmodel.clients, block))
            trows = getattr(tmodel.clients, block).numpy()
            if jrows.size == 0:
                assert trows.size == 0, block
                continue
            jrows = jrows[:12]
            np.testing.assert_allclose(
                trows, jrows, rtol=0, atol=1e-5 * np.abs(jrows).max(),
                err_msg=f"{block}, round {i}")
    np.testing.assert_array_equal(t_bytes, j_bytes)
    assert t_bytes[0] > 0 and t_bytes[1] > 0
    cfg = tmodel.cfg
    assert t_bytes[1] == 3 * 4 * cfg.upload_bytes


def test_powersgd_q_rows_warm():
    # a client's Q row is zero before its first round and holds its
    # [n, r] factor after it; untouched clients stay zero
    model, opt = _port_model("powersgd")
    m, n = tpowersgd.factor_shape(model.cfg.grad_size)
    assert not model.clients.velocities.any()
    batch = _batches(1, 4, 6, 12, seed=3)[0]
    model(batch)
    vel = model.clients.velocities.numpy()
    ids = batch[0]
    others = np.setdiff1d(np.arange(12), ids)
    assert (np.abs(vel[ids, :n * 2]).sum(axis=1) > 0).all()
    assert not vel[ids, n * 2:].any()
    assert not vel[others].any()
    assert np.abs(model.clients.errors.numpy()[ids]).sum() > 0


def test_dp_sketch_replay_bitwise():
    # the noise is a pure function of (seed, round): two runs agree
    states = []
    for _ in range(2):
        model, opt = _port_model("dp_sketch")
        for batch in _batches(3, 4, 6, 12, seed=5):
            model(batch)
        states.append(_state(model))
    _assert_state_equal(*states, "dp_sketch replay")


@pytest.mark.parametrize("case", DRILL_CASES)
def test_screened_matches_dropped(case):
    # NaN-poisoned slots under the finite screen land the same bits as
    # the same slots scripted as drops: server state, client rows
    # (PowerSGD's Q included) and every round's bytes
    slots = {1: [2], 2: [0, 3]}
    poisoned, _ = _port_model(case, update_screen="finite",
                              poison_kind="nan")
    poisoned.set_fault_schedule(FaultSchedule(poison=slots))
    dropped, _ = _port_model(case)
    dropped.set_fault_schedule(FaultSchedule(drop_slots=slots))
    for r, batch in enumerate(_batches(4, 4, 6, 12, seed=9)):
        *_, dp, up = poisoned(batch)
        *_, dd, ud = dropped(batch)
        np.testing.assert_array_equal(up, ud, err_msg=f"round {r}")
        np.testing.assert_array_equal(dp, dd, err_msg=f"round {r}")
        for s in slots.get(r, ()):
            assert up[s] == 0.0
    _assert_state_equal(_state(poisoned), _state(dropped),
                        f"{case}: screened vs dropped")


# ---------------- the RDP accountant -----------------------------------------

@pytest.mark.parametrize("sigma,delta", [(0.5, 1e-5), (0.7, 1e-5),
                                         (1.0, 1e-5), (2.0, 1e-6),
                                         (4.0, 1e-3)])
def test_rdp_epsilon_equals_jax_and_hugs_the_closed_form(sigma, delta):
    ta = tcompress.RdpAccountant(sigma, delta)
    ja = jcompress.RdpAccountant(sigma, delta)
    assert ta.alphas == ja.alphas
    prev = 0.0
    for steps in (0, 1, 2, 10, 100, 1000, 10_000):
        eps = ta.epsilon(steps)
        assert eps == ja.epsilon(steps)
        ref = tcompress.closed_form_epsilon(sigma, delta, steps)
        assert ref == jcompress.closed_form_epsilon(sigma, delta, steps)
        if steps == 0:
            assert eps == 0.0
            continue
        # the grid can only lose to the continuous optimum, within 1%
        # up to tests/test_compress.py's 1,000 rounds (past them the
        # optimum order nears 1, under the grid's first step 1.1)
        assert eps >= ref - 1e-9
        if steps <= 1000:
            assert eps <= ref * 1.01
        assert eps > prev
        prev = eps


def test_rdp_accountant_rejects_bad_params():
    for args in ((0.0, 1e-5), (1.0, 0.0), (1.0, 1.0)):
        with pytest.raises(ValueError):
            tcompress.RdpAccountant(*args)
    with pytest.raises(ValueError, match="> 1"):
        tcompress.RdpAccountant(1.0, 1e-5, alphas=(1.0, 2.0))


def _dp_run(tmp_path, name, rounds, target):
    """dp_sketch rounds with a journal; returns (the raise or None, the
    journal's records, the model)."""
    model, opt = _port_model("dp_sketch", dp_target_epsilon=target)
    path = str(tmp_path / f"{name}.jsonl")
    tele = TelemetrySession(journal=RunJournal(path))
    model.attach_telemetry(tele)
    err = None
    try:
        for batch in _batches(rounds, 4, 6, 12, seed=7):
            model(batch)
    except RuntimeError as e:
        err = e
    finally:
        tele.close(ok=err is None)
    recs, problems = validate_journal(path)
    assert not problems, problems
    return err, recs, model


def test_privacy_journal_and_budget(tmp_path):
    # one `privacy` event a round with JAX's keys and the accountant's
    # epsilon(n + 1); the JAX package's validate_journal reads the
    # journal clean
    acc = tcompress.RdpAccountant(0.5, 1e-5)
    err, recs, model = _dp_run(tmp_path, "free", 3, 0.0)
    assert err is None
    priv = [r for r in recs if r["event"] == "privacy"]
    assert [r["round"] for r in priv] == [0, 1, 2]
    for r in priv:
        assert r["epsilon"] == round(acc.epsilon(r["round"] + 1), 6)
        assert (r["sigma"], r["clip"], r["delta"]) == (0.5, 1.0, 1e-5)
    comp = [r for r in recs if r["event"] == "compressor"]
    assert len(comp) == 3 and all(c["mode"] == "dp_sketch" for c in comp)
    # a target between epsilon(N - 1) and epsilon(N) raises after round
    # N - 1's event, naming the flag; the journal holds N events
    N = 3
    target = 0.5 * (acc.epsilon(N - 1) + acc.epsilon(N))
    err, recs, model = _dp_run(tmp_path, "budget", 5, target)
    assert err is not None and "dp_target_epsilon" in str(err)
    priv = [r for r in recs if r["event"] == "privacy"]
    assert len(priv) == N
    assert priv[-1]["epsilon"] > target >= priv[-2]["epsilon"]
    # the crossing round committed before the raise
    assert model.server.round_idx == N


def test_privacy_resumes_from_the_rounds_done(tmp_path):
    # no accountant state in the checkpoint: a loaded model journals
    # epsilon(rounds_done + 1) for its next round
    model, _ = _port_model("dp_sketch")
    for batch in _batches(2, 4, 6, 12, seed=7):
        model(batch)
    path = tck.save_checkpoint(str(tmp_path / "ck"), model.server,
                               model.clients,
                               fingerprint=model.checkpoint_fingerprint)
    with np.load(path) as z:
        assert not any("priv" in k or "eps" in k for k in z.files)
    resumed, _ = _port_model("dp_sketch")
    resumed.load_state(tck.load_checkpoint(path))
    jpath = str(tmp_path / "j.jsonl")
    tele = TelemetrySession(journal=RunJournal(jpath))
    resumed.attach_telemetry(tele)
    resumed(_batches(3, 4, 6, 12, seed=7)[2])
    tele.close(ok=True)
    recs, _ = validate_journal(jpath)
    (priv,) = [r for r in recs if r["event"] == "privacy"]
    assert priv["round"] == 2
    assert priv["epsilon"] == round(
        tcompress.RdpAccountant(0.5, 1e-5).epsilon(3), 6)


# ---------------- checkpoints across the packages ------------------------------

def _save_kwargs(model):
    return dict(scheduler_step=2, accountant=model.accountant,
                prev_change_words=model._prev_change_words,
                fingerprint=model.checkpoint_fingerprint,
                client_rows=model.client_rows_payload())


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("case", DRILL_CASES)
def test_checkpoints_cross_load_both_ways(tmp_path, case, direction):
    # package P runs 2 rounds and saves; package Q loads it (PowerSGD's
    # Q factors and error residuals in the crows_* payload) and runs
    # round 3 from the same batch as P's round 3: weights at the round
    # limits, bytes equal
    P, Q = direction.split("-to-")
    make = {"jax": _jax_model, "port": _port_model}
    save = {"jax": jck.save_rotating, "port": tck.save_rotating}
    load = {"jax": jck.load_resilient, "port": tck.load_resilient}
    p_model, _ = make[P](case)
    batches = _batches(3, 4, 6, 12, seed=7)
    for batch in batches[:2]:
        p_model(batch)
    prefix = str(tmp_path / "p" / "ResNet9")
    written = save[P](prefix, p_model.server, p_model.clients,
                      **_save_kwargs(p_model))
    q_model, _ = make[Q](case)
    path, ckpt = load[Q](prefix, expect_fingerprint=q_model
                         .checkpoint_fingerprint)
    assert path == written
    assert q_model.load_state(ckpt) == 2
    if case == "powersgd":
        with np.load(written) as z:
            assert np.abs(z["crows_velocities"]).sum() > 0
            assert np.abs(z["crows_errors"]).sum() > 0
    _, _, pd, pu = p_model(batches[2])
    _, _, qd, qu = q_model(batches[2])
    pw = np.asarray(p_model.ps_weights)
    qw = np.asarray(q_model.ps_weights)
    np.testing.assert_allclose(qw, pw, rtol=0, atol=1e-5 * np.abs(pw).max())
    assert (np.sum(qd), np.sum(qu)) == (np.sum(pd), np.sum(pu))
    assert np.sum(qd) > 0


# ---------------- validate() refusals ----------------------------------------

REFUSED = {
    "powersgd_error_none": dict(mode="powersgd", error_type="none"),
    "powersgd_local_momentum": dict(mode="powersgd", error_type="local",
                                    local_momentum=0.5),
    "powersgd_rank0": dict(mode="powersgd", error_type="local",
                           powersgd_rank=0),
    "powersgd_rank_above_bound": dict(mode="powersgd", error_type="local",
                                      powersgd_rank=40),
    "dp_sketch_no_noise": dict(mode="dp_sketch", error_type="virtual"),
    "dp_sketch_clip0": dict(mode="dp_sketch", error_type="virtual",
                            dp_noise_mult=1.0, dp_clip=0.0),
    "dp_sketch_delta1": dict(mode="dp_sketch", error_type="virtual",
                             dp_noise_mult=1.0, dp_delta=1.0),
    "dp_sketch_negative_target": dict(mode="dp_sketch",
                                      error_type="virtual",
                                      dp_noise_mult=1.0,
                                      dp_target_epsilon=-1.0),
    "dp_sketch_local_error": dict(mode="dp_sketch", error_type="local",
                                  dp_noise_mult=1.0),
    "dp_sketch_local_momentum": dict(mode="dp_sketch", error_type="virtual",
                                     dp_noise_mult=1.0, local_momentum=0.9),
    "dp_sketch_and_dp": dict(mode="dp_sketch", error_type="virtual",
                             dp_noise_mult=1.0, do_dp=True),
    "dp_sketch_robust": dict(mode="dp_sketch", error_type="virtual",
                             dp_noise_mult=1.0, aggregator="trimmed_mean"),
    "noise_mult_on_sketch": dict(mode="sketch", error_type="virtual",
                                 dp_noise_mult=1.0),
    "target_epsilon_on_uncompressed": dict(mode="uncompressed",
                                           dp_target_epsilon=8.0),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_validate_refusals_match_jax(case):
    kw = {**dict(grad_size=1000, num_workers=8, num_clients=8,
                 local_momentum=0.0, k=4, num_rows=2, num_cols=64),
          **REFUSED[case]}
    with pytest.raises(ValueError) as je:
        JConfig(**kw).validate()
    with pytest.raises(ValueError) as te:
        TConfig(**kw, device="cpu").validate()
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("argv", [
    ["--mode", "powersgd", "--error_type", "local", "--local_momentum",
     "0", "--powersgd_rank", "2"],
    ["--mode", "dp_sketch", "--error_type", "virtual", "--local_momentum",
     "0", "--dp_clip", "1.0", "--dp_noise_mult", "0.5",
     "--dp_target_epsilon", "8", "--dp_delta", "1e-6"],
], ids=["powersgd", "dp_sketch"])
def test_plugin_modes_parse_in_both_packages(argv):
    from commefficient_tpu.config import parse_args as j_parse_args
    from commefficient_tpu_torch.config import parse_args
    t = parse_args(argv=argv + ["--device", "cpu"])
    j = j_parse_args(argv=argv)
    for f in ("mode", "powersgd_rank", "dp_clip", "dp_noise_mult",
              "dp_target_epsilon", "dp_delta"):
        assert getattr(t, f) == getattr(j, f), f
    assert math.isclose(t.dp_delta, j.dp_delta)
