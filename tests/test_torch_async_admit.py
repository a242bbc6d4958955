"""Buffered async admission (ROADMAP item 9e): the port's
AsyncAdmitBuffer against the JAX package's on the same operand stream
(bitwise: the same host merge in the same order), the k = 0 identity
with the synchronous straggler path, the defer/admit twin, resume with
entries pending, `asyb_*` checkpoints cross-loaded both ways, and admitted
rounds of the port against the JAX FedModel.

The round comparison holds the port to the JAX FedModel on a one-device
mesh with its round module's `shard_map` under check_vma=False
(test_torch_faults.py's setup for the straggler program): weights within
1e-5 of their scale, losses within 1e-5 relative or 1e-6 of the round's
largest, billed bytes identical.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.federated import async_agg as jasync
from commefficient_tpu.federated import round as jround
from commefficient_tpu.federated.api import (
    FedModel as JFedModel, FedOptimizer as JFedOptimizer,
)
from commefficient_tpu.parallel.mesh import make_client_mesh
from commefficient_tpu.utils import checkpoint as jckpt
from commefficient_tpu.utils import faults as jfaults
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.federated import async_agg as tasync
from commefficient_tpu_torch.federated.api import (
    FedModel as TFedModel, FedOptimizer as TFedOptimizer,
)
from commefficient_tpu_torch.utils import checkpoint as tckpt
from commefficient_tpu_torch.utils import faults as tfaults

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

D, W, B = 8, 8, 4


def _operand_stream(n, seed):
    """Rounds of (ids, data, mask, survivors, work) as the fault pass
    leaves them: None where nothing drops or slows."""
    rng = np.random.RandomState(seed)
    out = []
    for r in range(n):
        ids = rng.choice(40, W, replace=False).astype(np.int32)
        data = (rng.randn(W, B, 3).astype(np.float32),
                rng.randint(0, 5, size=(W, B)).astype(np.int32))
        mask = (rng.rand(W, B) > 0.2).astype(np.float32)
        surv = (None if r % 3 == 0
                else (rng.rand(W) > 0.25).astype(np.float32))
        work = None
        if r % 4 != 1:
            work = np.where(rng.rand(W) < 0.4,
                            rng.uniform(0.1, 0.99, W), 1.0).astype(
                                np.float32)
            if surv is None:
                surv = np.ones(W, np.float32)
        out.append((ids, data, mask, surv, work))
    return out


def _same(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("delay,decay", [(0, 0.5), (1, 0.5), (2, 0.9),
                                         (3, 1.0)])
def test_compose_matches_jax(delay, decay):
    t, j = tasync.AsyncAdmitBuffer(delay, decay), \
        jasync.AsyncAdmitBuffer(delay, decay)
    for r, ops in enumerate(_operand_stream(14, seed=delay)):
        got = t.compose(r, *ops)
        want = j.compose(r, *ops)
        _same(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            _same(a, b)
        for a, b in zip(got[2:], want[2:]):
            _same(a, b)
        assert t.last_admits == j.last_admits
        # untouched inputs come back as the same objects
        assert (got[0] is ops[0]) == (want[0] is ops[0])
        assert t.pending_count == j.pending_count
        st, sj = t.state_dict(), j.state_dict()
        assert set(st) == set(sj)
        for k in sj:
            np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    assert t.staleness_weight(3) == j.staleness_weight(3)
    with pytest.raises(ValueError):
        tasync.AsyncAdmitBuffer(-1)
    with pytest.raises(ValueError):
        tasync.AsyncAdmitBuffer(1, 0.0)


def test_buffer_round_trips_through_the_other_package():
    t = tasync.AsyncAdmitBuffer(3, 0.5)
    stream = _operand_stream(8, seed=11)
    for r, ops in enumerate(stream[:4]):
        t.compose(r, *ops)
    assert t.pending_count > 0
    j = jasync.AsyncAdmitBuffer(3, 0.5)
    j.load_state_dict(t.state_dict())
    back = tasync.AsyncAdmitBuffer(3, 0.5)
    back.load_state_dict(j.state_dict())
    for r, ops in enumerate(stream[4:], start=4):
        got, want = back.compose(r, *ops), j.compose(r, *ops)
        _same(got[0], want[0])
        for a, b in zip(got[2:], want[2:]):
            _same(a, b)


# ---------------- FedModel rounds ------------------------------------------

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
                   error_type="none", microbatch_size=-1, num_clients=16),
            **kw}


def _t_model(**kw):
    model = TFedModel(Lin(), _t_loss, TConfig(**_kw(**kw), device="cpu"),
                      device="cpu", num_clients=16)
    TFedOptimizer(model).param_groups[0]["lr"] = 0.1
    return model


def _j_model(**kw):
    model = JFedModel(None, _j_loss, JConfig(**_kw(**kw)),
                      params={"w": jnp.zeros(D)}, num_clients=16,
                      mesh=make_client_mesh(1))
    JFedOptimizer(model).param_groups[0]["lr"] = 0.1
    return model


def _rounds(n, seed):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(D).astype(np.float32)
    out = []
    for _ in range(n):
        ids = rng.choice(16, W, replace=False).astype(np.int32)
        x = rng.randn(W, B, D).astype(np.float32)
        out.append((ids, (x, np.einsum("wbd,d->wb", x, w_true).astype(
            np.float32)), np.ones((W, B), np.float32)))
    return out


def _bits(model):
    return [model.ps_weights.clone(), model.server.Vvelocity.clone()]


def test_k0_is_bitwise_the_straggler_path():
    stream = _rounds(6, seed=5)
    sched = tfaults.FaultSchedule(slow={1: {2: 0.5, 5: 0.7}, 3: {0: 0.4}})
    kw = dict(straggler_rate=0.3, straggler_cutoff=0.2)
    plain = _t_model(**kw)
    assert _t_model(**kw, async_admit_rounds=0).async_admit is None
    forced = _t_model(**kw)
    forced.async_admit = tasync.AsyncAdmitBuffer(0, 0.5)
    outs = []
    for model in (plain, forced):
        model.set_fault_schedule(sched)
        outs.append([model(batch)[-1] for batch in stream])
    for a, b in zip(_bits(plain), _bits(forced)):
        assert torch.equal(a, b)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert forced.async_admit.pending_count == 0


def test_defers_then_admits_discounted():
    # k = 1: slot 3 straggles at round 1, is dropped there and lands in
    # round 2 at f x decay (its slot is dropped at 2, so it takes it):
    # bitwise the twin that scripts that schedule synchronously
    f, decay = np.float32(0.6), 0.5
    stream = [_rounds(1, seed=7)[0]] * 4
    model = _t_model(async_admit_rounds=1, async_staleness_decay=decay)
    model.set_fault_schedule(tfaults.FaultSchedule(
        slow={1: {3: float(f)}}, drop_slots={2: [3]}))
    ups = [float(model(b)[-1].sum()) for b in stream]
    twin = _t_model()
    twin.set_fault_schedule(tfaults.FaultSchedule(
        drop_slots={1: [3]}, slow={2: {3: float(f * np.float32(decay))}}))
    t_ups = [float(twin(b)[-1].sum()) for b in stream]
    for a, b in zip(_bits(model), _bits(twin)):
        assert torch.equal(a, b)
    assert ups == t_ups and ups[1] < ups[0] and ups[2] == ups[0]


def test_resume_with_entries_pending_is_bitwise(tmp_path):
    stream = _rounds(6, seed=11)
    kw = dict(async_admit_rounds=2, async_staleness_decay=0.5,
              straggler_rate=0.4, straggler_cutoff=0.1)
    model_a = _t_model(**kw)
    for batch in stream:
        model_a(batch)
    model_b = _t_model(**kw)
    for batch in stream[:2]:
        model_b(batch)
    assert model_b.async_admit.pending_count > 0
    prefix = str(tmp_path / "asyb")
    tckpt.save_rotating(prefix, model_b.server, model_b.clients,
                        prev_change_words=model_b._prev_change_words,
                        accountant=model_b.accountant,
                        fingerprint=model_b.checkpoint_fingerprint,
                        async_admit=model_b.async_admit_state())
    model_c = _t_model(**kw)
    model_c.load_state(tckpt.load_latest(prefix))
    assert (model_c.async_admit.pending_count
            == model_b.async_admit.pending_count)
    for batch in stream[2:]:
        model_c(batch)
    for a, b in zip(_bits(model_a), _bits(model_c)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_asyb_checkpoints_cross_load(tmp_path, direction, monkeypatch):
    monkeypatch.setattr(jround, "shard_map",
                        lambda f, *, mesh, in_specs, out_specs, **kw:
                        jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                                      out_specs=out_specs, check_vma=False))
    kw = dict(async_admit_rounds=2, async_staleness_decay=0.5)
    spec = dict(slow={0: {1: 0.5, 6: 0.3}, 1: {2: 0.8}})
    port = direction == "port_to_jax"
    src = _t_model(**kw) if port else _j_model(**kw)
    src.set_fault_schedule((tfaults if port else jfaults)
                           .FaultSchedule(**spec))
    for batch in _rounds(2, seed=3):
        src(batch)
    assert src.async_admit.pending_count == 3
    save, load = ((tckpt.save_checkpoint, jckpt.load_checkpoint) if port
                  else (jckpt.save_checkpoint, tckpt.load_checkpoint))
    path = save(str(tmp_path / "a"), src.server, src.clients,
                fingerprint=src.checkpoint_fingerprint,
                async_admit=src.async_admit_state())
    dst = _j_model(**kw) if port else _t_model(**kw)
    dst.load_state(load(path))
    want, got = src.async_admit_state(), dst.async_admit_state()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_admitted_rounds_match_jax(monkeypatch):
    monkeypatch.setattr(jround, "shard_map",
                        lambda f, *, mesh, in_specs, out_specs, **kw:
                        jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                                      out_specs=out_specs, check_vma=False))
    kw = dict(async_admit_rounds=2, async_staleness_decay=0.5,
              straggler_rate=0.5, straggler_cutoff=0.2, seed=3)
    t, j = _t_model(**kw), _j_model(**kw)
    t_bytes = j_bytes = 0.0
    for i, batch in enumerate(_rounds(6, seed=13)):
        tl, _, td, tu = t(batch)
        jl, _, jd, ju = j(batch)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tu, ju)
        # a converged client's loss is ~1e-5: 1e-6 of the round's
        # largest loss absolute, beside 1e-5 relative
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-6 * float(np.max(jl)))
        t_bytes += float(tu.sum())
        j_bytes += float(np.sum(ju))
        jw = np.asarray(j.ps_weights)
        np.testing.assert_allclose(t.ps_weights.numpy(), jw, rtol=0,
                                   atol=1e-5 * np.abs(jw).max(),
                                   err_msg=f"round {i}")
        assert t.async_admit.last_admits == j.async_admit.last_admits
    assert t_bytes == j_bytes
    assert t.async_admit.pending_count == j.async_admit.pending_count
