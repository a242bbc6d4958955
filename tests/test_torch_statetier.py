"""Tiered client state (ROADMAP item 9e): the port's TieredStateStore.
The cases of the JAX package's tests/test_statetier.py that do not walk
jaxprs, on the port: --state_tier host bitwise --state_tier device per
round, spanned and pipelined; the disk tail; resume with rows hot,
spilled and mid-spill, the eviction stream replayed; an injected crash;
checkpoints across tiers, across packages (crows_lru_* keys both ways)
and from dense blocks; the prefetch neutral; the journal's state_tier
events; a corrupt tail row quarantined; the config refusals word for
word. Every comparison is bitwise.
"""
import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.federated.api import FedModel as JFedModel
from commefficient_tpu.federated.api import FedOptimizer as JFedOptimizer
from commefficient_tpu.parallel.mesh import make_client_mesh
from commefficient_tpu.telemetry.journal import summarize, validate_journal
from commefficient_tpu.utils import checkpoint as jckpt
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.federated.api import FedModel, FedOptimizer
from commefficient_tpu_torch.telemetry import RunJournal, TelemetrySession
from commefficient_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from commefficient_tpu_torch.utils.faults import FaultSchedule, InjectedFault

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

D, W, B, POP = 16, 8, 4, 64


class Lin(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(D))


def _loss(params, batch, mask):
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
    # local_topk with all three blocks live: error, velocity, stale weights
    return {**dict(mode="local_topk", error_type="local",
                   local_momentum=0.9, do_topk_down=True, k=8, down_k=16,
                   weight_decay=0.0, num_workers=W, microbatch_size=-1,
                   grad_size=D, seed=0, num_clients=POP), **kw}


def _cfg(**kw):
    return Config(**_kw(**kw), device="cpu").validate()


def _model(**kw):
    model = FedModel(Lin(), _loss, _cfg(**kw), device="cpu",
                     num_clients=POP)
    FedOptimizer(model).param_groups[0]["lr"] = 0.1
    return model


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(W, B, D).astype(np.float32),
            rng.randn(W, B).astype(np.float32),
            np.ones((W, B), np.float32))


def _ids_stream(rounds, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.choice(POP, W, replace=False).astype(np.int32)
            for _ in range(rounds)]


def _full_rows(model):
    """[POP, D] a tracked block: the device tier's blocks, or init plus
    the tiered model's crows payload."""
    if model.state_store is None:
        return {n: getattr(model.clients, n).numpy()[:POP]
                for n in ("errors", "velocities", "weights")}
    payload = model.client_rows_payload()
    out = {}
    for name in ("errors", "velocities", "weights"):
        full = (np.broadcast_to(payload["base_weights"], (POP, D)).copy()
                if name == "weights" else np.zeros((POP, D), np.float32))
        if len(payload["ids"]):
            full[payload["ids"]] = payload[name]
        out[name] = full
    return out


def _assert_same_state(a, b):
    np.testing.assert_array_equal(a.ps_weights.numpy(), b.ps_weights.numpy())
    ra, rb = _full_rows(a), _full_rows(b)
    for name in ra:
        np.testing.assert_array_equal(ra[name], rb[name], err_msg=name)


def _drive(model, ids_all, start=0, seed=2):
    x, y, mask = _problem(seed=seed)
    for ids in ids_all[start:]:
        model((ids, (x, y), mask))


def _span(model, ids_rows, x, y, mask):
    n = len(ids_rows)
    model.run_rounds(np.stack(ids_rows),
                     (np.broadcast_to(x, (n,) + x.shape),
                      np.broadcast_to(y, (n,) + y.shape)),
                     np.broadcast_to(mask, (n,) + mask.shape),
                     [0.1] * n)


# ---------------- tier identity -------------------------------------------

def test_host_tier_is_bitwise_device_tier_per_round():
    x, y, mask = _problem()
    dev = _model()
    host = _model(state_tier="host", state_working_set=16)
    assert host.clients.errors.shape == (16, D)
    for ids in _ids_stream(10):
        dev((ids, (x, y), mask))
        host((ids, (x, y), mask))
    assert host.state_store.spills > 0, "working set never spilled"
    _assert_same_state(dev, host)
    host.close_persistence()


def test_host_tier_is_bitwise_device_tier_spanned():
    x, y, mask = _problem(seed=5)
    dev = _model()
    host = _model(state_tier="host", state_working_set=24)
    ids_all = _ids_stream(9, seed=7)
    for lo in range(0, 9, 3):
        _span(dev, ids_all[lo:lo + 3], x, y, mask)
        _span(host, ids_all[lo:lo + 3], x, y, mask)
    assert host.state_store.spills > 0
    _assert_same_state(dev, host)
    host.close_persistence()


def test_disk_spill_dir_backs_the_tail(tmp_path):
    x, y, mask = _problem()
    dev = _model()
    disk = _model(state_tier="host", state_working_set=16,
                  state_spill_dir=str(tmp_path / "tail"))
    for ids in _ids_stream(8):
        dev((ids, (x, y), mask))
        disk((ids, (x, y), mask))
    disk.state_store.flush()
    assert disk.state_store.spills > 0
    for name in ("errors", "velocities", "weights"):
        assert (tmp_path / "tail" / f"tail_{name}.npy").exists()
    _assert_same_state(dev, disk)
    disk.close_persistence()


def test_default_tier_builds_no_store():
    dev = _model()
    assert dev.state_store is None
    assert dev.clients.errors.shape[0] == POP
    # a stateless config under the host tier has nothing to store
    stateless = FedModel(Lin(), _loss, _cfg(
        mode="uncompressed", error_type="none", local_momentum=0.0,
        do_topk_down=False, state_tier="host", state_working_set=8),
        device="cpu", num_clients=POP)
    assert stateless.state_store is None


def test_working_set_too_small_for_span_raises_as_jax():
    host = _model(state_tier="host", state_working_set=8)
    x, y, mask = _problem()
    ids = [np.arange(W, dtype=np.int32), np.arange(W, 2 * W, dtype=np.int32)]
    with pytest.raises(ValueError) as e:
        _span(host, ids, x, y, mask)
    assert str(e.value) == (
        "state_working_set=8 (8 slots) cannot hold the 16 distinct "
        "clients this round/span needs resident at once — raise "
        "--state_working_set or (scanned path) lower --scan_span")
    host.close_persistence()


@pytest.mark.parametrize("kw", [
    dict(state_tier="host"),
    dict(state_tier="host", state_working_set=4),
    dict(state_spill_dir="/tmp/x"),
    dict(state_tier="hbm"),
    dict(state_working_set=16),
    dict(state_tier="host", state_working_set=16, multihost=True),
    dict(state_working_set=-1),
    dict(async_admit_rounds=-1),
    dict(async_staleness_decay=0.0),
    dict(async_admit_rounds=1, multihost=True),
    dict(sampler="fastest"),
    dict(explore_floor=1.5),
    dict(deadline_quantile=1.5),
    dict(deadline_min_work=0.0),
    dict(target_survivors=-1),
    dict(target_survivors=9),
    dict(sampler="throughput", telemetry=False),
    dict(deadline_quantile=0.5, telemetry=False),
    dict(target_survivors=2, multihost=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_config_refusals_are_jax_word_for_word(kw):
    with pytest.raises(ValueError) as mine:
        Config(**_kw(**kw), device="cpu").validate()
    with pytest.raises(ValueError) as theirs:
        JConfig(**_kw(**kw)).validate()
    assert str(mine.value) == str(theirs.value)


# ---------------- crash -> resume -----------------------------------------

def _save(model, path):
    return save_checkpoint(path, model.server, model.clients,
                           fingerprint=model.checkpoint_fingerprint,
                           throughput=model.throughput.state_dict(),
                           client_rows=model.client_rows_payload())


def test_resume_bitwise_with_rows_hot_spilled_and_mid_spill(tmp_path):
    ids_all = _ids_stream(12, seed=17)
    a = _model(state_tier="host", state_working_set=16)
    _drive(a, ids_all)
    b = _model(state_tier="host", state_working_set=16)
    _drive(b, ids_all[:6])
    # stall the spill writer: the payload must drain the queue first
    gate = threading.Event()
    b.state_store._writer.submit(lambda: gate.wait(timeout=10) or None)
    released = [False]

    def release():
        time.sleep(0.05)
        released[0] = True
        gate.set()
    threading.Thread(target=release, daemon=True).start()
    path = _save(b, str(tmp_path / "tier.npz"))
    assert released[0], "the payload did not wait for the queue"
    z = np.load(path)
    assert "crows_lru_ids" in z.files and "crows_lru_slots" in z.files
    c = _model(state_tier="host", state_working_set=16)
    c.load_state(load_checkpoint(path,
                                 expect_fingerprint=c.checkpoint_fingerprint))
    for k in ("lru_ids", "lru_slots"):
        np.testing.assert_array_equal(b.state_store.snapshot_tier()[k],
                                      c.state_store.snapshot_tier()[k])
    _drive(c, ids_all, start=6)
    _assert_same_state(a, c)
    for m in (a, b, c):
        m.close_persistence()


def test_resume_replays_the_eviction_stream(tmp_path):
    ids_all = _ids_stream(12, seed=19)
    a = _model(state_tier="host", state_working_set=16)
    _drive(a, ids_all[:6])
    s = a.state_store
    mid = (s.hits, s.misses, s.spills)
    path = _save(a, str(tmp_path / "lru.npz"))
    _drive(a, ids_all, start=6)
    tail = (s.hits - mid[0], s.misses - mid[1], s.spills - mid[2])
    c = _model(state_tier="host", state_working_set=16)
    c.load_state(load_checkpoint(path))
    _drive(c, ids_all, start=6)
    assert (c.state_store.hits, c.state_store.misses,
            c.state_store.spills) == tail
    np.testing.assert_array_equal(s.snapshot_tier()["lru_ids"],
                                  c.state_store.snapshot_tier()["lru_ids"])
    for m in (a, c):
        m.close_persistence()


def test_injected_crash_then_resume_is_bitwise(tmp_path):
    ids_all = _ids_stream(10, seed=23)
    a = _model(state_tier="host", state_working_set=16)
    _drive(a, ids_all)
    b = _model(state_tier="host", state_working_set=16)
    b.set_fault_schedule(FaultSchedule(crash_after=4))
    with pytest.raises(InjectedFault):
        _drive(b, ids_all)
    b.set_fault_schedule(None)
    path = _save(b, str(tmp_path / "crash.npz"))
    c = _model(state_tier="host", state_working_set=16)
    c.load_state(load_checkpoint(path))
    _drive(c, ids_all, start=5)
    _assert_same_state(a, c)
    for m in (a, b, c):
        m.close_persistence()


def test_cross_tier_checkpoints_interchange(tmp_path):
    ids_all = _ids_stream(10, seed=29)
    dev = _model()
    _drive(dev, ids_all[:5])
    dev_path = _save(dev, str(tmp_path / "dev.npz"))
    host = _model(state_tier="host", state_working_set=16)
    _drive(host, ids_all[:5])
    host_path = _save(host, str(tmp_path / "host.npz"))
    h2 = _model(state_tier="host", state_working_set=16)
    h2.load_state(load_checkpoint(dev_path))
    d2 = _model()
    d2.load_state(load_checkpoint(host_path))
    for m in (dev, host, h2, d2):
        _drive(m, ids_all, start=5)
    _assert_same_state(dev, h2)
    _assert_same_state(dev, d2)
    _assert_same_state(dev, host)
    for m in (host, h2):
        m.close_persistence()


def test_dense_checkpoint_into_host_tier(tmp_path):
    ids_all = _ids_stream(8, seed=31)
    dev = _model()
    _drive(dev, ids_all[:4])
    path = save_checkpoint(str(tmp_path / "dense.npz"), dev.server,
                           dev.clients,
                           fingerprint=dev.checkpoint_fingerprint)
    assert "client_errors" in np.load(path).files
    host = _model(state_tier="host", state_working_set=16)
    host.load_state(load_checkpoint(path))
    assert host.client_rows_payload() is not None
    _drive(dev, ids_all, start=4)
    _drive(host, ids_all, start=4)
    _assert_same_state(dev, host)
    host.close_persistence()


def _j_model(**kw):
    model = JFedModel(None, _j_loss, JConfig(**_kw(**kw)),
                      params={"w": jnp.zeros(D, jnp.float32)},
                      num_clients=POP, mesh=make_client_mesh(1))
    JFedOptimizer(model).param_groups[0]["lr"] = 0.1
    return model


@pytest.mark.parametrize("src_tier,dst_tier", [("host", "host"),
                                               ("host", "device"),
                                               ("device", "host")])
def test_crows_checkpoints_cross_load_with_jax(tmp_path, src_tier,
                                               dst_tier):
    """A port checkpoint loads into the JAX FedModel and back: the rows,
    the LRU order and the slot map come back as written."""
    tier = lambda t: (dict(state_tier="host", state_working_set=16)  # noqa
                      if t == "host" else {})
    port = _model(**tier(src_tier))
    _drive(port, _ids_stream(6, seed=37))
    path = _save(port, str(tmp_path / "p.npz"))
    jm = _j_model(**tier(dst_tier))
    jm.load_state(jckpt.load_checkpoint(
        path, expect_fingerprint=jm.checkpoint_fingerprint))
    jpath = jckpt.save_checkpoint(
        str(tmp_path / "j.npz"), jm.server, jm.clients,
        fingerprint=jm.checkpoint_fingerprint,
        client_rows=jm.client_rows_payload())
    back = _model(**tier(src_tier))
    back.load_state(load_checkpoint(jpath))
    np.testing.assert_array_equal(back.ps_weights.numpy(),
                                  port.ps_weights.numpy())
    ra, rb = _full_rows(port), _full_rows(back)
    for name in ra:
        np.testing.assert_array_equal(ra[name], rb[name], err_msg=name)
    if src_tier == dst_tier == "host":
        za, zb = np.load(path), np.load(jpath)
        for k in ("crows_lru_ids", "crows_lru_slots", "crows_ids"):
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
        for k in ("lru_ids", "lru_slots"):
            np.testing.assert_array_equal(
                back.state_store.snapshot_tier()[k],
                port.state_store.snapshot_tier()[k])
    for m in (port, back):
        m.close_persistence()
    if jm.state_store is not None:
        jm.close_persistence()


# ---------------- the prefetch, the journal, the checks --------------------

def test_prefetch_is_lru_neutral_and_bitwise_neutral():
    x, y, mask = _problem()
    plain = _model(state_tier="host", state_working_set=16)
    warm = _model(state_tier="host", state_working_set=16)
    ids_all = _ids_stream(10, seed=47)
    for r, ids in enumerate(ids_all):
        if r + 1 < len(ids_all):
            warm.state_store.flush()
            warm.state_store.prefetch_host_rows(ids_all[r + 1])
        plain((ids, (x, y), mask))
        warm((ids, (x, y), mask))
    s, t = plain.state_store, warm.state_store
    assert (s.hits, s.misses, s.spills) == (t.hits, t.misses, t.spills)
    _assert_same_state(plain, warm)
    for m in (plain, warm):
        m.close_persistence()


def test_concurrent_prefetch_under_stress_is_bitwise():
    """The spill writer and prefetching threads (more than the cores)
    share the store's tail, pending spills and warm rows with the round
    loop; under a 1 us switch interval the rows stay bitwise the device
    tier's."""
    import sys
    x, y, mask = _problem()
    dev = _model()
    host = _model(state_tier="host", state_working_set=W)
    ids_all = _ids_stream(30, seed=53)
    stop = threading.Event()

    def hammer(seed):
        rng = np.random.RandomState(seed)
        while not stop.is_set():
            host.state_store.prefetch_host_rows(rng.choice(POP, W))

    threads = [threading.Thread(target=hammer, args=(i,), daemon=True)
               for i in range((os.cpu_count() or 1) + 2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for ids in ids_all:
            dev((ids, (x, y), mask))
            host((ids, (x, y), mask))
    finally:
        stop.set()
        sys.setswitchinterval(interval)
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert host.state_store.spills > 100
    _assert_same_state(dev, host)
    host.close_persistence()


def test_state_tier_journal_events_validate(tmp_path):
    jpath = str(tmp_path / "journal.jsonl")
    host = _model(state_tier="host", state_working_set=16)
    tele = TelemetrySession(journal=RunJournal(jpath, run_id="t"))
    host.attach_telemetry(tele)
    _drive(host, _ids_stream(8, seed=41))
    tele.close(ok=True)
    records, problems = validate_journal(jpath)
    assert problems == []
    tier = [r for r in records if r["event"] == "state_tier"]
    assert len(tier) == 8 and sum(r["spills"] for r in tier) > 0
    assert all(r["working_set"] == 16 for r in tier)
    summary = summarize(records)
    assert 0.0 <= summary["state_hit_rate"] <= 1.0
    assert summary["state_spills"] > 0
    host.close_persistence()


def test_corrupt_tail_row_is_quarantined(tmp_path):
    jpath = str(tmp_path / "q.jsonl")
    host = _model(state_tier="host", state_working_set=8)
    tele = TelemetrySession(journal=RunJournal(jpath, run_id="q"))
    host.attach_telemetry(tele)
    ids_all = [np.arange(W, dtype=np.int32),
               np.arange(W, 2 * W, dtype=np.int32),
               np.arange(W, dtype=np.int32)]
    x, y, mask = _problem()
    host((ids_all[0], (x, y), mask))
    host((ids_all[1], (x, y), mask))
    store = host.state_store
    store.flush()
    # flip a byte of client 3's spilled error row
    store._tail._tables["errors"][store._tail._rowmap[3]][0] += 1.0
    host((ids_all[2], (x, y), mask))
    tele.close(ok=True)
    records, problems = validate_journal(jpath)
    assert problems == []
    q = [r for r in records if r["event"] == "state_quarantine"]
    assert [(r["client"], r["field"]) for r in q] == [(3, "errors")]
    assert store.quarantines == 1
    host.close_persistence()


def test_spill_writer_failure_reraises_on_the_loop():
    host = _model(state_tier="host", state_working_set=8)
    x, y, mask = _problem()
    host((np.arange(W, dtype=np.int32), (x, y), mask))

    def broken(*a, **k):
        raise OSError("tail write failed")
    host.state_store._tail.put = broken
    host((np.arange(W, 2 * W, dtype=np.int32), (x, y), mask))
    with pytest.raises(OSError, match="tail write failed"):
        host.drain_persistence()


def test_pipelined_tiered_span_loop_is_bitwise_and_resumes(tmp_path):
    from commefficient_tpu_torch.training.scanloop import (
        make_span_checkpoint, run_scanned_rounds,
    )
    from commefficient_tpu_torch.utils.schedules import LambdaLR

    x, y, mask = _problem(seed=43)
    ids_all = _ids_stream(8, seed=43)
    stream = [(r, ids_all[r], (x, y), mask, 0.1) for r in range(8)]

    def run(pipeline, workdir):
        model = _model(state_tier="host", state_working_set=24,
                       checkpoint_every=1, ckpt_every_spans=2,
                       pipeline=pipeline)
        sch = LambdaLR(model._optimizer, lr_lambda=lambda s: 1.0)
        model._optimizer.param_groups[0]["lr"] = 0.1
        hook = make_span_checkpoint(os.path.join(workdir, "ck"), model,
                                    model.cfg, sch)
        assert run_scanned_rounds(model, iter(stream), 2, lambda *a: True,
                                  checkpoint=hook, pipeline=pipeline)
        model.drain_persistence()
        return model

    sync = run(False, str(tmp_path / "s"))
    pipe = run(True, str(tmp_path / "p"))
    plain = _model()
    _drive(plain, ids_all, seed=43)
    assert pipe.state_store.spills > 0
    _assert_same_state(sync, pipe)
    _assert_same_state(plain, pipe)
    mid = os.path.join(str(tmp_path / "p"), "ck-r00000004.npz")
    ckpt = load_checkpoint(mid)
    assert ckpt.client_rows is not None and "lru_ids" in ckpt.client_rows
    resumed = _model(state_tier="host", state_working_set=24)
    resumed.load_state(ckpt)
    first = int(ckpt.server.round_idx)
    assert first == 4
    for lo in range(first, 8, 2):
        _span(resumed, ids_all[lo:lo + 2], x, y, mask)
    _assert_same_state(sync, resumed)
    for m in (sync, pipe, resumed):
        m.close_persistence()


def test_cv_train_host_tier_matches_device_tier(tmp_path):
    from commefficient_tpu_torch.config import parse_args
    from commefficient_tpu_torch.training import cv_train
    finals = []
    for extra in ([], ["--state_tier", "host", "--state_working_set", "4"],
                  ["--state_tier", "host", "--state_working_set", "8",
                   "--scan_rounds", "--scan_span", "2", "--pipeline",
                   "--state_spill_dir", str(tmp_path / "tail")]):
        cfg = parse_args(argv=[
            "--test", "--device", "cpu", "--mode", "local_topk",
            "--error_type", "local", "--local_momentum", "0.9",
            "--num_workers", "4", "--num_epochs", "0.25", "--dataset_dir",
            str(tmp_path / "data"), "--no_telemetry"] + extra)
        model, opt, sched, loader, val = cv_train.build(
            cfg, device="cpu", synthetic_examples=(160, 32))
        assert cv_train.train(model, opt, sched, loader, val, model.cfg)
        model.close_persistence()
        rows = model.client_rows_payload()
        full = np.zeros((model.num_clients, model.cfg.grad_size), np.float32)
        full[rows["ids"]] = rows["errors"]
        finals.append((model.ps_weights.clone(), full))
    for w, rows in finals[1:]:
        assert torch.equal(w, finals[0][0])
        np.testing.assert_array_equal(rows, finals[0][1])


def test_journal_records_are_json(tmp_path):
    """The store's journal fields serialize (ints, not numpy scalars)."""
    host = _model(state_tier="host", state_working_set=16)
    _drive(host, _ids_stream(3, seed=2))
    json.dumps(host.state_store.take_journal_fields())
    host.close_persistence()
