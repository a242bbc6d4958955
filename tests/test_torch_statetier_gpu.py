"""The tiered client state on a CUDA card: spills through pinned host
memory and restores from it are bitwise, on the per-round path, the
pipelined span loop and the disk tail; a failing spill writer re-raises
on the round loop; a scheduled run on the card equals its plan. The
cases carry the `gpu` marker and skip without a card; on the card:
`python -m pytest tests/test_torch_statetier_gpu.py -m gpu --noconftest`
(this file imports no jax; tests/conftest.py does)."""
import numpy as np
import pytest
import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.federated.api import FedModel, FedOptimizer
from commefficient_tpu_torch.scheduler import RoundScheduler

pytestmark = pytest.mark.torch_port

D, W, B, POP = 4096, 8, 4, 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (spills and restores through pinned "
                    "memory; the CPU cases are tests/test_torch_statetier"
                    ".py)")
    return torch.device("cuda")


class Lin(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(D))


def _loss(params, batch, mask):
    x, y = batch
    per_ex = 0.5 * (x @ params["w"] - y) ** 2
    loss = (per_ex * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, (loss,)


def _model(device, **kw):
    cfg = Config(**{**dict(
        mode="local_topk", error_type="local", local_momentum=0.9,
        do_topk_down=True, k=64, down_k=128, weight_decay=0.0,
        num_workers=W, microbatch_size=-1, grad_size=D, seed=0,
        num_clients=POP, device=device.type), **kw})
    model = FedModel(Lin(), _loss, cfg, device=device, num_clients=POP)
    FedOptimizer(model).param_groups[0]["lr"] = 0.1
    return model


def _stream(rounds, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(W, B, D).astype(np.float32)
    y = rng.randn(W, B).astype(np.float32)
    ids = [rng.choice(POP, W, replace=False).astype(np.int32)
           for _ in range(rounds)]
    return ids, x, y, np.ones((W, B), np.float32)


def _full_rows(model):
    if model.state_store is None:
        return {f: getattr(model.clients, f).cpu().numpy()
                for f in ("errors", "velocities", "weights")}
    p = model.client_rows_payload()
    out = {}
    for f in ("errors", "velocities", "weights"):
        full = (np.broadcast_to(p["base_weights"], (POP, D)).copy()
                if f == "weights" else np.zeros((POP, D), np.float32))
        full[p["ids"]] = p[f]
        out[f] = full
    return out


def _assert_same(a, b):
    assert torch.equal(a.ps_weights.cpu(), b.ps_weights.cpu())
    ra, rb = _full_rows(a), _full_rows(b)
    for f in ra:
        np.testing.assert_array_equal(ra[f], rb[f], err_msg=f)


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.gpu
def test_pinned_spill_and_restore_are_bitwise_on_the_card(
        cuda_device, deterministic, tmp_path):
    ids_all, x, y, mask = _stream(12)
    dev = _model(cuda_device)
    host = _model(cuda_device, state_tier="host", state_working_set=16)
    disk = _model(cuda_device, state_tier="host", state_working_set=16,
                  state_spill_dir=str(tmp_path / "tail"))
    assert host.state_store._pin and host.state_store._tail._keep == {}
    for ids in ids_all:
        for m in (dev, host, disk):
            m((ids, (x, y), mask))
    assert host.state_store.spills > 0
    assert all(t.is_pinned() for t in host.state_store._tail._keep.values())
    _assert_same(dev, host)
    _assert_same(dev, disk)
    for m in (host, disk):
        m.close_persistence()


@pytest.mark.gpu
def test_pipelined_tiered_spans_on_the_card_are_bitwise(cuda_device,
                                                        deterministic):
    from commefficient_tpu_torch.training.scanloop import run_scanned_rounds
    ids_all, x, y, mask = _stream(8, seed=5)
    stream = [(r, ids_all[r], (x, y), mask, 0.1) for r in range(8)]
    dev = _model(cuda_device)
    for ids in ids_all:
        dev((ids, (x, y), mask))
    pipe = _model(cuda_device, state_tier="host", state_working_set=24,
                  pipeline=True)
    assert run_scanned_rounds(pipe, iter(stream), 2, lambda *a: True,
                              pipeline=True)
    pipe.drain_persistence()
    assert pipe.state_store.spills > 0
    _assert_same(dev, pipe)
    pipe.close_persistence()


@pytest.mark.gpu
def test_spill_writer_failure_reraises_on_the_loop(cuda_device):
    ids_all, x, y, mask = _stream(3)
    host = _model(cuda_device, state_tier="host", state_working_set=8)
    host((np.arange(W, dtype=np.int32), (x, y), mask))

    def broken(*a, **k):
        raise OSError("tail write failed")
    host.state_store._tail.put = broken
    host((np.arange(W, 2 * W, dtype=np.int32), (x, y), mask))
    with pytest.raises(OSError, match="tail write failed"):
        host.drain_persistence()


@pytest.mark.gpu
def test_scheduled_idle_slot_is_a_dropped_client_on_the_card(cuda_device):
    from commefficient_tpu_torch.utils.faults import FaultSchedule
    ids_all, x, y, mask = _stream(1)
    sched_model = _model(cuda_device, mode="uncompressed",
                         error_type="none", local_momentum=0.0,
                         do_topk_down=False, target_survivors=5)
    sched = RoundScheduler(sched_model.cfg, POP, sched_model.throughput)
    sched_model.attach_scheduler(sched)
    sched.begin_epoch(0)
    rng = np.random.RandomState(0)
    chosen = sched.select(np.arange(POP), W, rng)
    assert len(chosen) == 5
    pad = np.setdiff1d(np.arange(POP), chosen)[:W - 5]
    slots = np.concatenate([chosen, pad]).astype(np.int32)
    active = (np.arange(W) < 5).astype(np.float32)
    sched.commit_round(slots, active * B)
    m = mask * active[:, None]
    out_s = sched_model((slots, (x, y), m))
    ref = _model(cuda_device, mode="uncompressed", error_type="none",
                 local_momentum=0.0, do_topk_down=False)
    ref.set_fault_schedule(FaultSchedule(drop_slots={0: [5, 6, 7]}))
    out_r = ref((slots, (x, y), m))
    assert torch.equal(sched_model.ps_weights, ref.ps_weights)
    np.testing.assert_array_equal(out_s[-1], out_r[-1])
    assert (out_s[-1][5:] == 0).all()
