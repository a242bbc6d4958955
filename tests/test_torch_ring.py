"""Ring attention (commefficient_tpu_torch/parallel/ring.py): the
sequence sharded over a ring of CPU ranks (gloo subprocesses running
mh_worker's `ring` scenario), against the port's reference_attention on
the whole sequence and against the JAX ring (commefficient_tpu/parallel/
ring.py) under shard_map on a mesh of as many CPU devices, at JAX's
limits (tests/test_ring.py: rtol 2e-5, atol 2e-6 forward; rtol 2e-4,
atol 2e-5 gradients). The gradients of sum(out ** 2) flow back through
the inverse rotation and are held to autograd of the reference."""
import os

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.ops.attention import reference_attention
from commefficient_tpu_torch.parallel import mh_worker as tmw
from commefficient_tpu_torch.parallel.ring import SeqRing, ring_attention

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5


def _full():
    """RING_SHAPE's q, k, v as every rank of the scenario draws them."""
    rs = np.random.RandomState(0)
    return [rs.randn(*tmw.RING_SHAPE).astype(np.float32) for _ in range(3)]


def _reference(full):
    q, k, v = (torch.tensor(a, requires_grad=True) for a in full)
    out = reference_attention(q, k, v)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


def _jax_ring(full, n, clients=1):
    """The JAX ring on a ("clients", "seq") = (clients, n) CPU mesh, the
    batch split over clients."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from commefficient_tpu.parallel.compat import shard_map
    from commefficient_tpu.parallel.ring import ring_attention as j_ring
    if len(jax.devices()) < n * clients:
        pytest.skip(f"needs {n * clients} CPU devices")
    mesh = Mesh(np.asarray(jax.devices()[:n * clients]).reshape(clients, n),
                axis_names=("clients", "seq"))
    spec = P("clients", None, "seq", None)
    fn = jax.jit(shard_map(lambda q, k, v: j_ring(q, k, v, axis_name="seq"),
                           mesh=mesh, in_specs=(spec,) * 3, out_specs=spec))
    return np.asarray(fn(*full))


def _run_ring(tmp_path, n, rotate, rings=1):
    """The `ring` scenario on n CPU ranks; each rank's arrays."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    port = tmw.free_port()
    out = str(tmp_path / f"ring_{rotate}_{n}_{rings}")
    procs = [tmw.spawn(["--out", out, "--device", "cpu", "--rotate", rotate,
                        "--rings", str(rings),
                        "--process_id", str(i), "--num_processes", str(n),
                        "--port", str(port)], env, "ring")
             for i in range(n)]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(f"{out}.{i}.npz")) for i in range(n)]


@pytest.mark.parametrize("n,rotate", [(2, "p2p"), (2, "broadcast"),
                                      (4, "p2p")],
                         ids=["2-p2p", "2-broadcast", "4-p2p"])
def test_ring_matches_reference_and_jax_ring(tmp_path, n, rotate):
    full = _full()
    ranks = _run_ring(tmp_path, n, rotate)
    out = np.concatenate([r["out"] for r in ranks], axis=2)
    ref, grads = _reference(full)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, _jax_ring(full, n), rtol=RTOL,
                               atol=ATOL)
    # gradients through the inverse rotation
    for name, want in zip(("dq", "dk", "dv"), grads):
        got = np.concatenate([r[name] for r in ranks], axis=2)
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    # n - 1 rotations of k and of v forward, and of their gradients back:
    # one exchange each (p2p) or a broadcast from each rank
    per = 1 if rotate == "p2p" else n
    assert int(ranks[0]["rotations"]) == 4 * (n - 1) * per


def test_two_rings_of_two_match_reference_and_jax_ring(tmp_path):
    # four ranks as two rings, [0, 1] and [2, 3], ring i on batch row i,
    # beside a (2 clients x 2) Layout bound first: every rank builds both
    # rings' groups. Built by each ring alone, the groups of [0, 1] and
    # [2, 3] were one group under two names and the second positions
    # came out wrong
    full = _full()
    ranks = _run_ring(tmp_path, 4, "p2p", rings=2)
    assert [(int(r["ring"]), int(r["position"])) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    rows = [np.concatenate([ranks[2 * i + p]["out"] for p in range(2)],
                           axis=2) for i in range(2)]
    out = np.concatenate(rows, axis=0)
    ref, grads = _reference(full)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, _jax_ring(full, 2, clients=2),
                               rtol=RTOL, atol=ATOL)
    for name, want in zip(("dq", "dk", "dv"), grads):
        got = np.concatenate([np.concatenate(
            [ranks[2 * i + p][name] for p in range(2)], axis=2)
            for i in range(2)], axis=0)
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    # the Layout's clients groups after the rings': each position's
    # outputs gathered over the two rings, in batch order
    for p in range(2):
        for r in (ranks[p], ranks[2 + p]):
            np.testing.assert_array_equal(
                r["out_all"], out[:, :, p * 32:(p + 1) * 32])
    assert all(int(r["rotations"]) == 4 for r in ranks)


def test_ring_of_one_is_causal_attention():
    full = _full()
    q, k, v = (torch.tensor(a, requires_grad=True) for a in full)
    out = ring_attention(q, k, v, None)
    (out ** 2).sum().backward()
    ref, grads = _reference(full)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=RTOL,
                               atol=ATOL)
    for t, want in zip((q, k, v), grads):
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_seq_ring_validates():
    with pytest.raises(ValueError, match="unknown rotate"):
        SeqRing([0, 1], rotate="ring")
    with pytest.raises(ValueError, match="not in the ring"):
        SeqRing([1, 2]).bind(rank=0)
    ring = SeqRing([3, 1]).bind(rank=1)
    assert (ring.size, ring.position, ring.group) == (2, 1, None)
    ring = SeqRing([2, 3]).bind(rank=3, partition=[[0, 1], [2, 3]])
    assert (ring.position, ring.group) == (1, None)
    with pytest.raises(ValueError, match="not a ring of the partition"):
        SeqRing([0, 1]).bind(rank=0, partition=[[0, 2], [1, 3]])
    with pytest.raises(ValueError, match="overlap"):
        SeqRing([0, 1]).bind(rank=0, partition=[[0, 1], [1, 2]])


def test_seq_ring_refuses_a_partial_world(monkeypatch):
    # a ring narrower than the world with no partition would build a
    # group only some ranks took part in
    from commefficient_tpu_torch.parallel import multihost as mh
    monkeypatch.setattr(mh, "is_distributed", lambda: True)
    monkeypatch.setattr(mh, "process_count", lambda: 4)
    with pytest.raises(ValueError, match="do not partition the world"):
        SeqRing([0, 1]).bind(rank=0)
    with pytest.raises(ValueError, match="do not partition the world"):
        SeqRing([0, 1]).bind(rank=1, partition=[[0, 1], [2]])
