"""The port's multi-rank runtime (commefficient_tpu_torch/parallel/
multihost.py, mh_worker.py): the single-process functions and the
loaders' feed slices (tests/test_multihost.py:21-113 on the port), the
rendezvous's retry guard, and real grids of ranks as CPU subprocesses
over gloo:

  * the `base` scenario (sketch rounds with --topk_down, so the client
    rows are sharded by rank and the checkpoint gathers them in chunks;
    a span; an eval; the byte accounting) on 2 ranks, against the port's
    single process within the worker's RTOL, ATOL and against the JAX
    FedModel on make_client_mesh(2) in this process within the same
    limits; every rank's weights bitwise equal;
  * `noncontig` on 4 ranks under the --num_slices 2 emulation (ranks at
    positions [0, 2, 1, 3]) within rtol 1e-6 of the flat 4-rank layout
    (tests/test_mesh.py:68-98: placement changes only the reduce's
    order);
  * cv_train's --multihost driver on 2 ranks;
  * --sampler throughput --plan_transport collective on 2 ranks (the
    mh_worker `plan` scenario and cv_train's driver): weights bitwise
    equal, every round's digests cross-checked and journaled, and an
    injected divergence on rank 1 raising PlanDigestError on both;
  * the round's other families on 2 ranks against the one process (the
    screened family's cohort statistics, the robust aggregators, the
    per-client rows under dropout, --dp, dp_sketch), and the int8 wire,
    which each rank rounds on its block's table as the JAX engine rounds
    each shard's, against the JAX FedModel on make_client_mesh(2).
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.parallel import mh_worker as tmw
from commefficient_tpu_torch.parallel import multihost as tmh
from commefficient_tpu_torch.parallel.plantransport import PLAN_MAX_BYTES

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# single-process pieces


def test_single_process_is_the_coordinator():
    assert tmh.process_count() == 1 and tmh.process_index() == 0
    assert tmh.is_coordinator() and not tmh.is_multihost()
    tmh.sync_processes("nothing to wait for")


def test_local_row_slice_without_a_layout():
    assert tmh.local_row_slice(None, 8) == slice(0, 8)
    assert tmh.local_row_slice(None, 16) == slice(0, 16)


def test_gather_host_is_a_host_copy():
    x = np.arange(4.0)
    np.testing.assert_array_equal(tmh.gather_host(x), x)
    np.testing.assert_array_equal(tmh.gather_host(torch.arange(4.0)), x)


def test_rank_device_rule():
    assert tmh.rank_device("cpu", 3).type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tmh.rank_device("cuda", 0)
    assert tmh.resolve_backend(None, "cpu") == "gloo"
    assert tmh.resolve_backend(None, "cuda") == "nccl"
    assert tmh.resolve_backend("gloo", "cuda") == "gloo"


def test_initialize_takes_the_given_backend_and_never_falls_back(
        monkeypatch):
    """The backend is the caller's, else the device's (gloo on the CPU);
    an init that the backend refuses raises as it is, and is never tried
    again on another backend."""
    import torch.distributed as dist
    calls, up = [], [False]

    def init(backend, **kw):
        calls.append(backend)
        if backend == "nccl":
            raise RuntimeError("Duplicate GPU detected : rank 1 and rank 0 "
                               "both on CUDA device 0")
        up[0] = True

    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(dist, "is_initialized", lambda: up[0])
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(tmh, "_initialized", False)
    with pytest.raises(RuntimeError, match="Duplicate GPU"):
        tmh.initialize("127.0.0.1:1", 2, 1, backend="nccl", device="cpu",
                       retry_sleep=lambda s: None)
    assert calls == ["nccl"]
    tmh.initialize("127.0.0.1:1", 2, 1, device="cpu",
                   retry_sleep=lambda s: None)
    assert calls == ["nccl", "gloo"]
    monkeypatch.setattr(tmh, "_initialized", False)


def test_initialize_retries_transient_and_rebuilds(monkeypatch):
    """A transient rendezvous failure is retried after the half-built
    group is torn down; a fatal one raises at once; a second call is a
    no-op."""
    import torch.distributed as dist
    calls, destroyed, up = [], [], [False]

    def init(backend, **kw):
        calls.append((backend, kw["world_size"], kw["rank"],
                      kw["init_method"]))
        up[0] = True
        if len(calls) < 3:
            raise RuntimeError("connect() timed out: connection refused")

    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(dist, "is_initialized", lambda: up[0])
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: (destroyed.append(1), up.__setitem__(0,
                                                                     False)))
    monkeypatch.setattr(tmh, "_initialized", False)
    tmh.initialize("127.0.0.1:1", 2, 1, backend="gloo", device="cpu",
                   retry_sleep=lambda s: None)
    assert len(calls) == 3 and len(destroyed) == 2
    assert calls[0] == ("gloo", 2, 1, "tcp://127.0.0.1:1")
    tmh.initialize("127.0.0.1:1", 2, 1, backend="gloo", device="cpu")
    assert len(calls) == 3          # idempotent

    def fatal(backend, **kw):
        calls.append(backend)
        raise ValueError("world_size must be positive")

    monkeypatch.setattr(dist, "init_process_group", fatal)
    monkeypatch.setattr(tmh, "_initialized", False)
    with pytest.raises(ValueError, match="world_size"):
        tmh.initialize("127.0.0.1:1", 2, 1, backend="gloo", device="cpu",
                       retry_sleep=lambda s: None)
    assert len(calls) == 4          # no retry of a fatal error
    monkeypatch.setattr(tmh, "_initialized", False)


def test_initialize_needs_the_grid():
    with pytest.raises(ValueError, match="coordinator_address"):
        tmh.initialize(None, 2, 0, device="cpu")


def test_rendezvous_triage():
    import torch.distributed as dist
    from commefficient_tpu_torch.utils.faults import InjectedFault
    from commefficient_tpu_torch.utils.retry import is_rendezvous_transient
    assert is_rendezvous_transient(ConnectionRefusedError("x"))
    assert is_rendezvous_transient(RuntimeError("Socket Timed out"))
    assert is_rendezvous_transient(dist.DistNetworkError("store"))
    assert not is_rendezvous_transient(ValueError("bad rank"))
    assert not is_rendezvous_transient(InjectedFault(3))


def test_concurrent_writers_of_one_file_never_share_a_temporary(
        tmp_path, monkeypatch):
    """The ranks of a grid prepare one dataset cache at once: each
    atomic write goes through a temporary named for its process, so
    one rank never renames another's half-written file (a shared
    `<path>.tmp` raced: FileNotFoundError on the second os.replace)."""
    from commefficient_tpu_torch.utils import atomic_io
    renamed = []
    real = os.replace
    monkeypatch.setattr(atomic_io.os, "replace",
                        lambda a, b: (renamed.append(a), real(a, b)))
    path = str(tmp_path / "val.npz")
    atomic_io.atomic_savez(path, x=np.arange(3))
    atomic_io.atomic_write_text(str(tmp_path / "stats.json"), "{}")
    assert all(f".{os.getpid()}.tmp" in a for a in renamed)
    np.testing.assert_array_equal(np.load(path)["x"], np.arange(3))
    code = ("import sys, numpy as np; sys.path.insert(0, %r)\n"
            "from commefficient_tpu_torch.utils.atomic_io import "
            "atomic_savez\n"
            "for _ in range(200): atomic_savez(%r, x=np.arange(1000))"
            % (REPO, path))
    procs = [subprocess.Popen([sys.executable, "-c", code])
             for _ in range(3)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0, 0]
    np.testing.assert_array_equal(np.load(path)["x"], np.arange(1000))


# ---------------------------------------------------------------------------
# per-rank feeding through the data stack


@pytest.fixture(scope="module")
def synth_ds(tmp_path_factory):
    from commefficient_tpu_torch.data.cifar import FedCIFAR10
    root = tmp_path_factory.mktemp("mhdata")
    return FedCIFAR10(str(root), synthetic_examples=(80, 16))


def test_fedloader_feed_slice_matches_global_rows(synth_ds):
    """A feed_slice loader yields exactly the row block of the global
    loader's batches, client ids global (no augmentation: the stateful
    crop/flip draws for the fetched rows only)."""
    from commefficient_tpu_torch.data.loader import FedLoader
    full = FedLoader(synth_ds, num_workers=4, local_batch_size=3, seed=7)
    part = FedLoader(synth_ds, num_workers=4, local_batch_size=3, seed=7,
                     feed_slice=slice(2, 4))
    n = 0
    for (ids_a, data_a, mask_a), (ids_b, data_b, mask_b) in zip(
            full.epoch(), part.epoch()):
        np.testing.assert_array_equal(ids_a, ids_b)
        for a, b in zip(data_a, data_b):
            np.testing.assert_array_equal(a[2:4], b)
        np.testing.assert_array_equal(mask_a[2:4], mask_b)
        n += 1
    assert n == full.steps_per_epoch


def test_fedloader_feed_slice_is_the_jax_loaders(synth_ds, tmp_path):
    from commefficient_tpu.data.cifar import FedCIFAR10 as JCIFAR
    from commefficient_tpu.data.loader import FedLoader as JLoader
    from commefficient_tpu_torch.data.loader import FedLoader
    jds = JCIFAR(str(tmp_path), synthetic_examples=(80, 16))
    j = JLoader(jds, num_workers=4, local_batch_size=3, seed=7,
                feed_slice=slice(0, 2))
    t = FedLoader(synth_ds, num_workers=4, local_batch_size=3, seed=7,
                  feed_slice=slice(0, 2))
    for (ia, da, ma), (ib, db, mb) in zip(j.epoch(), t.epoch()):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ma, mb)
        for a, b in zip(da, db):
            np.testing.assert_array_equal(a, b)


def test_valloader_feed_slice_matches_global_rows(synth_ds):
    from commefficient_tpu_torch.data.loader import FedValLoader
    full = FedValLoader(synth_ds, valid_batch_size=2, num_shards=4)
    part = FedValLoader(synth_ds, valid_batch_size=2, num_shards=4,
                        feed_slice=slice(1, 3))
    for (data_a, mask_a), (data_b, mask_b) in zip(full.batches(),
                                                  part.batches()):
        for a, b in zip(data_a, data_b):
            np.testing.assert_array_equal(a[1:3], b)
        np.testing.assert_array_equal(mask_a[1:3], mask_b)


def test_fedmodel_refuses_rows_of_the_whole_cohort_on_a_rank():
    """A rank feeds its block only: a batch of the whole cohort's rows
    on a 2-position layout raises (checked before any collective)."""
    from commefficient_tpu_torch.federated.api import FedModel
    from commefficient_tpu_torch.parallel.mesh import make_client_mesh
    module, _ = tmw.make_model("base")
    lay = make_client_mesh(2, [0, 1])
    lay.rank, lay.position = 0, (0, 0)
    fed = FedModel(module, tmw.make_loss(module), tmw.scenario_config(),
                   device="cpu", num_clients=tmw.N_CLIENTS, layout=lay)
    assert fed.clients.weights.shape[0] == tmw.N_CLIENTS // 2
    ids, x, y, mask = tmw.scenario_batches("base")[0]
    with pytest.raises(ValueError, match="only the rank's rows"):
        fed((ids, (x, y), mask))


# ---------------------------------------------------------------------------
# grids of ranks: CPU subprocesses over gloo


def _jax_scenario(tmp_path, variant, mesh):
    """The JAX worker's scenario in this process on `mesh`; its init
    weights (a .npy path for the port's workers) and its artifact."""
    import jax
    from jax.flatten_util import ravel_pytree

    from commefficient_tpu.parallel import mh_worker as jmw
    jmodel, _, x0 = jmw._make_model_and_rules(variant)
    params = jmodel.init(jax.random.PRNGKey(0), x0)
    init = str(tmp_path / f"init_{variant}.npy")
    np.save(init, np.asarray(ravel_pytree(params)[0]))
    out = str(tmp_path / f"jax_{variant}.npz")
    make = jmw._make_mesh
    jmw._make_mesh = lambda v: mesh
    try:
        jmw.run_scenario(out, variant=variant)
    finally:
        jmw._make_mesh = make
    return init, dict(np.load(out))


# the JAX FedModel on its 2-device mesh and the port: the same float32
# round in another summation order (XLA's convolutions against torch's),
# held to the worker's own RTOL, ATOL
JAX_RTOL, JAX_ATOL = tmw.RTOL, tmw.ATOL


def test_two_rank_grid_matches_single_process_and_jax(tmp_path):
    from commefficient_tpu.parallel.mesh import make_client_mesh
    init, j = _jax_scenario(tmp_path, "base", make_client_mesh(2))
    got = tmw.run_grid(str(tmp_path), "base", 2, "cpu", init=init,
                       timeout=300)
    grid, single = got["grid"], got["single"]
    assert int(grid["process_count"]) == 2
    assert int(grid["ranks_bitwise_equal"]) == 1
    assert grid["layout"].tolist() == [[0], [1]]
    assert int(grid["collective_calls"]) > 0
    for key in tmw.RESULT_KEYS:
        np.testing.assert_allclose(grid[key], single[key], rtol=tmw.RTOL,
                                   atol=tmw.ATOL, err_msg=f"single:{key}")
        np.testing.assert_allclose(grid[key], j[key], rtol=JAX_RTOL,
                                   atol=JAX_ATOL, err_msg=f"jax:{key}")
    # --topk_down's rows: 16 clients gathered from 8 on each rank
    assert grid["ckpt_client_weights"].shape == (tmw.N_CLIENTS,
                                                 grid["ps_weights"].size)
    # exact byte accounting: 8 uploads of a 3 x 512 f32 table a round
    assert float(grid["upload"]) == 2 * 8 * 3 * 512 * 4


def test_noncontig_four_ranks_match_the_flat_layout(tmp_path):
    flat = tmw.run_grid(str(tmp_path), "base", 4, "cpu", timeout=300,
                        single=False)["grid"]
    perm = tmw.run_grid(str(tmp_path), "noncontig", 4, "cpu", timeout=300,
                        single=False)["grid"]
    assert perm["layout"].reshape(-1).tolist() == [0, 2, 1, 3]
    assert flat["layout"].reshape(-1).tolist() == [0, 1, 2, 3]
    assert int(perm["ranks_bitwise_equal"]) == 1
    assert int(flat["ranks_bitwise_equal"]) == 1
    for key in tmw.RESULT_KEYS:
        np.testing.assert_allclose(perm[key], flat[key], rtol=1e-6,
                                   atol=1e-7, err_msg=key)


def test_cv_train_multihost_driver_on_two_ranks(tmp_path):
    """cv_train --multihost on two CPU ranks over gloo: both exit 0, the
    coordinator alone prints the table and writes the checkpoint, and
    the per-client rows (local_topk) are sharded and gathered."""
    port = tmw.free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    argv = ["--test", "--device", "cpu", "--mode", "local_topk",
            "--error_type", "local", "--local_momentum", "0.9",
            "--num_workers", "4", "--num_epochs", "0.25",
            "--dataset_dir", str(tmp_path / "ds"), "--checkpoint",
            "--checkpoint_path", str(tmp_path / "ck"), "--no_telemetry",
            "--multihost", "--num_processes", "2",
            "--coordinator_address", f"127.0.0.1:{port}"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "commefficient_tpu_torch.training.cv_train",
         *argv, "--process_id", str(i)], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = []
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    assert "train_loss" in outs[0] and "train_loss" not in outs[1]
    assert "saved checkpoint" in outs[0]
    from commefficient_tpu.utils.checkpoint import (
        load_checkpoint as j_load_checkpoint,
    )
    from commefficient_tpu_torch.utils.checkpoint import load_checkpoint
    path = str(tmp_path / "ck" / "ResNet9.npz")
    ck = load_checkpoint(path)
    rows = ck.client_rows
    assert rows is not None and len(rows["ids"]) > 0
    assert rows["errors"].shape == (len(rows["ids"]),
                                    ck.server.ps_weights.shape[0])
    assert np.abs(rows["errors"]).sum() > 0
    # the JAX package's format, key for key: its reader takes the file
    jck = j_load_checkpoint(path)
    for key in ("ids", "errors", "velocities"):
        np.testing.assert_array_equal(np.asarray(jck.client_rows[key]),
                                      rows[key])
    np.testing.assert_array_equal(np.asarray(jck.server.ps_weights),
                                  ck.server.ps_weights.numpy())


# the round's other families on 2 ranks: the screened family's cohort
# statistics (the colluding and little-is-enough attacks' honest means,
# the norm screen's median), the robust aggregators over the gathered
# tables, the per-client error and velocity rows under dropout, the
# poison screen with stragglers, --dp's per-client keys, dp_sketch
FAMILIES = {
    "colluding_trimmed": dict(update_screen="norm", byzantine_rate=0.25,
                              attack="colluding",
                              aggregator="trimmed_mean"),
    "lie_median_dropout": dict(update_screen="norm", byzantine_rate=0.25,
                               attack="little_is_enough",
                               aggregator="coord_median",
                               client_dropout=0.25),
    "poison_stragglers": dict(poison_rate=0.25, poison_kind="nan",
                              update_screen="norm", straggler_rate=0.5,
                              straggler_cutoff=0.2),
    "local_rows_dropout": dict(mode="local_topk", error_type="local",
                               local_momentum=0.9, virtual_momentum=0.0,
                               do_topk_down=False, client_dropout=0.25),
    "dp_worker": dict(do_dp=True, dp_mode="worker", l2_norm_clip=1.0,
                      noise_multiplier=0.01, max_grad_norm=1.0),
    "dp_sketch": dict(mode="dp_sketch", dp_noise_mult=0.5,
                      do_topk_down=False),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_round_families_on_two_ranks_match_single_process(tmp_path,
                                                          family):
    got = tmw.run_grid(str(tmp_path), "base", 2, "cpu", timeout=300,
                       overrides=FAMILIES[family], tag=family)
    grid, single = got["grid"], got["single"]
    assert int(grid["ranks_bitwise_equal"]) == 1
    for key in tmw.RESULT_KEYS:
        np.testing.assert_allclose(grid[key], single[key], rtol=tmw.RTOL,
                                   atol=tmw.ATOL, err_msg=key)
    assert float(grid["upload"]) > 0


def test_int8_wire_rounds_each_ranks_sum_as_jax_rounds_each_shards(
        tmp_path, monkeypatch):
    """--sketch_table_dtype int8 on 2 ranks: each rank rounds its
    block's table before the all_reduce, as the JAX engine rounds each
    mesh shard's; so the grid matches the JAX FedModel on
    make_client_mesh(2) (and not the one process, whose single sum is
    rounded once)."""
    import commefficient_tpu.config as jconfig
    from commefficient_tpu.parallel.mesh import make_client_mesh
    real = jconfig.Config
    monkeypatch.setattr(jconfig, "Config", lambda **kw: real(
        **{**kw, "sketch_table_dtype": "int8"}))
    init, j = _jax_scenario(tmp_path, "base", make_client_mesh(2))
    got = tmw.run_grid(str(tmp_path), "base", 2, "cpu", init=init,
                       timeout=300, overrides={"sketch_table_dtype": "int8"},
                       tag="int8")
    grid, single = got["grid"], got["single"]
    assert int(grid["ranks_bitwise_equal"]) == 1
    # the billed wire: r * c int8 cells and 4 bytes of scale a row
    assert float(grid["upload"]) == 2 * 8 * (3 * 512 + 4 * 3)
    for key in tmw.RESULT_KEYS:
        np.testing.assert_allclose(grid[key], j[key], rtol=JAX_RTOL,
                                   atol=JAX_ATOL, err_msg=f"jax:{key}")
    assert not np.allclose(grid["ps_weights"], single["ps_weights"],
                           rtol=tmw.RTOL, atol=tmw.ATOL)


def test_the_round_sums_its_table_through_reduce_transmit(monkeypatch):
    """The round's one cross-rank sum is round.reduce_transmit: wrapped,
    it sees one call a round, and what it returns is the probe's
    gradient sum (FedModel.cohort_transmit) encoded and put on the wire
    by the same function (the table the card script's grid phase reads
    from a real round)."""
    from commefficient_tpu_torch.federated import round as fround
    from commefficient_tpu_torch.federated.api import FedModel, FedOptimizer
    module, _ = tmw.make_model("base")
    cfg = tmw.scenario_config(dict(do_topk_down=False))
    fed = FedModel(module, tmw.make_loss(module), cfg, device="cpu",
                   num_clients=tmw.N_CLIENTS)
    FedOptimizer(fed).param_groups[0]["lr"] = 0.1
    ids, x, y, mask = tmw.scenario_batches("base")[0]
    want = fround.reduce_transmit(fed.cfg, fed.cohort_transmit(
        (ids, (x, y), mask)))
    assert tuple(want.shape) == (cfg.num_rows, cfg.num_cols)
    tables, reduce = [], fround.reduce_transmit

    def record(*a, **kw):
        out = reduce(*a, **kw)
        tables.append(out.clone())
        return out

    monkeypatch.setattr(fround, "reduce_transmit", record)
    fed((ids, (x, y), mask))
    assert len(tables) == 1
    np.testing.assert_array_equal(tables[0].numpy(), want.numpy())


def test_async_checkpoint_is_on_disk_before_each_barrier(tmp_path,
                                                         monkeypatch):
    """In a multi-rank run the coordinator drains an async writer before
    each barrier of a save, so no rank passes a barrier before the file,
    then the manifest, is on disk."""
    from commefficient_tpu_torch.federated.round import ServerState
    from commefficient_tpu_torch.utils import checkpoint as ck
    seen = []
    monkeypatch.setattr(tmh, "is_multihost", lambda: True)
    monkeypatch.setattr(tmh, "sync_processes", lambda name="barrier":
                        seen.append((name, sorted(os.listdir(tmp_path)))))
    v = torch.arange(4.0)
    writer = ck.AsyncCheckpointWriter(max_pending=4)
    try:
        # a writer that is behind when the save is queued
        writer.submit(lambda: time.sleep(0.3))
        ck.save_final(str(tmp_path / "m"), ServerState(v, v, v, 3),
                      writer=writer)
    finally:
        writer.close()
    assert [n for n, _ in seen] == ["checkpoint-written",
                                    "checkpoint-rotated", "checkpoint-final"]
    assert "m-r00000003.npz" in seen[0][1]
    assert "m.latest" in seen[1][1]
    assert "m.npz" in seen[2][1]


@pytest.mark.parametrize("position", [0, 1])
def test_load_state_installs_the_ranks_block(position):
    """A checkpoint (the O(cohort) rows, or the dense blocks) loads into
    a rank of a 2-position layout as that rank's block of the rows:
    the one-process model's rows [8 p, 8 p + 8)."""
    from commefficient_tpu_torch.federated.api import FedModel, FedOptimizer
    from commefficient_tpu_torch.parallel.mesh import make_client_mesh
    from commefficient_tpu_torch.utils.checkpoint import Checkpoint

    def model(layout=None):
        module, _ = tmw.make_model("base")
        fed = FedModel(module, tmw.make_loss(module),
                       tmw.scenario_config(dict(
                           mode="local_topk", error_type="local",
                           local_momentum=0.9, virtual_momentum=0.0)),
                       device="cpu", num_clients=tmw.N_CLIENTS,
                       layout=layout)
        FedOptimizer(fed).param_groups[0]["lr"] = 0.1
        return fed

    one = model()
    for ids, x, y, mask in tmw.scenario_batches("base")[:2]:
        one((ids, (x, y), mask))
    lay = make_client_mesh(2, [0, 1])
    lay.rank, lay.position = position, (position, 0)
    block = slice(8 * position, 8 * position + 8)
    for dense in (False, True):
        rank = model(lay)
        rows = one.client_rows_payload()
        rank.load_state(Checkpoint(
            one.server, one.clients if dense else None, 2,
            client_rows=None if dense else rows))
        for name in ("errors", "velocities", "weights"):
            np.testing.assert_array_equal(
                getattr(rank.clients, name).numpy(),
                getattr(one.clients, name)[block].numpy(), err_msg=name)
        np.testing.assert_array_equal(rank.ps_weights.numpy(),
                                      one.ps_weights.numpy())


# ---------------------------------------------------------------------------
# the plan transport (parallel/plantransport.py) over the ranks


def _plan_grid(tmp_path, diverge_rank=None, timeout=120):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    port = tmw.free_port()
    out = str(tmp_path / "plan.npz")
    extra = [] if diverge_rank is None else ["--diverge_rank",
                                             str(diverge_rank)]
    procs = [tmw.spawn(["--out", out if i == 0 else f"{out}.{i}",
                        "--device", "cpu", "--process_id", str(i),
                        "--num_processes", "2", "--port", str(port),
                        *extra], env, "plan") for i in range(2)]
    t0 = time.monotonic()
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out, [p.returncode for p in procs], logs, time.monotonic() - t0


def test_plan_grid_on_two_ranks(tmp_path):
    """--sampler throughput --plan_transport collective on 2 ranks, each
    tracker fed its own wall clock: the coordinator's plans broadcast,
    the ranks' weights bitwise equal, a plan and an install digest
    cross-checked every round and journaled write-ahead."""
    out, codes, logs, _ = _plan_grid(tmp_path)
    assert codes == [0, 0], logs[0][-3000:] + logs[1][-3000:]
    z = np.load(out)
    rounds = int(z["rounds"])
    assert int(z["process_count"]) == 2
    assert int(z["ranks_bitwise_equal"]) == 1
    assert z["digest_rounds"].tolist() == list(range(rounds))
    assert int(z["plan_ids_match"]) == 1
    # a broadcast and two digest gathers (plan, install) a round
    assert int(z["transport_calls"]) == 3 * rounds
    # the [8 + PLAN_MAX_BYTES] buffer, and two [2, 32] int64 gathers
    assert int(z["transport_bytes"]) == rounds * (
        8 + PLAN_MAX_BYTES + 2 * 2 * 32 * 8)


def test_plan_grid_divergence_raises_on_every_rank(tmp_path):
    """Rank 1 alone drops a slot of round 1: the install digests are
    gathered before any rank compares, so both ranks raise
    PlanDigestError at round 1, and neither hangs."""
    out, codes, logs, secs = _plan_grid(tmp_path, diverge_rank=1)
    assert codes == [tmw.DIVERGED, tmw.DIVERGED], logs
    assert secs < 120
    for i, path in enumerate((out, f"{out}.1")):
        with open(f"{path}.diverged.{i}") as f:
            said = f.read()
        assert said.startswith("round 1: install digest diverged"), said


@pytest.mark.parametrize("diverge", [False, True],
                         ids=["agree", "rank1-diverges"])
def test_cv_train_plan_transport_collective_on_two_ranks(tmp_path, diverge):
    """cv_train --multihost --sampler throughput --plan_transport
    collective on two CPU ranks: both exit 0 with bitwise equal weights,
    every round's plan and install digests cross-checked (3 transport
    calls a round), the coordinator's journal holding a digest and the
    serialized plan for every round. With slot 0 of round 1 dropped on
    rank 1 alone, both ranks raise PlanDigestError at round 1."""
    port = tmw.free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    jpath = str(tmp_path / "j.jsonl")
    argv = ["--test", "--device", "cpu", "--mode", "sketch",
            "--error_type", "virtual", "--local_momentum", "0",
            "--num_workers", "4", "--num_epochs", "0.25",
            "--dataset_dir", str(tmp_path / "ds"), "--sampler", "throughput",
            "--plan_transport", "collective", "--journal_path", jpath,
            "--multihost", "--num_processes", "2",
            "--coordinator_address", f"127.0.0.1:{port}"]
    # cv_train.main, its run() wrapped to report the ranks' weights and
    # the transport's calls
    code = (
        "import sys\n"
        "from commefficient_tpu_torch.training import cv_train\n"
        "from commefficient_tpu_torch.parallel.mh_worker import "
        "ranks_bitwise_equal\n"
        "from commefficient_tpu_torch.utils.faults import FaultSchedule\n"
        "run = cv_train.run\n"
        "def wrapped(model, *a, **kw):\n"
        f"    if {diverge} and model.layout.rank == 1:\n"
        "        model.set_fault_schedule(\n"
        "            FaultSchedule(drop_slots={1: [0]}))\n"
        "    ok = run(model, *a, **kw)\n"
        "    print('RANKS_EQUAL', ranks_bitwise_equal(model.ps_weights),\n"
        "          'CALLS', model.plan_transport.stats.calls,\n"
        "          'ROUNDS', model.server.round_idx, flush=True)\n"
        "    return ok\n"
        "cv_train.run = wrapped\n"
        "sys.exit(0 if cv_train.main(sys.argv[1:]) else 1)\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *argv, "--process_id", str(i)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(2)]
    outs = []
    try:
        outs = [p.communicate(timeout=120 if diverge else 300)[0].decode()
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if diverge:
        for p, o in zip(procs, outs):
            assert p.returncode != 0, o[-3000:]
            assert "PlanDigestError: round 1: install digest diverged" in o
        return
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    reports = [[ln.split() for ln in o.splitlines()
                if ln.startswith("RANKS_EQUAL")][0] for o in outs]
    rounds = int(reports[0][5])
    assert rounds > 0
    for rep in reports:
        assert rep[1] == "True"
        assert int(rep[3]) == 3 * rounds
    from commefficient_tpu_torch.parallel.plantransport import (
        journaled_plan_stream,
    )
    digests, plans = journaled_plan_stream(jpath)
    assert sorted(digests) == sorted(plans) == list(range(rounds))
