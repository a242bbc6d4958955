"""Spawnable multi-rank worker: the port of
commefficient_tpu/parallel/mh_worker.py.

Fixed, deterministic FedModel scenarios, runnable as one process or as
one rank of an N-rank grid over torch.distributed: sketch rounds
through FedModel's per-round path, a span of rounds (run_rounds), the
byte accounting, an eval pass and a checkpoint whose client rows are
gathered over the ranks in chunks. The grid must give what the single
process gives, with per-rank batch feeding (each rank passes its block
of the rows).

Three variants (--variant) are the JAX worker's:
  * ``base``     - a 1-D clients layout over the ranks.
  * ``tp``       - a (clients x 2 model) layout with a tensor-parallel
                   MLP sandwich (parallel/tp.py): column-parallel up
                   projection, row-parallel down projection, a
                   replicated head.
  * ``noncontig``- the --num_slices 2 emulation (mesh.
                   make_multihost_client_mesh): rank i sits at the
                   slice-major position, a real permutation, so rank 1
                   of 4 feeds block 2. (The JAX worker's globalize()
                   fallback has no counterpart: one rank always feeds
                   one contiguous block.)

and two are the port's own (the JAX package runs them in one process):
  * ``plan``     - the base scenario's model and round config under
                   --sampler throughput --plan_transport collective
                   (parallel/plantransport.py), ROUNDS + SPAN rounds
                   drawn by a FedSampler through the RoundScheduler, the
                   tracker fed each rank's own wall clock: the
                   coordinator's plans broadcast, every plan and install
                   digest cross-checked, the coordinator's journal
                   holding a digest a round. `--diverge_rank r` drops
                   slot 0 of round 1 on rank r alone, a divergence every
                   rank must raise as PlanDigestError (exit code 3).
  * ``ring``     - ring attention (parallel/ring.py) over the ranks on
                   RING_SHAPE's q, k, v from a seed: each rank's chunk's
                   output and the gradients of sum(out ** 2), written to
                   <out>.<rank>.npz (`--rotate` picks the rotation).
                   `--rings R` splits the world into R rings of
                   consecutive ranks, ring i holding block i of the
                   batch, beside a (R clients x ring size) Layout bound
                   first: each rank also gathers its sequence
                   position's outputs over the Layout's clients group.

Launch, here two ranks on the CPU over gloo and the single process:

    python -m commefficient_tpu_torch.parallel.mh_worker --out r.npz \\
        --device cpu --process_id 0 --num_processes 2 --port 29517
    python -m commefficient_tpu_torch.parallel.mh_worker --out r1.npz \\
        --device cpu --process_id 1 --num_processes 2 --port 29517
    python -m commefficient_tpu_torch.parallel.mh_worker --out ref.npz \\
        --device cpu

On GPUs the ranks take cuda:{rank % device_count} and nccl by default
(`--backend gloo` where ranks share a card). `--init` loads the initial
flat weight vector from a .npy file (the JAX worker's init, for a
parity test); `--overrides` sets Config fields over the scenario's, as
JSON (the tests' other round families). `run_grid_vs_reference` spawns
a grid and the single process and compares every RESULT_KEYS entry.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from typing import Optional

import numpy as np

# scenario constants, the JAX worker's: identical in every rank and in
# the single-process reference run
W, B, N_CLIENTS, ROUNDS, SPAN = 8, 2, 16, 3, 2
MESH_DEVICES = 8
VARIANTS = ("base", "tp", "noncontig", "plan", "ring")
# the plan scenario's flags over the base config
PLAN_OVERRIDES = dict(sampler="throughput", plan_transport="collective")
# exit code of a rank whose control plane diverged (PlanDigestError)
DIVERGED = 3
# the ring scenario's [B, H, L, Dh] (L split over the ranks)
RING_SHAPE = (2, 2, 64, 16)
# grid-vs-single-process tolerance, stated in every comparison
RTOL, ATOL = 1e-5, 1e-6

# keys every scenario artifact carries; the grid runner compares all of
# them against the single-process reference
RESULT_KEYS = ("ps_weights", "losses", "span_losses", "eval_loss",
               "download", "upload", "ckpt_ps_weights",
               "ckpt_client_weights")


def scenario_batches(variant: str):
    """Deterministic per-round global batches [ROUNDS + SPAN]."""
    rs = np.random.RandomState(0)
    out = []
    for t in range(ROUNDS + SPAN):
        if variant == "tp":
            x = rs.randn(W, B, 12).astype(np.float32)
        else:
            x = rs.randn(W, B, 16, 16, 3).astype(np.float32)
        y = rs.randint(0, 10, (W, B)).astype(np.int32)
        ids = ((np.arange(W) * 2 + t) % N_CLIENTS).astype(np.int32)
        out.append((ids, x, y, np.ones((W, B), np.float32)))
    return out


def eval_batch(variant: str):
    """The eval pass's [MESH_DEVICES, B, ...] shards."""
    rs = np.random.RandomState(99)
    if variant == "tp":
        ex = rs.randn(MESH_DEVICES, B, 12).astype(np.float32)
    else:
        ex = rs.randn(MESH_DEVICES, B, 16, 16, 3).astype(np.float32)
    ey = rs.randint(0, 10, (MESH_DEVICES, B)).astype(np.int32)
    return ex, ey, np.ones((MESH_DEVICES, B), np.float32)


# the tp variant's rules: the JAX worker's, on the MLP's flat paths
TP_MLP_RULES = (
    (r"up/kernel$", (None, "model")),
    (r"up/bias$", ("model",)),
    (r"down/kernel$", ("model", None)),
)


def make_tp_mlp():
    """The JAX worker's TpMLP: Dense(64) 'up', relu, Dense(16) 'down',
    Dense(10) 'head', in the flax flat layout (kernels [in, out])."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from commefficient_tpu_torch.ops.flat import LayoutEntry
    from commefficient_tpu_torch.parallel.tp import (
        copy_to_model, even_range, reduce_from_model,
    )

    class TpMLP(nn.Module):
        supports_tensor_parallel = True
        _tp = None

        def __init__(self):
            super().__init__()
            self.up = nn.Linear(12, 64)
            self.down = nn.Linear(64, 16)
            self.head = nn.Linear(16, 10)
            rng = np.random.RandomState(0)
            with torch.no_grad():
                for lin in (self.up, self.down, self.head):
                    o, i = lin.weight.shape
                    lin.weight.copy_(torch.from_numpy(
                        (rng.standard_normal((i, o)) / np.sqrt(i))
                        .astype(np.float32).T))
                    lin.bias.zero_()

        def forward(self, x):
            tp = self._tp
            if tp is None:
                h = self.down(F.relu(self.up(x)))
            else:
                lo, hi = even_range(64, tp, "up features")
                h = F.relu(F.linear(copy_to_model(x, tp),
                                    self.up.weight[lo:hi],
                                    self.up.bias[lo:hi]))
                h = reduce_from_model(
                    F.linear(h, self.down.weight[:, lo:hi]), tp
                ) + self.down.bias
            return self.head(h)

        def jax_layout(self):
            out = []
            for name in ("down", "head", "up"):
                lin = getattr(self, name)
                o, i = lin.weight.shape
                out.append(LayoutEntry((name, "bias"), f"{name}.bias",
                                       (o,)))
                out.append(LayoutEntry((name, "kernel"), f"{name}.weight",
                                       (i, o), (1, 0)))
            return out

    return TpMLP()


def make_model(variant: str):
    """(torch module, tp rules or None)."""
    if variant == "tp":
        return make_tp_mlp(), TP_MLP_RULES
    from commefficient_tpu_torch.models import ResNet9
    return ResNet9(num_classes=10,
                   channels={"prep": 4, "layer1": 8, "layer2": 8,
                             "layer3": 8}), None


def make_layout(variant: str):
    """The variant's layout over the world's ranks; None in a single
    process (the reference run)."""
    from commefficient_tpu_torch.parallel import multihost as mh
    from commefficient_tpu_torch.parallel.mesh import (
        make_client_mesh, make_client_model_mesh,
        make_multihost_client_mesh,
    )
    n = mh.process_count()
    if n == 1:
        return None
    if variant == "tp":
        return make_client_model_mesh(n // 2, 2)
    if variant == "noncontig":
        return make_multihost_client_mesh(num_slices=2)
    return make_client_mesh(n)


def make_loss(module):
    """The JAX worker's masked cross-entropy with accuracy."""
    import torch

    def base_loss(params, batch, mask):
        xb, yb = batch
        logits = torch.func.functional_call(module, params, (xb,))
        logp = torch.log_softmax(logits, dim=-1)
        per_ex = -logp.gather(1, yb.long()[:, None])[:, 0]
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (per_ex * mask).sum() / denom
        acc = ((logits.argmax(-1) == yb.long()).to(mask.dtype)
               * mask).sum() / denom
        return loss, (acc,)
    return base_loss


def scenario_config(overrides: Optional[dict] = None):
    """The JAX worker's round config (--topk_down gives the scenario
    per-client rows, so the sharded row gather and the chunked
    checkpoint gather are exercised), with `overrides` (Config fields)
    on top."""
    from commefficient_tpu_torch.config import Config
    return Config(**{**dict(
        mode="sketch", error_type="virtual", virtual_momentum=0.9,
        local_momentum=0.0, k=16, num_rows=3, num_cols=512, num_blocks=1,
        weight_decay=5e-4, microbatch_size=-1, num_workers=W,
        num_clients=N_CLIENTS, seed=0, do_topk_down=True),
        **(overrides or {})})


def run_scenario(out_path: str, variant: str = "base", device="cuda",
                 init: Optional[str] = None,
                 overrides: Optional[dict] = None) -> None:
    import torch

    from commefficient_tpu_torch.federated.api import FedModel, FedOptimizer
    from commefficient_tpu_torch.models.convert import from_jax_params
    from commefficient_tpu_torch.parallel import multihost as mh
    from commefficient_tpu_torch.parallel.tp import tp_loss
    from commefficient_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    module, rules = make_model(variant)
    if init:
        from_jax_params(module, np.load(init))
    layout = make_layout(variant)
    loss = make_loss(module)
    if rules is not None:
        loss = tp_loss(loss, layout, rules)
    fed = FedModel(module, loss, scenario_config(overrides), device=device,
                   num_clients=N_CLIENTS, layout=layout)
    opt = FedOptimizer(fed)
    opt.param_groups[0]["lr"] = 0.1
    sl = mh.local_row_slice(fed.layout, W)
    esl = mh.local_row_slice(fed.layout, MESH_DEVICES)
    batches = scenario_batches(variant)

    losses = []
    for ids, x, y, mask in batches[:ROUNDS]:
        out = fed((ids, (x[sl], y[sl]), mask[sl]))
        losses.append(mh.gather_host(out[0]))

    # a span of rounds through the same per-rank feeding
    span = batches[ROUNDS:]
    ids_s = np.stack([b[0] for b in span])
    x_s = np.stack([b[1][sl] for b in span])
    y_s = np.stack([b[2][sl] for b in span])
    m_s = np.stack([b[3][sl] for b in span])
    out = fed.run_rounds(ids_s, (x_s, y_s), m_s,
                         np.full((SPAN,), 0.1, np.float32))
    span_losses, downloads, uploads = out[0], out[-2], out[-1]

    ex, ey, emask = eval_batch(variant)
    fed.train(False)
    eval_out = fed(((ex[esl], ey[esl]), emask[esl]))

    # the chunked gather of the sharded client rows; the coordinator
    # alone writes and reads the file
    ckpt_path = out_path + ".ckpt"
    save_checkpoint(ckpt_path, fed.server, fed.checkpoint_clients(
        chunk_rows=4), scheduler_step=7, accountant=fed.accountant,
        prev_change_words=fed._prev_change_words)
    weights = fed.ps_weights.detach().cpu().numpy()
    # every rank holds bitwise the same weights: the coordinator
    # records whether every other rank's equal its own
    same = np.asarray(1)
    if fed.layout is not None and fed.layout.connected:
        same = np.asarray(int(ranks_bitwise_equal(fed.ps_weights)))
    if mh.is_coordinator():
        ck = load_checkpoint(ckpt_path)
        assert ck.scheduler_step == 7
        np.savez(out_path,
                 ps_weights=weights,
                 losses=np.stack(losses),
                 span_losses=np.asarray(span_losses),
                 eval_loss=np.asarray(eval_out[0]),
                 download=np.asarray(downloads),
                 upload=np.asarray(uploads),
                 ckpt_ps_weights=np.asarray(ck.server.ps_weights),
                 ckpt_client_weights=np.asarray(ck.clients.weights),
                 process_count=mh.process_count(),
                 ranks_bitwise_equal=np.asarray(same),
                 layout=(np.asarray([]) if fed.layout is None
                         else fed.layout.ranks),
                 collective_calls=(0 if fed.layout is None
                                   else fed.layout.stats.calls),
                 feed_global=0)
    mh.sync_processes("scenario-done")
    print(f"mh_worker[{variant}] rank={mh.process_index()}"
          f"/{mh.process_count()} ok", flush=True)


def run_plan_scenario(out_path: str, device="cuda",
                      diverge_rank: Optional[int] = None) -> None:
    """The `plan` variant (module docstring)."""
    from types import SimpleNamespace

    from commefficient_tpu_torch.data.sampler import FedSampler
    from commefficient_tpu_torch.federated.api import FedModel, FedOptimizer
    from commefficient_tpu_torch.parallel import multihost as mh
    from commefficient_tpu_torch.parallel.plantransport import (
        PlanDigestError, attach_config_transport, deserialize_plan,
        journaled_plan_stream,
    )
    from commefficient_tpu_torch.scheduler import attach_round_scheduler
    from commefficient_tpu_torch.telemetry import (
        RunJournal, TelemetrySession,
    )
    from commefficient_tpu_torch.utils.faults import FaultSchedule

    module, _ = make_model("base")
    layout = make_layout("base")
    fed = FedModel(module, make_loss(module),
                   scenario_config({**PLAN_OVERRIDES,
                                    "multihost": layout is not None}),
                   device=device, num_clients=N_CLIENTS, layout=layout)
    FedOptimizer(fed).param_groups[0]["lr"] = 0.1
    rs = np.random.RandomState(0)
    x = rs.randn(N_CLIENTS, B, 16, 16, 3).astype(np.float32)
    y = rs.randint(0, 10, (N_CLIENTS, B)).astype(np.int32)
    smp = FedSampler(np.full(N_CLIENTS, B), W, B, seed=7)
    loader = SimpleNamespace(sampler=smp)
    sched = attach_round_scheduler(fed, loader)
    transport = attach_config_transport(fed, loader, fed.cfg)
    jpath = out_path + ".jsonl"
    coord = mh.is_coordinator()
    tele = TelemetrySession(journal=RunJournal(jpath) if coord else None,
                            tracker=fed.throughput)
    fed.attach_telemetry(tele)
    if diverge_rank is not None and mh.process_index() == diverge_rank:
        fed.set_fault_schedule(FaultSchedule(drop_slots={1: [0]}))
    sl = mh.local_row_slice(fed.layout, W)
    total, done, dispatched = ROUNDS + SPAN, 0, []
    try:
        while done < total:
            sched.begin_epoch(done)
            for ids, idx, mask in smp.epoch():
                ids = np.asarray(ids)
                fed((ids, (x[ids[:, None], idx][sl], y[ids[:, None], idx][sl]),
                     mask[sl]))
                dispatched.append(ids)
                done += 1
                if done >= total:
                    break
    except PlanDigestError as e:
        with open(f"{out_path}.diverged.{mh.process_index()}", "w") as f:  # graftlint: disable=GL006 -- a test scenario's marker, read once by its test
            f.write(str(e))
        raise SystemExit(DIVERGED)
    finally:
        tele.close()
    same = np.asarray(1)
    if fed.layout is not None and fed.layout.connected:
        same = np.asarray(int(ranks_bitwise_equal(fed.ps_weights)))
    if coord:
        digests, plans = journaled_plan_stream(jpath)
        parts = [np.asarray(deserialize_plan(plans[r]).participants)
                 for r in range(total)]
        np.savez(out_path,
                 ps_weights=fed.ps_weights.detach().cpu().numpy(),
                 process_count=mh.process_count(),
                 ranks_bitwise_equal=same,
                 rounds=total,
                 digest_rounds=np.asarray(sorted(digests)),
                 plan_ids_match=np.asarray(int(all(
                     np.array_equal(p, d[:len(p)])
                     for p, d in zip(parts, dispatched)))),
                 transport_calls=transport.stats.calls,
                 transport_bytes=transport.stats.bytes)
    mh.sync_processes("plan-done")
    print(f"mh_worker[plan] rank={mh.process_index()}"
          f"/{mh.process_count()} ok", flush=True)


def run_ring_scenario(out_path: str, device="cuda", rotate: str = "auto",
                      rings: int = 1) -> None:
    """The `ring` variant (module docstring)."""
    import torch

    from commefficient_tpu_torch.parallel import multihost as mh
    from commefficient_tpu_torch.parallel.mesh import make_client_model_mesh
    from commefficient_tpu_torch.parallel.ring import SeqRing, ring_attention
    n, me = mh.process_count(), mh.process_index()
    size = n // rings
    partition = [list(range(i * size, (i + 1) * size))
                 for i in range(rings)]
    layout = make_client_model_mesh(rings, size).bind()
    ring = SeqRing(partition[me // size], rotate=rotate).bind(
        partition=partition)
    Bq, H, L, Dh = RING_SHAPE
    rs = np.random.RandomState(0)
    full = [rs.randn(Bq, H, L, Dh).astype(np.float32) for _ in range(3)]
    lc, bc = L // size, Bq // rings
    pos, blk = ring.position, me // size
    q, k, v = (torch.tensor(a[blk * bc:(blk + 1) * bc, :,
                              pos * lc:(pos + 1) * lc],
                            device=device, requires_grad=True)
               for a in full)
    out = ring_attention(q, k, v, ring)
    (out ** 2).sum().backward()
    gathered = layout.gather(out.detach(), dim=0)
    np.savez(f"{out_path}.{me}.npz", out=out.detach().cpu().numpy(),  # graftlint: disable=GL006 -- a test scenario's output, read once by its test
             out_all=gathered.cpu().numpy(), dq=q.grad.cpu().numpy(),
             dk=k.grad.cpu().numpy(), dv=v.grad.cpu().numpy(),
             rotations=ring.stats.calls, ring=me // size, position=pos)
    print(f"mh_worker[ring] rank={me}/{n} ok", flush=True)


def ranks_bitwise_equal(t) -> bool:
    """Whether every rank's tensor `t` is bitwise rank 0's (a broadcast
    and an all_reduce, both served by gloo on a card)."""
    import torch
    import torch.distributed as dist
    lead = t.detach().clone()
    dist.broadcast(lead, src=0)  # graftlint: disable=GL007 -- a test scenario's check across the whole world
    differs = torch.tensor([0.0 if torch.equal(t, lead) else 1.0],
                           device=t.device)
    dist.all_reduce(differs)  # graftlint: disable=GL007 -- a test scenario's check across the whole world
    return float(differs.item()) == 0.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(args, env=None, variant: str = "base"):
    """One worker process of this interpreter, from the repo root."""
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return subprocess.Popen(
        [sys.executable, "-m", "commefficient_tpu_torch.parallel.mh_worker",
         "--variant", variant, *args],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def run_grid(out_dir: str, variant: str = "base", num_processes: int = 2,
             device: str = "cpu", backend: Optional[str] = None,
             init: Optional[str] = None, timeout: float = 600.0,
             single: bool = True, overrides: Optional[dict] = None,
             tag: str = "") -> dict:
    """Spawn the scenario as a `num_processes`-rank grid (and, with
    `single`, as one process beside it), its config with `overrides`;
    returns {"grid": arrays, "single": arrays or None}. Every process
    must exit 0. On the CPU each takes one thread."""
    env = dict(os.environ)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    port = free_port()
    grid = os.path.join(out_dir, f"grid_{variant}{tag}_{num_processes}.npz")
    ref = os.path.join(out_dir, f"single_{variant}{tag}.npz")
    common = ["--device", device] + (["--init", init] if init else [])
    if overrides:
        common += ["--overrides", json.dumps(overrides)]
    if backend:
        common += ["--backend", backend]
    procs = [spawn(["--out", grid if i == 0 else f"{grid}.{i}",
                    "--process_id", str(i),
                    "--num_processes", str(num_processes),
                    "--port", str(port), *common], env, variant)
             for i in range(num_processes)]
    if single:
        procs.append(spawn(["--out", ref, *common], env, variant))
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"mh_worker exited {p.returncode}:\n"
                               f"{log[-3000:]}")
    out = {"grid": dict(np.load(grid)), "single": None}
    if single:
        out["single"] = dict(np.load(ref))
    return out


def run_grid_vs_reference(out_dir: str, timeout: float = 600.0,
                          rtol: float = RTOL, atol: float = ATOL,
                          variant: str = "base", num_processes: int = 2,
                          device: str = "cpu",
                          backend: Optional[str] = None) -> dict:
    """run_grid, then every RESULT_KEYS entry of the grid within (rtol,
    atol) of the single process, and every rank's weights bitwise the
    coordinator's. Returns the grid's arrays."""
    got = run_grid(out_dir, variant, num_processes, device, backend,
                   timeout=timeout)
    a, b = got["single"], got["grid"]
    assert int(b["process_count"]) == num_processes
    assert int(b["ranks_bitwise_equal"]) == 1, "ranks' ps_weights differ"
    for key in RESULT_KEYS:
        np.testing.assert_allclose(a[key], b[key], rtol=rtol, atol=atol,
                                   err_msg=f"{variant}:{key}")
    return b


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--variant", choices=VARIANTS, default="base")
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--port", type=int, default=29517)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend (default: nccl for "
                         "cuda, gloo for cpu)")
    ap.add_argument("--init", default=None,
                    help="a .npy flat weight vector to start from")
    ap.add_argument("--overrides", default=None,
                    help="Config fields over the scenario's, as JSON")
    ap.add_argument("--diverge_rank", type=int, default=None,
                    help="plan: the rank whose round 1 diverges")
    ap.add_argument("--rotate", default="auto",
                    help="ring: the rotation (auto, p2p, broadcast)")
    ap.add_argument("--rings", type=int, default=1,
                    help="ring: the number of rings the world splits into")
    args = ap.parse_args(argv)

    from commefficient_tpu_torch.parallel import multihost as mh
    device = args.device
    if args.num_processes is not None and args.num_processes > 1:
        mh.initialize(coordinator_address=f"127.0.0.1:{args.port}",
                      num_processes=args.num_processes,
                      process_id=args.process_id, backend=args.backend,
                      device=args.device)
        device = mh.rank_device(args.device)
    try:
        if args.variant == "plan":
            run_plan_scenario(args.out, device=device,
                              diverge_rank=args.diverge_rank)
        elif args.variant == "ring":
            run_ring_scenario(args.out, device=device, rotate=args.rotate,
                              rings=args.rings)
        else:
            run_scenario(args.out, variant=args.variant, device=device,
                         init=args.init,
                         overrides=json.loads(args.overrides)
                         if args.overrides else None)
    finally:
        mh.shutdown()


if __name__ == "__main__":
    main()
