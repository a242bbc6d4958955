"""Multi-process runtime: the port of
commefficient_tpu/parallel/multihost.py.

The JAX package runs one process per host, each addressing several
devices, all running one SPMD program over a global mesh. PyTorch's
idiom, and the reference's own topology (one worker process per GPU
over torch.distributed), is one process per device: a mesh position
becomes a RANK, and every cross-device sum an explicit collective over
a process group (parallel/mesh.Layout).

  * `initialize` wraps torch.distributed.init_process_group behind the
    bounded connect policy of the JAX package (utils/retry's
    rendezvous triage), idempotent.
  * `process_count` / `process_index` / `is_coordinator` /
    `is_multihost` / `is_distributed`: the world and the rank-0 guard
    for logging, checkpoint writes and the journal.
  * `local_row_slice` / `apply_feed_slices`: the contiguous block of a
    [num_rows, ...] round batch a rank feeds (its loaders materialize
    only those rows).
  * `gather_host` / `sync_processes`: a host copy, and the barrier that
    orders checkpoint writes.

Devices. Each rank runs on cuda:{rank % torch.cuda.device_count()}
unless the caller asks for the CPU, as the tests do (`rank_device`).
On one card every rank lands on cuda:0.

Backends. `initialize(backend=None)` takes nccl for a CUDA device and
gloo for the CPU. NCCL refuses two ranks on one device, so a caller
that runs several ranks on one card passes backend="gloo" itself; a
failing NCCL init raises and never falls back to gloo. Gloo offers
only all_reduce and broadcast on CUDA tensors (no all_gather, no
reduce_scatter), so every collective of the port is written on those
two (a gather of blocks is a broadcast from each rank; a gather of rows
by client id an all_reduce of a zero buffer into which each rank writes
the rows it holds): the same code runs on gloo over the CPU, on gloo
over one shared card, and on NCCL over several.

No counterpart: the JAX package's `globalize`, `shard_rows`,
`globalize_owned`, `zeros` and `tile_rows` lift host values into
global arrays sharded over a process's several devices. One rank holds
one device here, so every host value a rank holds is already the
"global" one, its batch rows are its own tensors, and its share of the
client rows is a plain tensor of its block (federated/round.py).
"""
from __future__ import annotations

import datetime
from typing import Optional

import numpy as np
import torch

_initialized = False


def rank_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """The device rank `rank` (default: this process's) runs on: the
    CPU when `device` is the CPU, else cuda:{rank % device_count}.
    Raises without a GPU (device.resolve_device's rule)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the ranks on the CPU")
    rank = process_index() if rank is None else int(rank)
    return torch.device("cuda", rank % torch.cuda.device_count())


def resolve_backend(backend: Optional[str], device="cuda") -> str:
    """`backend`, or by default nccl for a CUDA device and gloo for the
    CPU."""
    if backend:
        return backend
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               connect_timeout_s: float = 300.0,
               connect_retries: int = 3,
               retry_sleep=None,
               backend: Optional[str] = None,
               device="cuda") -> None:
    """torch.distributed.init_process_group over
    tcp://`coordinator_address` with `num_processes` ranks, this one
    `process_id`, each attempt capped at `connect_timeout_s`.

    A TRANSIENT failure of the rendezvous (a refused or reset
    connection, a timed-out store: utils/retry.is_rendezvous_transient)
    is retried up to `connect_retries` more times with exponential
    backoff; a failed attempt's half-built process group is destroyed
    first, so the retry is a fresh one. Fatal errors (bad arguments, a
    backend that refuses the device) raise at once. A second call is a
    no-op. `retry_sleep` overrides the backoff sleep (tests)."""
    global _initialized
    if _initialized:
        return
    import torch.distributed as dist

    from commefficient_tpu_torch.utils.retry import (
        is_rendezvous_transient, with_retries,
    )
    if not coordinator_address or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize needs coordinator_address (host:port), "
            "num_processes and process_id: nothing on a GPU machine "
            "announces the process grid")
    be = resolve_backend(backend, device)
    if be == "nccl":
        # the rank's card before the communicator is built
        torch.cuda.set_device(rank_device(device, process_id))

    def attempt():
        try:
            dist.init_process_group(
                be, init_method=f"tcp://{coordinator_address}",
                world_size=int(num_processes), rank=int(process_id),
                timeout=datetime.timedelta(seconds=connect_timeout_s))
        except (RuntimeError, ValueError, OSError):
            # a failed connect may leave a half-built default group, and
            # the next init would then raise "already initialized",
            # masking the real error: tear it down, then re-raise for
            # the transient/fatal triage
            if dist.is_initialized():
                try:
                    dist.destroy_process_group()
                except (RuntimeError, ValueError, OSError):
                    pass
            raise

    retry_kw = {} if retry_sleep is None else {"sleep": retry_sleep}
    with_retries(attempt, retries=connect_retries,
                 classify=is_rendezvous_transient,
                 describe=f"torch.distributed init ({be}, "
                          f"{coordinator_address})", **retry_kw)
    _initialized = True


def initialize_from_config(cfg) -> None:
    """Driver entry: --coordinator_address / --num_processes /
    --process_id (config.py flags), on the run's --device."""
    initialize(
        coordinator_address=cfg.coordinator_address or None,
        num_processes=cfg.num_processes if cfg.num_processes > 0 else None,
        process_id=cfg.process_id if cfg.process_id >= 0 else None,
        device=cfg.device)


def shutdown() -> None:
    """Destroy the default process group (a no-op when none exists), so
    a rank process exits cleanly."""
    global _initialized
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def is_distributed() -> bool:
    """Whether this process is a rank of a torch.distributed world (of
    one rank too: an NCCL world of one runs the collectives)."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    if not is_distributed():
        return 1
    import torch.distributed as dist
    return dist.get_world_size()


def process_index() -> int:
    if not is_distributed():
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def is_coordinator() -> bool:
    """True on the rank that owns logging, checkpoint writes and the
    journal (the reference's rank-0 PS process)."""
    return process_index() == 0


def is_multihost() -> bool:
    return process_count() > 1


def local_row_slice(layout, num_rows: int) -> slice:
    """The contiguous block of a [num_rows, ...] clients-sharded round
    array this rank feeds: its clients position's share. One rank holds
    one mesh position, so the block is always contiguous (the JAX
    package's non-contiguity error has no counterpart); every rank of a
    model row feeds the same block."""
    if layout is None:
        if num_rows < 0:
            raise ValueError(f"num_rows={num_rows} < 0")
        return slice(0, num_rows)
    return layout.local_row_slice(num_rows)


def apply_feed_slices(model, train_loader, val_loader,
                      num_train_rows: int, num_val_rows: int) -> None:
    """Driver-side wiring of per-rank batch feeding (both trainers):
    both row slices are computed before either is assigned, so a
    divisibility error leaves both loaders global."""
    train_sl = local_row_slice(model.layout, num_train_rows)
    val_sl = local_row_slice(model.layout, num_val_rows)
    train_loader.feed_slice = train_sl
    val_loader.feed_slice = val_sl


def gather_host(x) -> np.ndarray:
    """A host (numpy) copy of `x`. Every value a rank holds is already
    the global one here (module docstring), so this is a copy, never a
    collective."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def sync_processes(name: str = "barrier") -> None:
    """Cross-rank barrier (checkpoint write ordering), written as an
    all_reduce of one element so that gloo over a card serves it too;
    a no-op in a single-process run."""
    if not is_multihost():
        return
    import torch.distributed as dist
    dist.all_reduce(torch.zeros(1, dtype=torch.float32,  # graftlint: disable=GL007 -- the world's barrier, no layout axis
                                device=_collective_device()))


def _collective_device() -> torch.device:
    """Where a barrier's tensor lives: the rank's card under nccl, the
    CPU otherwise (gloo takes either)."""
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
