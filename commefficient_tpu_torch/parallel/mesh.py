"""The rank layout: the port of commefficient_tpu/parallel/mesh.py.

The JAX package lays devices out as a `clients` mesh axis (each device
simulates a block of the round's cohort) with an optional inner `model`
axis for tensor parallelism. Here a mesh position is a RANK (one
process, one device; parallel/multihost.py) and a mesh axis is a
process group: one clients group per model column (the ranks whose
cohort blocks are summed), one model group per clients row (the ranks
that split one block's model). `Layout` holds the arrangement, this
rank's position in it and the two groups, and runs the port's
collectives over them, each an all_reduce or a broadcast (module
docstring of multihost.py): `all_reduce` is the engine's `lax.psum`,
`gather` its `lax.all_gather` in cohort order (a broadcast from each
rank).

The constructors take a list of "devices", by default the ranks
0..world-1 (any object with an `id`, and optionally a `slice_index`,
stands in for one in the tests), and keep the JAX package's
arrangement rules and validation messages word for word:
`make_client_mesh`, `make_client_model_mesh`, and
`make_multihost_client_mesh`, whose --num_slices emulation puts device
i in slice i % num_slices and regroups the axis slice-major by a
stable argsort (a real permutation whenever num_slices > 1).
`default_layout` is FedModel's rule: the widest clients axis that
divides num_workers after --model_parallel.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

# the JAX package's axis names (analysis/domains.py), values unchanged
CLIENTS_AXIS = "clients"
MODEL_AXIS = "model"


def _world_devices() -> list:
    from commefficient_tpu_torch.parallel import multihost as mh
    return list(range(mh.process_count()))


def _rank_of(d) -> int:
    return int(getattr(d, "id", d))


class CollectiveStats:
    """Calls, bytes and host seconds of a layout's collectives (the
    parallel layer's metrics: PERF.md section 3). With `log` a list, each
    collective is also appended to it as (kind, axis, shape, dtype,
    round stage): what graftmesh and graftnum price
    (analysis/costmodel.collective_cost, reassociation_ulp_bound)."""

    def __init__(self):
        self.log: Optional[list] = None
        self.reset()

    def note(self, kind: str, axis: str, t: torch.Tensor) -> None:
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        if self.log is not None:
            from commefficient_tpu_torch.analysis.recorder import (
                current_stage, dtype_name,
            )
            self.log.append((kind, axis, tuple(int(d) for d in t.shape),
                             dtype_name(t.dtype), current_stage()))

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    def as_dict(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes,
                "seconds": self.seconds}


class Layout:
    """A (clients[, model]) arrangement of ranks, bound to this rank by
    `bind` (which builds the process groups when torch.distributed is
    up; unbound or unconnected, every collective is the identity)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        grid = self.devices.reshape(self.devices.shape[0], -1)
        self._grid = np.vectorize(_rank_of, otypes=[np.int64])(grid)
        self.rank: Optional[int] = None
        self.position = (0, 0)
        self.clients_group = None
        self.model_group = None
        self.connected = False
        self.stats = CollectiveStats()

    # -- shape ---------------------------------------------------------
    @property
    def shape(self) -> dict:
        out = {CLIENTS_AXIS: int(self._grid.shape[0])}
        if MODEL_AXIS in self.axis_names:
            out[MODEL_AXIS] = int(self._grid.shape[1])
        return out

    @property
    def clients(self) -> int:
        return int(self._grid.shape[0])

    @property
    def model(self) -> int:
        return int(self._grid.shape[1])

    @property
    def size(self) -> int:
        return int(self._grid.size)

    @property
    def ranks(self) -> np.ndarray:
        """[clients, model] rank ids."""
        return self._grid

    @property
    def clients_index(self) -> int:
        return self.position[0]

    @property
    def model_index(self) -> int:
        return self.position[1]

    def __repr__(self) -> str:
        return (f"Layout({self.shape}, ranks={self._grid.tolist()}, "
                f"rank={self.rank})")

    # -- binding -------------------------------------------------------
    def bind(self, rank: Optional[int] = None) -> "Layout":
        """Fix this process's rank and position, and under
        torch.distributed build every clients and model group (a
        collective call: every rank binds, in the same order). The
        world must hold exactly one rank per position."""
        from commefficient_tpu_torch.parallel import multihost as mh
        self.rank = mh.process_index() if rank is None else int(rank)
        where = np.argwhere(self._grid == self.rank)
        if len(where) != 1:
            raise ValueError(
                f"rank {self.rank} holds no single position of the layout "
                f"{self._grid.tolist()}")
        self.position = (int(where[0][0]), int(where[0][1]))
        world = mh.process_count()
        if world != self.size:
            raise ValueError(
                f"the layout has {self.size} positions and the world "
                f"{world} ranks: the port runs one rank on every "
                "position")
        if mh.is_distributed():
            import torch.distributed as dist
            for j in range(self.model):
                g = dist.new_group(ranks=[int(r) for r in self._grid[:, j]])
                if j == self.model_index:
                    self.clients_group = g
            for i in range(self.clients):
                g = dist.new_group(ranks=[int(r) for r in self._grid[i, :]])
                if i == self.clients_index:
                    self.model_group = g
            self.connected = True
        return self

    # -- feeding -------------------------------------------------------
    def local_row_slice(self, num_rows: int) -> slice:
        """This rank's contiguous block of a [num_rows, ...]
        clients-sharded array."""
        n = self.clients
        if num_rows % n:
            raise ValueError(f"num_rows={num_rows} not divisible by the "
                             f"{n}-way clients axis")
        per = num_rows // n
        ci = self.clients_index
        return slice(ci * per, (ci + 1) * per)

    # -- collectives ---------------------------------------------------
    def _group(self, axis: str):
        return self.clients_group if axis == CLIENTS_AXIS \
            else self.model_group

    def axis_size(self, axis: str) -> int:
        return self.clients if axis == CLIENTS_AXIS else self.model

    def axis_index(self, axis: str) -> int:
        return (self.clients_index if axis == CLIENTS_AXIS
                else self.model_index)

    def all_reduce(self, t: torch.Tensor, axis: str = CLIENTS_AXIS
                   ) -> torch.Tensor:
        """The sum of `t` over `axis` (lax.psum), in place on a
        contiguous `t`, returned; the identity when not connected."""
        if not self.connected:
            return t
        import torch.distributed as dist
        if not t.is_contiguous():
            t = t.contiguous()
        t0 = time.perf_counter()
        dist.all_reduce(t, group=self._group(axis))
        self.stats.note("all_reduce", axis, t)
        self.stats.seconds += time.perf_counter() - t0
        return t

    def gather(self, t: torch.Tensor, axis: str = CLIENTS_AXIS,
               dim: int = 0, sizes=None) -> torch.Tensor:
        """Every rank's `t` along `axis`, concatenated on `dim` in axis
        order (lax.all_gather(..., tiled=True)): one broadcast from each
        rank, so each block crosses once, exactly. `sizes`: each rank's
        extent on `dim` where they differ (default: `t`'s own); the
        identity when not connected."""
        if not self.connected:
            return t
        import torch.distributed as dist
        ranks = (self._grid[:, self.model_index] if axis == CLIENTS_AXIS
                 else self._grid[self.clients_index, :])
        me = self.axis_index(axis)
        dim = dim % t.dim()
        parts = []
        t0 = time.perf_counter()
        for i, src in enumerate(ranks):
            if i == me:
                buf = t.contiguous()
            else:
                shape = list(t.shape)
                shape[dim] = t.shape[dim] if sizes is None else int(sizes[i])
                buf = t.new_empty(shape)
            dist.broadcast(buf, src=int(src), group=self._group(axis))
            parts.append(buf)
            self.stats.note("broadcast", axis, buf)
        self.stats.seconds += time.perf_counter() - t0
        return torch.cat(parts, dim=dim)

    def block(self, t: torch.Tensor, axis: str = CLIENTS_AXIS,
              dim: int = 0) -> torch.Tensor:
        """This rank's block of a gathered `t` (the inverse of
        gather)."""
        n = self.axis_size(axis)
        size = t.shape[dim] // n
        return t.narrow(dim, self.axis_index(axis) * size, size)


def make_client_mesh(num_client_shards: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> Layout:
    """1-D layout over the `clients` axis."""
    devices = list(devices) if devices is not None else _world_devices()
    n = num_client_shards or len(devices)
    if n > len(devices):
        raise ValueError(f"asked for {n} shards, have {len(devices)} devices")
    return Layout(np.asarray(devices[:n], dtype=object), (CLIENTS_AXIS,))


def make_client_model_mesh(num_client_shards: int, model_parallel: int,
                           devices: Optional[Sequence] = None) -> Layout:
    """2-D (clients, model) layout, model innermost: rank r sits at
    (r // model_parallel, r % model_parallel)."""
    devices = list(devices) if devices is not None else _world_devices()
    need = num_client_shards * model_parallel
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need], dtype=object).reshape(
        num_client_shards, model_parallel)
    return Layout(arr, (CLIENTS_AXIS, MODEL_AXIS))


def slice_balanced_prefix(devices: Sequence, count: int) -> Optional[list]:
    """Pick `count` devices spread EQUALLY across physical slices
    (slice-major order), or None when that isn't possible: a flat prefix
    can span slices unevenly (2 slices x 4 devices, count=6 -> 4+2).
    Callers fall back to a flat layout on None."""
    devices = list(devices)
    slices: dict = {}
    for d in devices:
        slices.setdefault(getattr(d, "slice_index", 0) or 0, []).append(d)
    n_sl = len(slices)
    if n_sl <= 1:
        return devices[:count] if count <= len(devices) else None
    per = count // n_sl
    if per * n_sl != count:
        return None
    if any(len(g) < per for g in slices.values()):
        return None
    out = []
    for k in sorted(slices):
        out.extend(slices[k][:per])
    return out


def make_multihost_client_mesh(model_parallel: int = 1,
                               devices: Optional[Sequence] = None,
                               num_slices: Optional[int] = None) -> Layout:
    """Layout spanning every slice of a multi-slice job: the `clients`
    axis slice-major (slices outer), the optional `model` axis
    innermost, so the round's one table-sized all-reduce is the only
    traffic that crosses slices.

    Devices that report a `slice_index` are grouped by it (real
    topology wins: a `num_slices` that disagrees raises). Otherwise
    `num_slices` emulates the layout: device i joins slice
    i % num_slices and the axis is regrouped slice-major by a stable
    argsort, a genuine permutation of the flat order, so tests run a
    non-identity placement (the results must not depend on it). The
    emulation is for correctness testing only."""
    devices = list(devices) if devices is not None else _world_devices()
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_parallel={model_parallel}")
    clients = n // model_parallel

    real_slices = {getattr(d, "slice_index", 0) or 0 for d in devices}
    if len(real_slices) > 1:
        n_sl = len(real_slices)
        if num_slices is not None and num_slices != n_sl:
            raise ValueError(
                f"num_slices={num_slices} but the devices report "
                f"{n_sl} physical slices")
        if clients % n_sl:
            raise ValueError(f"clients axis {clients} not divisible by "
                             f"{n_sl} slices")
        # slice-major, each slice's devices in their given order
        order = np.argsort([getattr(d, "slice_index", 0) or 0
                            for d in devices], kind="stable")
    else:
        n_sl = num_slices or 1
        if clients % n_sl:
            raise ValueError(f"clients axis {clients} not divisible by "
                             f"num_slices={n_sl}")
        order = np.argsort([i % n_sl for i in range(n)], kind="stable")
    arr = np.asarray(devices, dtype=object)[order].reshape(
        clients, model_parallel)
    if model_parallel == 1:
        return Layout(arr.reshape(-1), (CLIENTS_AXIS,))
    return Layout(arr, (CLIENTS_AXIS, MODEL_AXIS))


def default_layout(cfg, devices: Optional[Sequence] = None) -> Layout:
    """FedModel's layout when none is given (the JAX FedModel's mesh
    rule): the widest clients axis that divides num_workers after
    reserving the model_parallel factor, slice-balanced, slice-major
    under --num_slices."""
    devices = list(devices) if devices is not None else _world_devices()
    mp = max(cfg.model_parallel, 1)
    if len(devices) < mp:
        raise ValueError(
            f"model_parallel={mp} needs at least {mp} devices, "
            f"have {len(devices)}")
    n = min(len(devices) // mp, max(cfg.num_workers, 1))
    while cfg.num_workers % n:
        n -= 1
    picked = slice_balanced_prefix(devices, n * mp)
    if picked is not None:
        return make_multihost_client_mesh(
            model_parallel=mp, devices=picked,
            num_slices=cfg.num_slices if cfg.num_slices > 1 else None)
    if mp == 1:
        return make_client_mesh(n, devices)
    return make_client_model_mesh(n, mp, devices=devices[:n * mp])
