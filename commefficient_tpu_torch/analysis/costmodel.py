"""Static cost model over recorded rounds: the port of
commefficient_tpu/analysis/costmodel.py.

The JAX model prices the equations of a traced program; this one prices
the ops a `recorder.RoundRecorder` wrote, with the same `Cost` fields and
the same pricing rules, so a drift in the port's committed baseline
(analysis/baselines/audit.json) is a change of the round someone must
look at:

  * FLOPs: `mm`, `bmm`, `addmm`, `baddbmm`, `mv`, `dot` and `linear`
    cost 2 M N K (`dot_general`'s count); `convolution` and each output
    of `convolution_backward` cost `_conv_flops`' 2 x outputs x the
    products a output reads (for a stride-1 convolution each gradient
    costs the forward's); `sort` and `topk` are comparison networks
    (n ceil(log2 width), n ceil(log2 k)); reducers cost their input
    size; data movement (casts, copies, indexing, concatenation) costs
    0; everything else one op an output element.
  * bytes: every op priced un-fused, operands read and outputs written
    once; views (which move nothing in PyTorch) are free.
  * kernel entries (hooks.kernel_region) cost their own bytes and
    operations, the ones the kernel's bound counts.

The second half is the collective model of graftmesh and graftnum
(`MeshLinkModel`, `CollectiveRecord`, `CollectiveCost`,
`reassociation_ulp_bound`), the JAX package's arithmetic over the
collectives a `parallel/mesh.Layout` logged (`CollectiveStats.log`)
instead of jaxpr equations.

Stdlib only; it reads records, never tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# views: PyTorch moves nothing for them
_VIEWS = frozenset({
    "view", "_unsafe_view", "_reshape_alias", "reshape", "expand",
    "expand_as", "permute", "transpose", "t", "squeeze", "unsqueeze",
    "slice", "select", "alias", "detach", "as_strided", "narrow",
    "split", "split_with_sizes", "unbind", "diagonal", "view_as",
    "unfold", "lift_fresh", "_to_copy_view", "movedim",
})

# data movement: FLOPs 0, bytes priced (the JAX package's _DATA_MOVEMENT)
_DATA_MOVEMENT = frozenset({
    "clone", "copy_", "_to_copy", "contiguous", "cat", "stack",
    "constant_pad_nd", "pad", "index", "index_select", "gather",
    "scatter", "index_put_", "index_put", "_index_put_impl_",
    "index_copy_", "index_copy", "masked_scatter_", "flip", "roll",
    "repeat", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
    "ones_like", "new_ones", "full", "full_like", "new_full", "arange",
    "scalar_tensor", "fill_", "zero_", "fill", "set_", "resize_",
    "_local_scalar_dense", "embedding", "tril", "triu", "nonzero",
})

# reducers: one op per INPUT element
_REDUCERS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
    "argmin", "any", "all", "cumsum", "cumprod", "norm",
    "linalg_vector_norm", "var", "std", "var_mean", "std_mean",
    "logsumexp", "median", "nanmedian", "count_nonzero",
})

_MATMULS = frozenset({"mm", "bmm", "addmm", "baddbmm", "mv", "dot",
                      "linear", "addmv", "matmul"})
_CONVS = frozenset({"convolution", "convolution_backward",
                    "_convolution"})

_ITEMSIZE = {"float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
             "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
             "bool": 1, "complex64": 8, "complex128": 16, "uint32": 4,
             "uint64": 8, "uint16": 2}


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def meta_bytes(meta) -> int:
    """Bytes of one (shape, dtype, device) tensor meta."""
    shape, dtype = meta[0], meta[1]
    return _numel(shape) * _ITEMSIZE.get(dtype, 4)


def base_op(op: str) -> str:
    """'addmm.default' -> 'addmm', 'add_.Tensor' -> 'add_'."""
    return op.split(".", 1)[0]


def _log2ceil(n: int) -> int:
    return max(1, math.ceil(math.log2(max(int(n), 2))))


class Cost:
    """Accumulator: total flops/bytes + per-op rollup (the JAX Cost's
    fields: `eqns` counts the ops, `dynamic_loops` stays 0, the port
    records every iteration)."""

    def __init__(self):
        self.flops = 0
        self.hbm_bytes = 0
        self.eqns = 0
        self.dynamic_loops = 0
        self.by_primitive: Dict[str, Dict[str, int]] = {}

    def add(self, prim: str, flops: int, hbm_bytes: int) -> None:
        self.flops += int(flops)
        self.hbm_bytes += int(hbm_bytes)
        self.eqns += 1
        row = self.by_primitive.setdefault(
            prim, {"count": 0, "flops": 0, "hbm_bytes": 0})
        row["count"] += 1
        row["flops"] += int(flops)
        row["hbm_bytes"] += int(hbm_bytes)

    def as_dict(self, top: int = 8) -> dict:
        """The JAX Cost.as_dict: the `top` ops by FLOPs (ties by bytes,
        then name) and an `other` rollup."""
        rows = sorted(self.by_primitive.items(),
                      key=lambda kv: (-kv[1]["flops"],
                                      -kv[1]["hbm_bytes"], kv[0]))
        head = {k: dict(v) for k, v in rows[:top]}
        tail = rows[top:]
        if tail:
            head["other"] = {
                "count": sum(v["count"] for _, v in tail),
                "flops": sum(v["flops"] for _, v in tail),
                "hbm_bytes": sum(v["hbm_bytes"] for _, v in tail),
            }
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "eqns": self.eqns, "dynamic_loops": self.dynamic_loops,
                "by_primitive": head}


def _matmul_flops(op: str, ins) -> int:
    shapes = [m[0] for m in ins]
    if op in ("addmm", "baddbmm", "addmv"):
        shapes = shapes[1:]
    if op == "linear":
        x, w = shapes[0], shapes[1]
        return 2 * _numel(x[:-1]) * int(w[0]) * int(x[-1])
    if op == "dot":
        return 2 * _numel(shapes[0])
    if op in ("mv", "addmv"):
        m, k = shapes[0]
        return 2 * int(m) * int(k)
    a, b = shapes[0], shapes[1]
    batch = _numel(a[:-2])
    return 2 * batch * int(a[-2]) * int(a[-1]) * int(b[-1])


def conv_flops(rec) -> int:
    """`_conv_flops` of the JAX package: 2 x output elements x the
    products each reads. `convolution`: out x (C_in / groups) x kernel
    area; `convolution_backward` prices the outputs its mask asks for,
    the input gradient at input x (C_out / groups) x kernel area and
    the weight gradient at weight x N x the output's spatial size."""
    op = base_op(rec.op)
    scalars = list(rec.scalars)
    if op in ("convolution", "_convolution"):
        w = rec.ins[1][0]
        out = _numel(rec.outs[0][0])
        return 2 * out * (_numel(w) // max(int(w[0]), 1))
    grad_out, inp, w = (m[0] for m in rec.ins[:3])
    mask = scalars[-1] if scalars and isinstance(scalars[-1], tuple) \
        else (True, True, False)
    groups = scalars[-2] if len(scalars) >= 2 and isinstance(
        scalars[-2], int) and not isinstance(scalars[-2], bool) else 1
    area = _numel(w[2:])
    flops = 0
    if mask[0]:
        flops += 2 * _numel(inp) * (int(w[0]) // max(groups, 1)) * area
    if mask[1]:
        flops += 2 * _numel(w) * (_numel(grad_out) // max(int(w[0]), 1))
    return flops


def sort_width(rec) -> int:
    shape = rec.ins[0][0] if rec.ins else ()
    if not shape:
        return 2
    dim = rec.kwarg("dim")
    if dim is None:
        dim = next((s for s in rec.scalars if isinstance(s, int)
                    and not isinstance(s, bool)), -1)
    return int(shape[dim % len(shape)])


def op_cost(rec) -> Tuple[int, int]:
    """(FLOPs, bytes) of one OpRecord."""
    if rec.kernel is not None:
        return rec.kernel.flops, rec.kernel.bytes
    op = base_op(rec.op)
    if op in _VIEWS:
        return 0, 0
    nbytes = (sum(meta_bytes(m) for m in rec.ins)
              + sum(meta_bytes(m) for m in rec.outs))
    if op in _MATMULS:
        return _matmul_flops(op, rec.ins), nbytes
    if op in _CONVS:
        return conv_flops(rec), nbytes
    if op == "sort":
        n = _numel(rec.ins[0][0]) if rec.ins else 0
        return n * _log2ceil(sort_width(rec)), nbytes
    if op == "topk":
        n = _numel(rec.ins[0][0]) if rec.ins else 0
        k = next((s for s in rec.scalars if isinstance(s, int)
                  and not isinstance(s, bool)), 2)
        return n * _log2ceil(abs(k)), nbytes
    if op in _REDUCERS:
        return sum(_numel(m[0]) for m in rec.ins), nbytes
    if op in _DATA_MOVEMENT:
        return 0, nbytes
    return sum(_numel(m[0]) for m in rec.outs), nbytes


def records_cost(records: Iterable) -> Cost:
    """Price recorded ops (and kernel entries), the JAX `jaxpr_cost`."""
    cost = Cost()
    for rec in records:
        flops, nbytes = op_cost(rec)
        cost.add(rec.kernel.name if rec.kernel is not None
                 else base_op(rec.op), flops, nbytes)
    return cost


def class_flops(records: Iterable) -> Dict[str, int]:
    """{"matmul": ..., "conv": ...}: the FLOPs of the two op classes the
    JAX `dot_general` and `conv_general_dilated` price exactly."""
    out = {"matmul": 0, "conv": 0}
    for rec in records:
        if rec.kernel is not None:
            continue
        op = base_op(rec.op)
        if op in _MATMULS:
            out["matmul"] += _matmul_flops(op, rec.ins)
        elif op in _CONVS:
            out["conv"] += conv_flops(rec)
    return out


# ---------------------------------------------------------------------------
# per-link collective cost (graftmesh)
#
# The JAX package's model, over the port's collectives: a Layout logs
# each all_reduce (the engine's psum) and each broadcast of its gather
# (the all_gather, one broadcast a rank) with its axis, payload shape
# and dtype. Every collective is priced as a hierarchical ring (one ring
# stage per slice, one ring over the slices), an all_reduce at factor 2,
# a broadcast at factor 1.

_COLLECTIVE_FACTORS = {"all_reduce": 2, "broadcast": 1}


@dataclasses.dataclass(frozen=True)
class MeshLinkModel:
    """Link classes of one layout (the JAX package's fields):
    axis_sizes {axis: ranks along it}, axis_slices {axis: distinct
    slices one group along it spans} (1: one slice, the intra-slice
    link; S > 1: S slice groups, a stage over the inter-slice link)."""
    name: str
    axis_sizes: Tuple[Tuple[str, int], ...]
    axis_slices: Tuple[Tuple[str, int], ...]

    def size(self, axis: str) -> int:
        return dict(self.axis_sizes).get(axis, 1)

    def slices(self, axis: str) -> int:
        return dict(self.axis_slices).get(axis, 1)

    def as_dict(self) -> dict:
        return {"axes": {a: n for a, n in self.axis_sizes},
                "slices": {a: s for a, s in self.axis_slices}}


@dataclasses.dataclass
class CollectiveRecord:
    """One logged collective, priced (the JAX field names: `ici` is the
    intra-slice link, `dcn` the inter-slice one)."""
    kind: str
    axes: Tuple[str, ...]
    payload_bytes: int
    operand_shapes: Tuple[Tuple[int, ...], ...]
    mult: int
    ici_bytes: int
    dcn_bytes: int
    crosses_dcn: bool
    stage: Optional[str] = None


class CollectiveCost:
    """Per-link rollup of every collective in one program."""

    def __init__(self):
        self.records: List[CollectiveRecord] = []
        self.ici_bytes = 0
        self.dcn_bytes = 0
        self.dcn_collectives = 0

    def add(self, rec: CollectiveRecord) -> None:
        self.records.append(rec)
        self.ici_bytes += rec.ici_bytes
        self.dcn_bytes += rec.dcn_bytes
        if rec.crosses_dcn:
            self.dcn_collectives += rec.mult

    def as_dict(self) -> dict:
        by_kind: Dict[str, Dict[str, int]] = {}
        for r in self.records:
            row = by_kind.setdefault(r.kind, {"count": 0, "bytes": 0})
            row["count"] += r.mult
            row["bytes"] += r.ici_bytes + r.dcn_bytes
        return {"ici_bytes": self.ici_bytes, "dcn_bytes": self.dcn_bytes,
                "dcn_collectives": self.dcn_collectives,
                "collectives": {k: dict(by_kind[k]) for k in sorted(by_kind)}}


def price_collective(entry, link: MeshLinkModel) -> CollectiveRecord:
    """One Layout log entry (kind, axis, shape, dtype, stage) priced."""
    kind, axis, shape, dtype = entry[:4]
    stage = entry[4] if len(entry) > 4 else None
    factor = _COLLECTIVE_FACTORS[kind]
    payload = _numel(shape) * _ITEMSIZE.get(dtype, 4)
    n = link.size(axis)
    s = max(link.slices(axis), 1)
    n_inner = max(n // s, 1)
    ici = factor * (n_inner - 1) * payload * s
    dcn = factor * (s - 1) * payload if s > 1 else 0
    return CollectiveRecord(
        kind=kind, axes=(axis,), payload_bytes=payload,
        operand_shapes=(tuple(int(d) for d in shape),), mult=1,
        ici_bytes=ici, dcn_bytes=dcn, crosses_dcn=s > 1, stage=stage)


def collective_cost(log: Sequence, link: MeshLinkModel) -> CollectiveCost:
    """Price every logged collective over `link`."""
    cost = CollectiveCost()
    for entry in log:
        cost.add(price_collective(entry, link))
    return cost


# ---------------------------------------------------------------------------
# reassociation ulp bound (graftnum): the JAX package's Higham bound,
# (participants - 1) result-ulps per float sum-type collective, over the
# all_reduces a Layout logged; integer all_reduces are exact and free

_FLOAT_PREFIXES = ("float", "bfloat")


def reassociation_ulp_bound(log: Sequence, axis_sizes: Dict[str, int],
                            default_axis_size: int = 2) -> int:
    total = 0
    for entry in log:
        kind, axis, _shape, dtype = entry[:4]
        if kind != "all_reduce" or not str(dtype).startswith(
                _FLOAT_PREFIXES):
            continue
        n = max(int(axis_sizes.get(axis, default_axis_size)), 1)
        if n > 1:
            total += n - 1
    return int(total)
