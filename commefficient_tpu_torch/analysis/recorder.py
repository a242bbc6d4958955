"""The round recorder: the port's counterpart of the JAX trace tiers'
tracing (commefficient_tpu/analysis/audit.trace_variant, numaudit.
trace_span, shardaudit.trace_mesh_program).

The port traces no program: a round is eager aten ops. `RoundRecorder`
is a `TorchDispatchMode` armed around one round; it records every aten
op the arming thread dispatches (forward and autograd backward alike)
as an `OpRecord`: the op, its tensor inputs and outputs (shape, dtype,
device), the Python scalars among its arguments, value ids (each
dispatched output is a new value; a tensor first seen as an input is
one of the round's inputs), whether it allocates (an output whose
storage no input shares) and the round stage it ran in.

What the mode cannot see, and what stands in for it:

  * the port's CUDA kernels are ctypes calls that never reach the
    dispatcher. Each kernel wrapper opens a `kernel_region` (the leaf
    module commefficient_tpu_torch/hooks.py) around its launch, or on
    the CPU around its plain version; the recorder writes the region as
    ONE kernel entry with the bytes and operations its bound counts
    (PERF.md section 6), and leaves every aten op dispatched inside it
    out of the tally. The CPU and the card therefore record the same
    kernel entries;
  * ops run on other Python threads (the --pipeline staging thread, the
    writer threads): the mode is per thread. The recorder records a
    round driven synchronously; with `count_foreign` it runs the CPU
    profiler over all threads beside the mode and reports how many
    top-level aten ops other threads dispatched while it was armed
    (`foreign_ops`, None where the profiler cannot follow threads), so
    a gap shows as a number;
  * `.numpy()`, and `.cpu()` of a CPU tensor, dispatch nothing.

`stage(name)` (hooks.py) labels the ops of a round stage (the train
round's `gather`, `round` and `scatter`), as the JAX tiers trace the
state-motion programs apart from the round program; the mode follows
autograd onto its device thread (PyTorch carries the mode stack there).

Torch is imported lazily: analysis/__init__ stays importable without it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time
from typing import Dict, List, Optional, Tuple

from commefficient_tpu_torch.hooks import (  # noqa: F401
    KernelEntry, arm, current_stage, disarm, in_region, stage,
)


# ---------------------------------------------------------------------------
# records

TensorMeta = Tuple[Tuple[int, ...], str, str]     # (shape, dtype, device)


def dtype_name(dt) -> str:
    """'float32', 'bfloat16', 'int64', 'bool' (numpy's names)."""
    return str(dt).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One recorded aten op, or (`kernel` set) one kernel entry."""
    op: str
    stage: Optional[str]
    ins: Tuple[TensorMeta, ...]
    outs: Tuple[TensorMeta, ...]
    in_vids: Tuple[int, ...]
    out_vids: Tuple[int, ...]
    scalars: Tuple[object, ...]
    kwargs: Tuple[Tuple[str, object], ...]
    allocates: bool
    kernel: Optional[KernelEntry] = None

    @property
    def signature(self) -> tuple:
        """(op, input shapes and dtypes): what a program digest hashes."""
        return (self.op, tuple((s, d) for s, d, _ in self.ins),
                tuple((s, d) for s, d, _ in self.outs))

    def kwarg(self, name: str, default=None):
        return dict(self.kwargs).get(name, default)


def _scalar(a):
    """A JSON-able form of one non-tensor argument, or None to drop."""
    import torch
    if isinstance(a, (bool, int, float)):
        return a
    if isinstance(a, torch.dtype):
        return dtype_name(a)
    if isinstance(a, torch.device):
        return str(a.type)
    if isinstance(a, (list, tuple)) and all(
            isinstance(x, (bool, int, float)) for x in a):
        return tuple(a)
    return None


def tensors_of(tree, out: Optional[list] = None) -> list:
    """The tensors of an op's arguments or outputs, in order (lists,
    tuples and dict values walked): a cheaper tree_flatten for the
    shapes aten takes."""
    import torch
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            tensors_of(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            tensors_of(x, out)
    return out


class RoundRecorder:
    """Arm with `with RoundRecorder() as rec:` around a round driven on
    this thread; `rec.records` are the ops in dispatch order. `names`
    maps round inputs to names (`name_inputs`), for the tiers'
    reports."""

    def __init__(self, count_foreign: bool = False):
        self.records: List[OpRecord] = []
        self.count_foreign = count_foreign
        self.foreign_ops: Optional[int] = None
        self.thread: Optional[int] = None
        self.seconds = 0.0
        self._mode = None
        self._vids = None
        self._next = itertools.count()
        self.names: Dict[int, str] = {}
        self._prof = None
        self._t0 = 0.0

    # -- value ids --------------------------------------------------------
    def _vid_in(self, t) -> int:
        v = self._vids.get(t)
        if v is None:
            v = next(self._next)
            self._vids[t] = v
        return v

    def _vid_out(self, t) -> int:
        v = next(self._next)
        self._vids[t] = v
        return v

    def name_inputs(self, prefix: str, tensors) -> None:
        """Name the tensors of a NamedTuple / dict / sequence as round
        inputs `prefix.field` (before they are dispatched on)."""
        import torch
        if hasattr(tensors, "_asdict"):
            items = tensors._asdict().items()
        elif isinstance(tensors, dict):
            items = tensors.items()
        else:
            items = enumerate(tensors)
        for k, t in items:
            if isinstance(t, torch.Tensor):
                self.names[self._vid_in(t)] = f"{prefix}.{k}"

    # -- recording --------------------------------------------------------
    def _record(self, func, args, kwargs, out) -> None:
        import torch
        t_in = tensors_of(kwargs, tensors_of(args))
        t_out = tensors_of(out)
        in_vids = tuple(self._vid_in(t) for t in t_in)
        storages = {_storage(t) for t in t_in}
        allocates = any(_storage(t) not in storages for t in t_out)
        out_vids = tuple(self._vid_out(t) for t in t_out)
        scalars = tuple(s for s in (_scalar(a) for a in args
                                    if not isinstance(a, torch.Tensor))
                        if s is not None)
        kw = tuple(sorted((k, s) for k, s in ((k, _scalar(v))
                                              for k, v in kwargs.items())
                          if s is not None))
        self.records.append(OpRecord(
            _op_name(func), current_stage(), tuple(_meta(t) for t in t_in),
            tuple(_meta(t) for t in t_out), in_vids, out_vids, scalars, kw,
            allocates))

    def on_kernel(self, entry: KernelEntry) -> None:
        self.records.append(OpRecord(
            "kernel." + entry.name, current_stage(), (), (), (), (), (), (),
            False, entry))

    # -- arming -----------------------------------------------------------
    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.weak import WeakIdKeyDictionary
        rec = self

        class _Mode(TorchDispatchMode):
            # the port compiles nothing: no Dynamo guard around the hook,
            # whose first use imports Dynamo (seconds) and which costs each op
            @classmethod
            def _should_skip_dynamo(cls):
                return False

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if not in_region():
                    rec._record(func, args, kwargs, out)
                return out

        self._vids = WeakIdKeyDictionary()
        self._t0 = time.perf_counter()
        if self.count_foreign:
            self._start_profiler()
        self._mode = _Mode()
        self._mode.__enter__()
        arm(self)
        return self

    def __exit__(self, *exc):
        disarm(self)
        self._mode.__exit__(*exc)
        self._mode = None
        if self._prof is not None:
            self._stop_profiler()
        self.seconds = time.perf_counter() - self._t0
        return False

    def _start_profiler(self) -> None:
        import torch
        try:
            from torch._C._profiler import _ExperimentalConfig
            cfg = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            return      # this torch cannot follow other threads
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=cfg)
        self._prof.__enter__()
        with torch.profiler.record_function("cct_recorder_mark"):
            pass

    def _stop_profiler(self) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        events = prof.events()
        mine = {e.thread for e in events if e.name == "cct_recorder_mark"}
        self.foreign_ops = sum(
            1 for e in events
            if e.name.startswith("aten::") and e.thread not in mine
            and e.cpu_parent is None)

    # -- views ------------------------------------------------------------
    def ops(self, stage: Optional[str] = "*") -> List[OpRecord]:
        """The aten records (kernel entries left out) of one stage
        ("*": all)."""
        return [r for r in self.records if r.kernel is None
                and (stage == "*" or r.stage == stage)]

    def kernels(self) -> List[KernelEntry]:
        return [r.kernel for r in self.records if r.kernel is not None]

    def digest(self, stage: Optional[str] = "*") -> str:
        """sha256 of the (op, shapes, dtypes) sequence, kernel entries
        included: what `runtime.count_programs` counts as one program."""
        h = hashlib.sha256()
        for r in self.records:
            if stage == "*" or r.stage == stage:
                h.update(repr(r.signature if r.kernel is None
                              else ("kernel", r.kernel.name,
                                    r.kernel.shapes)).encode())
        return h.hexdigest()


def _op_name(func) -> str:
    """'aten.mm.default' -> 'mm.default'."""
    name = str(func)
    return name[5:] if name.startswith("aten.") else name


def _meta(t) -> TensorMeta:
    return (tuple(int(d) for d in t.shape), dtype_name(t.dtype),
            t.device.type)


def _storage(t) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return id(t)
