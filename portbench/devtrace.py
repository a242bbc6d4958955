"""The traced run's device trace: torch.profiler (CUPTI) over a few
whole rounds, read back from its events in memory.

  * the window: two instant markers, set after a synchronize at each
    end; its wall is the device trace's own clock between them;
  * busy time: the union of the device's kernel, copy and set
    intervals inside the window;
  * kernel regions: an observer armed through `hooks.arm` marks each
    of the program's `hooks.kernel_region`s on the launching thread
    with an instant marker; the first kernel launch that follows it on
    that thread is the region's (the wrappers launch one kernel each),
    and its device time is attributed to the region's name, never to a
    kernel symbol. Launches on other threads (autograd's, under
    --remat) follow no marker and are attributed to no region;
  * the breakdown: device time by region or kernel name, and the idle
    gaps by the host operation the launching thread was inside.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

MARK = "portbench.region."
BEGIN, END = "portbench.begin", "portbench.end"
LAUNCH_NAMES = ("LaunchKernel", "LaunchCooperativeKernel")


class RegionMarks:
    """The observer: each kernel region entered on the arming thread
    becomes an instant marker and an (name, shapes) entry, in order."""

    def __init__(self):
        self.entries: List[Tuple[str, tuple]] = []

    def on_kernel(self, entry) -> None:
        self.entries.append((entry.name, entry.shapes))
        with torch.profiler.record_function(MARK + entry.name):
            pass


class Launch(NamedTuple):
    region: str            # the region's name, or the kernel's
    shapes: Optional[tuple]
    ordinal: int           # this region's launches before it
    seconds: float


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    launches: List[Launch]           # region launches, in order
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _is_device(ev) -> bool:
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def _is_work(ev) -> bool:
    """A kernel, copy or set on the device; not a user annotation that
    the profiler mirrors onto the device's timeline."""
    annotation = getattr(ev, "is_user_annotation", None)
    return not ((annotation is not None and annotation())
                or ev.name().startswith("portbench.")
                or ev.name().startswith("ProfilerStep"))


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _events(prof) -> list:
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        raise RuntimeError("the profiler kept no kineto results")
    return list(results.events())


def analyze(prof, marks: RegionMarks, top: int = 10) -> Trace:
    evs = _events(prof)
    cpu = [e for e in evs if not _is_device(e)]
    dev = [e for e in evs if _is_device(e) and _is_work(e)]
    begin = next(e for e in cpu if e.name() == BEGIN)
    end = next(e for e in cpu if e.name() == END)
    lo, hi = begin.start_ns(), end.start_ns()
    main = begin.start_thread_id()

    kernels = {}
    spans = []
    for e in dev:
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        if t <= lo or s >= hi:
            continue
        spans.append((max(s, lo), min(t, hi)))
        kernels[e.correlation_id()] = e
    busy = _merge(spans)
    busy_ns = sum(b - a for a, b in busy)

    launches = sorted((e for e in cpu
                       if any(n in e.name() for n in LAUNCH_NAMES)
                       and lo <= e.start_ns() <= hi),
                      key=lambda e: e.start_ns())
    same_thread = any(e.start_thread_id() == main for e in launches)
    region_marks = sorted((e for e in cpu if e.name().startswith(MARK)
                           and lo <= e.start_ns() <= hi),
                          key=lambda e: e.start_ns())
    if len(region_marks) != len(marks.entries):
        raise RuntimeError(f"{len(region_marks)} region markers in the "
                           f"trace, {len(marks.entries)} regions entered")
    label = {}
    out: List[Launch] = []
    seen: Dict[str, int] = defaultdict(int)
    i = 0
    for mark, (name, shapes) in zip(region_marks, marks.entries):
        while i < len(launches) and (
                launches[i].start_ns() < mark.start_ns()
                or (same_thread and launches[i].start_thread_id()
                    != mark.start_thread_id())):
            i += 1
        if i == len(launches):
            break
        k = kernels.get(launches[i].correlation_id())
        i += 1
        if k is None:
            continue
        label[id(k)] = name
        out.append(Launch(name, shapes, seen[name], k.duration_ns() / 1e9))
        seen[name] += 1

    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        if t > lo and s < hi:
            by_name[label.get(id(e), e.name()[:120])] += (
                min(t, hi) - max(s, lo)) / 1e9

    host = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in cpu if e.start_thread_id() == main
                  and not e.name().startswith(MARK)
                  and e.duration_ns() > 0)
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        name = "host python (no operation)"
        # the innermost host operation holding the gap's middle: the
        # latest to start among those that have not ended
        j = bisect.bisect_right(starts, mid) - 1
        for h in host[max(0, j - 4096):j + 1][::-1]:
            if h[1] > mid:
                name = h[2]
                break
        gaps[name] += (b - a) / 1e9

    def ranked(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:top]

    return Trace((hi - lo) / 1e9, busy_ns / 1e9, out, ranked(by_name),
                 ranked(gaps))


class Profiler:
    """Profiles from `start()` to `stop()`, each after a synchronize,
    with the region observer armed on this thread between them."""

    def __init__(self):
        from commefficient_tpu_torch import hooks
        self.hooks = hooks
        self.marks = RegionMarks()
        self.prof = None

    @staticmethod
    def warm(device) -> None:
        """The profiler's first start initializes CUPTI: pay it in
        set-up."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        with torch.profiler.record_function(BEGIN):
            pass
        self.hooks.arm(self.marks)

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.hooks.disarm(self.marks)
        with torch.profiler.record_function(END):
            pass
        self.prof.stop()
