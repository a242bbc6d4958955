"""Checkpoint / resume: the port of commefficient_tpu/utils/checkpoint.py,
on-disk format key for key, so a checkpoint written by either package
resumes in the other (the two share the flat parameter layout).

One .npz holds the whole training state: `ps_weights`, `Vvelocity`,
`Verror`, `round_idx` (int32), `scheduler_step`; the per-client rows as
the O(cohort) `crows_*` payload (ids of the clients ever sampled, their
rows, and under --topk_down the init weights the others rebuild from)
or the legacy dense `client_*` blocks; the accountant (`acct_*`,
`acct_prev_change_words`), the throughput tracker (`thr_*`), the
sampler's stream (`smp_*`) and the config fingerprint (`fp_*`). The
JAX package's scheduler (`sched_*`) and async-admission (`asyb_*`)
keys are read and carried; the port writes them back as it read them.

Every write lands in `<path>.tmp`, is fsynced and `os.replace`d over
the real name, so a preemption mid-write leaves the previous file
intact. `save_rotating` keeps the newest `keep_last` round-stamped
files and a `<prefix>.latest` JSON manifest with each file's per-array
CRC32s and a finite bit; `load_resilient` walks that rotation
newest-first and falls back past a corrupt file.

`transfer_for_finetune` (--finetune) carries an old model's weights
into a new one and says which coordinates it froze.

`AsyncCheckpointWriter` (--pipeline) moves the serialization, fsync,
rename and manifest of `save_rotating(..., writer=)` onto one bounded
FIFO writer thread; the device-to-host gather stays on the caller's
thread.

In a multi-rank run (parallel/) the client rows reach the writers
already gathered by the model (FedModel.client_rows_payload, or
checkpoint_clients in chunks); the coordinator alone writes the file,
the manifest and the fixed copy, and every rank then waits at a
barrier, so no rank runs ahead of a half-written checkpoint. A load
reads the file on every rank and each installs its own block
(FedModel.load_state).
"""
from __future__ import annotations

import errno
import glob as _glob
import json
import os
import queue
import shutil
import threading
import time
import zipfile
import zlib
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from commefficient_tpu_torch.federated.round import ClientState, ServerState
from commefficient_tpu_torch.models.convert import load_flat
from commefficient_tpu_torch.ops.flat import flatten_params, module_layout
from commefficient_tpu_torch.parallel import multihost as mh
from commefficient_tpu_torch.telemetry.trace import TRACE
from commefficient_tpu_torch.utils.atomic_io import atomic_write_text
from commefficient_tpu_torch.utils.watchdog import drain_queue

# the config fields a checkpoint must agree on to load into a run
# (order fixed; serialized as strings)
FINGERPRINT_FIELDS = ("mode", "grad_size", "num_clients", "error_type")


class CheckpointMismatchError(ValueError):
    """A checkpoint written under a different config, naming the first
    offending fingerprint field."""

    def __init__(self, path: str, field: str, found, expected):
        self.field, self.found, self.expected = field, found, expected
        super().__init__(
            f"checkpoint {path!r} does not match this run's config: "
            f"{field}: checkpoint has {found!r}, this run expects "
            f"{expected!r}. Point --checkpoint_path at a checkpoint "
            f"written with the same mode/model/client-count, or start "
            f"fresh without --resume.")


def config_fingerprint(cfg, num_clients: Optional[int] = None) -> dict:
    """The compatibility fingerprint embedded in every checkpoint."""
    return {
        "mode": cfg.mode,
        "grad_size": int(cfg.grad_size),
        "num_clients": int(num_clients if num_clients is not None
                           else (cfg.num_clients or 0)),
        "error_type": cfg.error_type,
    }


def validate_fingerprint(found: dict, expected: dict,
                         path: str) -> None:
    """Raise CheckpointMismatchError on the first field where `found`
    disagrees with `expected`; fields absent from `found` are skipped,
    values compare as strings."""
    for k in FINGERPRINT_FIELDS:
        if k in found and str(found[k]) != str(expected[k]):
            raise CheckpointMismatchError(path, k, found[k], expected[k])


class AsyncCheckpointWriter:
    """A bounded-queue writer thread for checkpoint persistence
    (--pipeline). Jobs (write closures) run strictly FIFO on one thread,
    so a stamped file lands before its manifest entry and the rotation
    order holds; the atomic `.tmp` + os.replace discipline is the
    synchronous one's. The queue holds `max_pending` jobs (default one
    running plus one queued), so a slow disk back-pressures the round
    loop. `drain()` blocks until every submitted write is durable and
    re-raises the writer's first failure on the caller's thread;
    `submit` re-raises an earlier job's failure too. `drain_timeout`
    (--writer_drain_timeout_s) bounds drain() and close()
    (utils/watchdog)."""

    _SENTINEL = object()

    def __init__(self, max_pending: int = 2, drain_timeout: float = 0.0,
                 name: str = "checkpoint"):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(max_pending, 1))
        # the writer's first failure, handed to the caller's thread
        self._exc: Optional[BaseException] = None
        self._exc_lock = threading.Lock()
        self._closed = False
        self._drain_timeout = float(drain_timeout)
        self._name = str(name)
        # submission sequence: the enqueue instant and the writer-side
        # qwait / write spans of one job share it
        self._seq = 0
        self._thread = threading.Thread(
            target=self._run, name=f"{name}-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is self._SENTINEL:
                    return
                job, enq_mono, seq, tags = item
                try:
                    if enq_mono is not None:
                        TRACE.record(f"{self._name}_qwait", enq_mono,
                                     time.monotonic(), seq=seq, **tags)
                        with TRACE.span(f"{self._name}_write", seq=seq,
                                        **tags):
                            job()
                    else:
                        job()
                # re-raised on the caller's thread by drain() / submit()
                except BaseException as e:  # graftlint: disable=GL005 -- re-raised on the caller's thread
                    with self._exc_lock:
                        if self._exc is None:
                            self._exc = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        with self._exc_lock:
            exc, self._exc = self._exc, None
        if exc is not None:
            raise exc

    def submit(self, job: Callable[[], None]) -> None:
        """Queue one write closure; blocks while the queue is full."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        self._raise_pending()
        if TRACE.enabled:
            seq, self._seq = self._seq, self._seq + 1
            tags = TRACE.current_tags()
            TRACE.instant(f"{self._name}_enqueue", seq=seq,
                          q=self._q.qsize(), **tags)
            self._q.put((job, time.monotonic(), seq, tags))
        else:
            self._q.put((job, None, 0, {}))

    def drain(self) -> None:
        """Block until every submitted write is durable; re-raise the
        first writer-side failure here."""
        drain_queue(self._q, self._drain_timeout, self._name)
        self._raise_pending()

    def close(self) -> None:
        """Drain, then stop the thread. Idempotent."""
        if self._closed:
            return
        drain_queue(self._q, self._drain_timeout, self._name)
        self._closed = True
        self._q.put(self._SENTINEL)
        self._thread.join()
        self._raise_pending()


class Checkpoint(NamedTuple):
    """Loaded training state, as CPU tensors (server, dense client
    blocks) and numpy arrays (everything else). `clients` and
    `client_rows` are exclusive: the O(cohort) payload or the dense
    blocks."""
    server: ServerState
    clients: Optional[ClientState]
    scheduler_step: int
    accountant_state: Optional[dict] = None
    prev_change_words: Optional[np.ndarray] = None
    fingerprint: Optional[dict] = None
    throughput: Optional[dict] = None
    scheduler: Optional[dict] = None
    sampler: Optional[dict] = None
    client_rows: Optional[dict] = None
    async_admit: Optional[dict] = None


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, server: ServerState,
                    clients: Optional[ClientState] = None,
                    scheduler_step: int = 0,
                    accountant=None,
                    prev_change_words: Optional[np.ndarray] = None,
                    fingerprint: Optional[dict] = None,
                    throughput: Optional[dict] = None,
                    scheduler: Optional[dict] = None,
                    sampler: Optional[dict] = None,
                    client_rows: Optional[dict] = None,
                    async_admit: Optional[dict] = None,
                    writer: Optional[AsyncCheckpointWriter] = None) -> str:
    """Write training state to `path` (.npz appended if absent),
    atomically. `client_rows` (FedModel.client_rows_payload) takes
    precedence over the dense `clients` blocks. With `writer`, the
    arrays are gathered to the host here and the file is written on the
    writer's thread (durable after `writer.drain()`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not path.endswith(".npz"):
        path = path + ".npz"
    arrays = {
        "ps_weights": _host(server.ps_weights),
        "Vvelocity": _host(server.Vvelocity),
        "Verror": _host(server.Verror),
        # the JAX package keeps the round counter as an int32 scalar
        "round_idx": np.asarray(_host(server.round_idx), np.int32),
        "scheduler_step": np.asarray(scheduler_step),
    }
    if client_rows is not None:
        for k, v in client_rows.items():
            arrays[f"crows_{k}"] = np.asarray(v)
    elif clients is not None:
        arrays["client_errors"] = _host(clients.errors)
        arrays["client_velocities"] = _host(clients.velocities)
        arrays["client_weights"] = _host(clients.weights)
    if accountant is not None:
        for k, v in accountant.state_dict().items():
            arrays[f"acct_{k}"] = v
    if prev_change_words is not None:
        arrays["acct_prev_change_words"] = np.asarray(prev_change_words)
    for prefix, state in (("thr", throughput), ("sched", scheduler),
                          ("smp", sampler), ("asyb", async_admit)):
        if state is not None:
            for k, v in state.items():
                arrays[f"{prefix}_{k}"] = np.asarray(v)
    if fingerprint is not None:
        for k in FINGERPRINT_FIELDS:
            arrays[f"fp_{k}"] = np.asarray(str(fingerprint[k]))

    def _write():
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as e:
            if e.errno == errno.ENOSPC:
                raise OSError(
                    e.errno,
                    f"checkpoint write to {path!r} failed: disk full "
                    "(ENOSPC). Free space on the checkpoint "
                    "filesystem or point --checkpoint_path at a "
                    "volume with room; the previous checkpoint is "
                    "intact (atomic .tmp+replace).") from e
            raise

    # a multi-rank run's client blocks reach here already gathered
    # (FedModel.client_rows_payload / checkpoint_clients, collective);
    # the coordinator alone writes, the reference's rank-0 rule, and
    # every rank waits for the file
    if mh.is_coordinator():
        if writer is None:
            _write()
        else:
            writer.submit(_write)
    _barrier_after_write(writer, "checkpoint-written")
    return path


def _barrier_after_write(writer: Optional[AsyncCheckpointWriter],
                         name: str) -> None:
    """The barrier every rank waits at after the coordinator's write. In
    a multi-rank run an async `writer` is drained first, so that no rank
    passes the barrier before the file is on disk."""
    if writer is not None and mh.is_multihost():
        writer.drain()
    mh.sync_processes(name)


def _prefixed(z, prefix: str) -> dict:
    return {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}


def load_checkpoint(path: str,
                    expect_fingerprint: Optional[dict] = None
                    ) -> Checkpoint:
    """Read training state back. With `expect_fingerprint` a checkpoint
    of another config raises CheckpointMismatchError; a legacy file
    without a fingerprint is checked by its weight vector's length."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        fingerprint = None
        if "fp_mode" in z.files:
            fingerprint = {k: str(z[f"fp_{k}"]) for k in FINGERPRINT_FIELDS
                           if f"fp_{k}" in z.files}
        if expect_fingerprint is not None:
            found = fingerprint
            if found is None:
                found = {"grad_size": str(int(z["ps_weights"].shape[0]))}
            validate_fingerprint(found, expect_fingerprint, path)
        server = ServerState(
            ps_weights=torch.from_numpy(z["ps_weights"]),
            Vvelocity=torch.from_numpy(z["Vvelocity"]),
            Verror=torch.from_numpy(z["Verror"]),
            round_idx=int(z["round_idx"]))
        clients = None
        client_rows = None
        if "crows_ids" in z.files:
            client_rows = _prefixed(z, "crows_")
        elif "client_errors" in z.files:
            clients = ClientState(
                errors=torch.from_numpy(z["client_errors"]),
                velocities=torch.from_numpy(z["client_velocities"]),
                weights=torch.from_numpy(z["client_weights"]))
        acct = {k: v for k, v in _prefixed(z, "acct_").items()
                if k != "prev_change_words"}
        prev = (z["acct_prev_change_words"]
                if "acct_prev_change_words" in z.files else None)
        return Checkpoint(server, clients, int(z["scheduler_step"]),
                          acct or None, prev, fingerprint,
                          _prefixed(z, "thr_") or None,
                          _prefixed(z, "sched_") or None,
                          _prefixed(z, "smp_") or None, client_rows,
                          _prefixed(z, "asyb_") or None)


# ---------------- keep-last-k rotation + latest manifest -----------------

def _manifest_path(prefix: str) -> str:
    return prefix + ".latest"


def _round_stamp(basename: str) -> int:
    """Round index of a `<name>-r<round:08d>.npz` basename, or -1."""
    try:
        return int(basename.rsplit("-r", 1)[1].split(".", 1)[0])
    except (IndexError, ValueError):
        return -1


class CorruptCheckpointError(ValueError):
    """A checkpoint failed its integrity check: an unreadable npz or a
    per-array CRC32 that disagrees with the manifest. load_resilient
    falls back to the previous rotation."""


# what np.load raises on a truncated or corrupted .npz
_NPZ_READ_ERRORS = (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile)


def file_integrity(path: str) -> Tuple[Dict[str, int], bool]:
    """ONE read of a checkpoint from disk: per-array CRC32s and whether
    every float array is finite."""
    out: Dict[str, int] = {}
    finite = True
    with np.load(path) as z:
        for name in z.files:
            a = np.ascontiguousarray(z[name])
            out[name] = zlib.crc32(a.tobytes()) & 0xFFFFFFFF
            if finite and np.issubdtype(a.dtype, np.floating):
                finite = bool(np.isfinite(a).all())
    return out, finite


def file_checksums(path: str) -> Dict[str, int]:
    """Per-array CRC32s of a checkpoint .npz."""
    return file_integrity(path)[0]


def verify_checkpoint_file(path: str,
                           checksums: Optional[Dict[str, int]]) -> None:
    """Raise CorruptCheckpointError unless `path` is a readable npz
    whose arrays match `checksums` (None: readability only)."""
    try:
        found = file_checksums(path)
    except _NPZ_READ_ERRORS as e:
        raise CorruptCheckpointError(
            f"checkpoint {path!r} is unreadable "
            f"({type(e).__name__}: {e}) — truncated or torn write?"
        ) from e
    if not checksums:
        return
    expect = {k: int(v) for k, v in checksums.items()}
    if found != expect:
        bad = sorted(set(expect) ^ set(found)
                     | {k for k in set(expect) & set(found)
                        if expect[k] != found[k]})
        raise CorruptCheckpointError(
            f"checkpoint {path!r} failed its integrity check: "
            f"array(s) {bad[:5]} disagree with the manifest checksums "
            "recorded at save time — corrupted on disk?")


def load_resilient(prefix: str,
                   expect_fingerprint: Optional[dict] = None,
                   on_fallback: Optional[Callable[[str, str], None]]
                   = None,
                   require_finite: bool = False
                   ) -> Optional[Tuple[str, Checkpoint]]:
    """Load the newest good checkpoint of `prefix`: manifest history,
    then stamped files the manifest lost, then the legacy fixed name,
    each integrity-checked; every skipped candidate fires
    `on_fallback(path, reason)`. A fingerprint mismatch re-raises (it is
    not corruption). require_finite also skips files the manifest
    records non-finite. Returns (path, Checkpoint) or None."""
    ckpt_dir = os.path.dirname(prefix) or "."
    candidates: List[str] = []
    checksums: Dict[str, Dict[str, int]] = {}
    finite_map: Dict[str, bool] = {}
    try:
        with open(_manifest_path(prefix)) as f:
            manifest = json.load(f)
        for base in manifest.get("history", []):
            candidates.append(os.path.join(ckpt_dir, base))
        checksums = manifest.get("checksums", {}) or {}
        finite_map = manifest.get("finite", {}) or {}
    except (OSError, ValueError):
        pass
    seen = set(candidates)
    for p in sorted(_glob.glob(prefix + "-r*.npz"), reverse=True):
        if p not in seen:
            candidates.append(p)
    fixed = prefix if prefix.endswith(".npz") else prefix + ".npz"
    if fixed not in seen and os.path.exists(fixed):
        candidates.append(fixed)
    for path in candidates:
        if not os.path.exists(path):
            continue
        if require_finite and \
                finite_map.get(os.path.basename(path)) is False:
            reason = ("manifest records non-finite state at save "
                      "time (numeric rollback skips it)")
            print(f"checkpoint fallback: skipping non-finite "
                  f"{path!r}; trying the previous rotation")
            if on_fallback is not None:
                on_fallback(path, reason)
            continue
        try:
            verify_checkpoint_file(
                path, checksums.get(os.path.basename(path)))
            return path, load_checkpoint(
                path, expect_fingerprint=expect_fingerprint)
        except CheckpointMismatchError:
            raise
        except (CorruptCheckpointError, *_NPZ_READ_ERRORS) as e:
            reason = f"{type(e).__name__}: {e}"
            print(f"checkpoint fallback: skipping corrupt {path!r} "
                  f"({reason}); trying the previous rotation")
            if on_fallback is not None:
                on_fallback(path, reason)
    return None


def save_rotating(prefix: str, server: ServerState,
                  clients: Optional[ClientState] = None,
                  keep_last: int = 3, max_age_hours: float = 0.0,
                  writer: Optional[AsyncCheckpointWriter] = None,
                  **kw) -> str:
    """Atomic round-stamped save (`<prefix>-r<round:08d>.npz`), then
    the `<prefix>.latest` manifest {"latest", "history" newest-first,
    "checksums", "finite"} written atomically AFTER the file, then
    keep-last-k pruning of every stamped file outside the kept history
    (entries stamped after this round belong to an abandoned timeline
    and go too). max_age_hours > 0 also prunes kept entries older than
    that, never the file just written. With `writer`, the file and then
    the manifest are written on its thread, in that order. Returns the
    written path."""
    round_idx = int(_host(server.round_idx))
    path = f"{prefix}-r{round_idx:08d}.npz"
    save_checkpoint(path, server, clients, writer=writer, **kw)
    if not mh.is_coordinator():
        pass
    elif writer is None:
        _manifest_and_prune(prefix, path, round_idx, keep_last,
                            max_age_hours)
    else:
        writer.submit(lambda: _manifest_and_prune(
            prefix, path, round_idx, keep_last, max_age_hours))
    _barrier_after_write(writer, "checkpoint-rotated")
    return path


def _manifest_and_prune(prefix: str, path: str, round_idx: int,
                        keep_last: int, max_age_hours: float) -> None:
    """save_rotating's manifest update and pruning, after `path` is on
    disk."""
    base = os.path.basename(path)
    mpath = _manifest_path(prefix)
    history: list = []
    old_sums: dict = {}
    old_fin: dict = {}
    try:
        with open(mpath) as f:
            m = json.load(f)
        history = list(m.get("history", []))
        old_sums = dict(m.get("checksums", {}) or {})
        old_fin = dict(m.get("finite", {}) or {})
    except (OSError, ValueError):
        pass
    history = [h for h in history if _round_stamp(h) <= round_idx]
    history = [base] + [h for h in history if h != base]
    keep = history[:max(keep_last, 1)]
    if max_age_hours > 0:
        cutoff_ts = time.time() - max_age_hours * 3600.0
        ckpt_dir = os.path.dirname(prefix) or "."

        def fresh(basename: str) -> bool:
            try:
                return (os.path.getmtime(
                    os.path.join(ckpt_dir, basename)) >= cutoff_ts)
            except OSError:
                return False
        keep = [keep[0]] + [h for h in keep[1:] if fresh(h)]
    # the manifest vouches for the bytes on disk: re-read the file just
    # written, checksums and finite bit in one pass
    try:
        old_sums[base], old_fin[base] = file_integrity(path)
    except _NPZ_READ_ERRORS as e:
        print(f"checkpoint warning: cannot checksum just-written "
              f"{path!r} ({e})")
    sums = {b: old_sums[b] for b in keep if b in old_sums}
    fins = {b: old_fin[b] for b in keep if b in old_fin}
    atomic_write_text(mpath, json.dumps(
        {"latest": base, "history": keep, "checksums": sums,
         "finite": fins}, indent=2))
    keep_set = set(keep)
    for old in _glob.glob(prefix + "-r*.npz"):
        if os.path.basename(old) not in keep_set:
            try:
                os.remove(old)
            except OSError:
                pass


def save_final(prefix: str, server: ServerState,
               clients: Optional[ClientState] = None,
               keep_last: int = 3, max_age_hours: float = 0.0,
               writer: Optional[AsyncCheckpointWriter] = None,
               **kw) -> str:
    """End-of-run save: the rotated stamped checkpoint (and manifest)
    plus an atomic copy of its bytes at the fixed `<prefix>.npz`.
    Returns the fixed-name path."""
    stamped = save_rotating(prefix, server, clients, keep_last=keep_last,
                            max_age_hours=max_age_hours, writer=writer,
                            **kw)
    if writer is not None:
        # the copy below reads the stamped bytes
        writer.drain()
    fixed = prefix if prefix.endswith(".npz") else prefix + ".npz"
    if mh.is_coordinator():
        tmp = fixed + ".tmp"
        shutil.copyfile(stamped, tmp)
        os.replace(tmp, fixed)
    mh.sync_processes("checkpoint-final")
    return fixed


def latest_checkpoint_path(prefix: str) -> Optional[str]:
    """The manifest's `latest` when it exists on disk, else the
    highest-round stamped file, else the legacy `<prefix>.npz`, else
    None."""
    ckpt_dir = os.path.dirname(prefix) or "."
    try:
        with open(_manifest_path(prefix)) as f:
            base = json.load(f).get("latest")
        if base:
            cand = os.path.join(ckpt_dir, base)
            if os.path.exists(cand):
                return cand
    except (OSError, ValueError):
        pass
    stamped = sorted(_glob.glob(prefix + "-r*.npz"))
    if stamped:
        return stamped[-1]
    if os.path.exists(prefix + ".npz"):
        return prefix + ".npz"
    return None


def load_latest(prefix: str,
                expect_fingerprint: Optional[dict] = None
                ) -> Optional[Checkpoint]:
    """The newest checkpoint of `prefix` (latest_checkpoint_path), or
    None."""
    path = latest_checkpoint_path(prefix)
    if path is None:
        return None
    return load_checkpoint(path, expect_fingerprint=expect_fingerprint)


def transfer_for_finetune(old_module: torch.nn.Module, old_vec,
                          new_module: torch.nn.Module):
    """Head-swap transfer (reference resnet9.py:105-130, cv_train.py:
    377-384): every parameter of `new_module` whose flax path and shape
    match one of `old_module` (whose weights are the flat vector
    `old_vec`) takes the old values; the others (a classifier head for
    another class count) keep the new model's initialization. The
    result is loaded into `new_module`. Returns (the new flat vector,
    the frozen mask: [D] float32 numpy, 1.0 at transferred coordinates,
    in the flat order of ops/flat.py)."""
    old_layout = module_layout(old_module)
    old_vec = torch.as_tensor(np.asarray(old_vec, np.float32)).reshape(-1)
    old = {e.path: (e.flat_shape, seg) for e, seg in zip(
        old_layout, torch.split(old_vec, [e.size for e in old_layout]))}
    new_layout = module_layout(new_module)
    new_vec, _ = flatten_params(new_module)
    new_vec = new_vec.detach().cpu()
    segs, frozen = [], []
    for e, seg in zip(new_layout,
                      torch.split(new_vec, [e.size for e in new_layout])):
        prev = old.get(e.path)
        moved = prev is not None and prev[0] == e.flat_shape
        segs.append(prev[1] if moved else seg)
        frozen.append(np.full(e.size, 1.0 if moved else 0.0, np.float32))
    vec = torch.cat(segs)
    load_flat(new_module, vec.to(next(new_module.parameters()).device))
    return vec, np.concatenate(frozen)
