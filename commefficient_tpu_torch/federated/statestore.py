"""Tiered client state, the port of commefficient_tpu/federated/
statestore.py: a bounded working set of client rows on the device over
a host tail.

Under `--state_tier host` the ClientState blocks are [working_set, D]
(round.client_state_rows) and the round addresses rows by device slot.
`plan_round` gives each cohort member a slot and advances an LRU: a
resident client is a hit; a miss takes a free slot or evicts the least
recently used client that this round (or span, `plan_span`) does not
need. `execute` then moves the rows on the device's stream, before the
round that reads them:

  * a spill gathers the victims' rows and copies them to pinned host
    memory (non_blocking, queued right behind the work that last wrote
    them); a bounded writer thread (utils/checkpoint.
    AsyncCheckpointWriter) waits for that copy and commits the rows to
    the tail with a CRC32 a row. A writer failure re-raises on the
    round loop, at the next spill or flush;
  * a restore fills a pinned buffer with the misses' rows (the tail, a
    spill still in flight, or the init row of a client never seen) and
    copies it to their slots with one non_blocking host-to-device copy.

The tail is host RAM (pinned when the device is a card) or, with
`--state_spill_dir`, one sparse [num_clients, D] memmap a block. A tail
row is checked against its CRC32 when it is read; a mismatch
re-initializes the row (a `state_quarantine` journal event).

Rows round-trip the host bit for bit and the round reads the same
values through its slot, so a run at `--state_tier host` is bitwise the
run at `--state_tier device`, per round, spanned and pipelined. The LRU
advances only in `plan_round`, a function of the cohort stream; its
order and slot map ride in checkpoints as `crows_lru_ids` /
`crows_lru_slots`, the JAX package's keys, so a resumed run replays the
eviction stream, and a checkpoint drains the spill queue first.
"""
from __future__ import annotations

import errno
import os
import threading
import zlib
from collections import OrderedDict, deque
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from commefficient_tpu_torch.federated import round as fround
from commefficient_tpu_torch.telemetry.trace import TRACE

# the tracked blocks in ClientState order (the crows_* field names)
STATE_FIELDS = ("errors", "velocities", "weights")


def _row_crc(row: np.ndarray) -> int:
    """CRC32 of one row's f32 bytes (read in place, not copied)."""
    return zlib.crc32(np.ascontiguousarray(row, dtype=np.float32)
                      ) & 0xFFFFFFFF


def tracked_fields(cfg) -> Dict[str, bool]:
    """Which ClientState blocks the config materializes."""
    return {
        "errors": fround._has_errors(cfg),
        "velocities": fround._has_velocities(cfg),
        "weights": cfg.do_topk_down,
    }


def _host_buffer(shape, pin: bool) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, pin_memory=pin)


class TierPlan(NamedTuple):
    """One round's tier motion, planned on the host at stage time and
    executed against the block as it then stands."""
    slots: np.ndarray                 # [W] int64 device slot a member
    restores: Tuple[Tuple[int, int], ...]  # (client id, slot) misses
    spills: Tuple[Tuple[int, int], ...]    # (victim id, slot) evictions


class _Spill:
    """One execute's spilled rows: pinned host copies of the victims'
    rows, and the event their copies complete at (None on the CPU)."""

    def __init__(self, rows: Dict[str, torch.Tensor], event):
        self.rows = rows
        self.event = event

    def host(self) -> Dict[str, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return {f: t.numpy() for f, t in self.rows.items()}


class _RamTail:
    """The host-RAM tail: one growable [cap, D] f32 table a tracked
    block (pinned on a card) and an id -> row map."""

    def __init__(self, fields: List[str], D: int, pin: bool):
        self._fields = list(fields)
        self._D = int(D)
        self._pin = pin
        self._rowmap: Dict[int, int] = {}
        self._tables: Dict[str, np.ndarray] = {
            f: np.zeros((0, self._D), np.float32) for f in fields}
        # the pinned tensors the tables are numpy views of
        self._keep: Dict[str, torch.Tensor] = {}

    def _grow(self, need: int) -> None:
        have = next(iter(self._tables.values())).shape[0] \
            if self._tables else 0
        if need <= have:
            return
        cap = max(need, have * 2, 64)
        for f in self._fields:
            t = self._tables[f]
            keep = _host_buffer((cap, self._D), self._pin)
            nt = keep.numpy()
            nt[:t.shape[0]] = t
            self._keep[f] = keep
            self._tables[f] = nt

    def put(self, ids, rows: Dict[str, np.ndarray]) -> None:
        for i, cid in enumerate(int(c) for c in ids):
            row = self._rowmap.get(cid)
            if row is None:
                row = len(self._rowmap)
                self._grow(row + 1)
                self._rowmap[cid] = row
            for f in self._fields:
                self._tables[f][row] = rows[f][i]

    def has(self, cid: int) -> bool:
        return int(cid) in self._rowmap

    def get(self, cid: int) -> Dict[str, np.ndarray]:
        row = self._rowmap[int(cid)]
        return {f: self._tables[f][row] for f in self._fields}

    def get_many(self, ids) -> Dict[str, np.ndarray]:
        rows = np.fromiter((self._rowmap[int(c)] for c in ids),
                           np.int64, count=len(ids))
        return {f: self._tables[f][rows] for f in self._fields}

    def clear(self) -> None:
        self._rowmap.clear()
        self._keep.clear()
        for f in self._fields:
            self._tables[f] = np.zeros((0, self._D), np.float32)

    def close(self) -> None:
        pass


class _DiskTail:
    """The tail on disk (--state_spill_dir): one sparse [num_clients, D]
    f32 memmap a tracked block, indexed by client id. Scratch state,
    written fresh each run and rebuilt from crows_* rows on resume."""

    def __init__(self, dirpath: str, fields: List[str],
                 num_clients: int, D: int):
        self._dir = str(dirpath)
        self._fields = list(fields)
        self._present: set = set()
        self._maps: Dict[str, np.ndarray] = {}
        try:
            os.makedirs(dirpath, exist_ok=True)
            for f in fields:
                path = os.path.join(dirpath, f"tail_{f}.npy")
                self._maps[f] = np.lib.format.open_memmap(
                    path, mode="w+", dtype=np.float32,
                    shape=(int(num_clients), int(D)))
        except OSError as e:
            raise self._spill_error(e) from e

    def _spill_error(self, e: OSError) -> OSError:
        why = ("disk full (ENOSPC)" if e.errno == errno.ENOSPC
               else f"{type(e).__name__}: {e}")
        return OSError(
            e.errno or errno.EIO,
            f"state spill write under --state_spill_dir "
            f"{self._dir!r} failed: {why}. Spilled rows are the "
            "authoritative copy of evicted client state — free space "
            "on (or relocate) --state_spill_dir, or drop the flag to "
            "keep the tail in host RAM.")

    def put(self, ids, rows: Dict[str, np.ndarray]) -> None:
        idx = np.asarray(ids, np.int64)
        try:
            for f in self._fields:
                self._maps[f][idx] = rows[f][:len(idx)]
        except OSError as e:
            raise self._spill_error(e) from e
        self._present.update(int(c) for c in idx)

    def has(self, cid: int) -> bool:
        return int(cid) in self._present

    def get(self, cid: int) -> Dict[str, np.ndarray]:
        return {f: np.array(self._maps[f][int(cid)])
                for f in self._fields}

    def get_many(self, ids) -> Dict[str, np.ndarray]:
        idx = np.asarray(ids, np.int64)
        return {f: np.asarray(self._maps[f][idx], np.float32)
                for f in self._fields}

    def clear(self) -> None:
        self._present.clear()

    def close(self) -> None:
        try:
            for m in self._maps.values():
                m.flush()
        except OSError as e:
            raise self._spill_error(e) from e


class TieredStateStore:
    """The host side of `--state_tier host`, owned by FedModel."""

    def __init__(self, cfg, device, init_weights, num_clients: int):
        from commefficient_tpu_torch.utils.checkpoint import (
            AsyncCheckpointWriter,
        )
        self.cfg = cfg
        self.device = torch.device(device)
        self.num_clients = int(num_clients)
        self.tracked = tracked_fields(cfg)
        self.fields = [f for f in STATE_FIELDS if self.tracked[f]]
        self.D = int(cfg.grad_size)
        self.slots = int(cfg.state_working_set)
        self._pin = self.device.type == "cuda"
        self._lru: "OrderedDict[int, int]" = OrderedDict()
        self._free: deque = deque(range(self.slots))
        self._tail = (_DiskTail(cfg.state_spill_dir, self.fields,
                                self.num_clients, self.D)
                      if cfg.state_spill_dir
                      else _RamTail(self.fields, self.D, self._pin))
        # spills in flight: id -> (its _Spill, row); the lock covers
        # the tail, this map, the sums and the quarantine list, which
        # the writer thread and the round loop both touch
        self._pending: Dict[int, Tuple[_Spill, int]] = {}
        self._sums: Dict[int, Dict[str, int]] = {}
        self._quarantined: List[dict] = []
        self._lock = threading.Lock()
        self._writer = AsyncCheckpointWriter(
            max_pending=4, drain_timeout=cfg.writer_drain_timeout_s,
            name="state-spill")
        # host rows warmed by the scheduler's prefetch (LRU-neutral)
        self._warm: Dict[int, Dict[str, np.ndarray]] = {}
        # every client ever resident (= lru | pending | tail)
        self._ever: set = set()
        self._ever_sorted: Optional[np.ndarray] = None
        self._init_weights = (np.asarray(init_weights, np.float32)
                              if cfg.do_topk_down else None)
        self.hits = 0
        self.misses = 0
        self.spills = 0
        self.restores = 0
        self.spill_bytes = 0
        self.restore_bytes = 0
        self.quarantines = 0
        self._emitted = {"hits": 0, "misses": 0, "spills": 0,
                         "restores": 0, "spill_bytes": 0,
                         "restore_bytes": 0, "quarantines": 0}

    # -- planning (host) ---------------------------------------------------
    def plan_round(self, client_ids,
                   pinned: Optional[set] = None) -> TierPlan:
        """A slot for every cohort member, the LRU advanced: residents
        hit, misses take a free slot or evict the least recently used
        client not in the cohort or `pinned`."""
        ids = np.asarray(client_ids, np.int64).reshape(-1)
        pin = {int(c) for c in ids}
        if pinned:
            pin |= {int(c) for c in pinned}
        slots = np.empty(len(ids), np.int64)
        restores: List[Tuple[int, int]] = []
        spills: List[Tuple[int, int]] = []
        for i, cid in enumerate(int(c) for c in ids):
            slot = self._lru.get(cid)
            if slot is not None:
                self._lru.move_to_end(cid)
                slots[i] = slot
                self.hits += 1
                continue
            self.misses += 1
            if self._free:
                slot = self._free.popleft()
            else:
                victim = next((c for c in self._lru if c not in pin),
                              None)
                if victim is None:
                    raise ValueError(
                        f"state_working_set={self.cfg.state_working_set} "
                        f"({self.slots} slots) cannot hold the "
                        f"{len(pin)} distinct clients this "
                        "round/span needs resident at once — raise "
                        "--state_working_set or (scanned path) lower "
                        "--scan_span")
                slot = self._lru.pop(victim)
                spills.append((victim, slot))
                self.spills += 1
            if cid not in self._ever:
                self._ever.add(cid)
                self._ever_sorted = None
            self._lru[cid] = slot
            restores.append((cid, slot))
            self.restores += 1
            slots[i] = slot
        return TierPlan(slots, tuple(restores), tuple(spills))

    def plan_span(self, ids_rounds) -> List[TierPlan]:
        """Per-round plans of a span ([N, W] ids). Every restore happens
        before the span is queued, so each plan pins the whole span's
        clients: no slot a later round of the span reads is given away
        within it."""
        ids_rounds = np.asarray(ids_rounds)
        span_ids = {int(c) for row in ids_rounds for c in row}
        return [self.plan_round(row, pinned=span_ids)
                for row in ids_rounds]

    # -- execution (the device's stream) ----------------------------------
    def execute(self, clients: fround.ClientState,
                plan: TierPlan) -> fround.ClientState:
        """One plan's motion on the current block, in place: the spills'
        gathers first (they read the victims' rows before their slots
        are refilled, in stream order), then the restores."""
        if plan.spills:
            with TRACE.span("tier_spill"):
                self._spill(clients, plan.spills)
        if plan.restores:
            with TRACE.span("tier_restore"):
                self._restore(clients, plan.restores)
        return clients

    def _spill(self, clients, chunk) -> None:
        index = torch.as_tensor([s for _, s in chunk], dtype=torch.int64,
                                device=self.device)
        rows, event = {}, None
        for f in self.fields:
            gathered = getattr(clients, f)[index]
            if self._pin:
                host = _host_buffer(gathered.shape, True)
                host.copy_(gathered, non_blocking=True)
            else:
                host = gathered
            rows[f] = host
        if self._pin:
            event = torch.cuda.Event()
            event.record()
        spill = _Spill(rows, event)
        ids = [cid for cid, _ in chunk]
        with self._lock:
            for i, cid in enumerate(ids):
                self._pending[cid] = (spill, i)
                self._warm.pop(cid, None)
        self.spill_bytes += len(ids) * self.D * 4 * len(self.fields)

        def commit():
            host = spill.host()
            sums = {cid: {f: _row_crc(host[f][i]) for f in self.fields}
                    for i, cid in enumerate(ids)}
            with self._lock:
                self._tail.put(ids, host)
                self._sums.update(sums)
                for cid in ids:
                    ent = self._pending.get(cid)
                    if ent is not None and ent[0] is spill:
                        del self._pending[cid]

        self._writer.submit(commit)

    def _init_row(self, field: str) -> np.ndarray:
        if field == "weights" and self._init_weights is not None:
            return np.array(self._init_weights, np.float32)
        return np.zeros(self.D, np.float32)

    def _verify_tail_bulk(self, ids, rows: dict) -> None:
        """Check tail rows (field -> [n, D] copies) against the CRC32s
        recorded when they were written; a mismatching field is
        re-initialized, written back with a fresh sum and queued for a
        `state_quarantine` event. The caller holds the lock."""
        for i, cid in enumerate(int(c) for c in ids):
            expect = self._sums.get(cid)
            if not expect:
                continue
            bad = [f for f in self.fields
                   if f in expect and _row_crc(rows[f][i]) != expect[f]]
            if not bad:
                continue
            for f in bad:
                rows[f][i] = self._init_row(f)
                self.quarantines += 1
                self._quarantined.append(  # graftsync: disable=SY001 -- caller holds self._lock
                    {"client": cid, "field": f})
            self._tail.put(  # graftsync: disable=SY001 -- caller holds self._lock
                [cid], {f: rows[f][i][None] for f in self.fields})
            self._sums[cid] = {  # graftsync: disable=SY001 -- caller holds self._lock
                f: _row_crc(rows[f][i]) for f in self.fields}

    def _verify_tail_row(self, cid: int, rows: dict) -> dict:
        stacked = {f: np.array(rows[f], np.float32)[None]
                   for f in self.fields}
        self._verify_tail_bulk([cid], stacked)
        return {f: stacked[f][0] for f in self.fields}

    def _rows_for(self, cid: int) -> dict:
        """A non-resident client's rows: a spill in flight, the
        prefetch cache, the tail, or the init rows."""
        with self._lock:
            ent = self._pending.get(cid)
            warm = self._warm.pop(cid, None)
            if ent is None and warm is None and self._tail.has(cid):
                return self._verify_tail_row(cid, self._tail.get(cid))
        if ent is not None:
            spill, i = ent
            host = spill.host()
            return {f: host[f][i] for f in self.fields}
        if warm is not None:
            return warm
        return {f: self._init_row(f) for f in self.fields}

    def _restore(self, clients, chunk) -> None:
        m = len(chunk)
        staged = {f: _host_buffer((m, self.D), self._pin)
                  for f in self.fields}
        views = {f: t.numpy() for f, t in staged.items()}
        for i, (cid, _) in enumerate(chunk):
            rows = self._rows_for(cid)
            for f in self.fields:
                views[f][i] = rows[f]
        index = torch.as_tensor([s for _, s in chunk], dtype=torch.int64,
                                device=self.device)
        # every row was verified by _rows_for above (graftsync's
        # checksum-verify-before-restore edge)
        for f in self.fields:
            block = getattr(clients, f)
            block.index_copy_(0, index,
                              staged[f].to(self.device, non_blocking=True))
        self.restore_bytes += m * self.D * 4 * len(self.fields)

    # -- the scheduler's prefetch -----------------------------------------
    def prefetch_host_rows(self, client_ids) -> None:
        """Warm the host side of an upcoming plan's restores (a tail
        read, a disk tail's page-in, and its check), without touching
        the LRU or the device: the eviction stream and the results are
        the same with or without it. Spills still in flight are left
        to the restore."""
        for cid in (int(c) for c in np.asarray(client_ids).reshape(-1)):
            if cid in self._lru or cid in self._warm:
                continue
            with self._lock:
                if cid not in self._pending and self._tail.has(cid):
                    self._warm[cid] = self._verify_tail_row(
                        cid, self._tail.get(cid))
        with self._lock:
            if len(self._warm) > 4 * max(self.cfg.num_workers, 1):
                for cid in list(self._warm)[:len(self._warm) // 2]:
                    del self._warm[cid]

    # -- telemetry ----------------------------------------------------------
    def take_journal_fields(self) -> dict:
        """The counters' deltas since the last take: one `state_tier`
        journal event."""
        totals = {"hits": self.hits, "misses": self.misses,
                  "spills": self.spills, "restores": self.restores,
                  "spill_bytes": self.spill_bytes,
                  "restore_bytes": self.restore_bytes,
                  "quarantines": self.quarantines}
        out = {k: totals[k] - self._emitted[k] for k in totals}
        self._emitted = totals
        out["resident"] = len(self._lru)
        out["working_set"] = self.slots
        return out

    def take_quarantine_events(self) -> List[dict]:
        with self._lock:
            out, self._quarantined = self._quarantined, []
        return out

    # -- the crows_* checkpoint payload -------------------------------------
    def snapshot_tier(self) -> dict:
        """The LRU order, slot map and touched ids as they stand: a
        span's boundary, for a checkpoint written one span late."""
        return {
            "lru_ids": np.fromiter(self._lru.keys(), np.int64,
                                   count=len(self._lru)),
            "lru_slots": np.fromiter(self._lru.values(), np.int64,
                                     count=len(self._lru)),
            "touched": np.asarray(self.touched_ids(), np.int64),
        }

    def resident_rows(self, clients, tier: dict) -> Dict[str, torch.Tensor]:
        """The resident rows of `tier` gathered on the device (O(working
        set)), by field; the caller copies them to the host."""
        index = torch.as_tensor(np.asarray(tier["lru_slots"], np.int64),
                                device=self.device)
        return {f: getattr(clients, f)[index] for f in self.fields}

    def checkpoint_rows(self, resident: Dict[str, np.ndarray],
                        tier: dict) -> dict:
        """The crows_* payload: `resident` (the host copies of
        resident_rows for `tier`) and every evicted row read from the
        tail, after the spill queue is drained; with the LRU order and
        slot map (`lru_ids`, `lru_slots`)."""
        self.flush()
        lru_ids = np.asarray(tier["lru_ids"], np.int64)
        lru_slots = np.asarray(tier["lru_slots"], np.int64)
        resident_set = set(int(c) for c in lru_ids)
        evicted = [int(c) for c in np.asarray(tier["touched"])
                   if int(c) not in resident_set]
        all_ids = np.sort(np.concatenate(
            [lru_ids, np.asarray(evicted, np.int64)])
            if len(lru_ids) or evicted else np.zeros((0,), np.int64))
        payload = {"ids": all_ids,
                   "lru_ids": lru_ids, "lru_slots": lru_slots}
        if self._init_weights is not None:
            payload["base_weights"] = self._init_weights
        res_mask = np.isin(all_ids, lru_ids)
        pos_in_lru = {int(c): i for i, c in enumerate(lru_ids)}
        res_pos = np.fromiter(
            (pos_in_lru[int(c)] for c in all_ids[res_mask]),
            np.int64, count=int(res_mask.sum()))
        evicted_sel = all_ids[~res_mask]
        with self._lock:
            if len(evicted_sel):
                tail_rows = self._tail.get_many(evicted_sel)
                self._verify_tail_bulk(evicted_sel, tail_rows)
            else:
                tail_rows = {f: np.zeros((0, self.D), np.float32)
                             for f in self.fields}
        empty = np.zeros((0,), np.float32)
        for name in STATE_FIELDS:
            if name not in self.fields:
                payload[name] = empty
                continue
            out = np.empty((len(all_ids), self.D), np.float32)
            if len(res_pos):
                out[res_mask] = resident[name][res_pos]
            out[~res_mask] = tail_rows[name]
            payload[name] = out
        return payload

    def load_rows(self, clients, rows: dict) -> None:
        """Rebuild the tiers from a crows_* payload, into `clients` (a
        fresh block at init values): rows recorded resident go back to
        their slots, the rest to the tail. A payload without lru keys
        (a device-tier run's), or one recorded under another working
        set, starts cold, all rows in the tail: same values."""
        self._reset()
        ids = np.asarray(rows["ids"], np.int64).reshape(-1)
        self._ever = set(int(c) for c in ids)
        self._ever_sorted = None
        lru_ids = np.asarray(rows.get("lru_ids", ()),
                             np.int64).reshape(-1)
        lru_slots = np.asarray(rows.get("lru_slots", ()),
                               np.int64).reshape(-1)
        compatible = (len(lru_ids) == len(lru_slots)
                      and len(lru_ids) <= self.slots
                      and (len(lru_slots) == 0
                           or int(lru_slots.max()) < self.slots))
        if not compatible:
            lru_ids = np.zeros((0,), np.int64)
            lru_slots = np.zeros((0,), np.int64)
        pos = {int(c): j for j, c in enumerate(ids)}
        field_rows = {name: np.asarray(rows.get(name, ()), np.float32)
                      for name in self.fields}
        tail_mask = ~np.isin(ids, lru_ids)
        if tail_mask.any():
            tail_ids = ids[tail_mask]
            tail_vals = {name: field_rows[name][tail_mask]
                         for name in self.fields}
            sums = {int(cid): {f: _row_crc(tail_vals[f][i])
                               for f in self.fields}
                    for i, cid in enumerate(tail_ids)}
            with self._lock:
                self._tail.put(tail_ids, tail_vals)
                self._sums.update(sums)
        for cid, slot in zip(lru_ids, lru_slots):
            self._lru[int(cid)] = int(slot)
        used = set(self._lru.values())
        self._free = deque(s for s in range(self.slots)
                           if s not in used)
        if len(lru_ids):
            index = torch.as_tensor(lru_slots, device=self.device)
            for name in self.fields:
                data = np.stack([field_rows[name][pos[int(c)]]
                                 for c in lru_ids])
                getattr(clients, name)[index] = torch.from_numpy(
                    data).to(self.device)

    def import_dense(self, dense_rows: Dict[str, np.ndarray]) -> None:
        """Dense client_* blocks into the tail: the rows that differ
        from their init value are the touched ones; the working set
        starts cold."""
        self._reset()
        n = min(self.num_clients,
                *(dense_rows[f].shape[0] for f in self.fields))
        diff = np.zeros(n, bool)
        for f in self.fields:
            block = np.asarray(dense_rows[f][:n], np.float32)
            diff |= (block != self._init_row(f)[None, :]).any(axis=1)
        touched = np.nonzero(diff)[0]
        if len(touched):
            vals = {f: np.asarray(dense_rows[f][touched], np.float32)
                    for f in self.fields}
            sums = {int(cid): {f: _row_crc(vals[f][i])
                               for f in self.fields}
                    for i, cid in enumerate(touched)}
            with self._lock:
                self._tail.put(touched, vals)
                self._sums.update(sums)
        self._ever = set(int(c) for c in touched)
        self._ever_sorted = None

    def set_init_weights(self, vec: Optional[np.ndarray]) -> None:
        """The init row untouched --topk_down clients restore from (a
        checkpoint's saved base)."""
        if self.cfg.do_topk_down and vec is not None:
            self._init_weights = np.asarray(vec, np.float32)

    def touched_ids(self) -> np.ndarray:
        """Every client whose rows may differ from init, sorted."""
        if self._ever_sorted is None:
            self._ever_sorted = np.fromiter(
                sorted(self._ever), np.int64, count=len(self._ever))
        return self._ever_sorted

    def _reset(self) -> None:
        self.flush()
        self._lru.clear()
        self._free = deque(range(self.slots))
        self._ever = set()
        self._ever_sorted = None
        with self._lock:
            self._tail.clear()
            self._pending.clear()
            self._warm.clear()
            self._sums.clear()

    # -- lifecycle ------------------------------------------------------------
    def flush(self) -> None:
        """Block until every queued spill is in the tail; re-raise a
        writer failure."""
        self._writer.drain()

    def close(self) -> None:
        self._writer.close()
        self._tail.close()
