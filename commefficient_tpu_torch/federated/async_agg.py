"""Buffered async admission, the port of
commefficient_tpu/federated/async_agg.py: a straggler's late work is
admitted a few rounds on, discounted by its staleness, instead of being
cut at the deadline.

All of it is a merge on the host into the cohort operands the round
already takes:

  * defer: a live slot with work fraction < 1 (a straggler draw, a
    scripted slow slot or a deadline truncation that survived the
    cutoff) leaves its round on the dropped-client path (survivor 0) and
    is buffered with its client id, batch rows, mask and fraction, due
    at round t + k;
  * admit: at its due round the entry goes back into the cohort (its
    own slot if idle, else the lowest idle slot, else the highest fresh
    slot not yet claimed) with work f x decay ** rounds_late; the
    round's processed-example weighting turns that into the discount.

At k = 0 both land in one `compose` call and each entry returns to its
own slot with f x decay ** 0 = f: the operands are the synchronous
straggler path's, bitwise. Pending entries ride in checkpoints under
`asyb_*` keys, the JAX package's.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np


class _PendingEntry(NamedTuple):
    client_id: int
    origin: int                 # the round its work was drawn for
    due: int                    # origin + delay
    frac: np.float32            # the work done by its own deadline
    slot: int                   # its cohort slot at origin
    data: Tuple[np.ndarray, ...]  # that slot's batch rows
    mask: np.ndarray


class AsyncAdmitBuffer:
    """The defer/admit buffer of one run. `compose` runs once a round,
    in round order, after the fault pass (FedModel._faults_for_round)
    and before placement, so the composed stream is a pure function of
    (stream, faults, buffer state)."""

    def __init__(self, delay: int, decay: float = 0.5):
        if delay < 0:
            raise ValueError(f"delay={delay} must be >= 0")
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay={decay} must be in (0, 1]")
        self.delay = int(delay)
        self.decay = float(decay)
        self._pending: List[_PendingEntry] = []
        # the last compose's admissions: (slot, client id, effective
        # work, origin round)
        self.last_admits: List[Tuple[int, int, float, int]] = []

    def staleness_weight(self, rounds_late: int) -> np.float32:
        """decay ** rounds_late in f32 (exactly 1.0 at 0)."""
        if rounds_late < 0:
            raise ValueError(f"rounds_late={rounds_late} must be >= 0")
        return np.float32(self.decay ** int(rounds_late))

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    def compose(self, round_idx: int, client_ids, data, mask,
                survivors: Optional[np.ndarray],
                work: Optional[np.ndarray]):
        """Defer this round's stragglers and admit the entries due.
        Returns (client_ids, data, mask, survivors, work) with
        _faults_for_round's None conventions; the inputs themselves when
        nothing is deferred or admitted."""
        round_idx = int(round_idx)
        self.last_admits = []
        due = [e for e in self._pending if e.due <= round_idx]
        if work is None and not due:
            return client_ids, data, mask, survivors, work

        ids = np.asarray(client_ids)
        W = ids.shape[0]
        surv_arr = (np.ones(W, np.float32) if survivors is None
                    else np.asarray(survivors, np.float32).copy())
        work_arr = (np.ones(W, np.float32) if work is None
                    else np.asarray(work, np.float32).copy())
        changed = False

        if work is not None:
            for i in np.flatnonzero((work_arr < 1.0)
                                    & (surv_arr > 0.0)):
                i = int(i)
                self._pending.append(_PendingEntry(
                    client_id=int(ids[i]), origin=round_idx,
                    due=round_idx + self.delay,
                    frac=np.float32(work_arr[i]), slot=i,
                    data=tuple(np.asarray(d)[i].copy() for d in data),
                    mask=np.asarray(mask)[i].copy()))
                surv_arr[i] = 0.0
                work_arr[i] = 1.0
                changed = True
            # at delay 0 the entries just deferred are due now
            due = [e for e in self._pending if e.due <= round_idx]

        if due:
            self._pending = [e for e in self._pending
                             if e.due > round_idx]
            ids = np.array(ids, copy=True)
            data = tuple(np.array(d, copy=True) for d in data)
            mask = np.array(mask, copy=True)
            taken: set = set()
            for e in due:  # FIFO: a deterministic slot assignment
                slot = self._pick_slot(e.slot, surv_arr, taken)
                taken.add(slot)
                ids[slot] = e.client_id
                for d, row in zip(data, e.data):
                    d[slot] = row
                mask[slot] = e.mask
                surv_arr[slot] = 1.0
                work_arr[slot] = e.frac * self.staleness_weight(
                    round_idx - e.origin)
                self.last_admits.append(
                    (slot, int(e.client_id), float(work_arr[slot]),
                     int(e.origin)))
            changed = True

        if not changed:
            return client_ids, data, mask, survivors, work
        out_work: Optional[np.ndarray] = work_arr
        if np.all(work_arr >= 1.0):
            out_work = None
        out_surv: Optional[np.ndarray] = surv_arr
        if (out_work is None and survivors is None
                and np.all(surv_arr >= 1.0)):
            out_surv = None
        return ids, data, mask, out_surv, out_work

    @staticmethod
    def _pick_slot(preferred: int, surv_arr: np.ndarray,
                   taken: set) -> int:
        """The entry's own slot when idle, else the lowest idle slot,
        else the highest slot not yet claimed this round."""
        if surv_arr[preferred] <= 0.0 and preferred not in taken:
            return preferred
        for i in range(len(surv_arr)):
            if surv_arr[i] <= 0.0 and i not in taken:
                return i
        for i in range(len(surv_arr) - 1, -1, -1):
            if i not in taken:
                return i
        raise ValueError("more admissions than cohort slots")

    # -- the asyb_* checkpoint keys ---------------------------------------
    def state_dict(self) -> dict:
        """The pending entries as [m, ...] arrays (empty when none)."""
        m = len(self._pending)
        out = {
            "ids": np.array([e.client_id for e in self._pending],
                            np.int64),
            "origin": np.array([e.origin for e in self._pending],
                               np.int64),
            "due": np.array([e.due for e in self._pending], np.int64),
            "frac": np.array([e.frac for e in self._pending],
                             np.float32),
            "slot": np.array([e.slot for e in self._pending],
                             np.int64),
            "n_data": np.int64(len(self._pending[0].data) if m else 0),
        }
        if m:
            out["mask"] = np.stack([e.mask for e in self._pending])
            for j in range(int(out["n_data"])):
                out[f"data{j}"] = np.stack(
                    [e.data[j] for e in self._pending])
        return out

    def load_state_dict(self, state: dict) -> None:
        ids = np.asarray(state["ids"], np.int64)
        self._pending = []
        n_data = int(np.asarray(state.get("n_data", 0)))
        for i in range(ids.shape[0]):
            self._pending.append(_PendingEntry(
                client_id=int(ids[i]),
                origin=int(np.asarray(state["origin"])[i]),
                due=int(np.asarray(state["due"])[i]),
                frac=np.float32(np.asarray(state["frac"])[i]),
                slot=int(np.asarray(state["slot"])[i]),
                data=tuple(np.asarray(state[f"data{j}"])[i]
                           for j in range(n_data)),
                mask=np.asarray(state["mask"])[i]))
