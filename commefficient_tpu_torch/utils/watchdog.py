"""Writer-thread watchdog: the port of commefficient_tpu/utils/watchdog.py.

The bounded-queue persistence writers (telemetry/journal.RunJournal
with `async_writer`, utils/checkpoint.AsyncCheckpointWriter) drain with
`queue.Queue.join()`, which waits forever: a hung fsync would turn the
crash-time drain into a silent hang. `drain_queue` is a join with a
deadline (`--writer_drain_timeout_s`; 0 waits forever) that raises a
TimeoutError naming the stuck writer.
"""
from __future__ import annotations

import queue
import time


def drain_queue(q: "queue.Queue", timeout: float, name: str) -> None:
    """`q.join()` bounded by `timeout` seconds (<= 0 waits forever). On
    expiry raises TimeoutError naming `name` and the writes still
    queued. Waits on the Queue's own all_tasks_done condition, so a
    completion wakes it at once."""
    if timeout is None or timeout <= 0:
        q.join()
        return
    deadline = time.monotonic() + float(timeout)
    with q.all_tasks_done:
        while q.unfinished_tasks:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"{name} writer failed to drain within "
                    f"{float(timeout):.1f}s — {q.unfinished_tasks} "
                    "queued write(s) still pending (hung fsync / dead "
                    "filesystem?). The queue is NOT drained; raise "
                    "--writer_drain_timeout_s or fix the backing "
                    "store.")
            q.all_tasks_done.wait(remaining)
