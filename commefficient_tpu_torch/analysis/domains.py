"""The central registries: the port of commefficient_tpu/analysis/
domains.py (the PRNG domain tags, the controllers' plan wire fields,
and the host-concurrency contracts graftsync enforces).

Each registry is the ONE place its names are claimed, and each is
asserted at import time:

  * DOMAINS: the PRNG domain tags. The fault, scheduler and plugin draws
    are pure functions of (seed, domain, round) on numpy's counter-based
    generator, so the streams never alias while the tags stay distinct.
    The values are the JAX package's integers, FROZEN: changing one
    changes every historical run's replay (utils/faults re-exports the
    dict, scheduler/policy and compress/ draw from it). graftlint GL009
    re-proves uniqueness on the literal dict and flags an inline hex tag
    at a `SeedSequence` / `fold_in` call anywhere in the tree.
  * CONTROL_FIELDS: controller name -> its RoundPlan wire field
    (control/base re-exports it). The journaled plan stream is the
    adjustment log a takeover replays, so two controllers on one field
    would overwrite each other's decisions; GL014 holds a `WIRE_FIELD`
    class attribute to the registered values.
  * SHARED_STATE: `Class.attr` -> the lock attribute that guards it,
    for state a writer thread and the caller's thread both mutate.
    graftsync SY001 flags a mutation outside `with self.<guard>:` and
    cross-thread-mutated state missing from here.
  * MESH_AXES: the Layout axis names (graftlint GL010).
  * PRECISION_SEAMS: the registered lossy casts (graftnum NU002).
  * ORDERING_EDGES: named happens-before contracts between host calls,
    each a call-order dominance inside one function of the port
    (graftsync SY006: `before` present and its first call ahead of every
    `after`). Names are the JAX package's, frozen; an edge may be moved
    to its function's new home, never weakened or dropped.

Stdlib only: utils/faults and control/base import this at module load,
and the lint parses it without executing anything.
"""
from __future__ import annotations

# name -> domain tag: the JAX package's values ("0D120" ~ Dropout,
# "51044" ~ SLOw, "5C4ED" ~ SChED), frozen
DOMAINS = {
    "dropout": 0x0D120,    # utils/faults.bernoulli_survivors
    "straggler": 0x51044,  # utils/faults.straggler_work_fractions
    "sampler": 0x5C4ED,    # scheduler/policy.ThroughputAwareSampler
    "poison": 0xBAD0D,     # utils/faults.poison_mask (value faults)
    "byzantine": 0xB42A1,  # utils/faults.byzantine_mask (adversaries)
    "dp": 0xD9A05,         # compress/dp_sketch per-round Gaussian noise
    "powersgd": 0x909D0,   # compress/powersgd fresh-client Q warm start
}

_values = list(DOMAINS.values())
assert len(set(_values)) == len(_values), (
    "PRNG domain collision in analysis/domains.DOMAINS: two streams "
    "sharing a tag are perfectly correlated")


def domain(name: str) -> int:
    """The registered domain tag for `name`; KeyError (with the known
    names listed) on a typo rather than a silent new stream."""
    try:
        return DOMAINS[name]
    except KeyError:
        raise KeyError(
            f"unknown PRNG domain {name!r}; registered: "
            f"{sorted(DOMAINS)} (add new streams to analysis/domains)"
        ) from None


# the mesh-axis registry: parallel/mesh.py's axis names (the JAX
# package's values, frozen). graftlint GL010 holds every axis-name
# literal at a Layout call in parallel/ and federated/ to it
CLIENTS_AXIS = "clients"
MODEL_AXIS = "model"
MESH_AXES = (CLIENTS_AXIS, MODEL_AXIS)

assert len(set(MESH_AXES)) == len(MESH_AXES), (
    "duplicate axis name in analysis/domains.MESH_AXES")


# precision seams: the places a round deliberately LOSES precision, the
# JAX package's registry re-pointed at the port's code. graftnum NU002
# holds every lossy cast a recorded round makes (float narrowing, float
# to int8/int16) to a registered (src, dst) dtype pair; a new seam is
# declared here, with its residual story, before it ships
PRECISION_SEAMS = {
    "sketch-wire-bf16": {
        "src": "float32", "dst": "bfloat16",
        "path": "commefficient_tpu_torch/ops/kernels/quant.py",
        "function": "quantize_table",
        "why": "the bf16 sketch-table wire format: the rounding is "
               "bounded per cell and lands in the error-feedback "
               "residual, which FetchSGD re-transmits",
    },
    "sketch-wire-int8": {
        "src": "float32", "dst": "int8",
        "path": "commefficient_tpu_torch/ops/kernels/quant.py",
        "function": "quantize_table",
        "why": "the int8 symmetric sketch-table wire format: a per-row "
               "scale rides beside the payload, the quantization noise "
               "lands in the error-feedback residual",
    },
    "attention-output-cast": {
        "src": "float32", "dst": "bfloat16",
        "path": "commefficient_tpu_torch/ops/attention.py",
        "function": "_flash_fwd_plain",
        "why": "the flash-attention f32 accumulator is cast back to the "
               "bf16 activation type on exit, outside the error-feedback "
               "loop",
    },
}

for _name, _seam in PRECISION_SEAMS.items():
    assert {"src", "dst", "path", "function", "why"} <= set(_seam), (
        f"PRECISION_SEAMS[{_name!r}] is missing a required field")
    assert _seam["src"] != _seam["dst"], (
        f"PRECISION_SEAMS[{_name!r}]: src and dst name the same dtype")


def precision_seam_pairs() -> set:
    """The registered (src, dst) dtype-name pairs graftnum NU002 holds
    lossy casts to."""
    return {(s["src"], s["dst"]) for s in PRECISION_SEAMS.values()}


# controller name -> plan wire field (control/), the JAX package's,
# frozen: a renamed field orphans every historical journal's plans
CONTROL_FIELDS = {
    "screen_adapt": "screen_mult",      # control/screen
    "speed_match": "speed_ratio",       # control/speed
    "span_cadence": "scan_span",        # control/span
    "staleness_decay": "staleness_decay",  # control/staleness
}

_fields = list(CONTROL_FIELDS.values())
assert len(set(_fields)) == len(_fields), (
    "controller wire-field collision in CONTROL_FIELDS: two controllers "
    "sharing a plan wire field overwrite each other's journaled "
    "adjustments")


# "Class.attr" -> its guard lock attribute on the same instance
SHARED_STATE = {
    # telemetry/trace.py: per-thread span rings, appended by every
    # producing thread (the writer threads included), drained by flush
    "Tracer._rings": "_lock",
    "Tracer._dropped": "_lock",
    # federated/statestore.py: the spill writer commits rows and their
    # CRC32s to the tail and retires pending entries while the caller's
    # thread restores, prefetches and verifies rows; quarantine records
    # are appended at verification and drained by the telemetry emitter
    "TieredStateStore._tail": "_lock",
    "TieredStateStore._pending": "_lock",
    "TieredStateStore._warm": "_lock",
    "TieredStateStore._sums": "_lock",
    "TieredStateStore._quarantined": "_lock",
    # utils/checkpoint.py: the writer thread stores its failure, the
    # caller's thread consumes (clears) it
    "AsyncCheckpointWriter._exc": "_exc_lock",
}

assert all(g for g in SHARED_STATE.values()), (
    "every SHARED_STATE entry must name its guard lock attribute")


ORDERING_EDGES = {
    # write-ahead: every plan of a span is durable in the journal before
    # the span's rounds are queued (a takeover replays the journal)
    "wal-flush-before-dispatch": {
        "path": "commefficient_tpu_torch/federated/api.py",
        "function": "dispatch_rounds",
        "before": "_flush_write_ahead",
        "after": "with_retries",
        "why": "a plan executed before its journal line is durable "
               "cannot be replayed by a coordinator takeover",
    },
    # the checkpoint payload reads the host tail only after every
    # queued spill has committed to it
    "spill-drain-before-checkpoint-payload": {
        "path": "commefficient_tpu_torch/federated/statestore.py",
        "function": "checkpoint_rows",
        "before": "flush",
        "after": "get_many",
        "why": "a payload built from a tail with spills still in "
               "flight loses evicted client rows (error-feedback "
               "state) on resume",
    },
    # both drivers' --checkpoint save goes through persist.
    # checkpoint_final: the async writer drains before the synchronous
    # final save, so the manifest rotates in order
    "writer-drain-before-save-final": {
        "path": "commefficient_tpu_torch/training/persist.py",
        "function": "checkpoint_final",
        "before": "drain_persistence",
        "after": "save_final",
        "why": "a final save overtaking queued rotating saves rotates "
               "the manifest out of order (resume picks a stale "
               "newest); cv_train.main calls this function",
    },
    "writer-drain-before-save-final-gpt2": {
        "path": "commefficient_tpu_torch/training/persist.py",
        "function": "checkpoint_final",
        "before": "drain_persistence",
        "after": "save_final",
        "why": "the same manifest-ordering contract for gpt2_train."
               "main, which calls the same function",
    },
    # every tail row a restore installs was CRC-verified (and on a
    # mismatch quarantined to its init value) inside _rows_for, before
    # the index_copy_ puts it in a device slot
    "checksum-verify-before-restore": {
        "path": "commefficient_tpu_torch/federated/statestore.py",
        "function": "_restore",
        "before": "_rows_for",
        "after": "index_copy_",
        "why": "a restore that copies tail rows to the device before "
               "their checksum verification installs silently "
               "corrupted error-feedback state in the working set",
    },
    # the spill's device-to-pinned copies are non_blocking: the CUDA
    # event recorded behind them is what the writer's commit waits on
    # (_Spill.host) before it reads the pinned rows, and the restores
    # that refill the same slots are queued after it on the stream
    "gather-barrier-before-donated-scatter": {
        "path": "commefficient_tpu_torch/federated/statestore.py",
        "function": "_spill",
        "before": "record",
        "after": "submit",
        "why": "without the event the writer thread reads pinned rows "
               "the card has not finished copying (garbage rows in the "
               "tail), and nothing orders the copy against the restore "
               "that overwrites the same slots",
    },
}

for _name, _edge in ORDERING_EDGES.items():
    assert {"path", "function", "before", "after", "why"} <= set(_edge), (
        f"ORDERING_EDGES[{_name!r}] is missing a required field")
    assert _edge["before"] != _edge["after"], (
        f"ORDERING_EDGES[{_name!r}]: before and after name the same "
        "call — the edge is vacuous")
