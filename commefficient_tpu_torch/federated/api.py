"""Reference-shaped high-level API: FedModel + FedOptimizer, the port
of commefficient_tpu/federated/api.py.

The call contract is the JAX package's:

    model = FedModel(module, loss_fn, cfg, device="cuda")
    opt = FedOptimizer(model)
    opt.param_groups[0]["lr"] = lr          # or a LambdaLR scheduler
    losses, *metrics, down, up = model((client_ids, (x, y), mask))
    opt.step()

`model(batch)` runs the whole round (client compute, cohort sum,
sketch, server step, weight update) with the learning rate set before
the call; `opt.step()` only exists for call-pattern parity. Losses and
metrics come back as tensors on the model's device; download/upload are
the round's per-client byte counts (numpy), accounted one round late
exactly as in the JAX package.

Checkpointing (utils/checkpoint.py): the model tracks the clients ever
sampled (`_touched`), so `client_rows_payload` persists only their rows,
and `load_state` rebuilds the rest from their init; a telemetry session
(`attach_telemetry`) is fed each round's metric vector, byte totals and
a `compressor` event.

Faults (utils/faults.py) are drawn here on the host, as pure functions
of (seed, round), and ride into the round as RoundBatch operands:
--client_dropout and FaultSchedule drops (survivors), --straggler_rate
and scripted slow slots (work; a fraction below --straggler_cutoff
degrades to a drop), and in the screened family (round.screened_family,
or a rollback's forced window, `force_screen_rounds`) the poison or
adversary mask with the screen flag. The accountant bills the round's
admitted (or contributing) clients; the journal gets `screened`,
`aggregator` and `injected_fault` events.

Controllers (commefficient_tpu_torch/control): under
--target_screened_rate the adaptive screen's multiplier is the value of
the round's screen operand (a plan's stamped value wins over the
controller's own), and each committed round's screened count feeds it
(`screen_adapt` events); the controller bank (--speed_match,
--adapt_staleness, --scan_span_palette) stamps each fresh plan, its
plan-carried values are installed as the round is planned (the
staleness decay set on the admission buffer before it composes), every
committed round's metric row feeds its observe_commit and every
collected span's seconds its feed_span, and its moves are journaled as
`control` events.

A round scheduler (commefficient_tpu_torch/scheduler,
`attach_scheduler`) plans rounds at selection; `_faults_for_round`
composes a plan's `active` mask into the survivors (an idle slot is a
dropped client) and its `work` fractions into the straggler draw by
minimum, and the plan is journaled as a `schedule` event as the round
is planned, before it is queued (the JAX rule: no plan, no event).
Under --async_admit_rounds (federated/async_agg.py) the plan stage then
defers the round's stragglers and admits the entries due. Under
--state_tier host (federated/statestore.py) the planned cohort gets
device slots (`plan_round`, after admission) and the rows move before
the round (`execute`); spans plan every round of the span first
(`plan_span`).

A plan transport (parallel/plantransport.py, `attach_transport`) makes
each round's decision write-ahead: `_seal_plan` digests the composed
decision (the cohort after admission, its survivor, work, poison and
screen operands, the admission merges), journals it on the round's
`schedule` event (one for every round while a transport is attached,
with the serialized plan when the round had one), cross-checks it with
the other controllers, and `_flush_write_ahead` makes the journal
durable before the round, or the span, is dispatched. A deterministic
restart loads the crashed run's stream (`load_plan_stream`): the
journaled plans install into the scheduler, and each replayed round's
digest must equal the journaled one (PlanDigestError).

dp_sketch runs the RDP accountant (compress/privacy.py) on the host:
each committed round journals a `privacy` event with the cumulative
epsilon, and the run raises once --dp_target_epsilon is exceeded,
after that round's event. Epsilon is a function of the rounds done, so
a resumed run re-derives it; no accountant state is checkpointed.

Ranks (parallel/): given a parallel/mesh.Layout, or by default under
torch.distributed, --model_parallel > 1 or --num_slices > 1 (the JAX
FedModel's mesh rule, mesh.default_layout), the model runs as one rank
of a process grid. A round's batch then carries the whole cohort's
client ids and only the rank's rows of data and mask (its block of the
clients axis, `local_row_slice`; the drivers' loaders materialize only
those, data/loader.py); the fault operands, drawn on every rank from
the same seed, are cut to the block here. The round engine gathers the
per-client outputs, so losses, metrics, the byte accounting and the
accountant are the whole cohort's and identical on every rank; the
drivers attach the journal on the coordinator only. Eval gathers its
per-shard values. The client rows are sharded by rank: checkpoints
gather them (client_rows_payload, utils/checkpoint.save_checkpoint)
and a load installs each rank's block. A loss wrapped by
parallel/tp.tp_loss on a layout with a model axis shards the module
(tensor parallelism) and completes the flat gradient over the model
group.

Spans (--scan_rounds, training/scanloop.py): `dispatch_rounds` takes N
rounds staged on the host as [N, W, B, ...], places them on the device
once (pinned memory, asynchronous copies on the card) and queues the N
rounds back to back with no host read between them; each round is the
per-round path's `train_round`, operation for operation. The change
bits stay on the device as [N, D/32] until `collect_rounds`, which
brings them to the host in one copy and runs each round's accounting,
journal events and the telemetry of the whole span, in round order.
Under --pipeline the span loop dispatches span t+1 before it collects
span t, so the host stages t+1 while the card's queue still holds t.
A FaultSchedule `crash_after` inside a span cuts the span at that round;
a `crash_in_span` commits nothing. The dispatch runs under
utils/retry.with_retries, which replays it only while the client rows it
writes in place are untouched. With --pipeline the checkpoint writes
ride `ckpt_writer`, an AsyncCheckpointWriter (`drain_persistence`,
`close_persistence`).
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from commefficient_tpu_torch.hooks import explicit_transfer
from commefficient_tpu_torch.compress import RdpAccountant
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.control import (
    AdaptiveScreenController, make_bank,
)
from commefficient_tpu_torch.device import resolve_device
from commefficient_tpu_torch.federated import round as fround
from commefficient_tpu_torch.federated.accounting import (
    CommAccountant, from_words, pack_change_bits, to_words,
)
from commefficient_tpu_torch.federated.async_agg import AsyncAdmitBuffer
from commefficient_tpu_torch.federated.statestore import (
    TieredStateStore, tracked_fields,
)
from commefficient_tpu_torch.ops.flat import flatten_params
from commefficient_tpu_torch.ops.prng import PRNGKey, fold_in
from commefficient_tpu_torch.parallel import multihost as mh
from commefficient_tpu_torch.parallel import tp as tensor_parallel
from commefficient_tpu_torch.parallel.mesh import default_layout
from commefficient_tpu_torch.parallel.plantransport import (
    PlanDigestError, install_digest, journaled_plan_stream, serialize_plan,
)
from commefficient_tpu_torch.telemetry.clients import ClientThroughputTracker
from commefficient_tpu_torch.telemetry.metrics import METRIC_INDEX
from commefficient_tpu_torch.telemetry.trace import TRACE
from commefficient_tpu_torch.utils.checkpoint import (
    AsyncCheckpointWriter, config_fingerprint, validate_fingerprint,
)
from commefficient_tpu_torch.utils.faults import (
    FaultSchedule, InjectedFault, bernoulli_survivors, byzantine_mask,
    poison_mask, straggler_work_fractions,
)
from commefficient_tpu_torch.utils.retry import (
    is_transient_error, with_retries,
)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _staged(x, device) -> torch.Tensor:
    """A host array on `device` for a span: on the card through pinned
    memory with an asynchronous copy, so placing the span never waits
    for the work already queued there."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t` queued on the card's stream behind the work
    already there (pinned memory, asynchronous); `t` itself on the CPU.
    Read it after its _HostCopies.wait()."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class _HostCopies:
    """Tensors copied to the host behind the queued work, and the event
    their copies complete at. Queued right after a span's rounds, the
    copies wait for that span only: a copy queued at its collect, under
    --pipeline, would wait behind the next span already dispatched."""

    def __init__(self, device: torch.device, tensors: dict):
        self._tensors = {k: None if v is None else _host_copy(v)
                         for k, v in tensors.items()}
        self._event = None
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> dict:
        if self._event is not None:
            self._event.synchronize()
        return self._tensors


def _bank_row(metrics, cfg: Config) -> Optional[np.ndarray]:
    """The round's telemetry row on the host, for the controller bank."""
    if not cfg.telemetry:
        return None
    with explicit_transfer("controllers: the round's telemetry row"):
        return metrics.telemetry.cpu().numpy()


def _host_rows(rows: Optional[dict], host: dict) -> Optional[dict]:
    """FedModel._client_rows' `rows` completed with the host copies of
    its tensors (numpy, or a ClientState of the dense blocks, or under
    the tiered store its payload)."""
    if rows is None:
        return None
    if "tier" in rows:
        store = rows["store"]
        return store.checkpoint_rows(
            {f: host[f].numpy() for f in store.fields}, rows["tier"])
    if "dense" in rows:
        return {"dense": fround.ClientState(
            *[host[f"dense{i}"] for i in range(3)])}
    return {**rows, **{k: host[k].numpy() for k in
                       ("errors", "velocities", "weights") if k in host}}


# a round's fault operands on the host: (survivors, work, poison,
# screen), each None where the round has none
Operands = Tuple[Optional[np.ndarray], Optional[np.ndarray],
                 Optional[np.ndarray], Optional[np.float32]]


class _SpanHandle(NamedTuple):
    """One dispatched span, to be collected in dispatch order."""
    first: int                   # the span's first round index
    ids_host: np.ndarray         # [N, W] client ids, admissions merged
    operands: List[Operands]     # each round's fault operands
    crash_at: Optional[int]      # a FaultSchedule crash_after inside it
    host: _HostCopies            # the rounds' stacked metrics and bits
    n_metrics: int
    last_bits: torch.Tensor      # the last round's change bits, on device
    t_dispatch0: float
    t_dispatched: float
    span_idx: int


def _owned(x, device) -> torch.Tensor:
    """A float32 copy of a loaded array on `device`, sharing no memory
    with the checkpoint it came from (the round updates client rows in
    place)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))
    return t.to(device, torch.float32, copy=True)


class FedModel:
    def __init__(self, module: torch.nn.Module, loss_train, cfg: Config,
                 loss_val=None, device="cuda",
                 num_clients: Optional[int] = None,
                 lr_scale_vec: Optional[np.ndarray] = None,
                 layout=None):
        """module: the torch model (its flat vector is laid out as the
        JAX package's, ops/flat.py). loss_*: loss_fn(params, batch_tuple,
        mask) -> (loss, metrics), with `params` the {name: tensor} dict
        for torch.func.functional_call. lr_scale_vec: an optional [D]
        per-parameter learning-rate scale (the Fixup nets' parameter
        groups); the round then takes lr x that vector, in every mode.
        Its exact zeros mark frozen coordinates (--finetune): their
        gradients are zeroed at the source (the round's `grad_mask`), so
        they take no share of the compression budget. layout: the
        rank layout (parallel/mesh.py), or the default one under
        torch.distributed, --model_parallel > 1 or --num_slices > 1
        (module docstring); `device` is then this rank's
        (multihost.rank_device)."""
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.training = True
        vec, self.unravel = flatten_params(self.module)
        cfg = cfg.replace(grad_size=int(vec.shape[0])).validate()
        self.cfg = cfg
        self.num_clients = cfg.resolved_num_clients(num_clients)
        self.layout = self._resolve_layout(cfg, layout, loss_train)
        train_unravel = self.unravel
        rules = getattr(loss_train, "tp_rules", None)
        if (rules is not None and self.layout is not None
                and self.layout.model > 1):
            # tensor parallelism: the module takes its slices, and the
            # flat gradient is completed over the model group
            tensor_parallel.shard_module(self.module, self.layout)
            sharded = torch.from_numpy(tensor_parallel.sharded_coordinates(
                self.module, rules)).to(self.device)
            train_unravel = tensor_parallel.complete_grad_unravel(
                self.unravel, self.layout, sharded)
        grad_mask = None
        if lr_scale_vec is not None and np.any(np.asarray(lr_scale_vec) == 0):
            grad_mask = (np.asarray(lr_scale_vec) != 0).astype(np.float32)
        self.frozen_count = (0 if grad_mask is None
                             else int((grad_mask == 0).sum()))
        self._train_round = fround.make_train_fn(
            loss_train, train_unravel, cfg,
            grad_mask=(None if grad_mask is None
                       else _as_tensor(grad_mask, self.device)),
            layout=self.layout)
        self._eval_batch = fround.make_eval_fn(
            loss_val if loss_val is not None else loss_train,
            self.unravel, cfg, layout=self.layout)
        self.server = fround.init_server_state(cfg, vec)
        # under --state_tier host the blocks hold the working set only,
        # and the store moves rows between them and the host tail; with
        # a layout, the rank's block of the population
        self.clients = fround.init_client_state(
            cfg, fround.client_state_rows(cfg, self.num_clients),
            self.device, vec, layout=self.layout)
        self.state_store = None
        if cfg.state_tier != "device" and any(tracked_fields(cfg).values()):
            self.state_store = TieredStateStore(
                cfg, self.device,
                (vec.detach().cpu().numpy() if cfg.do_topk_down
                 else None), self.num_clients)
        self.accountant = CommAccountant(cfg, self.num_clients,
                                         frozen_count=self.frozen_count)
        # fault injection: an optional script (set_fault_schedule), and
        # the end of a rollback's forced-screen window (a round index)
        self.fault_schedule: Optional[FaultSchedule] = None
        self._screen_force_until = 0
        # O(cohort) checkpoints: the clients ever sampled (their rows
        # may differ from init), and under --topk_down the init weights
        # untouched rows rebuild from. A load of dense client blocks
        # loses the touched set, so saves stay dense from there on.
        self._touched: set = set()
        self._sparse_rows_ok = True
        self._init_weights_host = (vec.detach().cpu().numpy().astype(
            np.float32) if cfg.do_topk_down else None)
        # observability: the throughput tracker always exists (its state
        # rides in every checkpoint); the session is the driver's
        self.throughput = ClientThroughputTracker(self.num_clients)
        self.telemetry = None
        # the run's FedSampler, whose stream rides in checkpoints
        self.data_sampler = None
        # the run's RoundScheduler (attach_scheduler), the plans' active
        # masks by round (idle slots are kept out of the tracker) and
        # their `schedule` journal fields
        self.scheduler = None
        self._plan_active: dict = {}
        self._plan_journal: dict = {}
        # the control plane: the attached transport, a restart's
        # journaled digests by round, and whether a sealed record waits
        # for the write-ahead flush
        self.plan_transport = None
        self._replay_digests: dict = {}
        self._wa_dirty = False
        # --target_screened_rate: the adaptive screen, and each planned
        # round's stamped multiplier (a plan's value wins over the
        # controller's own); the controller bank (None without a bank
        # flag), and each planned round's `controls`
        self.screen_ctl = (AdaptiveScreenController(cfg)
                           if cfg.adaptive_screen else None)
        self._plan_screen_mult: dict = {}
        self.control_bank = make_bank(cfg)
        self._plan_controls: dict = {}
        # --async_admit_rounds: the defer/admit buffer
        self.async_admit = (
            AsyncAdmitBuffer(cfg.async_admit_rounds,
                             cfg.async_staleness_decay)
            if cfg.async_admit_rounds > 0 else None)
        # the run's threefry key; every round folds in its index
        self._key = PRNGKey(cfg.seed)
        self.lr_scale_vec = (None if lr_scale_vec is None
                             else _as_tensor(np.asarray(lr_scale_vec,
                                                        np.float32),
                                             self.device))
        # the previous round's packed change bits, on the device, and
        # their host words when a span's collect already has them
        self._prev_change_bits: Optional[torch.Tensor] = None
        self._prev_words_host: Optional[np.ndarray] = None
        self._optimizer: Optional["FedOptimizer"] = None
        # dp_sketch: epsilon is a pure function of the rounds done
        self.privacy = (RdpAccountant(cfg.dp_noise_mult, cfg.dp_delta)
                        if cfg.mode == "dp_sketch" else None)
        # the spans dispatched so far (training/scanloop.py counts them;
        # --profile_spans selects on it)
        self._spans_dispatched = 0
        # --pipeline: checkpoint serialization off the round loop
        self.ckpt_writer = (
            AsyncCheckpointWriter(drain_timeout=cfg.writer_drain_timeout_s)
            if cfg.pipeline else None)

    @staticmethod
    def _resolve_layout(cfg: Config, layout, loss_train):
        """The given layout (bound to this rank), the tp-wrapped loss's,
        the default one when a grid or a model/slice axis is asked for,
        else None (the single-process path)."""
        if layout is None:
            layout = getattr(loss_train, "tp_layout", None)
        if layout is None and (mh.is_distributed() or cfg.model_parallel > 1
                               or cfg.num_slices > 1):
            layout = default_layout(cfg)
        if layout is None:
            return None
        if layout.rank is None:
            layout.bind()
        if cfg.num_workers % layout.clients:
            raise ValueError(
                f"num_workers={cfg.num_workers} not divisible by the "
                f"{layout.clients}-way clients axis")
        return layout

    def _block(self, x):
        """The rank's block of a whole-cohort [W, ...] host operand (x
        itself without a layout, or when None or a scalar)."""
        if (self.layout is None or x is None
                or np.ndim(x) == 0):
            return x
        return np.asarray(x)[self.layout.local_row_slice(len(x))]

    def _check_rows(self, mask, W: int, leading: int = 0) -> None:
        """A rank feeds only its block's rows (multihost.local_row_slice)."""
        if self.layout is None:
            return
        got = np.shape(mask)[leading]
        want = W // self.layout.clients
        if got != want:
            raise ValueError(
                f"this rank feeds rows {self.layout.local_row_slice(W)} "
                f"of the {W}-client cohort ({want} rows), got {got}: "
                "pass the client ids of the whole cohort and only the "
                "rank's rows of data and mask")

    def train(self, training: bool):
        self.training = training

    def __call__(self, batch):
        if self.training:
            return self._call_train(batch)
        return self._call_val(batch)

    def finalize(self):
        """Nothing to tear down; kept for API parity."""

    def drain_persistence(self) -> None:
        """Block until every queued checkpoint write (--pipeline) and
        every queued spill of the tiered store is durable, re-raising a
        writer failure here; a no-op otherwise. The drivers call it
        before any synchronous save and on their way out."""
        if self.ckpt_writer is not None:
            self.ckpt_writer.drain()
        if self.state_store is not None:
            self.state_store.flush()

    def close_persistence(self) -> None:
        """drain_persistence, then stop the writer threads. Idempotent."""
        if self.ckpt_writer is not None:
            self.ckpt_writer.close()
        if self.state_store is not None:
            self.state_store.close()

    @property
    def ps_weights(self) -> torch.Tensor:
        return self.server.ps_weights

    # -- observability and checkpoint payloads ----------------------------
    def attach_telemetry(self, session) -> None:
        """Install a telemetry.TelemetrySession (or None to detach); a
        session without a tracker gets this model's `throughput`."""
        self.telemetry = session
        if session is not None and session.tracker is None:
            session.tracker = self.throughput

    def attach_data_sampler(self, sampler) -> None:
        """Install the run's FedSampler (or None): its stream state
        rides in checkpoints under `smp_*`, and load_state restores it,
        so a resumed run continues the exact data stream."""
        self.data_sampler = sampler

    def sampler_state(self) -> Optional[dict]:
        return (self.data_sampler.state_dict()
                if self.data_sampler is not None else None)

    def attach_scheduler(self, scheduler) -> None:
        """Install a scheduler.RoundScheduler (or None): its plans are
        consumed at dispatch (_faults_for_round), its state rides in
        checkpoints under `sched_*`, and under the tiered store it
        prefetches a plan's host rows. The model's adaptive screen and
        controller bank are shared with it: it stamps their values into
        every plan, and their state rides its keys."""
        self.scheduler = scheduler
        if scheduler is not None:
            scheduler.state_prefetch = (
                self.state_store.prefetch_host_rows
                if self.state_store is not None else None)
            scheduler.screen_ctl = self.screen_ctl
            scheduler.control_bank = self.control_bank

    def attach_transport(self, transport) -> None:
        """Install a plantransport.PlanTransport (or None): every
        round's decision is then digested, journaled write-ahead and
        cross-checked with the other controllers (module docstring)."""
        self.plan_transport = transport

    def load_plan_stream(self, journal_path: str) -> None:
        """A deterministic restart's hook: the crashed run's journaled
        plans install into the scheduler (replayed rounds run the
        decisions it committed, not ones recomputed from the restored
        tracker), and its digests check every replayed round."""
        self._replay_digests, plans = journaled_plan_stream(journal_path)
        if plans and self.scheduler is not None:
            self.scheduler.load_replay_plans(plans)

    def scheduler_state(self) -> Optional[dict]:
        """The `sched_*` payload of the attached scheduler, or None."""
        return (self.scheduler.state_dict()
                if self.scheduler is not None else None)

    def async_admit_state(self) -> Optional[dict]:
        """The `asyb_*` payload: the pending admissions, or None."""
        return (self.async_admit.state_dict()
                if self.async_admit is not None else None)

    @property
    def _prev_change_words(self) -> Optional[np.ndarray]:
        """The previous round's change bits as host uint32 words (the
        checkpoint's `acct_prev_change_words`)."""
        if self._prev_words_host is not None:
            return self._prev_words_host
        return (None if self._prev_change_bits is None
                else to_words(self._prev_change_bits))

    def _set_prev_bits(self, bits: Optional[torch.Tensor],
                       words: Optional[np.ndarray] = None) -> None:
        self._prev_change_bits = bits
        self._prev_words_host = words

    @property
    def checkpoint_fingerprint(self) -> dict:
        return config_fingerprint(self.cfg, self.num_clients)

    def _client_rows(self):
        """(rows, tensors): client_rows_payload's dict with each tracked
        block's rows gathered on the device, or {"dense": None} after a
        dense load, or None for a stateless config, or under the tiered
        store its LRU bookkeeping (completed by _host_rows); and the
        tensors to copy to the host by key."""
        store = self.state_store
        if store is not None:
            tier = store.snapshot_tier()
            return ({"tier": tier, "store": store},
                    store.resident_rows(self.clients, tier))
        tracked = [block.ndim == 2 for block in self.clients]
        if not any(tracked):
            return None, {}
        if not self._sparse_rows_ok:
            # a copy: the next round writes the blocks in place (the
            # whole population's, gathered, with a layout)
            if self.layout is not None:
                return {"dense": None}, {
                    f"dense{i}": torch.from_numpy(block)
                    for i, block in enumerate(self.checkpoint_clients())}
            return {"dense": None}, {
                f"dense{i}": block.clone()
                for i, block in enumerate(self.clients)}
        ids = (np.sort(np.fromiter(self._touched, np.int64))
               if self._touched else np.zeros((0,), np.int64))
        rows = {"ids": ids}
        if self._init_weights_host is not None:
            rows["base_weights"] = self._init_weights_host
        index = _staged(ids, self.device)
        tensors = {}
        for name, used in zip(("errors", "velocities", "weights"),
                              tracked):
            if used and len(ids):
                # collective with a layout: every rank takes part
                tensors[name] = fround.gather_rows_by_id(
                    getattr(self.clients, name), index, self.layout)
            else:
                rows[name] = np.zeros((0,), np.float32)
        return rows, tensors

    def checkpoint_clients(self, chunk_rows: int = 256
                           ) -> fround.ClientState:
        """The client blocks a dense checkpoint writes: the model's own
        without a layout; with one, the whole population's rows gathered
        in chunks of `chunk_rows` (collective: every rank calls it) as
        host arrays on the coordinator, [0] placeholders elsewhere."""
        if self.layout is None:
            return self.clients
        coord = mh.is_coordinator()
        out = []
        for b in self.clients:
            if b.ndim == 2:
                b = fround.gather_population(b, self.layout, chunk_rows,
                                             keep=coord)
                out.append(np.zeros((0,), np.float32) if b is None else b)
            else:
                out.append(b.detach().cpu().numpy())
        return fround.ClientState(*out)

    def state_snapshot(self) -> dict:
        """The server state and the client rows as they stand now,
        copied to the host behind the queued work, so the next span's
        in-place row writes cannot reach them. The pipelined span
        checkpoint takes one at each span's boundary; `wait_snapshot`
        reads it."""
        rows, tensors = self._client_rows()
        s = self.server
        copies = _HostCopies(self.device, {
            **tensors, "ps_weights": s.ps_weights,
            "Vvelocity": s.Vvelocity, "Verror": s.Verror})
        return {"rows": rows, "copies": copies, "round_idx": s.round_idx}

    @staticmethod
    def wait_snapshot(snap: dict) -> Tuple[fround.ServerState,
                                           Optional[dict]]:
        """(server state, client rows) of a state_snapshot on the host:
        the rows as client_rows_payload gives them, {"dense":
        ClientState} after a dense load, or None."""
        host = snap["copies"].wait()
        server = fround.ServerState(host["ps_weights"], host["Vvelocity"],
                                    host["Verror"], snap["round_idx"])
        return server, _host_rows(snap["rows"], host)

    def client_rows_payload(self) -> Optional[dict]:
        """The O(cohort) `crows_*` payload on the host: the sorted ids of
        every client ever sampled, each tracked block's rows for exactly
        those ids ([0] for untracked blocks) and, under --topk_down,
        `base_weights`. None for a stateless config or after a dense
        load; the caller then saves the dense blocks."""
        rows, tensors = self._client_rows()
        if rows is None or "dense" in rows:
            return None
        return _host_rows(rows, _HostCopies(self.device, tensors).wait())

    def load_state(self, ckpt) -> int:
        """Install a loaded utils.checkpoint.Checkpoint (written by
        either package) on this model's device; returns its scheduler
        step. A fingerprint of another config raises
        CheckpointMismatchError."""
        if ckpt.fingerprint is not None:
            validate_fingerprint(ckpt.fingerprint,
                                 self.checkpoint_fingerprint,
                                 "<loaded checkpoint>")
        dev = self.device
        s = ckpt.server
        self.server = fround.ServerState(
            _owned(s.ps_weights, dev), _owned(s.Vvelocity, dev),
            _owned(s.Verror, dev), int(s.round_idx))
        store = self.state_store
        if ckpt.client_rows is not None:
            # init (zeros, or the init weights under --topk_down) plus
            # the saved rows IS the full state: untouched rows never
            # left their init values
            rows = ckpt.client_rows
            if rows.get("base_weights") is not None:
                self._init_weights_host = np.asarray(
                    rows["base_weights"], np.float32)
            base = (self._init_weights_host
                    if self._init_weights_host is not None
                    else np.asarray(s.ps_weights, np.float32))
            self.clients = fround.init_client_state(
                self.cfg, fround.client_state_rows(self.cfg,
                                                   self.num_clients),
                dev, _owned(base, dev), layout=self.layout)
            if store is not None:
                # the store rebuilds its tiers: rows recorded resident
                # back to their slots, the rest to the tail
                store.set_init_weights(self._init_weights_host)
                store.load_rows(self.clients, rows)
                self._finish_load(ckpt)
                return ckpt.scheduler_step
            ids = np.asarray(rows["ids"], np.int64)
            self._touched = set(int(i) for i in ids)
            self._sparse_rows_ok = True
            sel = np.arange(len(ids))
            if self.layout is not None and len(ids):
                # the rows of the clients this rank holds
                R = fround.local_rows(self.num_clients, self.layout)
                lo = self.layout.clients_index * R
                sel = np.nonzero((ids >= lo) & (ids < lo + R))[0]
                ids = ids[sel] - lo
            if len(ids):
                index = torch.from_numpy(ids).to(dev)
                for name in ("errors", "velocities", "weights"):
                    data = np.asarray(rows.get(name, ()))
                    block = getattr(self.clients, name)
                    if data.ndim == 2 and block.ndim == 2:
                        block[index] = _owned(data[sel], dev)
        elif ckpt.clients is not None and store is not None:
            # dense blocks into the tiered store: the rows that differ
            # from init go to the tail, the working set starts cold
            store.import_dense({name: np.asarray(getattr(ckpt.clients,
                                                         name))
                                for name in store.fields})
        elif ckpt.clients is not None:
            # dense blocks: the touched set is unrecoverable, so this
            # model's own saves stay dense from here on. With a layout,
            # each rank takes its block (--topk_down's missing padding
            # rows from the loaded weights)
            blocks = list(ckpt.clients)
            if self.layout is not None:
                fill = [None, None, np.asarray(s.ps_weights, np.float32)]
                blocks = [fround.own_block(np.asarray(b), self.num_clients,
                                           self.layout, f)
                          if np.ndim(b) == 2 else b
                          for b, f in zip(blocks, fill)]
            self.clients = fround.ClientState(
                *[_owned(block, dev) for block in blocks])
            if any(block.ndim == 2 for block in ckpt.clients):
                self._sparse_rows_ok = False
        self._finish_load(ckpt)
        return ckpt.scheduler_step

    def _finish_load(self, ckpt) -> None:
        """Accounting, throughput, scheduler (with the controllers'
        screen_* and ctl_* keys), sampler stream, pending admissions and
        the previous round's change bits. Attach the run's scheduler and
        sampler BEFORE load_state."""
        if ckpt.accountant_state:
            self.accountant.load_state_dict(ckpt.accountant_state)
        if ckpt.throughput:
            self.throughput.load_state_dict(ckpt.throughput)
        if ckpt.scheduler and self.scheduler is not None:
            self.scheduler.load_state_dict(ckpt.scheduler)
        if ckpt.sampler and self.data_sampler is not None:
            # the drivers then continue the restored stream
            # (sampler.resolve_resume)
            self.data_sampler.load_state_dict(ckpt.sampler)
        if ckpt.async_admit and self.async_admit is not None:
            self.async_admit.load_state_dict(ckpt.async_admit)
        words = ckpt.prev_change_words
        self._set_prev_bits(
            None if words is None else from_words(words, self.device),
            None if words is None else np.asarray(words, np.uint32))

    def _lr(self):
        """The scheduler's learning rate: a float, or a [D] tensor with
        a per-parameter scale vector."""
        if self._optimizer is None:
            raise RuntimeError("attach a FedOptimizer before training")
        lr = float(self._optimizer.param_groups[0]["lr"])
        if self.lr_scale_vec is not None:
            return lr * self.lr_scale_vec
        return lr

    # -- faults (utils/faults.py) -----------------------------------------
    def set_fault_schedule(self, schedule: Optional[FaultSchedule]) -> None:
        """Install (or clear, with None) a deterministic fault script:
        scripted drops and slow slots compose with the random draws,
        scripted poison / adversary slots put the rounds in the
        screened family, crash_after raises InjectedFault once that
        round has completed and crash_in_span before it commits."""
        self.fault_schedule = schedule

    def _survivors_for_round(self, round_idx: int,
                             ids: np.ndarray) -> Optional[np.ndarray]:
        """[W] f32 survivor mask, or None when nothing drops clients."""
        mask = None
        if self.cfg.client_dropout > 0:
            mask = bernoulli_survivors(self.cfg.seed, round_idx, len(ids),
                                       self.cfg.client_dropout)
        if self.fault_schedule is not None:
            scripted = self.fault_schedule.survival_mask(round_idx, ids)
            if scripted is not None:
                mask = scripted if mask is None else mask * scripted
        return mask

    def _work_for_round(self, round_idx: int,
                        W: int) -> Optional[np.ndarray]:
        """[W] f32 work fractions, or None when nothing slows clients;
        scripted fractions compose with the draw by minimum."""
        work = None
        if self.cfg.straggler_rate > 0:
            work = straggler_work_fractions(
                self.cfg.seed, round_idx, W, self.cfg.straggler_rate,
                self.cfg.straggler_min_work)
        if self.fault_schedule is not None:
            scripted = self.fault_schedule.work_fractions(round_idx, W)
            if scripted is not None:
                work = scripted if work is None else np.minimum(work,
                                                                scripted)
        return work

    def _faults_for_round(self, round_idx: int, ids: np.ndarray):
        """(survivors, work) with --straggler_cutoff applied: a fraction
        below it degrades to a drop (survivor bit 0, work 1.0); a work
        vector left all ones is None, so the round runs exactly the
        dropout variant; work always rides with survivors.

        The scheduler's plan composes in before the cutoff: its idle
        slots zero the survivors (a dropped client's path) and its
        deadline fractions take the minimum with the straggler draw; its
        `schedule` journal fields wait for the round's seal."""
        surv = self._survivors_for_round(round_idx, ids)
        work = self._work_for_round(round_idx, len(ids))
        plan = (self.scheduler.take_plan(round_idx)
                if self.scheduler is not None else None)
        if plan is not None:
            if plan.active is not None:
                surv = (plan.active if surv is None
                        else surv * plan.active)
                self._plan_active[int(round_idx)] = plan.active
            if plan.work is not None:
                w = np.asarray(plan.work, np.float32)
                work = w if work is None else np.minimum(work, w)
            if plan.screen_mult is not None:
                self._plan_screen_mult[int(round_idx)] = float(
                    plan.screen_mult)
            if plan.controls:
                # the plan's values are the trajectory: installed as the
                # bank's live state, the decay kept for the compose
                self._plan_controls[int(round_idx)] = dict(plan.controls)
                if self.control_bank is not None:
                    self.control_bank.install(plan.controls)
            fields = plan.journal_fields()
            if self.plan_transport is not None:
                # the journal is then the decision log a restart replays
                fields["plan"] = serialize_plan(plan).decode()
            self._plan_journal[int(round_idx)] = fields
        if work is not None:
            work = np.asarray(work, np.float32)
            cutoff = self.cfg.straggler_cutoff
            if cutoff > 0:
                below = work < cutoff
                if below.any():
                    surv = (np.ones(len(ids), np.float32) if surv is None
                            else surv.copy())
                    surv[below] = 0.0
                    work = np.where(below, np.float32(1.0), work)
            if np.all(work >= 1.0):
                work = None
        if work is not None and surv is None:
            surv = np.ones(len(ids), np.float32)
        return surv, work

    def _screened_dispatch(self, round_idx: int) -> bool:
        """Whether this round runs in the screened family: screening,
        poison, adversaries or a robust aggregator configured, a forced
        window after a rollback, or scripted poison / adversaries."""
        return (fround.screened_family(self.cfg)
                or round_idx < self._screen_force_until
                or (self.fault_schedule is not None
                    and bool(self.fault_schedule.poison
                             or self.fault_schedule.byzantine)))

    def _poison_values(self, round_idx: int, W: int) -> np.ndarray:
        """[W] f32 {0,1}: the poison draw, or under --byzantine_rate the
        adversary draw (the two are exclusive), max-composed with the
        schedule's slots."""
        sched = self.fault_schedule
        if self.cfg.byzantine_rate > 0:
            mask = byzantine_mask(self.cfg.seed, round_idx, W,
                                  self.cfg.byzantine_rate)
            scripted = (None if sched is None
                        else sched.byzantine_mask_for(round_idx, W))
        else:
            mask = poison_mask(self.cfg.seed, round_idx, W,
                               self.cfg.poison_rate)
            scripted = (None if sched is None
                        else sched.poison_mask_for(round_idx, W))
        return mask if scripted is None else np.maximum(mask, scripted)

    def _screen_flag(self, round_idx: int) -> np.float32:
        """Nonzero when the admission screen applies this round
        (configured, or inside a rollback's forced window), else 0.0:
        poison then reaches the server state. Under --target_screened_
        rate the value is the norm multiplier: the round's plan's, or
        without one the controller's."""
        on = (self.cfg.update_screen != "off"
              or round_idx < self._screen_force_until)
        mult = self._plan_screen_mult.pop(int(round_idx), None)
        if not on:
            return np.float32(0.0)
        if self.cfg.adaptive_screen:
            if mult is None and self.screen_ctl is not None:
                mult = self.screen_ctl.plan_mult()
            if mult is not None:
                return np.float32(mult)
        return np.float32(1.0)

    def force_screen_rounds(self, n: int) -> None:
        """Force the admission screen on for the next `n` rounds (a
        numeric rollback's window, --rollback_screen_rounds): the
        replayed rounds draw the identical poison and screen it out."""
        self._screen_force_until = max(self._screen_force_until,
                                       self.server.round_idx + int(n))

    def _journal_fault(self, kind: str, round_idx: int) -> None:
        """An InjectedFault about to raise, durable in the journal."""
        if self.telemetry is not None:
            self.telemetry.journal_event("injected_fault", fault=kind,
                                         round=int(round_idx))
            self.telemetry.flush()

    def _seal_plan(self, round_idx: int, client_ids, survivors, work,
                   admits=(), pois=None, screen=None) -> None:
        """The write-ahead seal of a round's decision, before it is
        queued: the `schedule` event (the plan's fields, in the screened
        family the screen flag and the poisoned count), with the install
        digest while a transport or a replay stream is live; the digest
        held to the journaled one on a replay and cross-checked with the
        other controllers. Without a transport a round without a plan
        journals none (the JAX rule)."""
        fields = self._plan_journal.pop(int(round_idx), None)
        digest = None
        if self.plan_transport is not None or self._replay_digests:
            digest = install_digest(round_idx, client_ids, survivors, work,
                                    admits, poison=pois, screen_on=screen)
        if pois is not None and fields is not None:
            fields["screen_on"] = (None if screen is None
                                   else float(screen))
            fields["n_poisoned"] = int((np.asarray(pois) > 0).sum())
        if self._replay_digests:
            expect = self._replay_digests.pop(int(round_idx), None)
            if expect is not None and expect != digest:
                raise PlanDigestError(
                    f"round {round_idx}: deterministic-restart replay "
                    f"computed install digest {digest[:12]}… but the "
                    f"write-ahead journal recorded {expect[:12]}… — "
                    "the resumed control stream diverged from what "
                    "the crashed run durably committed (differing "
                    "config/seed, or a non-deterministic decision "
                    "leaked into the plan)")
        if self.plan_transport is not None and fields is None:
            # every round of a transport run: its operands and merges
            # are the decision a takeover verifies
            ids = np.asarray(client_ids).reshape(-1)
            fields = {"round": int(round_idx),
                      "sampler": self.cfg.sampler,
                      "n_sampled": int(len(ids) if survivors is None
                                       else (np.asarray(survivors)
                                             > 0).sum())}
        if fields is not None and self.telemetry is not None:
            if digest is not None:
                fields["digest"] = digest
            self.telemetry.journal_event("schedule", **fields)
            if self.plan_transport is not None:
                self._wa_dirty = True
        if self.plan_transport is not None and digest is not None:
            self.plan_transport.verify(round_idx, digest, scope="install")

    def _flush_write_ahead(self) -> None:
        """The write-ahead barrier: every sealed record durable before
        the dispatch that executes it (a no-op without a transport, and
        for the synchronous journal, durable as it returns)."""
        if self._wa_dirty:
            self._wa_dirty = False
            if self.telemetry is not None:
                self.telemetry.journal_flush()

    def _journal_round_faults(self, round_idx, survivors, admitted,
                              agg_stats) -> None:
        """A faulted round's journal: a `screened` event when the
        admission mask refused survivors, an `aggregator` event under a
        robust aggregator. The JAX writer's keys."""
        tele = self.telemetry
        if admitted is not None:
            n_screened = int((survivors > 0).sum() - (admitted > 0).sum())
            if n_screened > 0:
                tele.journal_event(
                    "screened", round=int(round_idx),
                    n_screened=n_screened,
                    kind=(self.cfg.update_screen
                          if self.cfg.update_screen != "off" else "finite"))
        if agg_stats is not None:
            resid = float(agg_stats[2])
            tele.journal_event(
                "aggregator", round=int(round_idx),
                aggregator=self.cfg.aggregator,
                n_trimmed=round(float(agg_stats[0]), 6),
                n_clipped=int(agg_stats[1]),
                residual_l2=(round(resid, 6) if np.isfinite(resid)
                             else -1.0),
                n_contrib=int(agg_stats[3]))

    def _observe_screening(self, round_idx: int, survivors,
                           admitted) -> None:
        """Feed the adaptive screen one committed round's screened count
        (every round, zero included) and journal a `screen_adapt` event
        when the multiplier moved."""
        n_cohort = int((np.asarray(survivors) > 0).sum())
        n_screened = n_cohort - int((np.asarray(admitted) > 0).sum())
        changed = self.screen_ctl.observe(round_idx, n_screened, n_cohort)
        if changed is not None and self.telemetry is not None:
            old, new, rate = changed
            self.telemetry.journal_event(
                "screen_adapt", round=int(round_idx),
                old_mult=round(old, 6), new_mult=round(new, 6),
                rate=round(rate, 6),
                target=float(self.cfg.target_screened_rate))

    @staticmethod
    def _control_signals(row) -> dict:
        """The commit-time signals of one round's [NUM_METRICS]
        telemetry row ({} with metrics off: the controllers then skip
        the round)."""
        if row is None or getattr(row, "size", 0) == 0:
            return {}
        row = np.asarray(row, np.float32)
        return {"estimate_residual": float(
            row[METRIC_INDEX["estimate_residual"]])}

    def _journal_control_events(self) -> None:
        """The bank's queued moves (stamps, commits, spans) as `control`
        events."""
        if self.control_bank is None:
            return
        events = self.control_bank.take_events()
        if self.telemetry is None:
            return
        for adj in events:
            self.telemetry.journal_event(
                "control", round=int(adj.round_idx),
                controller=str(adj.controller),
                signal=round(float(adj.signal), 6),
                old=round(float(adj.old), 6),
                new=round(float(adj.new), 6),
                clamped=bool(adj.clamped))

    def _apply_plan_controls(self, round_idx: int) -> None:
        """Set the admission buffer's decay from the round's plan, before
        the buffer composes the round."""
        controls = self._plan_controls.pop(int(round_idx), None)
        if (controls and self.async_admit is not None
                and "staleness_decay" in controls):
            self.async_admit.decay = float(
                np.float32(controls["staleness_decay"]))

    def _journal_privacy(self, round_idx: int) -> None:
        """One committed round's `privacy` event (the cumulative epsilon
        over the rounds committed so far), then the raise once the
        budget is exceeded: the crossing round is journaled first."""
        eps = float(self.privacy.epsilon(round_idx + 1))
        if self.telemetry is not None:
            self.telemetry.journal_event(
                "privacy", round=int(round_idx), epsilon=round(eps, 6),
                sigma=float(self.cfg.dp_noise_mult),
                clip=float(self.cfg.dp_clip),
                delta=float(self.cfg.dp_delta))
        target = float(self.cfg.dp_target_epsilon)
        if target > 0 and eps > target:
            raise RuntimeError(
                f"privacy budget exhausted at round {round_idx}: "
                f"cumulative epsilon {eps:.4f} exceeds "
                f"--dp_target_epsilon {target:g} at delta "
                f"{self.cfg.dp_delta:g}. Raise --dp_noise_mult, "
                f"raise --dp_target_epsilon, or train fewer rounds.")

    def _plan_round(self, round_idx: int, ids_host: np.ndarray, data,
                    mask):
        """A round's plan stage on the host: the fault operands, drawn
        as pure functions of (seed, round), with the scheduler's plan;
        the async admission merge; in the screened family the poison
        mask and screen flag (survivors then always present); the
        `schedule` event. Returns (ids, data, mask, operands) with the
        admissions merged into ids, data and mask."""
        survivors, work = self._faults_for_round(round_idx, ids_host)
        self._apply_plan_controls(round_idx)
        admits = ()
        if self.async_admit is not None:
            ids_host, data, mask, survivors, work = self.async_admit.compose(
                round_idx, ids_host, data, mask, survivors, work)
            admits = self.async_admit.last_admits
        pois = screen = None
        if self._screened_dispatch(round_idx):
            W = len(ids_host)
            pois = self._poison_values(round_idx, W)
            screen = self._screen_flag(round_idx)
            if survivors is None:
                survivors = np.ones(W, np.float32)
        self._seal_plan(round_idx, ids_host, survivors, work, admits, pois,
                        screen)
        return ids_host, data, mask, (survivors, work, pois, screen)

    def _commit_round(self, round_idx: int, ids_host: np.ndarray,
                      ops: Operands, prev_words, admitted, contributors,
                      agg_stats, bank_row=None):
        """A round's host commit, in the JAX engine's order: the
        accountant bills the clients that completed it (the admitted
        ones in the screened family, the contributors under a robust
        aggregator) against the previous round's change bits
        `prev_words`; then the screened and aggregator events, the
        adaptive screen's observation, the controller bank's (from
        `bank_row()`, the round's telemetry row, when given: the span
        path observes after its span's telemetry instead), the
        `compressor` event and dp_sketch's `privacy` event. Returns
        (download, upload)."""
        survivors = ops[0]
        bill = admitted if contributors is None else contributors
        if bill is None:
            bill = survivors
        with TRACE.span("account"):
            download, upload = self.accountant.record_round(
                ids_host, prev_words, survivors=bill)
        if self.telemetry is not None:
            if survivors is not None:
                self._journal_round_faults(round_idx, survivors, admitted,
                                           agg_stats)
        if (self.screen_ctl is not None and admitted is not None
                and survivors is not None):
            self._observe_screening(round_idx, survivors, admitted)
        if self.control_bank is not None and bank_row is not None:
            self.control_bank.observe_commit(
                round_idx, self._control_signals(bank_row()))
            self._journal_control_events()
        if self.telemetry is not None:
            # the mode's wire geometry and the round's billed upload
            self.telemetry.journal_event(
                "compressor", round=round_idx, mode=self.cfg.mode,
                wire_bytes=float(self.cfg.upload_bytes),
                up_bytes=round(float(upload.sum()), 3),
                frozen_count=self.frozen_count)
        if self.privacy is not None:
            self._journal_privacy(round_idx)
        return download, upload

    def _call_train(self, batch):
        """batch = (client_ids [W], data tuple of [W, B, ...],
        mask [W, B])."""
        client_ids, data, mask = batch
        ids_host = np.asarray(client_ids).reshape(-1)
        self._check_rows(mask, len(ids_host))
        this_round = self.server.round_idx
        if (self.fault_schedule is not None
                and self.fault_schedule.should_crash_in_span(this_round, 1)):
            # preempted while this round is in flight: nothing commits
            self._journal_fault("crash_in_span", this_round - 1)
            raise InjectedFault(this_round - 1)
        with TRACE.span("plan", round=this_round):
            ids_host, data, mask, ops = self._plan_round(
                this_round, ids_host, data, mask)
            self._flush_write_ahead()
        # the tiered store's slots for the cohort, admissions included
        tier_plan = None
        ids_device = ids_host
        if self.state_store is not None:
            tier_plan = self.state_store.plan_round(ids_host)
            ids_device = tier_plan.slots
        with TRACE.span("stage", round=this_round):
            # the previous round's change bits come to the host BEFORE
            # this round is queued, so the copy waits on that round only
            prev_words = self._prev_change_words

            def operand(x):
                # the rank's block of a per-client operand
                return None if x is None else _as_tensor(
                    np.asarray(self._block(x), np.float32), self.device)

            placed = fround.RoundBatch(
                _as_tensor(np.asarray(ids_device, np.int64), self.device),
                tuple(_as_tensor(d, self.device) for d in data),
                _as_tensor(mask, self.device).to(torch.float32),
                *[operand(x) for x in ops])
            lr = self._lr()
        prev_weights = self.server.ps_weights
        if tier_plan is not None:
            with TRACE.span("tier_motion", round=this_round):
                self.clients = self.state_store.execute(self.clients,
                                                        tier_plan)
        with TRACE.span("dispatch", round=this_round):
            self.server, self.clients, metrics = self._train_round(
                self.server, self.clients, placed, lr, self._key)
        if self.state_store is None:
            self._touched.update(int(i) for i in ids_host)
        with TRACE.span("collect", round=this_round):
            self._set_prev_bits(pack_change_bits(
                self.server.ps_weights - prev_weights))
            # the host copies wait for this round
            with explicit_transfer("screening: the round's admission "
                                   "masks, for the accountant"):
                admitted, contrib, agg = (
                    None if t is None else t.cpu().numpy()
                    for t in (metrics.admitted, metrics.contributors,
                              metrics.agg_stats))
            download, upload = self._commit_round(
                this_round, ids_host, ops, prev_words, admitted, contrib,
                agg, bank_row=lambda: _bank_row(metrics, self.cfg))
        sched_mask = self._plan_active.pop(this_round, None)
        if self.telemetry is not None:
            # the round's metric tensors, journaled one round late; idle
            # slots are kept out of the tracker
            self.telemetry.on_round(
                this_round, ids_host,
                metrics.telemetry if self.cfg.telemetry else None,
                metrics.num_examples,
                comm=(float(download.sum()), float(upload.sum())),
                scheduled=sched_mask)
            self._journal_tier(round=this_round)
        if (self.fault_schedule is not None
                and self.fault_schedule.should_crash(this_round)):
            # the round above fully completed: crash at the boundary a
            # real preemption leaves
            self._journal_fault("crash_after", this_round)
            raise InjectedFault(this_round)
        return [metrics.losses, *metrics.metrics, download, upload]

    def cohort_transmit(self, batch) -> torch.Tensor:
        """The summed client transmit of a round's batch (client_ids,
        data, mask: the rank's rows, as __call__ takes them) on the
        current weights: in the gradient modes the cohort's gradient
        sum, summed over the clients group by the round's own reduce
        (round.reduce_transmit, without its encode) and completed over
        the model group under tensor parallelism. A probe for parity
        checks: no fault operands, and the state is left as it was."""
        client_ids, data, mask = batch
        ids = np.asarray(client_ids).reshape(-1)
        self._check_rows(mask, len(ids))
        placed = fround.RoundBatch(
            _as_tensor(np.asarray(ids, np.int64), self.device),
            tuple(_as_tensor(d, self.device) for d in data),
            _as_tensor(mask, self.device).to(torch.float32))
        cohort = fround.gather_cohort(self.cfg, self.clients,
                                      placed.client_ids, self.layout)
        key = fold_in(self._key, self.server.round_idx)
        local_sum = self._train_round.client_phase(
            self.server.ps_weights, placed, cohort, self._lr(), key)[0]
        return fround.reduce_transmit(self.cfg, local_sum, self.layout,
                                      encode=False)

    def _journal_tier(self, **where) -> None:
        """The tiered store's `state_tier` event (its counters' deltas)
        and a `state_quarantine` event a re-initialized tail row."""
        store = self.state_store
        if store is None:
            return
        self.telemetry.journal_event("state_tier", **where,
                                     **store.take_journal_fields())
        for q in store.take_quarantine_events():
            self.telemetry.journal_event("state_quarantine", **where, **q)

    # -- spans (training/scanloop.py) -------------------------------------
    def _state_versions(self) -> tuple:
        """The version counters of the state tensors: a round writes the
        client rows in place (scatter_back), which moves them."""
        return tuple(t._version for t in (*self.server[:3], *self.clients))

    def run_rounds(self, client_ids, data, mask, lrs):
        """N rounds as one span: dispatch_rounds then collect_rounds,
        back to back. client_ids [N, W]; data a tuple of [N, W, B, ...];
        mask [N, W, B]; lrs N learning rates. Returns (losses [N, W],
        metrics [N, W]..., download, upload) on the host, the last two
        the span's byte totals."""
        return self.collect_rounds(
            self.dispatch_rounds(client_ids, data, mask, lrs))

    def dispatch_rounds(self, client_ids, data, mask, lrs) -> _SpanHandle:
        """Stage and queue one span without waiting for it: the fault
        operands of each round, one placement of the span's arrays, the
        rounds queued back to back under with_retries, and the copies to
        the host of what collect reads (the rounds' metrics and change
        bits). The model's state is the span's result when this returns
        (its tensors still being computed on the card). Returns the
        handle collect_rounds takes; collect handles in dispatch
        order."""
        ids_host = np.asarray(client_ids)
        self._check_rows(mask, ids_host.shape[1], leading=1)
        lrs = [float(lr) for lr in lrs]
        n_rounds = ids_host.shape[0]
        first = self.server.round_idx
        sched = self.fault_schedule
        if sched is not None and sched.should_crash_in_span(first,
                                                            n_rounds):
            # preempted while the span is in flight: nothing commits
            self._journal_fault("crash_in_span", first - 1)
            raise InjectedFault(first - 1)
        crash_at = None
        if (sched is not None and sched.crash_after is not None
                and first <= sched.crash_after < first + n_rounds):
            # the span ends at the crash round, which commits
            crash_at = int(sched.crash_after)
            n_rounds = crash_at - first + 1
            ids_host = ids_host[:n_rounds]
            lrs = lrs[:n_rounds]
            data = tuple(np.asarray(d)[:n_rounds] for d in data)
            mask = np.asarray(mask)[:n_rounds]
        span_idx = self._spans_dispatched
        with TRACE.span("plan", round=first, span=span_idx):
            operands = []
            copied = False
            for n in range(n_rounds):
                row = (ids_host[n], tuple(np.asarray(d)[n] for d in data),
                       np.asarray(mask)[n])
                ids_n, data_n, mask_n, ops = self._plan_round(
                    first + n, *row)
                operands.append(ops)
                if ids_n is not row[0]:
                    # an admission rewrote this round's rows: copy the
                    # span's arrays once, the caller's stay untouched
                    if not copied:
                        ids_host = np.array(ids_host, copy=True)
                        data = tuple(np.array(np.asarray(d), copy=True)
                                     for d in data)
                        mask = np.array(np.asarray(mask), copy=True)
                        copied = True
                    ids_host[n] = ids_n
                    for d, d_n in zip(data, data_n):
                        d[n] = d_n
                    mask[n] = mask_n
        ids_device = ids_host
        if self.state_store is not None:
            # every restore of the span before its rounds are queued;
            # each round's plan pins the span's clients resident
            with TRACE.span("tier_motion", round=first, span=span_idx):
                plans = self.state_store.plan_span(ids_host)
                for plan in plans:
                    self.clients = self.state_store.execute(self.clients,
                                                            plan)
                ids_device = np.stack([p.slots for p in plans])

        def dispatch():
            dev = self.device
            with TRACE.span("stage", round=first, span=span_idx):
                ids_d = _staged(np.asarray(ids_device, np.int64), dev)
                data_d = tuple(_staged(d, dev) for d in data)
                mask_d = _staged(mask, dev).to(torch.float32)
                ops_d = [[None if x is None else _staged(
                    np.asarray(self._block(x), np.float32), dev)
                    for x in ops] for ops in operands]
            server, clients = self.server, self.clients
            ms, bits = [], []
            for n in range(n_rounds):
                placed = fround.RoundBatch(
                    ids_d[n], tuple(d[n] for d in data_d), mask_d[n],
                    *ops_d[n])
                lr = (lrs[n] if self.lr_scale_vec is None
                      else lrs[n] * self.lr_scale_vec)
                prev = server.ps_weights
                server, clients, m = self._train_round(
                    server, clients, placed, lr, self._key)
                bits.append(pack_change_bits(server.ps_weights - prev))
                ms.append(m)

            def rows(get):
                vals = [get(m) for m in ms]
                return None if vals[0] is None else torch.stack(vals)

            # what collect reads, queued to the host behind this span
            host = _HostCopies(dev, {
                "bits": torch.stack(bits),
                "losses": rows(lambda m: m.losses),
                "counts": rows(lambda m: m.num_examples),
                "telemetry": (rows(lambda m: m.telemetry)
                              if self.cfg.telemetry else None),
                "admitted": rows(lambda m: m.admitted),
                "contributors": rows(lambda m: m.contributors),
                "agg_stats": rows(lambda m: m.agg_stats),
                **{f"metric{i}": rows(lambda m, i=i: m.metrics[i])
                   for i in range(len(ms[0].metrics))}})
            return server, clients, host, len(ms[0].metrics), bits[-1]

        # every sealed plan of the span durable before it is queued
        self._flush_write_ahead()
        versions = self._state_versions()

        def classify(exc: BaseException) -> bool:
            # transient AND the state untouched: a dispatch that wrote
            # client rows in place must not be replayed over them
            return (is_transient_error(exc)
                    and self._state_versions() == versions)

        def journal_retry(attempt: int, exc: BaseException,
                          delay: float) -> None:
            if self.telemetry is not None:
                self.telemetry.journal_event(
                    "retry", op="round span", attempt=int(attempt),
                    delay_s=round(delay, 3), error=repr(exc)[:200])

        t0 = time.monotonic()
        with TRACE.span("dispatch", round=first, span=span_idx):
            (self.server, self.clients, host, n_metrics,
             last_bits) = with_retries(
                dispatch, describe="round span", classify=classify,
                on_retry=journal_retry)
        t1 = time.monotonic()
        if self.state_store is None:
            self._touched.update(int(i) for i in ids_host.reshape(-1))
        return _SpanHandle(first, ids_host, operands, crash_at, host,
                           n_metrics, last_bits, t0, t1, span_idx)

    def collect_rounds(self, handle: _SpanHandle):
        """Wait for a dispatched span and commit it: its host copies
        (queued behind its rounds at dispatch), then round by round the
        accounting
        (round n against round n - 1's bits, the first against the
        previous span's last), the journal events and dp_sketch's
        privacy event; then the span's telemetry (`on_span`) and the
        crash_after boundary. Returns (losses [N, W], metrics [N, W]...,
        download, upload) as host arrays, the last two the span's byte
        totals."""
        first, ids_host = handle.first, handle.ids_host
        host = {k: None if v is None else v.numpy()
                for k, v in handle.host.wait().items()}   # the span done
        words = host["bits"].astype(np.uint32)
        t_blocked = time.monotonic()
        TRACE.record("device_execute", handle.t_dispatched, t_blocked,
                     round=first, span=handle.span_idx)
        download = upload = 0.0
        comm_rows = []
        with TRACE.span("collect", round=first, span=handle.span_idx):
            admitted, contrib, agg = (host["admitted"],
                                      host["contributors"],
                                      host["agg_stats"])
            prev_words = self._prev_change_words
            for n in range(ids_host.shape[0]):
                d, u = self._commit_round(
                    first + n, ids_host[n], handle.operands[n], prev_words,
                    None if admitted is None else admitted[n],
                    None if contrib is None else contrib[n],
                    None if agg is None else agg[n])
                # the next round bills against this one's bits
                prev_words = words[n]
                download += float(d.sum())
                upload += float(u.sum())
                comm_rows.append((float(d.sum()), float(u.sum())))
            self._set_prev_bits(handle.last_bits, prev_words)
            losses, counts, tele = (host["losses"], host["counts"],
                                    host["telemetry"])
            mets = [host[f"metric{i}"] for i in range(handle.n_metrics)]
        sched_rows = [self._plan_active.pop(first + n, None)
                      for n in range(ids_host.shape[0])]
        if self.telemetry is not None:
            self.telemetry.on_span(
                first, ids_host, tele, counts,
                dispatch_s=handle.t_dispatched - handle.t_dispatch0,
                block_s=t_blocked - handle.t_dispatched,
                comm_rows=comm_rows,
                scheduled_rows=(None if all(r is None for r in sched_rows)
                                else sched_rows))
            # under --pipeline the deltas include the next span's motion,
            # already planned (as in the JAX package)
            self._journal_tier(first_round=first,
                               rounds=int(ids_host.shape[0]))
        if self.control_bank is not None:
            # each round's metric row, then the span's seconds (dispatch
            # and device), then the moves journaled, before a crash
            # boundary raises
            n_done = int(ids_host.shape[0])
            for n in range(n_done):
                self.control_bank.observe_commit(
                    first + n, self._control_signals(
                        None if tele is None else tele[n]))
            self.control_bank.feed_span(first + n_done - 1, n_done,
                                        t_blocked - handle.t_dispatch0)
            self._journal_control_events()
        if handle.crash_at is not None:
            # every round up to the crash committed above
            self._journal_fault("crash_after", handle.crash_at)
            raise InjectedFault(handle.crash_at)
        return [losses, *mets, np.float64(download), np.float64(upload)]

    def _call_val(self, batch):
        """batch = (data tuple of [S, vb, ...], mask [S, vb]); returns
        per-shard [loss, *metrics, count] as numpy arrays."""
        data, mask = batch
        loss, mets, count = self._eval_batch(
            self.server.ps_weights,
            tuple(_as_tensor(d, self.device) for d in data),
            _as_tensor(mask, self.device).to(torch.float32))
        return [loss.cpu().numpy(), *[m.cpu().numpy() for m in mets],
                count.cpu().numpy()]


class FedOptimizer:
    """Holds param_groups for LR scheduling; the server update itself
    runs inside FedModel's round."""

    def __init__(self, model: FedModel, cfg: Optional[Config] = None):
        self.model = model
        self.cfg = cfg or model.cfg
        self.param_groups = [{"lr": 0.0}]
        model._optimizer = self

    def step(self):
        """No-op kept for call-pattern parity: the weight update already
        happened inside model(batch)."""

    def zero_grad(self):
        raise NotImplementedError(
            "gradients are per-round temporaries in the fused design")
