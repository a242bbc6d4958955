"""Configuration: the port's copy of the flat config namespace.

Field for field and flag for flag the same as commefficient_tpu's
Config and parse_args (itself the reference CLI's flag set), so a
launch command of the JAX drivers parses here unchanged and the
parity tests can build both configs from one argument list. The one
difference is `--device`: the port takes cuda (the default) or cpu
where the JAX package names a TPU.

`validate()` runs the same invariants as the JAX package. The port
runs every option the JAX package does (the last, `--debug_transfer_
guard`, is analysis/runtime.forbid_transfers), so it refuses none for
want of a port.

`--kernel_backend` is accepted for flag parity only. The port's route
is chosen by the tensor's device: a CUDA tensor goes through the
hand-written kernels, a CPU tensor through their plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

MODES = ("sketch", "true_topk", "local_topk", "fedavg", "uncompressed",
         "powersgd", "dp_sketch")
ERROR_TYPES = ("none", "local", "virtual")
DP_MODES = ("worker", "server")
SCREEN_MODES = ("off", "finite", "norm")
POISON_KINDS = ("nan", "inf", "scale")
AGGREGATORS = ("mean", "coord_median", "trimmed_mean", "norm_clip")
ATTACKS = ("sign_flip", "scaled", "colluding", "little_is_enough")

FED_DATASETS = {
    "CIFAR10": 10,
    "CIFAR100": 100,
    "EMNIST": 62,
    "ImageNet": 1000,
    "PERSONA": -1,
}

DEFAULT_NUM_CLIENTS = {
    "EMNIST": 3500,
    "PERSONA": 17568,
}

def num_classes_of_dataset(dataset_name: str) -> int:
    return FED_DATASETS[dataset_name]


@dataclass(frozen=True)
class Config:
    # meta
    do_test: bool = False
    mode: str = "sketch"
    use_tensorboard: bool = False
    seed: int = 21

    # data / model
    model: str = "ResNet9"
    do_finetune: bool = False
    do_checkpoint: bool = False
    checkpoint_path: str = "./checkpoint"
    checkpoint_every: int = 0
    resume: bool = False
    finetune_path: str = "./finetune"
    finetuned_from: Optional[str] = None
    num_results_train: int = 2
    num_results_val: int = 2
    dataset_name: str = "CIFAR10"
    dataset_dir: str = "./dataset"
    do_batchnorm: bool = False
    nan_threshold: float = 999.0
    do_profile: bool = False

    # observability (telemetry/: the run journal, the stage tracer)
    telemetry: bool = True
    journal_path: str = ""
    profile_spans: str = ""
    debug_transfer_guard: bool = False
    trace: bool = False

    # compression
    k: int = 50000
    num_cols: int = 500000
    num_rows: int = 5
    num_blocks: int = 20
    do_topk_down: bool = False
    down_k: int = 0
    kernel_backend: str = "xla"
    sketch_table_dtype: str = "f32"

    # optimization
    local_momentum: float = 0.9
    virtual_momentum: float = 0.0
    weight_decay: float = 5e-4
    num_epochs: float = 24.0
    num_fedavg_epochs: int = 1
    fedavg_batch_size: int = -1
    fedavg_lr_decay: float = 1.0
    error_type: str = "none"
    lr_scale: Optional[float] = None
    pivot_epoch: float = 5.0

    # fault tolerance and integrity
    client_dropout: float = 0.0
    donate_round_state: bool = True
    straggler_rate: float = 0.0
    straggler_min_work: float = 0.1
    straggler_cutoff: float = 0.0
    update_screen: str = "off"
    screen_norm_mult: float = 5.0
    poison_rate: float = 0.0
    poison_kind: str = "nan"
    aggregator: str = "mean"
    trim_beta: float = 0.2
    byzantine_rate: float = 0.0
    attack: str = "sign_flip"
    target_screened_rate: float = -1.0
    screen_adapt_step: float = 0.5
    screen_mult_min: float = 1.5
    screen_mult_max: float = 64.0
    speed_match: bool = False
    speed_match_target: float = 0.25
    speed_match_step: float = 0.25
    speed_ratio: float = 0.5
    speed_ratio_min: float = 0.25
    speed_ratio_max: float = 0.9
    scan_span_palette: str = ""
    adapt_staleness: bool = False
    staleness_target: float = 0.3
    staleness_step: float = 0.25
    staleness_decay_min: float = 0.2
    staleness_decay_max: float = 0.95
    rollback_screen_rounds: int = 8
    max_numeric_rollbacks: int = 2
    keep_checkpoints: int = 3
    ckpt_max_age_hours: float = 0.0
    ckpt_every_spans: int = 1

    # parallelization
    port: int = 5315
    scan_rounds: bool = False
    scan_span: int = 0
    num_clients: Optional[int] = None
    num_workers: int = 1
    model_parallel: int = 1
    num_slices: int = 1
    multihost: bool = False
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1
    do_bf16: bool = False
    do_remat: bool = False
    max_local_batch: int = -1
    # where the port runs: "cuda" (the default; raises without a GPU)
    # or "cpu" (the kernels' plain versions). The JAX package's default
    # here is "tpu"; the flag name and destination are the same.
    device: str = "cuda"
    num_devices: int = 1
    share_ps_gpu: bool = False
    do_iid: bool = False
    train_dataloader_workers: int = 0
    val_dataloader_workers: int = 0

    # GPT2
    model_checkpoint: str = "gpt2"
    num_candidates: int = 2
    max_history: int = 2
    local_batch_size: int = 8
    valid_batch_size: int = 8
    microbatch_size: int = -1
    lm_coef: float = 1.0
    mc_coef: float = 1.0
    max_grad_norm: Optional[float] = None
    personality_permutations: int = 1
    eval_before_start: bool = False

    # differential privacy
    do_dp: bool = False
    dp_mode: str = "worker"
    l2_norm_clip: float = 1.0
    noise_multiplier: float = 0.0

    # compressor plugin knobs
    powersgd_rank: int = 2
    dp_clip: float = 1.0
    dp_noise_mult: float = 0.0
    dp_target_epsilon: float = 0.0
    dp_delta: float = 1e-5

    # round scheduling
    sampler: str = "uniform"
    explore_floor: float = 0.1
    deadline_quantile: float = 0.0
    deadline_min_work: float = 0.1
    target_survivors: int = 0

    # pipelining, async admission, tiered state, control plane
    pipeline: bool = False
    async_admit_rounds: int = 0
    async_staleness_decay: float = 0.5
    state_tier: str = "device"
    state_working_set: int = 0
    state_spill_dir: str = ""
    plan_transport: str = ""
    plan_controllers: int = 2
    writer_drain_timeout_s: float = 0.0

    # set after model construction (number of flat parameters)
    grad_size: int = 0

    # --- derived helpers -------------------------------------------------
    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def compressor(self):
        """The Compressor plugin for this mode (lazy import: the
        compress package imports this module)."""
        from commefficient_tpu_torch.compress import get_compressor
        return get_compressor(self.mode)

    @property
    def state_shape(self) -> Tuple[int, ...]:
        """Shape of the server accumulators (an [r, c] table for
        sketch, [grad_size] otherwise)."""
        return self.compressor.state_shape(self)

    @property
    def upload_floats(self) -> int:
        return self.compressor.wire_floats(self)

    @property
    def upload_bytes(self) -> int:
        return self.compressor.wire_bytes(self)

    @property
    def defer_sketch_encode(self) -> bool:
        """Sketch linearity: with nothing nonlinear applied per client
        the sum of client sketches equals the sketch of the summed
        gradient, so the round encodes the client sum ONCE."""
        return (self.mode == "sketch" and not self.do_dp
                and self.max_grad_norm is None)

    @property
    def fused_client_backward(self) -> bool:
        """Backward linearity: when every client transmit is linear in
        its gradient, the cohort's summed transmit is the gradient of
        the count-weighted summed loss, so the round runs ONE backward
        over all clients. Microbatching is gated out."""
        return (self.mode in ("sketch", "uncompressed", "true_topk")
                and not self.do_dp and self.max_grad_norm is None
                and self.local_momentum == 0
                and self.error_type != "local"
                and not self.do_topk_down
                and self.microbatch_size <= 0)

    @property
    def robust_aggregation(self) -> bool:
        if self.aggregator == "trimmed_mean" and self.trim_beta == 0.0:
            return False
        return self.aggregator != "mean"

    @property
    def adaptive_screen(self) -> bool:
        """The norm screen's multiplier is the plan-carried value the
        AdaptiveScreenController moves (the round's screen operand);
        otherwise the static screen_norm_mult."""
        return (self.target_screened_rate >= 0.0
                and self.update_screen == "norm")

    @property
    def span_palette(self) -> tuple:
        """--scan_span_palette parsed: ascending unique span lengths, ()
        when off. Ascending is the warmup order and the argmin's tie
        break (the shortest span wins a tie)."""
        s = self.scan_span_palette.strip()
        if not s:
            return ()
        return tuple(sorted({int(tok) for tok in s.split(",")
                             if tok.strip()}))

    @property
    def control_loop(self) -> bool:
        """A bank controller is on: control.make_bank builds a bank
        exactly then."""
        return bool(self.speed_match or self.span_palette
                    or self.adapt_staleness)

    def resolved_num_clients(self,
                             dataset_num_clients: Optional[int] = None) -> int:
        if self.num_clients is not None:
            return self.num_clients
        if dataset_num_clients is not None:
            return dataset_num_clients
        if self.dataset_name in DEFAULT_NUM_CLIENTS:
            return DEFAULT_NUM_CLIENTS[self.dataset_name]
        raise ValueError(
            f"num_clients must be given for dataset {self.dataset_name}")

    def validate(self) -> "Config":
        """The JAX package's invariants (ValueError)."""
        self._validate_invariants()
        return self

    def _validate_invariants(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode}")
        if self.error_type not in ERROR_TYPES:
            raise ValueError(f"unknown error_type {self.error_type}")
        if self.dp_mode not in DP_MODES:
            raise ValueError(f"unknown dp_mode {self.dp_mode}")
        if self.mode == "fedavg":
            if self.local_batch_size != -1:
                raise ValueError("fedavg requires local_batch_size == -1")
            if self.local_momentum != 0:
                raise ValueError("fedavg requires local_momentum == 0")
            if self.error_type != "none":
                raise ValueError("fedavg requires error_type == none")
        if self.mode == "true_topk" and self.error_type != "virtual":
            raise ValueError("true_topk requires error_type == virtual")
        if self.mode == "local_topk" and self.error_type == "virtual":
            raise ValueError("local_topk cannot use virtual error")
        if self.mode == "sketch":
            if self.error_type == "local" and self.virtual_momentum != 0:
                raise ValueError(
                    "sketch+local error requires virtual_momentum=0")
            if self.error_type == "virtual" and self.local_momentum != 0:
                raise ValueError(
                    "sketch+virtual error requires local_momentum=0")
            if self.error_type == "local":
                raise ValueError(
                    "sketch mode cannot use per-client local error "
                    "accumulation")
            if self.local_momentum != 0:
                raise ValueError("sketch mode cannot use local momentum")
        if self.mode == "uncompressed" and self.error_type == "local":
            raise ValueError(
                "uncompressed cannot use local error accumulation")
        if not 0.0 <= self.client_dropout < 1.0:
            raise ValueError(
                f"client_dropout={self.client_dropout} must be in [0, 1)")
        if not 0.0 <= self.straggler_rate <= 1.0:
            raise ValueError(
                f"straggler_rate={self.straggler_rate} must be in [0, 1]")
        if not 0.0 < self.straggler_min_work <= 1.0:
            raise ValueError(
                f"straggler_min_work={self.straggler_min_work} must be in "
                "(0, 1] (zero work is dropout: use client_dropout or "
                "straggler_cutoff)")
        if not 0.0 <= self.straggler_cutoff <= 1.0:
            raise ValueError(
                f"straggler_cutoff={self.straggler_cutoff} must be in "
                "[0, 1] (fractions below it degrade to dropout)")
        if self.update_screen not in SCREEN_MODES:
            raise ValueError(f"unknown update_screen {self.update_screen!r}")
        if self.screen_norm_mult <= 1.0:
            raise ValueError(
                f"screen_norm_mult={self.screen_norm_mult} must be > 1 "
                "(an update at the cohort median is not an outlier)")
        if not 0.0 <= self.poison_rate < 1.0:
            raise ValueError(
                f"poison_rate={self.poison_rate} must be in [0, 1)")
        if self.poison_kind not in POISON_KINDS:
            raise ValueError(f"unknown poison_kind {self.poison_kind!r}")
        if self.aggregator not in AGGREGATORS:
            raise ValueError(f"unknown aggregator {self.aggregator!r}")
        if not 0.0 <= self.trim_beta < 0.5:
            raise ValueError(
                f"trim_beta={self.trim_beta} must be in [0, 0.5) (trimming "
                "half the cohort from each end leaves no client)")
        if not 0.0 <= self.byzantine_rate < 1.0:
            raise ValueError(
                f"byzantine_rate={self.byzantine_rate} must be in [0, 1)")
        if self.attack not in ATTACKS:
            raise ValueError(f"unknown attack {self.attack!r}")
        if self.byzantine_rate > 0 and self.poison_rate > 0:
            raise ValueError(
                "--byzantine_rate and --poison_rate are mutually exclusive: "
                "both ride the per-client fault operand")
        if self.target_screened_rate >= 0:
            if self.update_screen != "norm":
                raise ValueError(
                    "--target_screened_rate adapts the NORM-screen "
                    "threshold and requires --update_screen norm "
                    "(finite screening has no threshold to adapt)")
            if self.target_screened_rate >= 1.0:
                raise ValueError(
                    f"target_screened_rate={self.target_screened_rate}"
                    " must be < 1 (screening the whole cohort every "
                    "round is a dead run)")
        if self.screen_adapt_step <= 0:
            raise ValueError(
                "screen_adapt_step must be > 0 (the multiplicative "
                "adjustment factor is 1 + step)")
        if not 1.0 < self.screen_mult_min <= self.screen_mult_max:
            raise ValueError(
                f"need 1 < screen_mult_min={self.screen_mult_min} <= "
                f"screen_mult_max={self.screen_mult_max} (same > 1 "
                "floor as screen_norm_mult)")
        if self.rollback_screen_rounds < 1:
            raise ValueError(
                "rollback_screen_rounds must be >= 1: a rollback with no "
                "forced-screen round replays the same non-finite update")
        if self.max_numeric_rollbacks < 0:
            raise ValueError(
                "max_numeric_rollbacks must be >= 0 (0 = a numeric trip "
                "fails loud at once)")
        if self.sampler not in ("uniform", "throughput"):
            raise ValueError(
                f"unknown sampler {self.sampler!r} (choices: uniform, "
                "throughput — commefficient_tpu/scheduler)")
        if not 0.0 <= self.explore_floor <= 1.0:
            raise ValueError(
                f"explore_floor={self.explore_floor} must be in [0, 1] "
                "(1.0 degenerates throughput sampling to uniform)")
        if not 0.0 <= self.deadline_quantile <= 1.0:
            raise ValueError(
                f"deadline_quantile={self.deadline_quantile} must be "
                "in [0, 1] (0 = no deadline)")
        if not 0.0 < self.deadline_min_work <= 1.0:
            raise ValueError(
                f"deadline_min_work={self.deadline_min_work} must be "
                "in (0, 1] — zero work is dropout, not a deadline "
                "truncation (use straggler_cutoff for degradation)")
        if self.target_survivors < 0:
            raise ValueError("target_survivors must be >= 0 (0 = fill "
                             "every participant slot)")
        if self.target_survivors > self.num_workers:
            raise ValueError(
                f"target_survivors={self.target_survivors} exceeds "
                f"num_workers={self.num_workers}: a round cannot "
                "produce more survivors than compiled participant "
                "slots")
        if not self.telemetry and (self.sampler != "uniform"
                                   or self.deadline_quantile > 0):
            # nothing would feed the tracker these policies read
            raise ValueError(
                "--sampler throughput / --deadline_quantile require "
                "telemetry (drop --no_telemetry: the session feeds "
                "the throughput measurements these policies read)")
        if self.async_admit_rounds < 0:
            raise ValueError(
                "async_admit_rounds must be >= 0 (0 = synchronous "
                "stragglers, k = admit late contributions k rounds on)")
        if not 0.0 < self.async_staleness_decay <= 1.0:
            raise ValueError(
                f"async_staleness_decay={self.async_staleness_decay} "
                "must be in (0, 1] (1.0 = undiscounted late admission)")
        if self.plan_transport not in ("", "collective", "emulated"):
            raise ValueError(
                f"unknown plan_transport {self.plan_transport!r} "
                "(choices: '' — none, collective — the production "
                "one-to-all host collective, emulated — the in-process "
                "N-controller harness; parallel/plantransport.py)")
        if self.plan_controllers < 1:
            raise ValueError("plan_controllers must be >= 1")
        if self.plan_transport == "emulated" and self.plan_controllers < 2:
            raise ValueError(
                "--plan_transport emulated needs --plan_controllers "
                ">= 2 (one coordinator plus at least one follower — "
                "a single controller has nobody to broadcast to and "
                "would silently test nothing)")
        if self.plan_transport and self.do_checkpoint \
                and not self.journal_path:
            raise ValueError(
                "--plan_transport with --checkpoint requires an "
                "explicit --journal_path: the write-ahead plan "
                "journal is the authoritative decision log a "
                "--resume takeover replays, and the default journal "
                "location (<run dir>/journal.jsonl) is a fresh "
                "timestamped directory each run — a resumed process "
                "could never find the crashed run's stream and would "
                "silently recompute (and diverge from) its durably "
                "committed plans")
        if self.plan_transport == "emulated" and self.multihost:
            raise ValueError(
                "--plan_transport emulated is the IN-PROCESS "
                "N-controller harness (one process pretending to be "
                "many) and cannot coexist with real multihost; use "
                "--plan_transport collective there")
        if (self.multihost and not self.plan_transport
                and (self.sampler != "uniform"
                     or self.deadline_quantile > 0
                     or self.target_survivors > 0)):
            raise ValueError(
                "scheduler policies (--sampler throughput / "
                "--deadline_quantile / --target_survivors) derive from "
                "process-local wall-clock throughput measurements and "
                "would diverge across controllers without a plan "
                "transport: attach --plan_transport collective (the "
                "coordinator broadcasts each round's RoundPlan and "
                "every process installs the received plan — "
                "parallel/plantransport.py)")
        if self.multihost and self.pipeline:
            raise ValueError(
                "--pipeline is single-controller only for now: the "
                "persistence writer threads and the one-span-late "
                "commit would need cross-process barriers (a ROADMAP "
                "opening — the plan transport does not cover it)")
        if (self.multihost and self.async_admit_rounds > 0
                and not self.plan_transport):
            raise ValueError(
                "--async_admit_rounds needs a plan transport in "
                "multihost runs: the defer/admit merges are control "
                "decisions every controller must prove identical "
                "(each process defers/admits its OWN batch rows, but "
                "the slot/weight stream is digest-cross-checked) — "
                "attach --plan_transport collective "
                "(parallel/plantransport.py)")
        self._validate_controllers()
        if self.state_tier not in ("device", "host"):
            raise ValueError(
                f"unknown state_tier {self.state_tier!r} (choices: "
                "device — full population in device HBM, the default — "
                "or host — LRU working set on device, cold tail on "
                "host; federated/statestore.py)")
        if self.state_working_set < 0:
            raise ValueError("state_working_set must be >= 0")
        if self.state_tier != "device":
            if self.state_working_set <= 0:
                raise ValueError(
                    "--state_tier host requires --state_working_set N "
                    "(the device-HBM row budget; must be >= "
                    "num_workers)")
            if self.state_working_set < self.num_workers:
                raise ValueError(
                    f"state_working_set={self.state_working_set} < "
                    f"num_workers={self.num_workers}: one round's "
                    "whole cohort must fit in the device working set")
            if self.multihost:
                raise ValueError(
                    "--state_tier host is single-controller only for "
                    "now: the host tail is process-local state and "
                    "would need per-process sharded spill/restore "
                    "(the coordinator-broadcast ROADMAP opening)")
        if self.state_spill_dir and self.state_tier == "device":
            raise ValueError(
                "--state_spill_dir backs the HOST tail and requires "
                "--state_tier host (the device tier has no tail to "
                "spill)")
        if self.state_working_set > 0 and self.state_tier == "device":
            # the full population blocks would be allocated anyway
            raise ValueError(
                "--state_working_set caps the device-resident rows of "
                "the HOST tier and requires --state_tier host (the "
                "device tier keeps every row in HBM, uncapped)")
        if self.kernel_backend not in ("xla", "pallas"):
            raise ValueError(
                f"unknown kernel_backend {self.kernel_backend!r}")
        if self.sketch_table_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(
                f"unknown sketch_table_dtype {self.sketch_table_dtype!r}")
        if self.sketch_table_dtype != "f32" and self.mode != "sketch":
            raise ValueError(
                "--sketch_table_dtype requires --mode sketch")
        if self.down_k < 0:
            raise ValueError("down_k must be >= 0 (0 = share the upload k)")
        if self.down_k > self.grad_size > 0:
            raise ValueError(
                f"down_k={self.down_k} exceeds grad_size={self.grad_size}")
        if self.num_rows < 1 or self.num_cols < 1:
            raise ValueError("num_rows and num_cols must be >= 1")
        if self.trace and not self.telemetry:
            # the session drains the tracer's rings into the journal
            raise ValueError(
                "--trace requires telemetry (drop --no_telemetry: "
                "the session drains the trace rings into the journal)")
        if self.ckpt_every_spans < 0:
            raise ValueError(
                "ckpt_every_spans must be >= 0 (0 = no span-boundary "
                "saves, only the epoch cadence)")
        if self.profile_spans:
            # a malformed spec fails here, with the flag named
            from commefficient_tpu_torch.telemetry import (
                parse_profile_spans,
            )
            parse_profile_spans(self.profile_spans)
            if not self.scan_rounds:
                raise ValueError(
                    "--profile_spans requires --scan_rounds (span "
                    "indices select SCANNED spans; use --profile for "
                    "the per-round path's whole-first-epoch trace)")
            if not self.telemetry:
                raise ValueError(
                    "--profile_spans requires telemetry (drop "
                    "--no_telemetry: the session drives the capture)")
        if self.writer_drain_timeout_s < 0:
            raise ValueError(
                "writer_drain_timeout_s must be >= 0 (0 = wait "
                "forever; positive = a hung journal/checkpoint writer "
                "drain raises TimeoutError naming the writer)")
        if self.dp_noise_mult != 0 and self.mode != "dp_sketch":
            raise ValueError(
                "--dp_noise_mult calibrates the dp_sketch Gaussian "
                f"mechanism and requires --mode dp_sketch (got "
                f"{self.mode!r}; --dp/--noise_multiplier is the "
                "separate per-gradient DP path)")
        if self.dp_target_epsilon != 0 and self.mode != "dp_sketch":
            raise ValueError(
                "--dp_target_epsilon bounds the dp_sketch privacy "
                "budget and requires --mode dp_sketch (got "
                f"{self.mode!r})")
        # the plugin's own invariants
        self.compressor.validate(self)

    def _validate_controllers(self) -> None:
        """The JAX package's checks of the controller bank's flags."""
        if self.speed_match:
            if self.async_admit_rounds <= 0:
                raise ValueError(
                    "--speed_match defers measured-slow clients into "
                    "async admission slots — it needs "
                    "--async_admit_rounds > 0 to have somewhere to "
                    "put them")
            if not 0.0 < self.speed_match_target < 1.0:
                raise ValueError(
                    f"speed_match_target={self.speed_match_target} "
                    "must be in (0, 1) (the deferred cohort fraction "
                    "the ratio is steered toward)")
            if self.speed_match_step <= 0:
                raise ValueError(
                    "speed_match_step must be > 0 (the multiplicative "
                    "adjustment per observed round)")
            if not (0.0 < self.speed_ratio_min
                    <= self.speed_ratio_max < 1.0):
                raise ValueError(
                    f"need 0 < speed_ratio_min={self.speed_ratio_min} "
                    f"<= speed_ratio_max={self.speed_ratio_max} < 1: "
                    "a ratio >= 1 would flag at-median clients as "
                    "slow and could defer half the cohort every round")
        if self.scan_span_palette.strip():
            pal = self.span_palette
            if any(p <= 0 for p in pal):
                raise ValueError(
                    f"scan_span_palette={self.scan_span_palette!r}: "
                    "span lengths must be positive")
            if 1 not in pal:
                raise ValueError(
                    f"scan_span_palette={self.scan_span_palette!r} "
                    "must include 1: the stream tail decomposes "
                    "greedily over the palette, and only a 1-span can "
                    "finish an arbitrary leftover without tracing a "
                    "new program shape")
            if not self.scan_rounds:
                raise ValueError(
                    "--scan_span_palette sizes the scanned staging "
                    "loop — enable --scan_rounds")
            if self.scan_span > 0:
                raise ValueError(
                    "--scan_span and --scan_span_palette are mutually "
                    "exclusive: the palette controller owns the span "
                    "length (static spans = --scan_span alone)")
        if self.adapt_staleness:
            if self.async_admit_rounds <= 0:
                raise ValueError(
                    "--adapt_staleness tunes the async admission "
                    "staleness discount — it needs "
                    "--async_admit_rounds > 0 for the discount to "
                    "apply to anything")
            if self.staleness_step <= 0:
                raise ValueError(
                    "staleness_step must be > 0 (the multiplicative "
                    "adjustment per observed round)")
            if not (0.0 < self.staleness_decay_min
                    <= self.staleness_decay_max <= 1.0):
                raise ValueError(
                    f"need 0 < staleness_decay_min="
                    f"{self.staleness_decay_min} <= staleness_decay_max="
                    f"{self.staleness_decay_max} <= 1 (1.0 = "
                    "undiscounted late admission)")
            if (self.pipeline and self.scan_rounds
                    and self.scan_span <= 0
                    and not self.scan_span_palette.strip()):
                raise ValueError(
                    "--adapt_staleness stamps a fixed-lag decay (the "
                    "lag bounds how far staging can run ahead of "
                    "commits), so pipelined --scan_rounds needs a "
                    "bounded span: set --scan_span or "
                    "--scan_span_palette (epoch-sized spans have no "
                    "static bound)")


def _build_parser(default_lr: Optional[float] = None) -> argparse.ArgumentParser:
    """The same flags, names, defaults and destinations as the JAX
    package's parser (the reference CLI surface)."""
    p = argparse.ArgumentParser()
    a = p.add_argument
    a("--test", action="store_true", dest="do_test")
    a("--mode", choices=list(MODES), default="sketch")
    a("--tensorboard", dest="use_tensorboard", action="store_true")
    a("--seed", type=int, default=21)

    a("--model", default="ResNet9")
    a("--finetune", action="store_true", dest="do_finetune")
    a("--checkpoint", action="store_true", dest="do_checkpoint")
    a("--checkpoint_path", type=str, default="./checkpoint")
    a("--checkpoint_every", type=int, default=0)
    a("--resume", action="store_true")
    a("--finetune_path", type=str, default="./finetune")
    a("--finetuned_from", type=str, choices=list(FED_DATASETS))
    a("--num_results_train", type=int, default=2)
    a("--num_results_val", type=int, default=2)
    a("--dataset_name", type=str, default="CIFAR10",
      choices=list(FED_DATASETS))
    a("--dataset_dir", type=str, default="./dataset")
    a("--batchnorm", action="store_true", dest="do_batchnorm")
    a("--nan_threshold", type=float, default=999)
    a("--profile", action="store_true", dest="do_profile")
    a("--no_telemetry", action="store_false", dest="telemetry")
    a("--journal_path", type=str, default="")
    a("--profile_spans", type=str, default="")
    a("--trace", action="store_true")
    a("--debug_transfer_guard", action="store_true")

    a("--k", type=int, default=50000)
    a("--num_cols", type=int, default=500000)
    a("--num_rows", type=int, default=5)
    a("--num_blocks", type=int, default=20)
    a("--topk_down", action="store_true", dest="do_topk_down")
    a("--down_k", type=int, default=0)
    a("--kernel_backend", choices=("xla", "pallas"), default="xla",
      help="accepted for flag parity; the port routes by the tensor's "
           "device (CUDA kernels on the card, plain versions on the CPU)")
    a("--sketch_table_dtype", choices=("f32", "bf16", "int8"),
      default="f32")

    a("--local_momentum", type=float, default=0.9)
    a("--virtual_momentum", type=float, default=0)
    a("--weight_decay", type=float, default=5e-4)
    a("--num_epochs", type=float, default=24)
    a("--num_fedavg_epochs", type=int, default=1)
    a("--fedavg_batch_size", type=int, default=-1)
    a("--fedavg_lr_decay", type=float, default=1)
    a("--error_type", choices=list(ERROR_TYPES), default="none")
    a("--lr_scale", type=float, default=default_lr)
    a("--pivot_epoch", type=float, default=5)

    a("--client_dropout", type=float, default=0.0)
    a("--no_donate_round_state", action="store_false",
      dest="donate_round_state")
    a("--straggler_rate", type=float, default=0.0)
    a("--straggler_min_work", type=float, default=0.1)
    a("--straggler_cutoff", type=float, default=0.0)
    a("--update_screen", choices=list(SCREEN_MODES), default="off")
    a("--screen_norm_mult", type=float, default=5.0)
    a("--poison_rate", type=float, default=0.0)
    a("--poison_kind", choices=list(POISON_KINDS), default="nan")
    a("--aggregator", choices=list(AGGREGATORS), default="mean")
    a("--trim_beta", type=float, default=0.2)
    a("--byzantine_rate", type=float, default=0.0)
    a("--attack", choices=list(ATTACKS), default="sign_flip")
    a("--target_screened_rate", type=float, default=-1.0)
    a("--screen_adapt_step", type=float, default=0.5)
    a("--screen_mult_min", type=float, default=1.5)
    a("--screen_mult_max", type=float, default=64.0)
    a("--speed_match", action="store_true")
    a("--speed_match_target", type=float, default=0.25)
    a("--speed_match_step", type=float, default=0.25)
    a("--speed_ratio", type=float, default=0.5)
    a("--speed_ratio_min", type=float, default=0.25)
    a("--speed_ratio_max", type=float, default=0.9)
    a("--scan_span_palette", type=str, default="")
    a("--adapt_staleness", action="store_true")
    a("--staleness_target", type=float, default=0.3)
    a("--staleness_step", type=float, default=0.25)
    a("--staleness_decay_min", type=float, default=0.2)
    a("--staleness_decay_max", type=float, default=0.95)
    a("--rollback_screen_rounds", type=int, default=8)
    a("--max_numeric_rollbacks", type=int, default=2)
    a("--keep_checkpoints", type=int, default=3)
    a("--ckpt_max_age_hours", type=float, default=0.0)
    a("--ckpt_every_spans", type=int, default=1)

    a("--pipeline", action="store_true")
    a("--async_admit_rounds", type=int, default=0)
    a("--async_staleness_decay", type=float, default=0.5)
    a("--state_tier", choices=("device", "host"), default="device")
    a("--state_working_set", type=int, default=0)
    a("--state_spill_dir", type=str, default="")
    a("--plan_transport", choices=("", "collective", "emulated"),
      default="",
      help="coordinator-broadcast control plane "
           "(parallel/plantransport.py): collective = the production "
           "one-to-all host collective (lifts the single-controller "
           "rejection of non-default schedulers / --async_admit_rounds "
           "in multihost runs), emulated = the in-process N-controller "
           "harness (--plan_controllers; chaos scripting via "
           "CCTPU_EMU_COORD_CRASH / CCTPU_EMU_COORDINATOR env vars), "
           "'' = none (the default — bit-identical to the "
           "transport-free build)")
    a("--plan_controllers", type=int, default=2,
      help="controller count of the emulated plan-transport harness "
           "(>= 2 when --plan_transport emulated)")
    a("--writer_drain_timeout_s", type=float, default=0.0)
    a("--sampler", choices=("uniform", "throughput"), default="uniform")
    a("--explore_floor", type=float, default=0.1)
    a("--deadline_quantile", type=float, default=0.0)
    a("--deadline_min_work", type=float, default=0.1)
    a("--target_survivors", type=int, default=0)
    a("--port", type=int, default=5315)
    a("--num_clients", type=int)
    a("--num_workers", type=int, default=1)
    a("--max_local_batch", type=int, default=-1)
    a("--device", type=str, default="cuda", choices=("cuda", "cpu"),
      help="where the port runs: cuda (default; raises without a GPU) "
           "or cpu (the kernels' plain versions)")
    a("--num_devices", type=int, default=1)
    a("--share_ps_gpu", action="store_true")
    a("--scan_rounds", action="store_true")
    a("--scan_span", type=int, default=0)
    a("--model_parallel", type=int, default=1)
    a("--num_slices", type=int, default=1)
    a("--multihost", action="store_true")
    a("--coordinator_address", type=str, default="")
    a("--num_processes", type=int, default=0)
    a("--process_id", type=int, default=-1)
    a("--bf16", action="store_true", dest="do_bf16")
    a("--remat", action="store_true", dest="do_remat")
    a("--iid", action="store_true", dest="do_iid")
    a("--train_dataloader_workers", type=int, default=0)
    a("--val_dataloader_workers", type=int, default=0)

    a("--model_checkpoint", type=str, default="gpt2")
    a("--num_candidates", type=int, default=2)
    a("--max_history", type=int, default=2)
    a("--local_batch_size", type=int, default=8)
    a("--valid_batch_size", type=int, default=8)
    a("--microbatch_size", type=int, default=-1)
    a("--lm_coef", type=float, default=1.0)
    a("--mc_coef", type=float, default=1.0)
    a("--max_grad_norm", type=float)
    a("--personality_permutations", type=int, default=1)
    a("--eval_before_start", action="store_true")

    a("--dp", action="store_true", dest="do_dp")
    a("--dp_mode", choices=list(DP_MODES), default="worker")
    a("--l2_norm_clip", type=float, default=1.0)
    a("--noise_multiplier", type=float, default=0.0)

    a("--powersgd_rank", type=int, default=2)
    a("--dp_clip", type=float, default=1.0)
    a("--dp_noise_mult", type=float, default=0.0)
    a("--dp_target_epsilon", type=float, default=0.0)
    a("--dp_delta", type=float, default=1e-5)
    return p


def parse_args(default_lr: Optional[float] = None, argv=None) -> Config:
    ns = _build_parser(default_lr).parse_args(argv)
    return Config(**vars(ns)).validate()
