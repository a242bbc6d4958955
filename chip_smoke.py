#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines (tagged with the phase's name and
the seconds since the script started); any failure exits non-zero
before the result line:

1. device   — a CUDA card or fail; its name and power limit
               (nvidia-smi).
2. build    — the port's CUDA kernels, built from the checkout's
               sources into build/ (one nvcc per source, sm_90a, all
               started together).
3. kernels  — K1 (count-sketch encode) and K2 (median estimate of every
               coordinate), both reading eps and delta as packed sign
               bits, against their plain PyTorch versions (float sign
               tables) at config #2's and config #4's main-path shapes
               (d = 6,568,640 and 25,557,032) and four small geometries
               (padded tail / odd r, exact fit / even r, one chunk with
               c > d, c % 4 != 0 with a ragged last chunk). Tolerance:
               exact equality (bitwise up to the sign of zero). Times with
               CUDA events (median after warm-up, L2 flushed between
               launches): the kernel's device time, and the wrapper call
               with its host work beside it (host_ms), next to the least
               time the card needs for the same bytes and operations.
4. main     — the port's cv_train.train() on the full-width ResNet9
               (D = 6,568,640), BASELINE config #2 (`--mode sketch
               --error_type virtual --virtual_momentum 0.9 --local_momentum
               0 --num_workers 8 --k 50000 --num_rows 5 --num_cols 500000`),
               8 clients x 32 examples a round, 10 rounds over a synthetic
               CIFAR corpus of 100 clients. Every loss finite, the weights
               moved, K1 and K2 launched once a round each.
5. parity   — one round's client gradient sum, sketch table and top-k
               from the same weights and batch on the card and on the CPU
               (plain kernel versions, TF32 off), beside a float64 CPU
               gradient: relative error <= 2e-3 card vs CPU, the card no
               less accurate than the CPU against float64, and >= 99% of
               the top-k indices shared (PARITY_RTOL and its note); and a
               control run of the card with TF32, which they must refuse.
6. kernels  — K1 and K3a/K3b (the threshold decode's sample and mask)
               against their plain versions at the GPT2 main-path
               geometry (d = 124,444,417), the three threshold
               geometries of tests/test_kernels.py (one with the stride
               clamped to c) and the four small ones of phase 3,
               exact, K3b at three thresholds each (K3_THRESHOLDS); K1
               timed again at the GPT2 geometry; the share of
               coordinates whose first r // 2 + 1 rows all square under
               the timed threshold, and of 8-position sectors all of
               whose coordinates do (plain torch on the card); K4 (the
               flash-attention forward) against its plain version on
               the main path's layout, the [16, 12, L, 64] head views
               of one fused [16, L, 3 * 768] QKV projection, for the
               main path's L, 294, 256, 300 and 1024, within K4_RTOL.
               Times as in phase 3, K4's on those views; its library
               yardstick is scaled_dot_product_attention (f32, causal)
               pinned to the memory-efficient backend, on the same
               views, and its bound counts the products at the TF32
               tensor-core rate in three passes.
7. gpt2     — the port's gpt2_train.train_gpt2() on the full-width
               GPT2-small (D = 124,444,417, HashTokenizer(50262)),
               BASELINE config #5 (`--mode sketch --error_type virtual
               --virtual_momentum 0.9 --local_momentum 0 --num_workers 8`,
               k, r, c at their defaults) with `--max_history 20` over a
               synthetic PersonaChat of 16 personas x 2 dialogs x 24
               utterances (L = 299), 8 clients x 8 examples a round,
               GPT2_ROUNDS rounds. Every loss finite, the weights moved,
               K3a and K3b once a round, K1 twice (the cohort sum and the
               re-encode of the update), K4 12 x 8 a round. Then
               gpt2_train.test_gpt2 on the val split (forward only,
               through K4): its NLL finite.
8. gparity  — one round's gradient sum, table and threshold selection
               of a 2-layer full-width GPT2 (d = 53,565,697, so the
               threshold route), 2 clients x 2 examples at L = 299, on
               the card and on the CPU, beside a float64 CPU gradient:
               phase 5's checks at this model's own tolerances
               (GPT2_PARITY_RTOL, GPT2_ACCURACY_FLOOR), the selections
               sharing >= 99%; and a control run of the card with TF32
               matmuls, which those limits must refuse.
9. fedavg   — BASELINE config #1 through cv_train.train(): ResNet9 FedAvg
               (`--mode fedavg --local_batch_size -1 --fedavg_batch_size
               16`), 8 clients x 4 local steps of 16 a round, FEDAVG_ROUNDS
               rounds.
10. ttopk   — `--mode true_topk --error_type virtual --virtual_momentum
               0.9 --local_momentum 0.9 --k 50000` on ResNet9, TTOPK_ROUNDS
               rounds; the last round's participants' velocity rows zero
               at the coordinates sent.
11. ltopk   — BASELINE config #3: ResNet18/CIFAR100, `--mode local_topk
               --error_type local --local_momentum 0.9`, 100 non-IID
               clients, 8 x 32 a round, LTOPK_ROUNDS rounds (CONFIG3's
               note on its learning rate); nonzero error rows and the
               realized nonzeros of the aggregate beside 8 k.
12. lparity — one config #3 client step of 2 clients on the card and on
               the CPU beside float64 (ltopk_parity), with a TF32 control.
13. imagenet — BASELINE config #4 as benchmarks/imagenet.sh runs it
               (CONFIG4: FixupResNet50, D = 25,504,024, uncompressed, 7
               IID clients x 64 images of 224 px, one fused backward)
               through cv_train.train(), IMAGENET_ROUNDS rounds on a
               corpus this run writes in FedImageNet's preprocessed/
               layout (256 classes x 64 images from seed 21, 2.47 GB, in
               a temporary directory removed at the end); the Fixup LR
               scales in use, no sketch or attention kernel.
14. sketch50 — config #4 as BASELINE.json words it (CONFIG4_SKETCH:
               ResNet50, D = 25,557,032, sketched over 256 IID clients, 7
               x 64 a round, k / r / c at their defaults), IMAGENET_ROUNDS
               rounds on the same corpus: K1 and K2 once a round, K3a,
               K3b and K4 never; then the stable top-k alone over the
               last round's [52 x 500,000] estimates.
15. iparity — one round of ResNet50 at 224 px, 2 clients x 2 images of a
               phase 14 batch through phase 14's own client function
               (each client's local_step), card vs CPU vs float64: from
               damped bn3 scales at phase 5's limits, with a TF32
               control, and from phase 14's plain init at the accuracy
               limit alone (R50_BN3_SCALE says why).
16. dp      — config #2 with `--dp --dp_mode worker --l2_norm_clip 1.0
               --noise_multiplier 1e-4 --max_grad_norm 1.0` (DP_SIGMA says
               why), ROUNDS rounds, run after phase 5: each client's
               table encoded (K1, 8 a round) and clipped on its own;
               finite losses, ms/round beside config #2's, peak memory;
               the card's threefry bits and uniforms for the first
               round's client 0 at D bitwise the CPU's, its normals
               within DP_NORMAL_RTOL.
17. wire    — config #2 with `--sketch_table_dtype int8`, then `bf16`,
               ROUNDS rounds each: every client's upload a round exactly
               2,500,020 and 5,000,000 bytes; ms/round.
18. gpt2bf16 — config #5 with `--bf16`, run after phase 8, GPT2_ROUNDS
               rounds at full width: K4's bf16 instantiation 12 x 8 a
               round and its f32 one never, K1 / K3a / K3b as in phase 7,
               ms/round and peak beside config #5's; then --bf16's
               accuracy check (bf16_parity_phase: the 2-layer GPT2's
               bf16 gradient on the card and on the CPU against float64,
               their ratio within BF16_BAND, a float32 control outside
               it). Phase 6 holds K4's bf16 instantiation against its
               plain version at every K4 length.
19. imagenet_bf16 — config #4 per imagenet.sh with `--bf16`, run after
               phase 13, IMAGENET_ROUNDS rounds: ms/round, host batch and
               peak beside phase 13's; no kernel launched.
20. resume  — config #2 at full width through cv_train.run() with
               `--checkpoint_every 1 --trace` and the journal on, on a
               synthetic CIFAR10 of 20 clients x 64 images (5 rounds an
               epoch), cuDNN deterministic: run A over 2 epochs; run B
               preempted as its second epoch opens, then a fresh model
               with `--resume` runs epoch 2. The final checkpoints bitwise
               equal (every key but the wall-clock thr_*), every round's
               client ids and bytes equal, K1 / K2 once a round in each
               run; both journals checked without the JAX package
               (check_journal); ms/round beside phase 4's, each
               checkpoint's write seconds and bytes, the stage spans.
21. gpt2resume — the same for config #5 at full width through
               gpt2_train.run(), on 8 personas x 24 examples, all 8 in
               every round (3 rounds an epoch, L = 299): K1 twice, K3a,
               K3b once and K4 96 times a round.
22. faults  — config #2 with `--client_dropout 0.25 --straggler_rate
               0.25 --straggler_cutoff 0.2` (the dropout_stragglers
               variant on the fused backward), ROUNDS rounds: K1 and K2
               once a round; every round's uploads the wire bytes at the
               slots utils/faults' draws keep for the seed and 0 at the
               others; the survivor-weighted fused gradient of a batch
               equal to its survivors' own (PARITY_RTOL).
23. byzantine — config #2 with `--update_screen norm --byzantine_rate
               0.25 --attack colluding` and `--aggregator coord_median`
               (BYZANTINE_ROUNDS rounds), `trimmed_mean` and `norm_clip`
               (3 each): each client's transmit encoded on its own, K1 8
               times a round, the order statistics over [8, 5, 500000]
               tables; one K1 launch on a client's transmit bitwise its
               plain version; ms/round beside phase 4's.
24. rollback — config #2 with `--poison_kind nan`, the screen off, a
               checkpoint an epoch over 3 epochs: round ROLLBACK_POISONED
               poisoned by a FaultSchedule while the newest checkpoint is
               torn; the trip rolls back past the torn file to the older
               finite one, replays with screening forced and finishes
               finite; the journal read without JAX.
25. finetune — config #5's GPT2-small written by save_pretrained;
               --finetune loads it bitwise and evaluates it; then
               FINETUNE_ROUNDS rounds from it plain and with --remat
               under torch.use_deterministic_algorithms: the updates
               bitwise equal (else within 2x a second plain run's
               spread), K4 twice a block under remat, peak memory beside
               phase 7's.
26. cvfinetune — config #2's ResNet9 trained 3 rounds on CIFAR10 with
               --checkpoint, then `--finetune --finetuned_from CIFAR10`
               on the synthetic CIFAR100 for 3 rounds: the transferred
               coordinates bitwise unmoved, the head trained.
27. powersgd — config #2 with `--mode powersgd --error_type local
               --powersgd_rank 2` (POWERSGD), ROUNDS rounds: no sketch or
               attention kernel; every upload (2,564 + 2,562) x 2 x 4
               bytes; the Q factor warm in every sampled client's
               velocity row and the others zero; one client's residual
               seam card vs CPU vs float64 at POWERSGD_RTOL, with a TF32
               control it must refuse; ms/round beside phase 4's.
28. dp_sketch — config #2 with `--mode dp_sketch --dp_clip 1.0
               --dp_noise_mult 0.5` and a journal, ROUNDS rounds: K1 8
               times a round, K2 once; one `privacy` event a round at
               RdpAccountant(0.5, 1e-5).epsilon(n + 1); every client
               table at Frobenius norm <= dp_clip; one K1 launch on a
               client's gradient bitwise its plain version
               (sketch_encode_dp_sketch on the kernels line).
29. privacy — phase 28 with --dp_target_epsilon between epsilon(2) and
               epsilon(3): the raise after round 2's event, 3 privacy
               events in the journal.
30. spans   — config #2 each way of SPANS, deterministic: bitwise equal
               final states and bytes; ms/round and busy share each;
               --profile_spans 1:2 writes a trace holding kernels.
31. imagenet_pipeline — config #4 as imagenet.sh runs it, each way of
               IMAGENET_SPANS (run on phase 13's corpus, after it):
               ms/round, busy share and the host batch's share.
32. sched   — config #2, ROUNDS rounds, with SCHED (throughput sampling,
               a deadline, a survivor target of 6, 10% dropout) and the
               telemetry session's clock scripted (scripted_time): K1
               and K2 once a round; each slot billed the wire bytes
               exactly when the plan keeps it active and the dropout
               draw keeps it (an idle slot 0, a deadline-truncated one
               its full table, as a straggler); one `schedule` journal
               event a round holding its plan's fields (read without
               JAX); then run A and run B (preempted, resumed) of the
               same flags on phase 20's corpus: final checkpoints
               bitwise equal, thr_* included.
33. async_admit — config #2, ROUNDS rounds, with ASYNC (stragglers at
               0.5, cutoff 0.2, admitted 2 rounds late at decay 0.5):
               K1 and K2 once a round; each slot billed as the admission
               buffer composes it (replayed on the host); the same flags
               at --async_admit_rounds 0 and with a k = 0 buffer forced
               in, bitwise equal (deterministic algorithms); runs A and
               B with entries pending at B's checkpoint, bitwise equal.
34. statetier — config #3, LTOPK_ROUNDS rounds, deterministic: the
               device tier, then TIER (a working set of 16 rows), then
               TIER with --state_spill_dir and --scan_rounds --scan_span
               2 --pipeline: weights and every client row (the device
               block's, against the working set's and the tail's)
               bitwise equal; device rows 0.67 against 4.20 GB; peak
               beside phase 11's; spills, restores and ms/round.
35. control — config #2, ROUNDS rounds each, with a journal and the
               session's clock scripted: (a) control_screen, BYZANTINE with
               --aggregator trimmed_mean --target_screened_rate 0.1 (K1 8
               a round, as phase 23's): every round at its plan's
               multiplier, and a fresh AdaptiveScreenController fed the
               journaled screened counts reproduces the journaled
               screen_adapt moves and the final multiplier bitwise; (b)
               control_speed, SCHED + ASYNC + --speed_match on the clock
               control_time (rounds of 2.0 and 0.25 s, so the clients of
               the slow rounds measure 8x slower): every slot billed as
               the host replays the plan, the draws and the admission
               buffer; speed_match control events; (c) control_staleness,
               ASYNC + --adapt_staleness: every round composed at its
               plan's decay; (d) control_span, --scan_rounds
               --scan_span_palette 1,2,4 --pipeline against the same flags
               without the palette, deterministic: weights, server state,
               accountant and every round's journaled bytes bitwise
               equal, the picks printed; (e) control_resume, (a)-(c)
               combined (CONTROL_RESUME) as runs A and B on phase 20's
               corpus: final checkpoints bitwise equal, screen_* and ctl_*
               keys and thr_* included. K1 and K2 once a round in the
               other runs; ms/round beside phase 4's and peak memory.
36. gpt2medium — at [5, 500,000], B = 710 chunks: K1 at d = 354,829,313
               and K2 on windows of 134 chunks (the first, a middle one,
               the ragged last chunk of 329,313) against their plain
               versions, exact; the blockwise decode's (idx, vals) at
               k = 50,000 bitwise the same decode on plain windows, both
               timed; K4 on GPT2-medium's [16, 16, L, 64] head views
               within K4_RTOL. Then config #5 with GPT2M_FLAGS
               (GPT2-medium, --remat) on phase 7's corpus, GPT2M_ROUNDS
               rounds of 8 clients x GPT2M_EXAMPLES examples: every loss
               finite, the weights moved, K1 once a round (the update's
               re-sketch takes the scatter route at r * k = 250,000), K2
               on 6 windows a round, K4 2 x 24 x 8 a round (--remat runs
               each block's forward twice), K3a and K3b never; every
               upload 10,000,000 bytes; peak memory.
37. grid    — config #2 on GRID_RANKS ranks over torch.distributed,
               each a subprocess of this script (`--rank`) sharing the
               card over gloo (NCCL refuses two ranks on one device),
               4 clients a rank, through cv_train with --multihost.
               Round one from phase 5's weights and batch, a real
               round of the model's (its result dropped) whose
               all-reduced table is read where round.reduce_transmit
               returns it: within PARITY_RTOL of phase 5's card
               table, no less accurate against the float64 table (phase
               5's accuracy rule), >= 99% of the top-k shared. Then
               ROUNDS rounds: ps_weights bitwise equal on the ranks, K1
               and K2 once a round on each, every upload r * c * 4
               bytes, finite losses, the weights moved; ms/round, each
               rank's peak and the collectives' calls, bytes and host
               ms beside phase 4. Then two NCCL ranks on the card (its
               refusal printed) and, beside it, an NCCL world of one rank
               and the one-process run, NCCL1_ROUNDS rounds each under
               deterministic algorithms: weights and bytes bitwise equal.
38. tpgpt2  — config #5's GPT2-small (D = 124,444,417, L = 299) under
               TP_FLAGS (--model_parallel 2 --remat) on 2 ranks sharing
               the card over gloo, through gpt2_train, TP_ROUNDS rounds
               of 8 x 8: from the same weights and batch as the one
               process (--model_parallel 1), round one's losses within
               TP_LOSS_RTOL, the cohort gradient within
               GPT2_PARITY_RTOL, >= 99% of the threshold selections
               shared; ps_weights bitwise equal on the ranks; on each,
               K4 2 x 12 x 8 a round on [16, 6, L, 64] head views (held
               against its plain version and timed there first), K1
               twice, K3a and K3b once a round; ms/round and each rank's
               peak beside phase 7's.
39. plan    — config #2, ROUNDS rounds under PLAN (`--sampler
               throughput`) on phase 32's scripted clock, deterministic:
               with `--plan_transport emulated --plan_controllers 3` (three
               controllers in the process, followers' trackers never fed)
               bitwise the one controller with the same flags, every round
               broadcast once, K1 and K2 once a round; then the takeover
               drill (TAKEOVER_ROUNDS rounds, a journal, a checkpoint after
               round 1, FaultSchedule(coordinator_crash_at=TAKEOVER_CRASH),
               controller 1 promoted, the checkpoint and the journal's plan
               stream loaded, rounds 2-3 replayed from the journaled plans
               with their digests consumed): weights and client ids bitwise
               the uninterrupted run; the takeover's wall seconds.
40. plangrid — phase 37's two ranks run a second leg, config #2 under
               PLAN_GRID (`--sampler throughput --plan_transport
               collective`), ROUNDS rounds, each rank's tracker fed its own
               wall clock: ps_weights bitwise equal, on each rank a plan
               broadcast and two digest gathers a round (plan, install),
               K1 and K2 once a round; the transport's calls, bytes and
               host ms a round beside the round's own collectives. Phase
               37's NCCL world of one rank and its one-process twin run
               under PLAN_NCCL1 (a plan a round through the collective
               transport, on a gloo group of the transport's own beside
               NCCL's), still bitwise equal.
41. ring    — on the same two ranks, parallel/ring.ring_attention on
               GPT2-small's [16, 12, RING_L, 64] head views of one fused
               QKV projection, RING_L // 2 positions a rank, the chunks
               rotated by a broadcast from each rank (gloo has no send on
               CUDA tensors): the forward within K4_RTOL of K4 on the whole
               sequence, the gradients of sum(out ** 2) within
               RING_GRAD_RTOL of autograd of the plain reference (relative
               to the largest); ms a call forward and forward-backward, the
               folds alone, the bytes rotated.
42. analysis — config #2 for ROUNDS rounds with the journal on through
               the paths that own threads (ANALYSIS: phase 34's host tier
               in pipelined spans of 2, the download top-k giving the
               tier its stale weight rows): under the port's
               LockOrderSanitizer, interleaving_stress and
               NumericSanitizer (analysis/runtime.py), then again
               unsanitized, both under deterministic algorithms. The lock
               graph acyclic, the guard's `checked` >= ROUNDS, the
               weights bitwise the unsanitized run's, K1 and K2 once a
               round, the tier spilling, each journal valid under the
               port's validate_journal with summarize's ROUNDS rounds and
               byte totals equal to cv_train's accountant totals; then
               the port's lint and sync audit over the checkout (zero
               findings each, the audit's digest journaled and
               validated). Each run's ms/round beside its twin's, and the
               phase's seconds.
43. audit   — the trace tiers' torch counterparts (item 10f) on the
               card, under deterministic algorithms: (a) config #2 for
               ROUNDS rounds through cv_train.train with
               --debug_transfer_guard (analysis/runtime.forbid_transfers
               around every round after the first): no implicit sync,
               weights and every round's billed bytes bitwise its
               unguarded twin's, the explicit boundaries a round by
               reason and both runs' ms/round; (b) one steady-state
               config #2 round under the RoundRecorder: its ops, FLOPs
               and bytes (costmodel), K1 and K2 one kernel entry each
               with the bytes and operations of their rows in the
               kernels line, and those bytes at 3.35 TB/s, graftnum's
               NU004 list of the ops that are not bitwise reproducible
               on the card, the ops other threads dispatched, and the
               recorder's cost beside the same round unrecorded; (c) config #5 for AUDIT_GPT2_ROUNDS
               rounds under the guard: K1 twice, K3a, K3b once and K4
               96 times a round, no implicit sync; (d) graftaudit at
               AUDIT_GEOMETRY on the card beside the same audit on the
               CPU (which must equal the committed baseline): the same
               kernel entries and the same count of every op both
               devices dispatch, each op that only one device
               dispatches printed by name, no finding on either.
Phases 27-36 print their peak memory as read in the full script, beside
the memory earlier phases leave allocated (live_gib).

Phases 9-11 run on the synthetic CIFAR of phase 4 at full width; each
prints its ms/round, the host's batch ms, peak memory, the client-state
bytes and one per-client masked_topk at its D timed on the card, and
fails if a sketch or attention kernel launched (13 and 14 print the
first three). Every path's rounds (4, 7, 9-11, 13, 14) run beside a
background nvidia-smi reading the SM clock and power draw every 200 ms,
and the host's load average before and after.

Phases 20-21 (RESUME_EPOCHS' note) fall back, on a bitwise miss, to a
second run A: B must then lie within 2x A's own spread, and the phase
names the arrays that differ.

Before the last two lines comes {"kernels": [...]}, one entry per
kernel and main path: K1 six times (sketch_encode at config #2's
shapes, sketch_encode_dp, sketch_encode_byzantine and
sketch_encode_dp_sketch at the same shapes for the dp, byzantine and
dp_sketch paths, sketch_encode_r50 at config #4's, sketch_encode_gpt2
at config #5's),
K1 once more (sketch_encode_gpt2medium, phase 36), K2 twice
(config #2's, sketch_estimate_all_r50) and its windowed launch
(sketch_estimate_window, phase 36), K3a, K3b, and K4 three times
(flash_fwd on f32 operands, flash_fwd_bf16 on bf16 ones, config #5 and
config #5 with --bf16, and flash_fwd_gpt2medium), and since phases
37-38 K1 and K2 as a rank of the grid launches them
(sketch_encode_grid, sketch_estimate_all_grid) and K4 on a
tensor-parallel rank's 6-head views (flash_fwd_tp), each with the
launches of its own path's run ("path"; a grid's or TP run's rank 0).
Phases 39-41 add no entry: they launch K1, K2 and K4 as the paths above
do, and the ring folds with the plain online-softmax fold, as the JAX
ring does. The line before the last holds
the card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
`--profile [DIR]` additionally traces three more rounds of each path
with torch.profiler and writes the device time by kernel to
DIR/profile_rounds.txt (config #2), DIR/profile_gpt2_rounds.txt
(config #5) and DIR/profile_{dp,gpt2bf16,fedavg,ttopk,ltopk,imagenet,
imagenet_bf16,sketch50}_rounds.txt,
chiprun_out/ beside the script by default, and prints K3b's mean device
time a launch on the GPT2 rounds' own tables.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import glob
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from typing import NamedTuple

import numpy as np

# phase 25 runs under torch.use_deterministic_algorithms, which needs
# cuBLAS's fixed workspace from the process's first cuBLAS call on
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32 outside
# the tensor cores, and dense TF32 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12

MAIN_D, MAIN_C, MAIN_R = 6_568_640, 500_000, 5
SMALL_GEOMETRIES = [
    dict(d=1000, c=200, r=5),       # padded tail, odd r
    dict(d=512, c=128, r=4),        # exact fit, even r
    dict(d=300, c=400, r=3),        # single chunk, c > d
    dict(d=5000, c=301, r=5),       # c % 4 != 0, ragged last chunk
]
CONFIG2 = ["--mode", "sketch", "--error_type", "virtual",
           "--virtual_momentum", "0.9", "--local_momentum", "0",
           "--num_workers", "8", "--k", "50000", "--num_rows", "5",
           "--num_cols", "500000"]
ROUNDS = 10
# card-vs-CPU tolerances. A float32 backward of the full-width ResNet9
# over 256 images sits 1e-4 to 1e-3 (relative L2, depending on weights
# and batch) from its float64 value on EITHER device — rounding, which
# this phase measures against a float64 CPU gradient — so two float32
# devices may differ by about that much: 2e-3 is the bound. The card
# must also be as accurate as the CPU against float64: within
# ACCURACY_RATIO x the CPU's float32 error, or ACCURACY_RATIO x
# ACCURACY_FLOOR when the CPU happens to land closer than the usual
# float32 error of this backward. Rounding moves the top-k boundary by
# a few coordinates only.
PARITY_RTOL = 2e-3
ACCURACY_RATIO = 3.0
ACCURACY_FLOOR = 2e-4
TOPK_OVERLAP = 0.99
CLIENTS = 100
EXAMPLES_PER_CLIENT = 64     # 100 x 64 / (8 x 32) = 25 rounds an epoch

# the GPT2 path (BASELINE config #5)
GPT2_D, GPT2_VOCAB = 124_444_417, 50262
GPT2_CORPUS = (16, 2, 24)    # personas, dialogs each, utterances each
GPT2_L = 299                 # the corpus's padded train length
GPT2_ROUNDS = 6              # of 12 an epoch (768 examples / (8 x 8))
CONFIG5 = ["--dataset_name", "PERSONA", "--mode", "sketch",
           "--error_type", "virtual", "--virtual_momentum", "0.9",
           "--local_momentum", "0", "--num_workers", "8",
           "--max_history", "20"]
# K3 geometries of tests/test_kernels.py:112-160 as (geometry, stride,
# ns): the heavy-hitter and dispatch geometries at their own sample
# geometry, and the chunk narrower than the stride (clamped to c, one
# sample a chunk)
K3_GEOMETRIES = [(dict(d=40000, c=10000, r=5), None),
                 (dict(d=20000, c=5000, r=5), None),
                 (dict(d=16384, c=256, r=5), (256, 1))]
# K3b is held at three thresholds a geometry: the main path's share of
# coordinates kept (k = 50,000 of GPT2_D, as the sample's quantile), the
# median of the sample squares (about half kept) and the square of a
# value the median keeps (a tie, which >= keeps)
K3_THRESHOLDS = ("main-path", "median", "tie")
MAIN_KEEP = 50_000 / GPT2_D
# K4 against its plain version: the kernel's 3xTF32 tensor-core
# products over 64-key tiles (f32-accurate to ~2^-22 a product) vs the
# plain f32 128-key-block fold, reductions in another order
K4_RTOL = 1e-5
K4_LENGTHS = (GPT2_L, 294, 256, 300, 1024)
# the main path's attention operands: GPT2-small's fused QKV projection
# of 16 sequences (8 clients x 2 candidates), 12 heads of 64
K4_BATCH, K4_HEADS, K4_DH = 16, 12, 64
# GPT2 card-vs-CPU tolerances, its own: the 2-layer GPT2's float32
# gradient sits about 2e-6 (relative L2) from float64 on either device,
# three orders below ResNet9's, so ResNet9's limits would let the card
# be ~100x less accurate than the CPU. These sit ~10x above those
# readings and below the error of the same round with TF32 matmuls
# (the control run of phase 8, which they must refuse).
GPT2_PARITY_RTOL = 2e-5
GPT2_ACCURACY_FLOOR = 1e-5

# the remaining modes (phases 9-12), each on the synthetic CIFAR of
# CLIENTS x EXAMPLES_PER_CLIENT at full width. Config #1: ResNet9
# FedAvg, whole-client batches of 64 cut into 4 local steps of 16.
CONFIG1 = ["--mode", "fedavg", "--error_type", "none",
           "--local_momentum", "0", "--virtual_momentum", "0",
           "--local_batch_size", "-1", "--num_workers", "8",
           "--num_fedavg_epochs", "1", "--fedavg_batch_size", "16"]
# true_topk with local momentum: per-client velocity rows, masked at
# the coordinates the server sends
TTOPK = ["--mode", "true_topk", "--error_type", "virtual",
         "--virtual_momentum", "0.9", "--local_momentum", "0.9",
         "--k", "50000", "--num_workers", "8", "--local_batch_size", "32"]
# config #3: ResNet18 on CIFAR100, non-IID (one class a client),
# per-client top-k with local error and velocity rows. Its learning
# rate is cut to 0.04: on this synthetic one-class-a-client corpus the
# round diverges to a NaN loss within 10 rounds at the driver's default
# 0.4 and at 0.1, and the JAX package's round diverges the same way
# (the same losses at a tiny width on the CPU), so the cut is of the
# workload's step size, not of a fault
CONFIG3 = ["--dataset_name", "CIFAR100", "--model", "ResNet18",
           "--mode", "local_topk", "--error_type", "local",
           "--local_momentum", "0.9", "--virtual_momentum", "0",
           "--k", "50000", "--num_workers", "8", "--local_batch_size", "32",
           "--lr_scale", "0.04"]
CONFIG3_D = 5_252_388
FEDAVG_ROUNDS, TTOPK_ROUNDS, LTOPK_ROUNDS = 5, 3, 10
# counters of the kernels no path of these modes may launch
SKETCH_AND_ATTENTION = ("sketch_encode", "sketch_estimate_all",
                        "sketch_estimate_window", "threshold_sample",
                        "threshold_mask", "flash_fwd")

# BASELINE config #4 (phases 13-15) on a corpus written in FedImageNet's
# preprocessed/ layout: 224-px uint8 images from IMAGENET_SEED, one file
# of IMAGENET_PER_CLASS images for each of IMAGENET_CLASSES classes (of
# ImageNet's 1000; the model's head keeps 1000), and a val.npz
IMAGENET_CLASSES, IMAGENET_PER_CLASS, IMAGENET_VAL = 256, 64, 256
IMAGENET_HW, IMAGENET_SEED = 224, 21
IMAGENET_ROUNDS = 5          # of 37 an epoch (16,384 images / (7 x 64))
# phase 13: config #4 as benchmarks/imagenet.sh runs it, flag for flag
CONFIG4 = ["--dataset_name", "ImageNet", "--model", "FixupResNet50",
           "--local_batch_size", "64", "--max_local_batch", "64",
           "--scan_span", "0", "--local_momentum", "0.0",
           "--virtual_momentum", "0.9", "--weight_decay", "1e-4",
           "--error_type", "virtual", "--mode", "uncompressed", "--iid",
           "--num_clients", "7", "--num_workers", "7", "--k", "1000000",
           "--num_rows", "1", "--num_cols", "10000000"]
FIXUP50_D = 25_504_024
# phase 14: config #4 as BASELINE.json words it, ResNet-50 sketched over
# 256 clients (k, r, c at the parser's defaults: 50,000 / 5 / 500,000).
# One cut: --microbatch_size 64 (each client's whole batch, so the same
# gradient) runs the 7 clients' backwards one after another, because the
# fused backward would hold all 448 images' activations at once: 175 MB
# an image for this batch-normed ResNet50 (saved tensors counted on the
# CPU), 78 GB of the card's 80
CONFIG4_SKETCH = ["--dataset_name", "ImageNet", "--model", "ResNet50",
                  "--mode", "sketch", "--error_type", "virtual",
                  "--virtual_momentum", "0.9", "--local_momentum", "0",
                  "--weight_decay", "1e-4", "--iid", "--num_clients", "256",
                  "--num_workers", "7", "--local_batch_size", "64",
                  "--max_local_batch", "64", "--microbatch_size", "64"]
R50_D = 25_557_032
# phase 15 (iparity) steps from the phase 14 model's initial weights
# with each block's last norm scale (bn3) at R50_BN3_SCALE: at the plain
# init the float32 gradient of this 16-block batch-normed net over 2
# images a client sits 2.6e-2 (relative L2) from float64 (the CPU,
# float32 vs float64, measured with this script's inputs' shapes), as
# deep batch-normed nets' gradients grow through the blocks at init, so
# no float32 device could be held to PARITY_RTOL there; damped as ResNet
# inits that zero that scale damp it, the CPU's float32 gradient sits
# 7.1e-4 from float64 and shares 0.998 of the top-k: the regime the
# ResNet9 limits (PARITY_RTOL, ACCURACY_FLOOR) were set for. The plain
# init that phase 14 trains from is held too, at the accuracy limit
# alone: the card no further from float64 than ACCURACY_RATIO x the
# CPU's float32 error
R50_BN3_SCALE = 0.1

# the per-round options (phases 16-19, ROADMAP item 6b), each on a path
# already above. Phase 16 (dp): config #2 with worker-mode DP and the
# clip. The noise is N(0, 1) x DP_SIGMA x sqrt(8) a coordinate (the
# reference's scale, not multiplied by the clip): 2.8e-4, the size of
# one coordinate of a gradient clipped to norm 1 over D = 6,568,640
# (1 / sqrt(D) = 3.9e-4), so the rounds carry noise of the signal's
# order and stay finite
DP_SIGMA = 1e-4
CONFIG2_DP = ["--dp", "--dp_mode", "worker", "--l2_norm_clip", "1.0",
              "--noise_multiplier", str(DP_SIGMA), "--max_grad_norm", "1.0"]
# the card's normals against the CPU's from the same key (both from the
# bitwise-equal uniforms through ops/prng.erf_inv; the CPU's sit 2.4e-7
# relative at most from jax.random's, tests/test_torch_prng.py)
DP_NORMAL_RTOL = 1e-6
# phase 17 (wire): config #2's table on the quantized wires, upload
# bytes a client a round: 5 x 500,000 cells, int8 with 5 f32 row scales
WIRE_BYTES = {"int8": 2_500_020, "bf16": 5_000_000}
# phase 18 (gpt2bf16): config #5 with --bf16, K4 on bf16 operands. Its
# kernel check: o (bf16) within half a bf16 ulp of the plain version's
# f32 output before its cast, plus K4_RTOL of max|o|; lse (f32) within
# K4_RTOL relative. Its accuracy check (bf16_parity_phase): a 2-layer
# full-width GPT2's bf16 gradient on the card and on the CPU, each
# against the float64 CPU gradient; the card's distance over the CPU's
# within BF16_BAND (tests/test_torch_options.py holds the port's CPU
# bf16 gradient to JAX's with the same band), and a float32 control on
# the card outside it
BF16_BAND = (1 / 3, 3.0)
H100_BF16_FLOPS = 989e12
# phases 20-21 (resume, gpt2resume; ROADMAP item 6c): a config run with a
# rotated checkpoint an epoch, the journal and the tracer, twice: A over
# RESUME_EPOCHS epochs uninterrupted; B preempted as its second epoch's
# stream opens (Preempted) and finished by a fresh model built with
# --resume. Their final checkpoints must be bitwise equal but for the
# wall-clock throughput EMAs (thr_*), with cuDNN held deterministic for
# these runs. Config #2 on a synthetic CIFAR10 of RESUME_CIFAR_CLIENTS
# clients x 64 images (5 rounds of 8 x 32 an epoch); config #5 on
# RESUME_GPT2_CORPUS, 8 personas of 24 examples each, all 8 in every
# round (an epoch is exactly 3 rounds; L = 299, so K4 runs)
RESUME_EPOCHS = 2
RESUME_CIFAR_CLIENTS = 20
RESUME_CIFAR = (RESUME_CIFAR_CLIENTS * 64, 512)
RESUME_GPT2_CORPUS = (8, 1, 24)


# phases 27-31 (ROADMAP items 9b and 9c), at config #2's full width.
# Phase 27: PowerSGD at rank 2; its [D] update is the [2,564, 2,562]
# matrix, so a client uploads (2,564 + 2,562) x 2 float32 factors. The
# residual seam card vs CPU: its three GEMMs sum 2,562-2,564 products in
# float32 (relative L2 ~1e-7 between two orders); POWERSGD_RTOL sits
# well above that and below TF32's 10-bit products (~1e-3), which the
# control run must show
POWERSGD = ["--mode", "powersgd", "--error_type", "local",
            "--local_momentum", "0", "--powersgd_rank", "2"]
POWERSGD_MN = (2564, 2562)
POWERSGD_UPLOAD = (2564 + 2562) * 2 * 4
POWERSGD_RTOL = 1e-5
# phase 28: dp_sketch, noise std 0.5 x 1.0 on the aggregate a round;
# phase 29 sets --dp_target_epsilon between epsilon(N - 1) and
# epsilon(N) for N = PRIVACY_N
DP_SKETCH = ["--mode", "dp_sketch", "--error_type", "virtual",
             "--local_momentum", "0", "--dp_clip", "1.0",
             "--dp_noise_mult", "0.5"]
DP_SKETCH_SIGMA, DP_SKETCH_DELTA = 0.5, 1e-5
PRIVACY_N = 3
# phase 30: config #2 over ROUNDS rounds (spans of 4: 4, 4 and a tail
# of 2): the plain loop, spans, spans pipelined with a checkpoint every
# span (the issue's three), and pipelined without the checkpoints
SPANS = (("plain", []),
         ("spans", ["--scan_rounds", "--scan_span", "4"]),
         ("pipeline", ["--scan_rounds", "--scan_span", "4", "--pipeline",
                       "--checkpoint_every", "1", "--ckpt_every_spans",
                       "1"]),
         ("pipeline_nockpt", ["--scan_rounds", "--scan_span", "4",
                              "--pipeline"]))
# phase 31: config #4 as imagenet.sh runs it, plain against one span of
# IMAGENET_PIPE_ROUNDS pipelined and spans of 1 pipelined (where span
# t + 1's host batch can overlap span t on the card). Its depth is cut
# to 3 rounds a run (it ran 5, the six runs ~118 s of the script), to
# keep the whole script near the time it took before phases 35-36
IMAGENET_PIPE_ROUNDS = 3
IMAGENET_SPANS = (("plain", []),
                  ("span3_pipeline", ["--scan_rounds", "--scan_span",
                                      str(IMAGENET_PIPE_ROUNDS),
                                      "--pipeline"]),
                  ("span1_pipeline", ["--scan_rounds", "--scan_span", "1",
                                      "--pipeline"]))

# phases 32-34 (ROADMAP items 9d and 9e). Phase 32: the round scheduler
# on config #2 (a survivor target of 6 at the 0.9 survival prior samples
# 7 of the 8 slots); phase 33: async admission; phase 34: the tiered
# client state on config #3, whose 100 clients' error and velocity rows
# take 4.20 GB on the device tier and a working set of 16 rows 0.67 GB
SCHED = ["--sampler", "throughput", "--explore_floor", "0.1",
         "--deadline_quantile", "0.8", "--deadline_min_work", "0.25",
         "--target_survivors", "6", "--client_dropout", "0.1"]
ASYNC = ["--straggler_rate", "0.5", "--straggler_cutoff", "0.2",
         "--async_admit_rounds", "2", "--async_staleness_decay", "0.5"]
TIER = ["--state_tier", "host", "--state_working_set", "16"]


_T0 = time.perf_counter()


def phase(name: str, msg: str) -> None:
    """One line of a phase, with the seconds since the script started
    (where the run's time goes)."""
    print(f"[{name} {time.perf_counter() - _T0:.0f}s] {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """Registers, spill bytes and static shared memory of K1, K2, K3a
    and K3b at r = 5 and r = 16 and of K4 at each Dh
    from the build's `-Xptxas -v` report (empty when the library was
    already built). K4's tiles are dynamic shared memory, printed beside
    it."""
    import re
    out, fn = [], None
    names = (("encode_rows_kernelILi5E", "encode_rows_kernel<5>"),
             ("encode_rows_kernelILi16E", "encode_rows_kernel<16>"),
             ("estimate_all_kernelILi5E", "estimate_all_kernel<5>"),
             ("estimate_all_kernelILi16E", "estimate_all_kernel<16>"),
             ("threshold_sample_kernelILi5E", "threshold_sample_kernel<5>"),
             ("threshold_sample_kernelILi16E",
              "threshold_sample_kernel<16>"),
             ("threshold_mask_kernelILi5E", "threshold_mask_kernel<5>"),
             ("threshold_mask_kernelILi16E", "threshold_mask_kernel<16>"),
             ("flash_fwd_mma_kernelIfLi16E", "flash_fwd_mma_kernel<f32, 16>"),
             ("flash_fwd_mma_kernelIfLi32E", "flash_fwd_mma_kernel<f32, 32>"),
             ("flash_fwd_mma_kernelIfLi64E", "flash_fwd_mma_kernel<f32, 64>"),
             ("flash_fwd_mma_kernelI13__nv_bfloat16Li64E",
              "flash_fwd_mma_kernel<bf16, 64>"))
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = next((label for key, label in names if key in m.group(1)),
                      None)
            continue
        if fn and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        if fn and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{fn}: {regs} registers, {spill} bytes spilled, "
                       f"{smem.group(1) if smem else 0} bytes static smem")
            fn = None
    return "; ".join(out)


def k4_smem_bytes(dh: int, bf16: bool = False) -> int:
    """flash_fwd_mma_kernel's dynamic shared memory a block (flash_fwd.cu
    `Tile`): K and V tiles of 64 rows of Dh + 4 floats, 3 stages; for
    bf16 operands 3 stages of raw bf16 K and V tiles of 64 x Dh and one
    widened f32 K and V tile."""
    if bf16:
        return 2 * 2 * 3 * 64 * dh + 4 * 2 * 64 * (dh + 4)
    return 4 * 2 * 3 * 64 * (dh + 4)


def time_cuda(fn, iters: int, warmup: int = 3, flush: bool = True,
              wait: bool = True) -> float:
    """Median ms of `fn` over `iters` launches, CUDA events around each,
    the 50 MB L2 overwritten before each (the round finds its inputs
    cold: they are written by other kernels in between). With `wait`, a
    0.2 ms device-side wait before the first event keeps the card busy
    while the host enqueues the event and `fn`'s launches, so the time
    is the device's and not the host's launch overhead (a wrapper's
    Python checks take some tens of microseconds). Without it the card
    has only the flush to run while the host enqueues, so the reading
    also holds the wrapper's host time beyond the flush's ~30 us."""
    scratch = torch.empty(96 * 2 ** 20 // 4, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush:
            scratch.zero_()
        if wait:
            torch.cuda._sleep(400_000)      # ~0.2 ms at the H100's clock
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_phase(sc, CSVec):
    """K1 / K2 against their plain versions; returns the per-kernel
    result rows at config #2's and config #4's geometries (launch counts
    filled in after each main path)."""
    dev = torch.device("cuda")
    max_err = {"sketch_encode": 0.0, "sketch_estimate_all": 0.0}
    for geom in SMALL_GEOMETRIES + [dict(d=MAIN_D, c=MAIN_C, r=MAIN_R),
                                    dict(d=R50_D, c=MAIN_C, r=MAIN_R)]:
        sk = CSVec(**geom)
        off, eps, delta = sk.tables(dev)
        eps_bits, delta_bits = sk.sign_bits(dev)
        g = torch.Generator().manual_seed(geom["d"])
        x = torch.randn(geom["d"], generator=g).to(dev)
        t_k = sk.encode(x)
        t_p = sc.encode_plain(x, off, delta, eps, sk.c)
        e_k = sc.estimate_all(t_k, off, delta_bits, eps_bits, sk.d)
        e_p = sc.estimate_all_plain(t_k, off, delta, eps, sk.d)
        torch.cuda.synchronize()
        for name, k, p in (("sketch_encode", t_k, t_p),
                           ("sketch_estimate_all", e_k, e_p)):
            err = float((k - p).abs().max())
            max_err[name] = max(max_err[name], err)
            if not torch.equal(k, p):
                raise AssertionError(
                    f"{name} differs from its plain version at {geom}: "
                    f"max abs err {err}")
        phase("kernels", f"{geom}: K1 and K2 equal to their plain "
              "versions (exact)")
        del sk, x, t_k, t_p, e_k, e_p

    # timing at the main paths' shapes: config #2's ResNet9, config #4's
    # ResNet50
    out = []
    for d, suffix, path, seed in ((MAIN_D, "", "config2", 1),
                                  (R50_D, "_r50", "config4", 5)):
        sk = CSVec(d=d, c=MAIN_C, r=MAIN_R)
        x = torch.randn(d, generator=torch.Generator().manual_seed(seed)
                        ).to(dev)
        rows = [encode_row(sc, sk, x, "sketch_encode" + suffix, path),
                estimate_row(sc, sk, sk.encode(x),
                             "sketch_estimate_all" + suffix, path)]
        if path == "config2":
            # the dp path (phase 16), the robust aggregators (phase 23)
            # and dp_sketch (phase 28) encode each client's [D] transmit
            # at config #2's shapes, 8 a round
            rows.append(encode_row(sc, sk, x, "sketch_encode_dp", "dp"))
            rows.append(encode_row(sc, sk, x, "sketch_encode_byzantine",
                                   "byzantine"))
            # dp_sketch (phase 28): one encode a client, 8 a round
            rows.append(encode_row(sc, sk, x, "sketch_encode_dp_sketch",
                                   "dp_sketch"))
        out += [timed_row(row, max_err[row["counter"]]) for row in rows]
        del sk, x, rows
    phase("kernels", "sketch_estimate_all store policy: plain write-back "
          "float4 stores (not K3b's streaming __stcs: the [B, c] output "
          "and the table fit in the L2 together; sketch.cu header)")
    return out


def estimate_row(sc, sk, table, name, path):
    """The K2 row at `sk`'s geometry on `table` (on the card), its bytes
    and operations sc.estimate_cost's."""
    d, c, r, B = sk.d, sk.c, sk.r, sk.n_chunks
    off, eps, delta = sk.tables(table.device)
    eps_bits, delta_bits = sk.sign_bits(table.device)
    return dict(
        name=name, counter="sketch_estimate_all", path=path, route="cuda",
        source="commefficient_tpu_torch/ops/csrc/sketch.cu",
        replaces="commefficient_tpu/ops/kernels/sketch_pallas.py:191",
        fn=lambda: sc.estimate_all(table, off, delta_bits, eps_bits, d),
        plain=lambda: sc.estimate_all_plain(table, off, delta, eps, d),
        library=None,
        cost=sc.estimate_cost(r, c, B))


def encode_row(sc, sk, x, name, path):
    """The K1 row at `sk`'s geometry on `x` (on the card), its bytes and
    operations sc.encode_cost's. Library yardstick: one index_add_ of
    the pre-hashed, pre-signed [r * d] values into the flat table (hash
    and signs precomputed, not timed)."""
    d, c, r = sk.d, sk.c, sk.r
    off, eps, delta = sk.tables(x.device)
    eps_bits, delta_bits = sk.sign_bits(x.device)
    buckets, signs = sk.hash_indices(torch.arange(d, device=x.device))
    flat_pos = (torch.arange(r, device=x.device)[:, None] * c
                + buckets).reshape(-1)
    del buckets
    src = (signs * x[None, :]).reshape(-1)
    del signs
    lib_out = torch.zeros(r * c, device=x.device)
    return dict(
        name=name, counter="sketch_encode", path=path, route="cuda",
        source="commefficient_tpu_torch/ops/csrc/sketch.cu",
        replaces="commefficient_tpu/ops/kernels/sketch_pallas.py:146",
        fn=lambda: sc.encode(x, off, delta_bits, eps_bits, c),
        plain=lambda: sc.encode_plain(x, off, delta, eps, c),
        library=lambda: lib_out.zero_().index_add_(0, flat_pos, src),
        cost=sc.encode_cost(d, r, c, sk.n_chunks))


def timed_row(row, max_abs_err):
    """One entry of the kernels line: the kernel's, its plain version's
    and the library call's median times, and the bound from the bytes
    and operations the work needs (the row's `cost`, from the wrapper's
    own `*_cost`, which also prices the kernel's recorder entry; PEAK_*:
    the operations at the row's `peak_flops`, f32 outside the tensor
    cores unless it says otherwise). `ms` is the kernel's device time;
    `host_ms` times the same wrapper call with no device-side wait, so
    it also holds the wrapper's host time beyond the L2 flush. `counter`
    names the launch counter and `path` the main path whose count the
    entry takes; `bytes` and `ops` are the bound's."""
    nbytes, ops = row["cost"]
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / row.get("peak_flops", PEAK_F32_FLOPS) * 1e3
    res = dict(
        name=row["name"], counter=row["counter"], path=row["path"],
        route=row["route"], source=row["source"],
        replaces=row["replaces"], launches=0, max_abs_err=max_abs_err,
        bytes=nbytes, ops=ops,
        ms=time_cuda(row["fn"], 50),
        host_ms=time_cuda(row["fn"], 50, wait=False),
        plain_ms=time_cuda(row["plain"], 5, warmup=1),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=(None if row["library"] is None
                    else time_cuda(row["library"], 20)))
    phase("kernels", f"{res['name']}: kernel_ms={res['ms']:.4f} "
          f"host_ms={res['host_ms']:.4f} "
          f"plain_ms={res['plain_ms']:.4f} bound_ms="
          f"{res['bound_ms']:.4f} ({res['bound_by']}) library_ms="
          f"{res['library_ms']}")
    return res


class Preempted(Exception):
    """The preemption phases 20-21 simulate: raised as the stream of a
    chosen epoch opens, before it draws anything."""


class TimedLoader:
    """The train loader with the host time spent producing each round's
    batch recorded (sampling, fetch, augmentation, stacking), and the
    client ids and examples of the last round drawn. With
    `preempt_at_epoch` n, opening the n-th epoch raises Preempted."""

    def __init__(self, inner, preempt_at_epoch=None):
        self.inner = inner
        self.seconds = []
        self.last_ids = None
        self.last_examples = None
        self.preempt_at_epoch = preempt_at_epoch
        self.epochs = 0

    @property
    def steps_per_epoch(self):
        return self.inner.steps_per_epoch

    @property
    def sampler(self):
        return self.inner.sampler

    def epoch(self, skip=0):
        self.epochs += 1
        if self.epochs == self.preempt_at_epoch:
            raise Preempted(f"epoch {self.epochs}")
        it = iter(self.inner.epoch(skip=skip))
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.seconds.append(time.perf_counter() - t)
            self.last_ids = item[0]
            self.last_examples = float(item[2].sum())
            yield item


class CardSampler:
    """SM clock and power draw read by one background `nvidia-smi -lms
    200` while a path's rounds run, and the host's load average
    (os.getloadavg) before and after. A context manager: the process is
    stopped on the way out, whatever happened inside."""

    def __enter__(self):
        self.load = [os.getloadavg()]
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.load.append(os.getloadavg())
        self.clocks, self.power = [], []
        for line in out.splitlines():
            try:
                clock, power = (float(v) for v in line.split(","))
            except ValueError:
                continue
            self.clocks.append(clock)
            self.power.append(power)
        return False

    def summary(self) -> str:
        if not self.clocks:
            samples = "SM clock and power: not measured (no nvidia-smi samples)"
        else:
            samples = (f"SM clock median {statistics.median(self.clocks):.0f} "
                       f"min {min(self.clocks):.0f} MHz, power draw median "
                       f"{statistics.median(self.power):.2f} min "
                       f"{min(self.power):.2f} W ({len(self.clocks)} samples "
                       "at 200 ms)")
        return (samples + "; host load average (1/5/15 min) before "
                + "/".join(f"{v:.2f}" for v in self.load[0]) + ", after "
                + "/".join(f"{v:.2f}" for v in self.load[1]))


def reset_counts(sc, ac) -> None:
    sc.reset_launches()
    ac.reset_launches()


def read_counts(sc, ac) -> dict:
    return {**sc.LAUNCHES, **ac.LAUNCHES}


class RoundsRun(NamedTuple):
    round_ms: list          # host ms of each round, ended by a synchronize
    losses: torch.Tensor    # [rounds, W] per-client losses, on the host
    launches: dict          # every kernel's launches over the rounds
    peak: int               # max_memory_allocated over the rounds
    timed: TimedLoader
    card: CardSampler
    uploads: list           # each round's [W] upload bytes a client


def drive_rounds(label, sc, ac, model, loader, rounds, run) -> RoundsRun:
    """A main path's timed rounds: `run(timed_loader, on_round)` calls
    the driver's train loop over `loader`, each round ended by a
    synchronize. Every launch counter is set to 0 just before and read
    just after; the card is sampled beside the rounds. Fails unless the
    driver ran `rounds` rounds with finite losses and moved the
    weights; prints the ms/round line and the samples."""
    w0 = model.ps_weights.clone()
    stamps, losses, uploads = [], [], []

    def on_round(i, out):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(out[0])
        uploads.append(out[-1])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = TimedLoader(loader)
    reset_counts(sc, ac)
    t0 = time.perf_counter()
    with CardSampler() as card:
        ok = run(timed, on_round)
        torch.cuda.synchronize()
    launches = read_counts(sc, ac)
    peak = torch.cuda.max_memory_allocated()
    if not ok:
        raise AssertionError("the driver reported a NaN/divergent loss")
    if len(stamps) != rounds:
        raise AssertionError(f"{len(stamps)} rounds ran, {rounds} expected")
    # per-round tensors, or a span's host rows under --scan_rounds
    loss_vals = torch.stack([torch.as_tensor(v) for v in losses]).cpu()
    if not torch.isfinite(loss_vals).all():
        raise AssertionError(f"non-finite losses: {loss_vals}")
    if torch.equal(model.ps_weights, w0):
        raise AssertionError("the weights did not move")
    round_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
    phase(label, "ms/round " + " ".join(f"{t:.2f}" for t in round_ms)
          + f"; median (rounds 2-{rounds}) "
          f"{statistics.median(round_ms[1:]):.2f}, of which the host makes "
          "the batch (data) "
          f"{1e3 * statistics.median(timed.seconds[1:rounds]):.2f}; peak "
          f"memory {peak / 2 ** 30:.3f} GiB (max_memory_allocated)")
    phase(label, card.summary())
    return RoundsRun(round_ms, loss_vals, launches, peak, timed, card,
                     uploads)


def config2_build(cv_train, parse_args, data_dir, extra=(),
                  rounds=ROUNDS):
    """cv_train.build() of config #2 with the flags `extra` added, its
    schedule over `rounds` rounds; returns build()'s five."""
    n_train = CLIENTS * EXAMPLES_PER_CLIENT
    spe = math.ceil(n_train / (8 * 32))
    cfg = parse_args(argv=CONFIG2 + list(extra) + [
        "--local_batch_size", "32", "--num_clients", str(CLIENTS),
        "--device", "cuda", "--dataset_dir", data_dir,
        "--num_epochs", str(rounds / spe),
        "--pivot_epoch", str(rounds / spe / 2), "--seed", "21"])
    built = cv_train.build(cfg, device="cuda",
                           synthetic_examples=(n_train, 512))
    assert built[0].cfg.grad_size == MAIN_D, built[0].cfg.grad_size
    assert built[3].steps_per_epoch == spe
    return built


def config2_variant(label, sc, ac, cv_train, parse_args, data_dir,
                    extra=(), rounds=ROUNDS, setup=None):
    """Drive cv_train.train() for `rounds` rounds of config #2 with the
    flags `extra` added (`setup(model)` first, when given); returns
    (model, the rounds' run, the train loader)."""
    model, opt, sched, train_loader, val_loader = config2_build(
        cv_train, parse_args, data_dir, extra, rounds)
    if setup is not None:
        setup(model)
    rr = drive_rounds(label, sc, ac, model, train_loader, rounds,
                      lambda timed, on_round: cv_train.train(
                          model, opt, sched, timed, val_loader, model.cfg,
                          on_round=on_round))
    return model, rr, train_loader


def check_launches(label, launches, want) -> None:
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{label}: {name} launched {launches[name]} "
                                 f"times ({n} expected)")


def main_path(sc, ac, cv_train, parse_args, data_dir):
    """Drive cv_train.train() for ROUNDS rounds of config #2; returns
    (model, per-round ms, peak bytes, launches, a batch for parity)."""
    model, rr, train_loader = config2_variant("main", sc, ac, cv_train,
                                              parse_args, data_dir)
    check_launches("main", rr.launches, {"sketch_encode": ROUNDS,
                                         "sketch_estimate_all": ROUNDS})
    phase("main", f"{ROUNDS} rounds, D={MAIN_D}, mean client loss "
          f"first/last {float(rr.losses[0].mean()):.4f}/"
          f"{float(rr.losses[-1].mean()):.4f}, launches {rr.launches}")
    batch = next(iter(train_loader.epoch()))
    return model, rr.round_ms, rr.peak, rr.launches, batch


def dp_phase(sc, ac, cv_train, parse_args, data_dir, prng, main_ms,
             profile_dir=None):
    """Phase 16: config #2 with --dp (worker) and --max_grad_norm. Each
    client's table is encoded (K1) and clipped on its own, 8 a round;
    then the card's threefry draw for the first round's client 0 at D
    against the CPU's: bits and uniforms equal, normals within
    DP_NORMAL_RTOL. Returns the rounds' launches."""
    model, rr, loader = config2_variant("dp", sc, ac, cv_train, parse_args,
                                        data_dir, CONFIG2_DP)
    cfg = model.cfg
    assert not cfg.defer_sketch_encode and not cfg.fused_client_backward
    check_launches("dp", rr.launches, {"sketch_encode": 8 * ROUNDS,
                                       "sketch_estimate_all": ROUNDS})
    dp_ms = statistics.median(rr.round_ms[1:])
    phase("dp", f"{ROUNDS} rounds, sigma {DP_SIGMA:g}, clip 1.0, "
          f"max_grad_norm 1.0: mean client loss first/last "
          f"{float(rr.losses[0].mean()):.4f}/"
          f"{float(rr.losses[-1].mean()):.4f}, launches {rr.launches}; "
          f"median {dp_ms:.2f} ms/round beside config #2's "
          f"{statistics.median(main_ms[1:]):.2f} in this run; peak "
          f"{rr.peak / 2 ** 30:.3f} GiB")
    # client 0's key in the first round (round_idx 0)
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(cfg.seed), 0), 0)
    bits = {dev: prng.random_bits(key, MAIN_D, device=dev).cpu()
            for dev in ("cuda", "cpu")}
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    unif = {dev: prng.uniform(key, MAIN_D, lo, 1.0, device=dev).cpu()
            for dev in ("cuda", "cpu")}
    norm = {dev: prng.normal(key, MAIN_D, device=dev).cpu()
            for dev in ("cuda", "cpu")}
    n_rel = float(((norm["cuda"] - norm["cpu"]).abs()
                   / norm["cpu"].abs().clamp(min=1e-30)).max())
    same = float((norm["cuda"] == norm["cpu"]).float().mean())
    bits_eq = torch.equal(bits["cuda"], bits["cpu"])
    unif_eq = torch.equal(unif["cuda"].view(torch.int32),
                          unif["cpu"].view(torch.int32))
    draw_ms = time_cuda(lambda: prng.normal(key, MAIN_D, device="cuda"),
                        10, flush=False)
    phase("dp", f"threefry at D={MAIN_D}, the first round's client 0: "
          f"bits equal {bits_eq}, uniforms bitwise equal {unif_eq}, "
          f"normals max rel err {n_rel:.3e} ({same:.4f} bit-equal; "
          f"tolerance {DP_NORMAL_RTOL:g}); one normal draw on the card "
          f"{draw_ms:.3f} ms (device time, median of 10)")
    if not (bits_eq and unif_eq and n_rel <= DP_NORMAL_RTOL):
        raise AssertionError("the card's threefry draw differs from the "
                             "CPU's")
    if profile_dir:
        profile_rounds(model, loader, model._optimizer,
                       os.path.join(profile_dir, "profile_dp_rounds.txt"),
                       "dp profile")
    del model, loader
    torch.cuda.empty_cache()
    return rr.launches


def wire_phase(sc, ac, cv_train, parse_args, data_dir, main_ms) -> None:
    """Phase 17: config #2 on the int8 and bf16 wires; every client's
    upload a round is WIRE_BYTES exactly, K1 and K2 once a round."""
    for dtype, want in WIRE_BYTES.items():
        label = f"wire_{dtype}"
        model, rr, _ = config2_variant(
            label, sc, ac, cv_train, parse_args, data_dir,
            ["--sketch_table_dtype", dtype])
        check_launches(label, rr.launches, {"sketch_encode": ROUNDS,
                                            "sketch_estimate_all": ROUNDS})
        ups = sorted({float(u) for r in rr.uploads for u in r})
        phase(label, f"{ROUNDS} rounds: upload bytes a client a round "
              f"{ups} (want {want}); mean client loss first/last "
              f"{float(rr.losses[0].mean()):.4f}/"
              f"{float(rr.losses[-1].mean()):.4f}; median "
              f"{statistics.median(rr.round_ms[1:]):.2f} ms/round beside "
              f"config #2's {statistics.median(main_ms[1:]):.2f}")
        if ups != [float(want)]:
            raise AssertionError(f"{label}: uploads {ups}, {want} expected")
        del model
        torch.cuda.empty_cache()


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def cohort_grad_sum(fclient, loss_fn, unravel, w, xs, m, cfg):
    """The cohort's summed transmit and example counts through the
    client function the round takes for `cfg`: one backward over the
    cohort (Config.fused_client_backward), else each client's
    local_step in turn (its microbatched backward, weight decay, count
    scaling and the encode of its transmit), with the dummies of
    untracked error and velocity rows."""
    if cfg.fused_client_backward:
        g, _, _, counts = fclient.fused_shard_grads(
            fclient.make_flat_loss_fn(loss_fn, unravel), w, xs, m, cfg)
        return g, counts
    grad_fn = fclient.make_flat_grad_fn(loss_fn, unravel)
    dummy = w.new_zeros(())
    res = [fclient.local_step(grad_fn, w, tuple(x[c] for x in xs), m[c],
                              dummy, dummy, cfg)
           for c in range(m.shape[0])]
    return (torch.stack([r.transmit for r in res]).sum(dim=0),
            torch.stack([r.num_examples for r in res]))


def parity_phase(label, build, w, data, mask, cfg, make_loss, rtol, floor,
                 fclient, fserver, flat, tf32_control=False, keep=None):
    """One round's client gradient sum (through the path's own client
    function, cohort_grad_sum), sketch table and server selection
    (top-k, or the threshold route's) on the card vs the CPU, from the
    same flat weights `w` and batch (`data` numpy arrays, floating ones
    cast to the run's dtype), with a float64 CPU gradient as the
    yardstick of float32 rounding. `build()` makes a fresh module and
    `make_loss(module)` its loss. It passes when card and CPU agree
    within `rtol`, the card lies within ACCURACY_RATIO x max(the CPU's
    float32 error, `floor`) of float64, and the selections share
    TOPK_OVERLAP of theirs. `rtol=None` holds the accuracy limit alone,
    for weights whose float32 gradient sits too far from float64 on any
    device for two devices to agree within a limit. With
    `tf32_control` the card runs the round once more with TF32 matmuls
    and convolutions: the gradient limits must refuse that run, or they
    could not tell TF32 from float32. `keep`, a dict, receives the
    card's table and selection and the float64 table (phase 37 holds
    the grid's reduced table to them)."""
    sketch = fserver.args2sketch(cfg)
    runs = [("cuda", torch.float32, False), ("cpu", torch.float32, False),
            ("cpu", torch.float64, False)]
    if tf32_control:
        runs.append(("cuda", torch.float32, True))
    tf32_flags = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
    out = {}
    for dev, dtype, tf32 in runs:
        module = build().to(dev, dtype)
        _, unravel = flat.flatten_params(module)
        xs = tuple(t.to(dtype) if t.is_floating_point() else t
                   for t in (torch.from_numpy(a).to(dev) for a in data))
        m = torch.from_numpy(mask).to(dev, dtype)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            g, counts = cohort_grad_sum(fclient, make_loss(module), unravel,
                                        w.detach().to(dev, dtype), xs, m,
                                        cfg)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32_flags
        key = "f64" if dtype == torch.float64 else "tf32" if tf32 else dev
        if key != "f64":
            table = sketch.encode(g) / counts.sum()
            zeros = torch.zeros(sketch.table_shape, device=dev)
            upd = fserver.get_server_update(table, zeros, zeros, cfg, 1.0)
            top = set(torch.nonzero(upd.update).reshape(-1).cpu().tolist())
            out[key] = (g.cpu(), table.cpu(), top)
            del table, upd
        else:
            out[key] = g.cpu()
            if keep is not None:
                from commefficient_tpu_torch.ops.kernels import sketch_cuda
                off, eps, delta = sketch.tables("cpu")
                keep["table64"] = sketch_cuda.encode_plain(
                    g.cpu(), off, delta.double(), eps.double(),
                    sketch.c) / counts.sum().cpu()
        del module, g
    (gc, tc, kc), (gp, tp, kp), g64 = out["cuda"], out["cpu"], out["f64"]
    if keep is not None:
        keep.update(table=tc, top=kc)
    g_err, t_err = _rel(gc, gp), _rel(tc, tp)
    card64, cpu64 = _rel(gc, g64), _rel(gp, g64)
    overlap = len(kc & kp) / max(len(kp), 1)
    accuracy_limit = ACCURACY_RATIO * max(cpu64, floor)
    if rtol is None:
        phase(label, f"card vs CPU: grad rel err {g_err:.3e}, table rel "
              f"err {t_err:.3e}, selection overlap {overlap:.5f} (no "
              f"limit); vs the float64 CPU gradient: card {card64:.3e}, "
              f"CPU float32 {cpu64:.3e} (card <= {ACCURACY_RATIO:g} x "
              f"max(CPU, {floor:g}))")
        if card64 > accuracy_limit:
            raise AssertionError("the card is less accurate than the CPU")
        return g_err, t_err, overlap
    phase(label, f"card vs CPU: grad rel err {g_err:.3e}, table rel "
          f"err {t_err:.3e} (tolerance {rtol:g}); vs the float64 CPU "
          f"gradient: card {card64:.3e}, CPU float32 {cpu64:.3e} (card <= "
          f"{ACCURACY_RATIO:g} x max(CPU, {floor:g})); selection overlap "
          f"{overlap:.5f} of {len(kp)} (card selected {len(kc)}; >= "
          f"{TOPK_OVERLAP:g})")
    if not (g_err <= rtol and t_err <= rtol and card64 <= accuracy_limit
            and overlap >= TOPK_OVERLAP):
        raise AssertionError("card and CPU disagree beyond tolerance")
    if tf32_control:
        gt = out["tf32"][0]
        tf_err, tf64 = _rel(gt, gp), _rel(gt, g64)
        phase(label, f"control, the card with TF32: grad rel err vs CPU "
              f"{tf_err:.3e}, vs float64 {tf64:.3e} (must exceed {rtol:g} "
              f"or {accuracy_limit:.3e})")
        if tf_err <= rtol and tf64 <= accuracy_limit:
            raise AssertionError("the limits pass a TF32 round: they cannot "
                                 "tell TF32 from float32")
    return g_err, t_err, overlap


def kernel_phase_gpt2(sc, ac, CSVec):
    """K1 at the GPT2 geometry, K3a / K3b / K4 against their plain
    versions; returns their result rows (launch counts filled in after
    the GPT2 main path)."""
    dev = torch.device("cuda")
    err = {"sketch_encode": 0.0, "threshold_sample": 0.0,
           "threshold_mask": 0.0, "flash_fwd": 0.0}
    for geom, sampling in (K3_GEOMETRIES
                           + [(g, None) for g in SMALL_GEOMETRIES]
                           + [(dict(d=GPT2_D, c=MAIN_C, r=MAIN_R), None)]):
        sk = CSVec(**geom)
        off, eps, delta = sk.tables(dev)
        eps_bits, delta_bits = sk.sign_bits(dev)
        g = torch.Generator().manual_seed(geom["d"] + 1)
        x = torch.randn(geom["d"], generator=g).to(dev)
        table = sk.encode(x)
        t_p = sc.encode_plain(x, off, delta, eps, sk.c)
        stride, ns = sampling or sc.threshold_sample_geometry(sk.n_chunks,
                                                              sk.c)
        s_k = sc.threshold_sample(table, off, delta_bits, eps_bits, sk.d,
                                  stride, ns)
        s_p = sc.threshold_sample_plain(table, off, delta, eps, sk.d, stride,
                                        ns)
        pairs = [("sketch_encode", "", table, t_p),
                 ("threshold_sample", "", s_k, s_p)]
        selected = []
        for label, thr in zip(K3_THRESHOLDS, k3_thresholds(
                sc, s_p, table, off, delta, eps, sk.d)):
            m_k = sc.threshold_mask(table, off, delta_bits, eps_bits, thr,
                                    sk.d)
            m_p = sc.threshold_mask_plain(table, off, delta, eps, thr, sk.d)
            selected.append(int((m_p != 0).sum()))
            pairs.append(("threshold_mask", f" at the {label} threshold",
                          m_k, m_p))
        torch.cuda.synchronize()
        for name, where, k, p in pairs:
            e = float((k - p).abs().max())
            err[name] = max(err[name], e)
            if not torch.equal(k, p):
                raise AssertionError(f"{name} differs from its plain "
                                     f"version at {geom}{where}: max abs "
                                     f"err {e}")
        phase("kernels", f"{geom}: K1, K3a and K3b equal to their plain "
              f"versions (exact; stride {stride}, {ns} samples a chunk; "
              "selected at the " + ", ".join(
                  f"{t} threshold {n}" for t, n in zip(K3_THRESHOLDS,
                                                       selected)) + ")")
        del x, table, t_p, s_k, s_p, m_k, m_p, pairs
    shape = f"[{K4_BATCH}, {K4_HEADS}, L, {K4_DH}]"
    for L in K4_LENGTHS:
        q, k, v = k4_operands(L, seed=L)
        o, lse = ac.flash_fwd(q, k, v, 0.125)
        po, plse = ac.flash_fwd_plain(q, k, v, 0.125)
        torch.cuda.synchronize()
        e_o = float((o - po).abs().max())
        e_l = float((lse - plse).abs().max())
        err["flash_fwd"] = max(err["flash_fwd"], e_o, e_l)
        if not (e_o <= K4_RTOL * float(po.abs().max())
                and e_l <= K4_RTOL * float(plse.abs().max())):
            raise AssertionError(f"flash_fwd differs from its plain version "
                                 f"at {shape}, L={L}: o {e_o}, lse {e_l}")
        phase("kernels", f"{shape}, L={L}, head views of the fused QKV "
              f"projection: K4 within {K4_RTOL:g} of its plain version "
              f"(max abs err o {e_o:.3e}, lse {e_l:.3e})")
        del q, k, v, o, lse, po, plse
    err["flash_fwd_bf16"] = 0.0
    for L in K4_LENGTHS:
        q, k, v = k4_operands(L, seed=L, dtype=torch.bfloat16)
        o, lse = ac.flash_fwd(q, k, v, 0.125)
        po32, plse = ac.flash_fwd_plain(q.float(), k.float(), v.float(),
                                        0.125)
        po, _ = ac.flash_fwd_plain(q, k, v, 0.125)
        torch.cuda.synchronize()
        within = bf16_within_half_ulp(o, po32)
        e_o = float((o.float() - po.float()).abs().max())
        e_l = float((lse - plse).abs().max())
        err["flash_fwd_bf16"] = max(err["flash_fwd_bf16"], e_o, e_l)
        if not (o.dtype == torch.bfloat16 and within
                and e_l <= K4_RTOL * float(plse.abs().max())):
            raise AssertionError(f"bf16 flash_fwd differs from its plain "
                                 f"version at {shape}, L={L}: o {e_o}, "
                                 f"lse {e_l}")
        phase("kernels", f"{shape} bf16, L={L}, head views: K4 on bf16 "
              f"operands, o within half a bf16 ulp (+{K4_RTOL:g} max|o|) "
              f"of the plain f32 output before its cast, lse within "
              f"{K4_RTOL:g} (max abs err vs the plain bf16 version: o "
              f"{e_o:.3e}, lse {e_l:.3e})")
        del q, k, v, o, lse, po32, po, plse

    # timing at the GPT2 main-path shapes
    d, c, r = GPT2_D, MAIN_C, MAIN_R
    sk = CSVec(d=d, c=c, r=r)
    B = sk.n_chunks
    off, eps, delta = sk.tables(dev)
    eps_bits, delta_bits = sk.sign_bits(dev)
    x = torch.randn(d, generator=torch.Generator().manual_seed(2)).to(dev)
    table = sk.encode(x)
    stride, ns = sc.threshold_sample_geometry(B, c)
    sample = sc.threshold_sample(table, off, delta_bits, eps_bits, d, stride,
                                 ns)
    thr = (sample.reshape(-1) ** 2).quantile(1 - MAIN_KEEP).reshape(1)
    early_out_shares(sk, table, off, thr)
    q, kk, v = k4_operands(GPT2_L, seed=3)
    qb, kb, vb = k4_operands(GPT2_L, seed=3, dtype=torch.bfloat16)
    sdpa = sdpa_efficient(ac, q, kk, v)
    sdpa_b = sdpa_flash_bf16(ac, qb, kb, vb)
    rows = [
        encode_row(sc, sk, x, "sketch_encode_gpt2", "config5"),
        # K3a reads the whole table (its r * B * ns gathers cover it)
        dict(name="threshold_sample", counter="threshold_sample",
             path="config5", route="cuda",
             source="commefficient_tpu_torch/ops/csrc/sketch.cu",
             replaces="commefficient_tpu/ops/kernels/sketch_pallas.py:232",
             fn=lambda: sc.threshold_sample(table, off, delta_bits, eps_bits,
                                            d, stride, ns),
             plain=lambda: sc.threshold_sample_plain(table, off, delta, eps,
                                                     d, stride, ns),
             library=None, cost=sc.sample_cost(r, c, B, ns)),
        dict(name="threshold_mask", counter="threshold_mask",
             path="config5", route="cuda",
             source="commefficient_tpu_torch/ops/csrc/sketch.cu",
             replaces="commefficient_tpu/ops/kernels/sketch_pallas.py:250",
             fn=lambda: sc.threshold_mask(table, off, delta_bits, eps_bits,
                                          thr, d),
             plain=lambda: sc.threshold_mask_plain(table, off, delta, eps,
                                                   thr, d),
             library=None, cost=sc.mask_cost(d, r, c, B)),
        # f32-accurate, so on the TF32 tensor cores in three passes
        # (ac.flash_fwd_cost): 3x the operations at the TF32 rate (the
        # route SDPA's own f32 kernel takes too), against which the
        # bytes are the bound
        dict(name="flash_fwd", counter="flash_fwd", path="config5",
             route="cuda",
             source="commefficient_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="commefficient_tpu/ops/attention.py:91",
             fn=lambda: ac.flash_fwd(q, kk, v, 0.125),
             plain=lambda: ac.flash_fwd_plain(q, kk, v, 0.125),
             library=sdpa, cost=ac.flash_fwd_cost(q),
             peak_flops=PEAK_TF32_FLOPS),
        # bf16 operands (--bf16), one pass at the bf16 tensor-core
        # rate. Its yardstick rounds P to
        # bf16 before P.V, so it is not quite the same function
        dict(name="flash_fwd_bf16", counter="flash_fwd_bf16",
             path="config5_bf16", route="cuda",
             source="commefficient_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="commefficient_tpu/ops/attention.py:91",
             fn=lambda: ac.flash_fwd(qb, kb, vb, 0.125),
             plain=lambda: ac.flash_fwd_plain(qb, kb, vb, 0.125),
             library=sdpa_b, cost=ac.flash_fwd_cost(qb),
             peak_flops=H100_BF16_FLOPS),
    ]
    return [timed_row(row, err[row["counter"]]) for row in rows]


def k3_thresholds(sc, sample, table, off, delta, eps, d):
    """K3b's thresholds at one geometry, in K3_THRESHOLDS' order, from
    the plain sample and the plain mask."""
    sq = (sample * sample).reshape(-1)
    main = sq.quantile(1 - MAIN_KEEP).reshape(1)
    median = sq.median().reshape(1)
    kept = sc.threshold_mask_plain(table, off, delta, eps, median, d)
    kept = kept[kept != 0]
    tie = (kept[kept.numel() // 2] ** 2).reshape(1)
    return main, median, tie


def early_out_shares(sk, table, off, thr) -> None:
    """Print the share of coordinates whose first m = r // 2 + 1 row
    values all square under `thr`, and of 8-position sectors (32 bytes
    of the output; their table reads share sectors too) all of whose
    coordinates do: what an early-out of K3b after m rows would skip.
    Plain torch on the card, from the same table (the signs do not
    change a square)."""
    d, c, B = sk.d, sk.c, sk.n_chunks
    pos = torch.arange(c, device=table.device)
    small = torch.ones(B, c, dtype=torch.bool, device=table.device)
    for j in range(sk.r // 2 + 1):
        v = table[j][(pos[None, :] + off[j][:, None].long()) % c]
        small &= v * v < thr
        del v
    # the tail (and any padding to whole sectors) needs no rows
    small = torch.cat([small.reshape(-1),
                       small.new_ones(-(-B * c // 8) * 8 - B * c)])
    small[d:] = True
    coords = float(small[:d].float().mean())
    sectors = float(small.reshape(-1, 8).all(dim=1)[:-(-d // 8)]
                    .float().mean())
    phase("kernels", f"at d={d}, r={sk.r} and the timed threshold: "
          f"{coords:.4f} of the coordinates have their first "
          f"{sk.r // 2 + 1} rows all under it, and {sectors:.4f} of the "
          "8-position sectors hold only such coordinates (plain torch)")


def k4_operands(L: int, seed: int, dtype=torch.float32):
    """q, k, v as the GPT2 main path hands them to K4: the [B, H, L, Dh]
    head views of one fused [K4_BATCH, L, 3 * 768] QKV projection (row
    stride 3 * 768, no copy), in `dtype` (bf16 under --bf16)."""
    E = K4_HEADS * K4_DH
    qkv = torch.randn(K4_BATCH, L, 3 * E,
                      generator=torch.Generator().manual_seed(seed)
                      ).to("cuda", dtype)
    return tuple(t.reshape(K4_BATCH, L, K4_HEADS, K4_DH).transpose(1, 2)
                 for t in qkv.split(E, dim=-1))


def sdpa_efficient(ac, q, k, v):
    """K4's library yardstick: scaled_dot_product_attention (f32,
    causal) pinned to the memory-efficient backend, on the same views;
    checked once against the plain version so the yardstick computes
    the same function."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  scale=0.125)
    o = call()
    po, _ = ac.flash_fwd_plain(q, k, v, 0.125)
    e = float((o - po).abs().max() / po.abs().max())
    phase("kernels", f"library yardstick: scaled_dot_product_attention, "
          f"backend {SDPBackend.EFFICIENT_ATTENTION.name} (pinned), on "
          f"the head views; relative max err vs the plain version {e:.3e}")
    if not e <= K4_RTOL:
        raise AssertionError("the SDPA yardstick does not compute K4's "
                             "function")
    return call


def sdpa_flash_bf16(ac, q, k, v):
    """K4-bf16's library yardstick: scaled_dot_product_attention (bf16,
    causal) pinned to the flash backend, on the same bf16 views. It
    rounds P to bf16 before P.V, so it is held to the plain version
    only loosely (2e-2 of max|o|) and its error is printed."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  scale=0.125)
    o = call().float()
    po, _ = ac.flash_fwd_plain(q.float(), k.float(), v.float(), 0.125)
    e = float((o - po).abs().max() / po.abs().max())
    phase("kernels", f"library yardstick (bf16): scaled_dot_product_"
          f"attention, backend {SDPBackend.FLASH_ATTENTION.name} (pinned), "
          f"on the bf16 head views; relative max err vs the plain f32 "
          f"output {e:.3e}")
    if not e <= 2e-2:
        raise AssertionError("the bf16 SDPA yardstick is far from K4's "
                             "function")
    return call


def bf16_within_half_ulp(o, po32) -> bool:
    """o (bf16) within half a bf16 ulp of the f32 output po32 before its
    cast, plus K4_RTOL of max|po32|."""
    ulp = torch.where(po32 == 0, torch.zeros_like(po32),
                      torch.ldexp(torch.ones_like(po32),
                                  torch.frexp(po32).exponent - 8))
    bound = 0.5 * ulp + K4_RTOL * float(po32.abs().max())
    return bool(((o.float() - po32).abs() <= bound).all())


def gpt2_main_path(sc, ac, gpt2_train, parse_args, HashTokenizer, data_dir,
                   profile_dir=None, label="gpt2", extra=(),
                   attn="flash_fwd"):
    """Drive gpt2_train.train_gpt2() for GPT2_ROUNDS rounds of config #5,
    then test_gpt2 on the val split (and, with `profile_dir`, trace
    three more rounds); returns (launches, round ms, peak bytes, a batch
    for parity, the config)."""
    spe = math.ceil(GPT2_CORPUS[0] * GPT2_CORPUS[1] * GPT2_CORPUS[2]
                    / (8 * 8))
    cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=CONFIG5 + list(
        extra) + ["--local_batch_size", "8", "--device", "cuda",
        "--dataset_dir", data_dir, "--num_epochs", str(GPT2_ROUNDS / spe),
        "--seed", "21"])
    t0 = time.perf_counter()
    model, opt, sched, train_loader, val_loader = gpt2_train.build(
        cfg, HashTokenizer(GPT2_VOCAB), device="cuda",
        synthetic_examples=GPT2_CORPUS)
    phase(label, f"built in {time.perf_counter() - t0:.2f} s: D="
          f"{model.cfg.grad_size}, train L={train_loader.dataset.seq_len}, "
          f"val L={val_loader.dataset.seq_len}, {spe} rounds an epoch")
    assert model.cfg.grad_size == GPT2_D, model.cfg.grad_size
    assert train_loader.dataset.seq_len == GPT2_L
    assert train_loader.steps_per_epoch == spe
    assert model.cfg.fused_client_backward
    rr = drive_rounds(label, sc, ac, model, train_loader, GPT2_ROUNDS,
                      lambda timed, on_round: gpt2_train.train_gpt2(
                          model, opt, sched, timed, model.cfg,
                          on_round=on_round))
    launches = rr.launches
    want = {"threshold_sample": GPT2_ROUNDS, "threshold_mask": GPT2_ROUNDS,
            "sketch_encode": 2 * GPT2_ROUNDS, "sketch_estimate_all": 0,
            "sketch_estimate_window": 0,
            "flash_fwd": 0, "flash_fwd_bf16": 0}
    want[attn] = 12 * 8 * GPT2_ROUNDS
    check_launches(label, launches, want)
    phase(label, f"{GPT2_ROUNDS} rounds, D={GPT2_D}, L={GPT2_L}, mean "
          f"client loss first/last {float(rr.losses[0].mean()):.4f}/"
          f"{float(rr.losses[-1].mean()):.4f}, launches {launches}")
    reset_counts(sc, ac)
    t0 = time.perf_counter()
    stats = gpt2_train.test_gpt2(model, val_loader)
    torch.cuda.synchronize()
    if not math.isfinite(stats["val_nll"]):
        raise AssertionError(f"non-finite val NLL {stats['val_nll']}")
    phase(label, f"test_gpt2: val NLL {stats['val_nll']:.4f}, acc "
          f"{stats['val_acc']:.4f}, ppl {stats['val_ppl']:.2f} in "
          f"{time.perf_counter() - t0:.2f} s, K4 ({attn}) launched "
          f"{ac.LAUNCHES[attn]} times")
    if ac.LAUNCHES[attn] == 0:
        raise AssertionError(f"test_gpt2 did not launch K4 ({attn})")
    if profile_dir:
        profile_rounds(model, train_loader, opt,
                       os.path.join(profile_dir,
                                    f"profile_{label}_rounds.txt"),
                       f"{label} profile",
                       per_launch=("threshold_mask_kernel",))
    batch = next(iter(train_loader.epoch()))
    cfg = model.cfg
    del model, opt, sched
    torch.cuda.empty_cache()
    return launches, rr.round_ms, rr.peak, batch, cfg


def bf16_parity_phase(label, build, w, data, mask, make_loss, fclient,
                      flat) -> None:
    """--bf16's accuracy check: one client's flat gradient from the same
    weights `w` and batch in bf16 on the card and on the CPU, each
    against the float64 CPU gradient. The card's distance over the
    CPU's must lie within BF16_BAND; a float32 run on the card (the
    --bf16-off control) must fall outside it."""
    runs = (("cuda", torch.bfloat16), ("cpu", torch.bfloat16),
            ("cpu", torch.float64), ("cuda", None))
    out = {}
    for dev, dt in runs:
        dtype = torch.float64 if dt == torch.float64 else torch.float32
        module = build().to(dev, dtype)
        _, unravel = flat.flatten_params(module)
        xs = tuple(t.to(dtype) if t.is_floating_point() else t
                   for t in (torch.from_numpy(a).to(dev) for a in data))
        m = torch.from_numpy(mask).to(dev, dtype)
        grad_fn = fclient.make_flat_grad_fn(
            make_loss(module), unravel,
            torch.bfloat16 if dt == torch.bfloat16 else None)
        t0 = time.perf_counter()
        _, _, g = grad_fn(w.detach().to(dev, dtype), xs, m)
        out[dev, dt] = g.cpu()
        phase(label, f"{dev} {dt or torch.float32} gradient in "
              f"{time.perf_counter() - t0:.2f} s")
        del module, g
    g64 = out["cpu", torch.float64]
    e_card = _rel(out["cuda", torch.bfloat16], g64)
    e_cpu = _rel(out["cpu", torch.bfloat16], g64)
    e_ctrl = _rel(out["cuda", None], g64)
    e_pair = _rel(out["cuda", torch.bfloat16], out["cpu", torch.bfloat16])
    lo, hi = BF16_BAND
    phase(label, f"vs the float64 CPU gradient: card bf16 {e_card:.3e}, "
          f"CPU bf16 {e_cpu:.3e}, ratio {e_card / e_cpu:.3f} (within "
          f"[{lo:.3f}, {hi:g}]); card bf16 vs CPU bf16 {e_pair:.3e}; "
          f"control, the card with --bf16 off: {e_ctrl:.3e}, ratio "
          f"{e_ctrl / e_cpu:.3e} (must fall outside)")
    if not lo <= e_card / e_cpu <= hi:
        raise AssertionError("the card's bf16 gradient is not as accurate "
                             "as the CPU's")
    if lo <= e_ctrl / e_cpu <= hi:
        raise AssertionError("the band passes a float32 run: it cannot tell "
                             "bf16 from float32")


def profile_rounds(model, train_loader, opt, path, label="profile",
                   per_launch=()):
    """Device time by kernel over three traced rounds (after one
    untraced and one warm-up round of the profiler's schedule); for each
    kernel whose name holds a string of `per_launch`, its mean device
    time a launch."""
    from torch.profiler import ProfilerActivity, profile, schedule
    it = iter(train_loader.epoch())
    batches = [next(it) for _ in range(5)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=3)) as prof:
        for i, b in enumerate(batches):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            model(b)
            opt.step()
            prof.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    # kernels only: the ProfilerStep* rows annotate whole steps on the
    # device timeline and would count the steps' spans, not work
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.key.startswith("ProfilerStep"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"3 rounds, wall {wall_ms:.2f} ms (traced), device busy "
                f"{dev_us / 1e3:.2f} ms\n{table}\n")
    phase(label, f"3 traced rounds: wall {wall_ms:.2f} ms, kernels on "
          f"the device {dev_us / 1e3:.2f} ms (busy share "
          f"{dev_us / 1e3 / wall_ms:.3f}); table in {path}")
    for name in per_launch:
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and name in e.key]
        n = sum(e.count for e in hits)
        if n == 0:
            raise AssertionError(f"no {name} launch in the traced rounds")
        us = sum(e.self_device_time_total for e in hits)
        phase(label, f"{name} on the rounds' own tables: "
              f"{us / 1e3 / n:.4f} ms a launch (device time, mean of {n})")


def mode_path(label, sc, ac, cv_train, flat, parse_args, flags, rounds,
              spe, want_d, data_dir):
    """Drive cv_train.train() for `rounds` rounds of one of the remaining
    modes at full width, with the SM clock, power and host load sampled
    beside them; no sketch or attention kernel may launch. Returns (the
    model, the rounds' run, the train loader)."""
    n_train = CLIENTS * EXAMPLES_PER_CLIENT
    cfg = parse_args(argv=flags + [
        "--num_clients", str(CLIENTS), "--device", "cuda",
        "--dataset_dir", data_dir, "--num_epochs", str(rounds / spe),
        "--pivot_epoch", str(rounds / spe / 2), "--seed", "21"])
    model, opt, sched, train_loader, val_loader = cv_train.build(
        cfg, device="cuda", synthetic_examples=(n_train, 512))
    assert model.cfg.grad_size == want_d, model.cfg.grad_size
    assert train_loader.steps_per_epoch == spe, train_loader.steps_per_epoch
    rr = drive_rounds(label, sc, ac, model, train_loader, rounds,
                      lambda timed, on_round: cv_train.train(
                          model, opt, sched, timed, val_loader, model.cfg,
                          on_round=on_round))
    launched = {n: rr.launches[n] for n in SKETCH_AND_ATTENTION
                if rr.launches[n]}
    if launched:
        raise AssertionError(f"sketch/attention kernels launched on the "
                             f"{label} path: {launched}")
    state = sum(t.numel() * t.element_size() for t in model.clients)
    phase(label, f"{rounds} rounds, {model.cfg.model}, D={want_d}, mean "
          "client loss by round " + " ".join(
              f"{float(v):.4f}" for v in rr.losses.mean(dim=1))
          + f", launches {rr.launches}; client state {state / 1e9:.3f} GB "
          f"({state} bytes: errors {tuple(model.clients.errors.shape)}, "
          f"velocities {tuple(model.clients.velocities.shape)}, weights "
          f"{tuple(model.clients.weights.shape)}, f32)")
    x = torch.randn(want_d, generator=torch.Generator().manual_seed(4)
                    ).to("cuda")
    k = model.cfg.k
    topk_ms = time_cuda(lambda: flat.masked_topk(x, k), 20)
    kept = int((flat.masked_topk(x, k) != 0).sum())
    phase(label, f"one per-client masked_topk at d={want_d}, k={k} (the "
          f"sampled-threshold route above {flat.TOPK_THRESHOLD_MIN_D}): "
          f"{topk_ms:.4f} ms (device time, median of 20, L2 flushed), kept "
          f"{kept}")
    return model, rr, train_loader


def ttopk_checks(model, timed) -> None:
    """true_topk with local momentum: the last round's participants'
    velocity rows are zero wherever the server sent (its virtual error
    is zero there after the round) and nonzero elsewhere."""
    ids = torch.as_tensor(timed.last_ids, dtype=torch.long, device="cuda")
    vel = model.clients.velocities[ids]
    sent = model.server.Verror == 0
    n_sent = int(sent.sum())
    if not n_sent >= 0.9 * model.cfg.k:
        raise AssertionError(f"only {n_sent} coordinates sent (k = "
                             f"{model.cfg.k})")
    at_sent = int((vel[:, sent] != 0).sum())
    elsewhere = int((vel[:, ~sent] != 0).sum())
    phase("ttopk", f"last round: {n_sent} coordinates sent; nonzero "
          f"velocity entries of its {ids.numel()} participants at them "
          f"{at_sent}, elsewhere {elsewhere}")
    if at_sent or not elsewhere:
        raise AssertionError("the velocity rows are not masked at exactly "
                             "the coordinates sent")


def ltopk_checks(model, timed) -> None:
    """local_topk: the last round's participants carry nonzero error
    rows; the realized nonzeros of the aggregate beside 8 k."""
    ids = torch.as_tensor(timed.last_ids, dtype=torch.long, device="cuda")
    nz = (model.clients.errors[ids] != 0).sum(dim=1).tolist()
    acct = model.accountant
    k, W = model.cfg.k, model.cfg.num_workers
    phase("ltopk", f"nonzero error entries of the last round's participants "
          f"{nz}; realized nonzeros of the last aggregate update "
          f"{acct.realized_nonzeros}, max over the rounds "
          f"{acct.max_realized_nonzeros} (the {W} uploads' union is at "
          f"most {W} x k = {W * k} but for threshold ties and sampling "
          "noise)")
    if min(nz) == 0:
        raise AssertionError("a participant's error row is all zero")
    if acct.realized_nonzeros is None or acct.max_realized_nonzeros == 0:
        raise AssertionError("no realized nonzeros recorded")


def ltopk_parity(model, timed, batch, cv_train, models, convert, fclient,
                 flat) -> None:
    """One config #3 client step (local_step: forward, backward, local
    momentum and error, the per-client top-k) for 2 clients x 32 of a
    main-path batch, from the path's initial weights (its round 1) and
    the last round's participants' error and velocity rows, on the card
    and on the CPU (TF32 off), beside a float64 CPU run. The gradients
    must agree within PARITY_RTOL and the card be no less accurate than
    the CPU against float64 (parity_phase's limits); the selected
    supports must share TOPK_OVERLAP; the transmit and the new error and
    velocity rows must agree within PARITY_RTOL on the coordinates both
    runs selected alike (a coordinate near the threshold may be sent by
    one run and kept by the other, which moves a threshold-sized value
    between the transmit and the error row). A TF32 control run of the
    card must be refused. The initial weights, not the trained ones:
    after the path's loss spikes the float32 gradient of ResNet18 sits
    about as far from float64 as the limit itself, on either device."""
    cfg = model.cfg
    w, _ = flat.flatten_params(models.build_model(
        cfg.model, num_classes=100, seed=cfg.seed))
    ids = torch.as_tensor(timed.last_ids[:2], dtype=torch.long,
                          device=model.ps_weights.device)
    err = model.clients.errors[ids].cpu()
    vel = model.clients.velocities[ids].cpu()
    data, mask = tuple(a[:2] for a in batch[1]), batch[2][:2]
    runs = [("cuda", torch.float32, False), ("cpu", torch.float32, False),
            ("cpu", torch.float64, False), ("cuda", torch.float32, True)]
    tf32_flags = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
    out = {}
    for dev, dtype, tf32 in runs:
        module = models.build_model("ResNet18", num_classes=100)
        convert.load_flat(module, w)
        module = module.to(dev, dtype)
        _, unravel = flat.flatten_params(module)
        base = fclient.make_flat_grad_fn(cv_train.make_compute_loss(module),
                                         unravel)
        grads = []

        def grad_fn(wv, b, m):
            res = base(wv, b, m)
            grads.append(res[2])
            return res

        xs = tuple(t.to(dtype) if t.is_floating_point() else t
                   for t in (torch.from_numpy(a).to(dev) for a in data))
        m = torch.from_numpy(mask).to(dev, dtype)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            res = [fclient.local_step(
                grad_fn, w.to(dev, dtype), tuple(x[c] for x in xs), m[c],
                err[c].to(dev, dtype), vel[c].to(dev, dtype), cfg)
                for c in range(2)]
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32_flags
        key = "f64" if dtype == torch.float64 else "tf32" if tf32 else dev
        out[key] = ([g.cpu() for g in grads],
                    [(r.transmit.cpu(), r.error.cpu(), r.velocity.cpu())
                     for r in res])
        del module, grads, res
    worst = dict(grad=0.0, rows=0.0, ratio=0.0, overlap=1.0)
    for c in range(2):
        gc, gp, g64 = (out[k][0][c] for k in ("cuda", "cpu", "f64"))
        g_err, card64, cpu64 = _rel(gc, gp), _rel(gc, g64), _rel(gp, g64)
        limit = ACCURACY_RATIO * max(cpu64, ACCURACY_FLOOR)
        (tc, ec, vc), (tp, ep, vp) = out["cuda"][1][c], out["cpu"][1][c]
        sel_c, sel_p = tc != 0, tp != 0
        overlap = int((sel_c & sel_p).sum()) / max(int(sel_p.sum()), 1)
        alike = sel_c == sel_p
        rows = {name: _rel(a[alike], b[alike]) for name, a, b in
                (("transmit", tc, tp), ("error", ec, ep),
                 ("velocity", vc, vp))}
        phase("lparity", f"client {c}: grad rel err card vs CPU {g_err:.3e} "
              f"(tolerance {PARITY_RTOL:g}); vs float64: card {card64:.3e}, "
              f"CPU {cpu64:.3e} (card <= {limit:.3e}); selected card "
              f"{int(sel_c.sum())}, CPU {int(sel_p.sum())}, overlap "
              f"{overlap:.5f} (>= {TOPK_OVERLAP:g}); on the "
              f"{int(alike.sum())} coordinates selected alike: "
              + ", ".join(f"{n} {e:.3e}" for n, e in rows.items()))
        if not (g_err <= PARITY_RTOL and card64 <= limit
                and overlap >= TOPK_OVERLAP
                and max(rows.values()) <= PARITY_RTOL):
            raise AssertionError("card and CPU disagree beyond tolerance")
        tg = out["tf32"][0][c]
        tf_err, tf64 = _rel(tg, gp), _rel(tg, g64)
        phase("lparity", f"client {c}, control, the card with TF32: grad rel "
              f"err vs CPU {tf_err:.3e}, vs float64 {tf64:.3e} (must exceed "
              f"{PARITY_RTOL:g} or {limit:.3e})")
        if tf_err <= PARITY_RTOL and tf64 <= limit:
            raise AssertionError("the limits pass a TF32 round: they cannot "
                                 "tell TF32 from float32")


def write_imagenet_corpus(root: str) -> None:
    """Config #4's corpus under root/ImageNet/preprocessed/, file by file
    (no array of the whole set): IMAGENET_CLASSES `client<i>.npy` of
    [IMAGENET_PER_CLASS, 224, 224, 3] uint8 and a val.npz of
    IMAGENET_VAL images, all from one RandomState(IMAGENET_SEED).
    Uniform pixels: the shapes, the model and the code path are the
    real ones, the images are not."""
    import numpy as np
    pre = os.path.join(root, "ImageNet", "preprocessed")
    os.makedirs(pre)
    rng = np.random.RandomState(IMAGENET_SEED)
    shape = (IMAGENET_PER_CLASS, IMAGENET_HW, IMAGENET_HW, 3)

    def images(shape):
        return np.frombuffer(rng.bytes(math.prod(shape)),
                             np.uint8).reshape(shape)

    t0 = time.perf_counter()
    written = 0
    for c in range(IMAGENET_CLASSES):
        arr = images(shape)
        np.save(os.path.join(pre, f"client{c}.npy"), arr)
        written += arr.nbytes
    val = images((IMAGENET_VAL,) + shape[1:])
    np.savez(os.path.join(pre, "val.npz"), images=val,
             labels=rng.randint(0, IMAGENET_CLASSES, IMAGENET_VAL))
    written += val.nbytes
    seconds = time.perf_counter() - t0
    phase("corpus", f"{IMAGENET_CLASSES} class files x {IMAGENET_PER_CLASS} "
          f"images and {IMAGENET_VAL} val images of {IMAGENET_HW} px: "
          f"{written} bytes of uint8 written in {seconds:.2f} s under "
          f"{root}" + (" (over 60 s: cut IMAGENET_CLASSES)"
                       if seconds > 60 else ""))


def imagenet_path(label, sc, ac, cv_train, parse_args, flags, want_d,
                  data_dir):
    """Drive cv_train.train() for the first IMAGENET_ROUNDS rounds of one
    config #4 path on the corpus under `data_dir`, at full width, beside
    the card sampler: the learning-rate schedule is the run's own (24
    epochs, the ramp to its peak over 5), and train() is handed the
    config with num_epochs cut to IMAGENET_ROUNDS rounds. Returns (the
    model, the rounds' run, the train loader)."""
    n_train = IMAGENET_CLASSES * IMAGENET_PER_CLASS
    spe = math.ceil(n_train / (7 * 64))
    cfg = parse_args(argv=flags + [
        "--device", "cuda", "--dataset_dir", data_dir, "--seed", "21"])
    t0 = time.perf_counter()
    model, opt, sched, train_loader, val_loader = cv_train.build(
        cfg, device="cuda")
    phase(label, f"built in {time.perf_counter() - t0:.2f} s: {cfg.model}, "
          f"D={model.cfg.grad_size}, {model.num_clients} clients, "
          f"fused backward {model.cfg.fused_client_backward}, {spe} rounds "
          "an epoch")
    assert model.cfg.grad_size == want_d, model.cfg.grad_size
    assert train_loader.steps_per_epoch == spe, train_loader.steps_per_epoch
    cut = model.cfg.replace(num_epochs=IMAGENET_ROUNDS / spe)
    rr = drive_rounds(label, sc, ac, model, train_loader, IMAGENET_ROUNDS,
                      lambda timed, on_round: cv_train.train(
                          model, opt, sched, timed, val_loader, cut,
                          on_round=on_round))
    phase(label, f"{IMAGENET_ROUNDS} rounds at learning rate "
          f"{opt.param_groups[0]['lr']:.5f} by the last, mean client loss "
          "by round "
          + " ".join(f"{float(v):.4f}" for v in rr.losses.mean(dim=1))
          + f", launches {rr.launches}")
    return model, rr, train_loader


def imagenet_checks(model, rr) -> None:
    """Phase 13: no sketch or attention kernel, and the Fixup learning
    rates in use: 0.1 on the 16 blocks' 7 scalars and the head's 1000
    biases, 1 elsewhere."""
    launched = {n: rr.launches[n] for n in SKETCH_AND_ATTENTION
                if rr.launches[n]}
    if launched:
        raise AssertionError(f"sketch/attention kernels launched on the "
                             f"imagenet path: {launched}")
    scales = model.lr_scale_vec
    if scales is None:
        raise AssertionError("FixupResNet50 runs without its LR scales")
    n_low = int((scales == 0.1).sum())
    n_one = int((scales == 1.0).sum())
    phase("imagenet", f"Fixup LR scales in use: {n_low} coordinates at "
          f"0.1, {n_one} at 1.0")
    if n_low != 16 * 7 + 1000 or n_low + n_one != FIXUP50_D:
        raise AssertionError("the Fixup LR scale vector is not JAX's")


def sketch50_checks(model, rr, flat, fserver) -> None:
    """Phase 14: K1 and K2 once a round each, K3a, K3b and K4 never;
    then the stable top-k (ops/flat.topk_indices) timed alone over the
    last round's own estimates, [B x c] of them."""
    want = {"sketch_encode": IMAGENET_ROUNDS,
            "sketch_estimate_all": IMAGENET_ROUNDS, "threshold_sample": 0,
            "threshold_mask": 0, "flash_fwd": 0}
    for name, n in want.items():
        if rr.launches[name] != n:
            raise AssertionError(f"{name} launched {rr.launches[name]} times "
                                 f"in {IMAGENET_ROUNDS} rounds ({n} "
                                 "expected)")
    sketch = fserver.args2sketch(model.cfg)
    est = sketch._flat_estimates(model.server.Verror)
    sq = est * est
    k = model.cfg.k
    sort_ms = time_cuda(lambda: flat.topk_indices(sq, k), 20)
    phase("sketch50", f"stable top-k (ops/flat.topk_indices, a stable "
          f"descending sort) of {sq.numel()} estimates "
          f"({sketch.n_chunks} x {sketch.c}), k={k}: {sort_ms:.4f} ms "
          "(device time, median of 20, L2 flushed)")

class RoundLog:
    """on_round of a resume run: each round's end (after a synchronize),
    client ids, examples and download / upload bytes."""

    def __init__(self, timed):
        self.timed = timed
        self.t0 = time.perf_counter()
        self.ends, self.ids, self.examples, self.bytes = [], [], [], []

    def __call__(self, i, out):
        torch.cuda.synchronize()
        self.ends.append(time.perf_counter())
        self.ids.append(np.asarray(self.timed.last_ids).copy())
        self.examples.append(self.timed.last_examples)
        self.bytes.append((float(np.sum(out[-2])), float(np.sum(out[-1]))))

    def round_ms(self) -> list:
        return [1e3 * (b - a) for a, b in zip([self.t0] + self.ends[:-1],
                                              self.ends)]


class _Quiet:
    """A logger that prints nothing (the GPT2 driver's per-round table)."""

    def append(self, row):
        pass


def final_checkpoint(ck_dir: str, name: str) -> str:
    return sorted(glob.glob(os.path.join(ck_dir, f"{name}-r*.npz")))[-1]


def checkpoint_diff(a: str, b: str, thr: bool = False) -> dict:
    """{key: max |a - b|} of the keys whose arrays differ (thr_*, the
    wall-clock throughput EMAs, excepted unless `thr`); a missing key
    counts inf."""
    out = {}
    with np.load(a) as za, np.load(b) as zb:
        for k in sorted(set(za.files) | set(zb.files)):
            if k.startswith("thr_") and not thr:
                continue
            if k not in za.files or k not in zb.files:
                out[k] = math.inf
            elif not np.array_equal(za[k], zb[k]):
                x, y = za[k], zb[k]
                out[k] = (float(np.abs(x.astype(np.float64)
                                       - y.astype(np.float64)).max())
                          if x.shape == y.shape and x.dtype.kind in "fiu"
                          else math.inf)
    return out


# (run, its directory, the epoch whose opening preempts it, --resume)
RESUME_PLAN = (("A", "A", None, False), ("B1", "B", 2, False),
               ("B2", "B", None, True))


def resume_runs(label, sc, ac, build, tmp, plan=RESUME_PLAN):
    """A, then B preempted and resumed (RESUME_EPOCHS' note). `build(ck,
    journal, resume)` returns (model, loader, go) with go(loader,
    on_round) driving the driver's run(). Returns {name: (ok, RoundLog,
    launches)} for A, B1 (preempted) and B2 (resumed)."""
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, sub, preempt, resume in plan:
            d = os.path.join(tmp, sub)
            model, loader, go = build(d, d + ".jsonl", resume)
            timed = TimedLoader(loader, preempt_at_epoch=preempt)
            log = RoundLog(timed)
            reset_counts(sc, ac)
            torch.cuda.reset_peak_memory_stats()
            try:
                ok = go(timed, log)
            except Preempted:
                ok = None
            torch.cuda.synchronize()
            runs[name] = (ok, log, read_counts(sc, ac))
            phase(label, f"run {name}: {len(log.ends)} rounds, ok {ok}, "
                  "ms/round " + " ".join(f"{t:.2f}" for t in log.round_ms())
                  + f", peak over its rounds, checkpoints and resume "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
            del model, loader, go, timed
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return runs


def check_journal(label, path, rounds, epoch_rounds, log_rows):
    """The journal of one run (A) or of a preempted run and its resume
    (B), read without the JAX package: every record carries v, event,
    ts and mono; each segment opens with run_start (the second with
    resumed_round `epoch_rounds`) and closes with run_end, the last ok;
    one `round` event for each round index, whose bytes are the
    accountant's and whose examples and survivors are the round's;
    `epoch` and `checkpoint` events; `trace` events holding the stage,
    dispatch, collect and checkpoint spans. Returns the checkpoint
    events."""
    from commefficient_tpu_torch.telemetry.journal import read_journal
    records, problems = read_journal(path)
    fail = list(problems)
    for r in records:
        if not all(k in r for k in ("v", "event", "ts", "mono")):
            fail.append(f"record without v/event/ts/mono: {r}")
    starts = [r for r in records if r["event"] == "run_start"]
    ends = [r for r in records if r["event"] == "run_end"]
    want_starts = [0] if len(log_rows) == 1 else [0, epoch_rounds]
    if [s["resumed_round"] for s in starts] != want_starts:
        fail.append(f"run_start resumed_round "
                    f"{[s['resumed_round'] for s in starts]}, "
                    f"{want_starts} expected")
    if not ends or ends[-1]["ok"] is not True or \
            len(ends) != len(starts) or records[-1]["event"] != "run_end":
        fail.append(f"run_end records {ends}")
    by_round = {}
    for r in records:
        if r["event"] == "round":
            by_round.setdefault(r["round"], []).append(r)
    if sorted(by_round) != list(range(rounds)) or \
            any(len(v) != 1 for v in by_round.values()):
        fail.append(f"round events {sorted(by_round)}")
    ids = [i for log in log_rows for i in log.ids]
    examples = [e for log in log_rows for e in log.examples]
    nbytes = [b for log in log_rows for b in log.bytes]
    for i, rows in by_round.items():
        r = rows[0]
        m = r.get("metrics", {})
        if i < len(nbytes) and ((r["down_bytes"], r["up_bytes"])
                                != nbytes[i]
                                or m.get("examples") != examples[i]
                                or m.get("survivors") != len(ids[i])):
            fail.append(f"round {i}: {r} against bytes {nbytes[i]}, "
                        f"examples {examples[i]}")
    ckpts = [r for r in records if r["event"] == "checkpoint"]
    if not ckpts or not any(r["event"] == "epoch" for r in records):
        fail.append("no epoch or checkpoint event")
    spans = {s["name"] for r in records if r["event"] == "trace"
             for s in r["spans"]}
    if not {"stage", "dispatch", "collect", "checkpoint"} <= spans:
        fail.append(f"trace spans {sorted(spans)}")
    if fail:
        raise AssertionError(f"{label} journal {path}: " + "; ".join(
            str(f) for f in fail[:5]))
    return ckpts


def resume_phase(label, sc, ac, build, name, rounds, epoch_rounds,
                 want_launches, ref_ms, ref_label, tmp):
    """Phases 20-21: runs A and B, then the bitwise and journal checks.
    On a bitwise miss, A runs again: B must lie within 2x A's own spread
    (a nondeterministic op outside the port's code), else the phase
    fails."""
    runs = resume_runs(label, sc, ac, build, tmp)
    (a_ok, a_log, a_launch), (_, b1_log, _), (b_ok, b2_log, b_launch) = (
        runs["A"], runs["B1"], runs["B2"])
    if not (a_ok and b_ok) or len(a_log.ends) != rounds or \
            len(b1_log.ends) != epoch_rounds or \
            len(b2_log.ends) != rounds - epoch_rounds:
        raise AssertionError(f"{label}: rounds A {len(a_log.ends)}, B "
                             f"{len(b1_log.ends)} + {len(b2_log.ends)}")
    check_launches(label + " A", a_launch, {
        k: n * rounds for k, n in want_launches.items()})
    check_launches(label + " B", b_launch, {
        k: n * (rounds - epoch_rounds) for k, n in want_launches.items()})
    b_rows = b1_log.ids + b2_log.ids
    if not (all(np.array_equal(x, y) for x, y in zip(a_log.ids, b_rows))
            and a_log.bytes == b1_log.bytes + b2_log.bytes):
        raise AssertionError(f"{label}: B's client ids or bytes differ "
                             "from A's")
    fa = final_checkpoint(os.path.join(tmp, "A"), name)
    fb = final_checkpoint(os.path.join(tmp, "B"), name)
    diff = checkpoint_diff(fa, fb)
    if os.path.basename(fa) != os.path.basename(fb) or diff:
        phase(label, f"NOT bitwise: {os.path.basename(fa)} vs "
              f"{os.path.basename(fb)} differ in {diff}; running A again")
        resume_runs(label, sc, ac, build, tmp,
                    plan=(("A2", "A2", None, False),))
        spread = checkpoint_diff(fa, final_checkpoint(
            os.path.join(tmp, "A2"), name))
        if not spread or any(v > 2 * spread.get(k, 0.0)
                             for k, v in diff.items()):
            raise AssertionError(f"{label}: B differs from A by {diff}, "
                                 f"A from itself by {spread}")
        phase(label, f"B within 2x A's own spread {spread}")
    else:
        phase(label, f"final checkpoints {os.path.basename(fa)} bitwise "
              "equal (every key but thr_*); client ids and bytes of all "
              f"{rounds} rounds equal")
    ckpts = check_journal(label + " A", os.path.join(tmp, "A.jsonl"),
                          rounds, epoch_rounds, [a_log])
    ckpts += check_journal(label + " B", os.path.join(tmp, "B.jsonl"),
                           rounds, epoch_rounds, [b1_log, b2_log])
    med = statistics.median
    phase(label, f"journals valid; A median {med(a_log.round_ms()[1:]):.2f}"
          f" ms/round (journal, tracer and a checkpoint an epoch) beside "
          f"{ref_label}'s {med(ref_ms[1:]):.2f} (journal off)")
    phase(label, "checkpoints (write seconds, bytes): " + ", ".join(
        f"{os.path.basename(c['path'])} {c['seconds']:.3f} s "
        f"{c['bytes']}" for c in ckpts))
    phase(label, f"run B's resumed half launched {b_launch}")
    from commefficient_tpu_torch.telemetry.journal import read_journal
    from commefficient_tpu_torch.telemetry.trace import stage_stats
    spans = [sp for r in read_journal(os.path.join(tmp, "A.jsonl"))[0]
             if r["event"] == "trace" for sp in r["spans"]]
    phase(label, "A's stage spans, p50 ms (n): " + ", ".join(
        f"{k} {1e3 * v['p50_s']:.3f} ({v['n']})"
        for k, v in stage_stats(spans).items()))



# ---------------- item 9a and item 7: phases 22-26 ------------------------

FAULTS = ["--client_dropout", "0.25", "--straggler_rate", "0.25",
          "--straggler_cutoff", "0.2"]
BYZANTINE = ["--update_screen", "norm", "--byzantine_rate", "0.25",
             "--attack", "colluding"]
BYZANTINE_ROUNDS = 5        # coord_median; 3 each for the other two
ROLLBACK_EPOCHS = 3         # of 5 or 6 rounds (RESUME_CIFAR's corpus)
ROLLBACK_POISONED = 12      # a round of the third epoch
FINETUNE_ROUNDS = 2


def expected_survivors(seed: int, round_idx: int, W: int,
                       faults) -> np.ndarray:
    """The survivor mask utils/faults draws for config #2 with FAULTS:
    the dropout draw, times the straggler draw's fractions at or above
    the cutoff (a fraction under it degrades to a drop)."""
    surv = faults.bernoulli_survivors(seed, round_idx, W, 0.25)
    work = faults.straggler_work_fractions(seed, round_idx, W, 0.25, 0.1)
    return surv * (work >= 0.2)


def faults_phase(sc, ac, cv_train, parse_args, data_dir, fclient, faults,
                 main_ms) -> None:
    """Phase 22: config #2 with dropout and stragglers on the fused
    backward (the dropout_stragglers variant). Every round's uploads are
    the wire bytes at the slots utils/faults keeps and 0 at the others;
    a dropped slot adds no gradient: the survivor-weighted fused
    gradient of a batch equals the fused gradient of its survivors
    alone (PARITY_RTOL)."""
    model, rr, loader = config2_variant("faults", sc, ac, cv_train,
                                        parse_args, data_dir, FAULTS)
    assert model.cfg.fused_client_backward
    check_launches("faults", rr.launches, {"sketch_encode": ROUNDS,
                                           "sketch_estimate_all": ROUNDS})
    wire = float(model.cfg.upload_bytes)
    dropped = 0
    for r, up in enumerate(rr.uploads):
        want = expected_survivors(model.cfg.seed, r, 8, faults)
        dropped += int((want == 0).sum())
        if not np.array_equal(np.asarray(up), wire * want):
            raise AssertionError(f"faults: round {r} uploads {up}, the "
                                 f"draw keeps {want}")
    med = statistics.median
    phase("faults", f"{ROUNDS} rounds: {dropped} of {8 * ROUNDS} slots "
          "dropped or under the cutoff, each billed 0 bytes, the others "
          f"{wire:.0f}, as utils/faults draws them for seed "
          f"{model.cfg.seed}; median {med(rr.round_ms[1:]):.2f} ms/round "
          f"beside config #2's {med(main_ms[1:]):.2f}; launches "
          f"{rr.launches}")
    ids, data, mask = next(iter(loader.epoch()))
    dev = torch.device("cuda")
    data = tuple(torch.as_tensor(np.asarray(x)).to(dev) for x in data)
    mask = torch.as_tensor(mask).to(dev)
    surv = torch.ones(8, device=dev)
    surv[[2, 5]] = 0.0
    keep = surv > 0
    flat_loss = fclient.make_flat_loss_fn(
        cv_train.make_compute_loss(model.module), model.unravel)
    cfg = model.cfg
    g_s = fclient.fused_shard_grads(flat_loss, model.ps_weights, data,
                                    mask, cfg, survivors=surv)[0]
    g_k = fclient.fused_shard_grads(flat_loss, model.ps_weights,
                                    tuple(x[keep] for x in data),
                                    mask[keep], cfg)[0]
    err = _rel(g_s, g_k)
    phase("faults", f"fused gradient with slots 2 and 5 dropped vs the 6 "
          f"survivors alone: rel err {err:.3e} (tolerance {PARITY_RTOL:g})")
    if not err <= PARITY_RTOL:
        raise AssertionError("faults: a dropped slot moved the gradient")
    del model, loader
    torch.cuda.empty_cache()


def byzantine_phase(sc, ac, cv_train, parse_args, data_dir, fclient,
                    fserver, main_ms):
    """Phase 23: config #2 under the colluding attack, the norm screen
    and the robust aggregators. Each client's transmit is encoded on its
    own (K1 8 times a round) and the order statistics run over the
    [8, 5, 500000] tables; one K1 launch on a client's transmit equals
    its plain version bitwise. Returns coord_median's launches."""
    med = statistics.median
    launches = None
    for agg, rounds in (("coord_median", BYZANTINE_ROUNDS),
                        ("trimmed_mean", 3), ("norm_clip", 3)):
        label = f"byzantine_{agg}"
        model, rr, loader = config2_variant(
            label, sc, ac, cv_train, parse_args, data_dir,
            BYZANTINE + ["--aggregator", agg], rounds=rounds)
        assert model.cfg.robust_aggregation
        check_launches(label, rr.launches, {
            "sketch_encode": 8 * rounds, "sketch_estimate_all": rounds})
        phase(label, f"{rounds} rounds: median {med(rr.round_ms[1:]):.2f} "
              f"ms/round beside config #2's {med(main_ms[1:]):.2f}; peak "
              f"{rr.peak / 2 ** 30:.3f} GiB; mean client loss first/last "
              f"{float(rr.losses[0].mean()):.4f}/"
              f"{float(rr.losses[-1].mean()):.4f}; launches {rr.launches}")
        if launches is None:
            launches = rr.launches
            # one client's transmit through K1 against the plain version
            ids, data, mask = next(iter(loader.epoch()))
            cfg = model.cfg
            flat_grad = fclient.make_flat_grad_fn(
                cv_train.make_compute_loss(model.module), model.unravel)
            res = fclient.local_step(
                flat_grad, model.ps_weights,
                tuple(torch.as_tensor(np.asarray(x[0])).cuda()
                      for x in data),
                torch.as_tensor(mask[0]).cuda(), None, None, cfg)
            sk = fserver.args2sketch(cfg)
            off, eps, delta = sk.tables(res.transmit.device)
            t_k = sk.encode(res.transmit)
            t_p = sc.encode_plain(res.transmit, off, delta, eps, sk.c)
            torch.cuda.synchronize()
            if not torch.equal(t_k, t_p):
                raise AssertionError(
                    "byzantine: K1 on a client's transmit differs from its "
                    "plain version, max abs err "
                    f"{float((t_k - t_p).abs().max())}")
            phase(label, f"K1 on client 0's [{res.transmit.numel()}] "
                  "transmit equal to its plain version (exact)")
        del model, loader
        torch.cuda.empty_cache()
    return launches


def tear(path: str) -> None:
    """Cut a checkpoint file to half its bytes."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


def rollback_phase(sc, ac, cv_train, parse_args, faults, tmp) -> None:
    """Phase 24: config #2 with NaN poison and the screen off, a
    checkpoint an epoch: slot 1 of round ROLLBACK_POISONED is poisoned
    (a FaultSchedule) and, as it runs, the newest checkpoint is torn.
    The numeric watch trips one round later, the rollback falls back
    past the torn file to the older finite one, replays with screening
    forced (--rollback_screen_rounds 64 covers the rest of the run) and
    finishes finite. The journal, read without the JAX package, holds
    one numeric_trip, one checkpoint_fallback, and after the trip the
    poisoned round screened (its schedule record screen_on 1,
    n_poisoned 1). A survivor target of every slot (--target_survivors
    8) makes the scheduler plan each round without changing it: only a
    planned round journals its schedule record (the JAX rule)."""
    from commefficient_tpu_torch.telemetry.journal import read_journal
    from commefficient_tpu_torch.utils.checkpoint import (
        latest_checkpoint_path,
    )
    ck, journal = os.path.join(tmp, "ck"), os.path.join(tmp, "j.jsonl")
    cfg = parse_args(argv=CONFIG2 + [
        "--local_batch_size", "32", "--num_clients",
        str(RESUME_CIFAR_CLIENTS), "--device", "cuda", "--dataset_dir",
        os.path.join(HERE, "build", "chip_smoke_resume_data"),
        "--num_epochs", str(ROLLBACK_EPOCHS), "--pivot_epoch", "1",
        "--seed", "21", "--checkpoint_every", "1", "--checkpoint_path", ck,
        "--journal_path", journal, "--poison_kind", "nan",
        "--rollback_screen_rounds", "64", "--target_survivors", "8"])
    model, opt, sched, loader, val = cv_train.build(
        cfg, device="cuda", synthetic_examples=RESUME_CIFAR)
    model.set_fault_schedule(faults.FaultSchedule(
        poison={ROLLBACK_POISONED: [1]}))
    torn = []

    def on_round(i, out):
        torch.cuda.synchronize()
        if i == ROLLBACK_POISONED and not torn:
            torn.append(latest_checkpoint_path(os.path.join(ck, "ResNet9")))
            tear(torn[0])

    reset_counts(sc, ac)
    t0 = time.perf_counter()
    ok = cv_train.run(model, opt, sched, loader, val, model.cfg, ck,
                      on_round=on_round)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = math.ceil(ROLLBACK_EPOCHS * loader.steps_per_epoch)
    if not (ok and torch.isfinite(model.ps_weights).all()
            and model.server.round_idx == total):
        raise AssertionError(f"rollback: ok {ok}, round "
                             f"{model.server.round_idx} of {total}")
    records, problems = read_journal(journal)
    kinds = [r["event"] for r in records]
    trips = [i for i, k in enumerate(kinds) if k == "numeric_trip"]
    fail = list(problems)
    if len(trips) != 1 or records[trips[0]]["round"] != ROLLBACK_POISONED:
        fail.append(f"numeric_trip records {[records[i] for i in trips]}")
    after = records[trips[0] + 1:] if trips else []
    fallbacks = [r for r in after if r["event"] == "checkpoint_fallback"]
    screened = [r for r in after if r["event"] == "screened"]
    replay = [r for r in after if r["event"] == "schedule"
              and r["round"] == ROLLBACK_POISONED]
    if [r["path"] for r in fallbacks] != torn:
        fail.append(f"checkpoint_fallback {fallbacks}, torn {torn}")
    if [(r["round"], r["n_screened"]) for r in screened] != [
            (ROLLBACK_POISONED, 1)]:
        fail.append(f"screened {screened}")
    if not (replay and replay[0]["screen_on"] == 1.0
            and replay[0]["n_poisoned"] == 1):
        fail.append(f"replayed schedule {replay}")
    if records[-1]["event"] != "run_end" or records[-1]["ok"] is not True:
        fail.append(f"last record {records[-1]}")
    if fail:
        raise AssertionError("rollback journal: " + "; ".join(
            str(f) for f in fail[:5]))
    first = next(r["round"] for r in after if r["event"] == "round")
    phase("rollback", f"tripped at round {ROLLBACK_POISONED}, fell back past "
          f"{os.path.basename(torn[0])} (torn), replayed from round "
          f"{first} with screening forced; {total} rounds done, weights "
          f"finite; journal: 1 numeric_trip, 1 checkpoint_fallback, round "
          f"{ROLLBACK_POISONED} screened on the replay; {wall:.2f} s "
          f"wall, launches {read_counts(sc, ac)}")
    del model, loader
    torch.cuda.empty_cache()


def gpt2_finetune_phase(sc, ac, gpt2_train, gpt2_model, convert, flat,
                        parse_args, HashTokenizer, data_dir, g_ms, g_peak,
                        tmp) -> None:
    """Phase 25: config #5's GPT2-small from a seed, written by
    save_pretrained; --finetune (gpt2_train.build, as main() calls it)
    loads it bitwise and evaluates it (test_gpt2, the JAX driver's
    --finetune contract). Then FINETUNE_ROUNDS rounds of
    gpt2_train.train_gpt2 from the artifact (--model_checkpoint), plain
    and with --remat, under torch.use_deterministic_algorithms: the
    remat run's update bitwise the plain one's (or, if a second plain
    run differs from the first, within 2x that spread), K4 twice a block
    under remat, the peak memory of each beside phase 7's."""
    tok = HashTokenizer(GPT2_VOCAB)
    spe = math.ceil(math.prod(GPT2_CORPUS) / (8 * 8))
    base = CONFIG5 + ["--local_batch_size", "8", "--device", "cuda",
                      "--dataset_dir", data_dir, "--seed", "21",
                      "--num_epochs", str(FINETUNE_ROUNDS / spe)]
    module = gpt2_train.build_model_and_params(
        parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=base), tok,
        GPT2_L)
    saved, _ = flat.flatten_params(module)
    saved = saved.detach().clone()
    art = os.path.join(tmp, "artifact")
    t0 = time.perf_counter()
    gpt2_model.save_pretrained(art, convert.to_jax_params(module), module.cfg)
    save_s = time.perf_counter() - t0
    del module
    cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=base + [
        "--finetune", "--finetune_path", art])
    t0 = time.perf_counter()
    model, _, _, _, val = gpt2_train.build(cfg, tok, device="cuda",
                                           synthetic_examples=GPT2_CORPUS)
    load_s = time.perf_counter() - t0
    if not torch.equal(model.ps_weights.cpu(), saved):
        raise AssertionError("finetune: the loaded weights differ from the "
                             "saved ones")
    reset_counts(sc, ac)
    stats = gpt2_train.test_gpt2(model, val, logger=_Quiet())
    torch.cuda.synchronize()
    if not math.isfinite(stats["val_nll"]) or not ac.LAUNCHES["flash_fwd"]:
        raise AssertionError(f"finetune eval: {stats}, {ac.LAUNCHES}")
    phase("finetune", f"save_pretrained of D={saved.numel()} in "
          f"{save_s:.2f} s ({sum(os.path.getsize(os.path.join(art, f)) for f in os.listdir(art))} "
          f"bytes); --finetune built and loaded it bitwise in {load_s:.2f} "
          f"s; test_gpt2 val NLL {stats['val_nll']:.4f}")
    del model, val
    torch.cuda.empty_cache()

    def rounds(label, extra):
        cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=base + [
            "--model_checkpoint", art] + extra)
        model, opt, sched, loader, _ = gpt2_train.build(
            cfg, tok, device="cuda", synthetic_examples=GPT2_CORPUS)
        if not torch.equal(model.ps_weights.cpu(), saved):
            raise AssertionError(f"{label}: not the artifact's weights")
        assert model.module.cfg.remat == ("--remat" in extra)
        w0 = model.ps_weights.clone()
        rr = drive_rounds(label, sc, ac, model, loader, FINETUNE_ROUNDS,
                          lambda timed, on_round: gpt2_train.train_gpt2(
                              model, opt, sched, timed, model.cfg,
                              logger=_Quiet(), on_round=on_round))
        blocks = 2 if "--remat" in extra else 1
        check_launches(label, rr.launches, {
            "flash_fwd": blocks * 12 * 8 * FINETUNE_ROUNDS,
            "sketch_encode": 2 * FINETUNE_ROUNDS,
            "threshold_mask": FINETUNE_ROUNDS})
        update = (model.ps_weights - w0).cpu()
        del model, opt, loader
        torch.cuda.empty_cache()
        return update, rr

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain, p_rr = rounds("finetune_plain", [])
        remat, r_rr = rounds("finetune_remat", ["--remat"])
        if torch.equal(plain, remat):
            verdict = "bitwise equal"
        else:
            again, _ = rounds("finetune_plain2", [])
            spread = float((plain - again).abs().max())
            dist = float((plain - remat).abs().max())
            verdict = (f"NOT bitwise: max |plain - remat| {dist:.3e}, two "
                       f"plain runs {spread:.3e} apart")
            if not dist <= 2 * spread:
                raise AssertionError(f"finetune: {verdict}")
    finally:
        torch.use_deterministic_algorithms(False)
    med = statistics.median
    phase("finetune", f"{FINETUNE_ROUNDS} rounds from the artifact: remat "
          f"update vs plain {verdict}; K4 launched "
          f"{r_rr.launches['flash_fwd']} times under remat, "
          f"{p_rr.launches['flash_fwd']} plain; peak "
          f"{r_rr.peak / 2 ** 30:.3f} GiB remat, {p_rr.peak / 2 ** 30:.3f} "
          f"plain, phase 7's {g_peak / 2 ** 30:.3f}; ms/round "
          f"{med(r_rr.round_ms):.2f} remat, {med(p_rr.round_ms):.2f} plain "
          f"(phase 7's median {med(g_ms[1:]):.2f})")


def cvfinetune_phase(sc, ac, cv_train, parse_args, flat, models, tmp
                     ) -> None:
    """Phase 26: config #2's ResNet9 trained on CIFAR10 for 3 rounds with
    --checkpoint, then --finetune --finetuned_from CIFAR10 on the
    synthetic CIFAR100 (3 rounds): the body comes over leaf for leaf and
    never moves, the 100-class head trains, K1 and K2 once a round."""
    n_train = CLIENTS * EXAMPLES_PER_CLIENT
    spe = math.ceil(n_train / (8 * 32))
    ck = os.path.join(tmp, "ck")
    common = ["--local_batch_size", "32", "--num_clients", str(CLIENTS),
              "--device", "cuda", "--num_epochs", str(3 / spe),
              "--pivot_epoch", str(1.5 / spe), "--seed", "21",
              "--no_telemetry"]
    cfg = parse_args(argv=CONFIG2 + common + [
        "--dataset_dir", os.path.join(HERE, "build", "chip_smoke_data"),
        "--checkpoint", "--checkpoint_path", ck])
    model, opt, sched, loader, val = cv_train.build(
        cfg, device="cuda", synthetic_examples=(n_train, 512))
    if not cv_train.run(model, opt, sched, loader, val, model.cfg, tmp):
        raise AssertionError("cvfinetune: the CIFAR10 run failed")
    old = model.ps_weights.cpu()
    old_layout = flat.module_layout(model.module)
    del model, loader
    cfg = parse_args(argv=CONFIG2 + common + [
        "--dataset_name", "CIFAR100", "--dataset_dir",
        os.path.join(HERE, "build", "chip_smoke_cifar100_data"),
        "--finetune", "--finetune_path", ck, "--finetuned_from", "CIFAR10"])
    model, opt, sched, loader, val = cv_train.build(
        cfg, device="cuda", synthetic_examples=(n_train, 512))
    frozen = (model.lr_scale_vec == 0).cpu()
    w0 = model.ps_weights.cpu()
    old_at = dict(zip([e.path for e in old_layout],
                      torch.split(old, [e.size for e in old_layout])))
    off = moved_over = 0
    for e in flat.module_layout(model.module):
        seg = slice(off, off + e.size)
        off += e.size
        if bool(frozen[seg].all()):
            moved_over += e.size
            if not torch.equal(w0[seg], old_at[e.path]):
                raise AssertionError(f"cvfinetune: {e.path} not transferred")
    rr = drive_rounds("cvfinetune", sc, ac, model, loader, 3,
                      lambda timed, on_round: cv_train.train(
                          model, opt, sched, timed, val, model.cfg,
                          on_round=on_round))
    check_launches("cvfinetune", rr.launches, {"sketch_encode": 3,
                                               "sketch_estimate_all": 3})
    w = model.ps_weights.cpu()
    if not torch.equal(w[frozen], w0[frozen]) or \
            torch.equal(w[~frozen], w0[~frozen]):
        raise AssertionError("cvfinetune: frozen coordinates moved, or the "
                             "head did not train")
    phase("cvfinetune", f"D={w.numel()}: {moved_over} coordinates "
          f"transferred (frozen_count {model.frozen_count}) and bitwise "
          f"unmoved after 3 rounds; the head's {int((~frozen).sum())} "
          f"moved; launches {rr.launches}")
    del model, loader
    torch.cuda.empty_cache()


def live_gib() -> float:
    """Device memory still allocated by earlier phases, after a garbage
    collection (the peaks of phases 27-31 are read in the full script,
    with this much carried in)."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2 ** 30


def powersgd_phase(sc, ac, cv_train, parse_args, data_dir, fclient, prng,
                   main_ms) -> None:
    """Phase 27: config #2 with --mode powersgd --error_type local
    --powersgd_rank 2, ROUNDS rounds: no sketch or attention kernel;
    every client's upload exactly POWERSGD_UPLOAD bytes; the Q factor in
    each sampled client's velocity row ([:n * 2], the rest zero) and the
    rows of clients never sampled still zero; then one client's residual
    seam (approximation, error residual, Q) from its warm rows on the
    card against the CPU at POWERSGD_RTOL, each against float64, and a
    TF32 control on the card that the limit must refuse."""
    live = live_gib()
    model, rr, loader = config2_variant("powersgd", sc, ac, cv_train,
                                        parse_args, data_dir, POWERSGD)
    cfg = model.cfg
    check_launches("powersgd", rr.launches,
                   {n: 0 for n in SKETCH_AND_ATTENTION})
    for r, up in enumerate(rr.uploads):
        if not np.all(np.asarray(up) == POWERSGD_UPLOAD):
            raise AssertionError(f"powersgd: round {r} uploads {up}, "
                                 f"{POWERSGD_UPLOAD} a client expected")
    from commefficient_tpu_torch.compress.powersgd import factor_shape
    m, n = factor_shape(MAIN_D)
    assert (m, n) == POWERSGD_MN, (m, n)
    vel = model.clients.velocities
    touched = torch.tensor(sorted(model._touched), device=vel.device)
    fresh = torch.ones(vel.shape[0], dtype=torch.bool, device=vel.device)
    fresh[touched] = False
    q = vel[touched, :2 * n]
    if not (bool((q.abs().sum(dim=1) > 0).all())
            and not bool(vel[:, 2 * n:].any())
            and not bool(vel[fresh].any())):
        raise AssertionError("powersgd: the Q rows are not warm where "
                             "sampled and zero elsewhere")
    med = statistics.median
    phase("powersgd", f"{ROUNDS} rounds, [{m}, {n}] rank 2: every upload "
          f"{POWERSGD_UPLOAD} bytes; Q warm in all {len(touched)} sampled "
          f"clients' rows, the {int(fresh.sum())} others zero; median "
          f"{med(rr.round_ms[1:]):.2f} ms/round beside config #2's "
          f"{med(main_ms[1:]):.2f}; peak {rr.peak / 2 ** 30:.3f} GiB (read "
          f"in the full script, {live:.3f} GiB live before the phase); "
          f"mean client loss first/last {float(rr.losses[0].mean()):.4f}/"
          f"{float(rr.losses[-1].mean()):.4f}")
    # the seam on one client's real accumulator: its error row plus its
    # count-scaled gradient on a batch, from its warm Q row
    ids, data, mask = next(iter(loader.epoch()))
    c = int(ids[0])
    flat_grad = fclient.make_flat_grad_fn(
        cv_train.make_compute_loss(model.module), model.unravel)
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(cfg.seed),
                                    model.server.round_idx), 0)
    g, _, _, count = fclient.forward_grad(
        flat_grad, model.ps_weights,
        tuple(torch.as_tensor(np.asarray(x[0])).cuda() for x in data),
        torch.as_tensor(mask[0]).cuda(), cfg, key)
    acc = model.clients.errors[c] + g * count
    v = model.clients.velocities[c]
    comp = cfg.compressor

    def seam(dev, dtype=torch.float32):
        return [t.to(torch.float64).cpu() for t in comp.residual(
            cfg, acc.to(dev, dtype), None, v.to(dev, dtype), key)]

    card, cpu, f64 = seam("cuda"), seam("cpu"), seam("cpu", torch.float64)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = seam("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    names = ("approximation", "residual", "Q")
    errs = [_rel(a, b) for a, b in zip(card, cpu)]
    acc_card = [_rel(a, b) for a, b in zip(card, f64)]
    acc_cpu = [_rel(a, b) for a, b in zip(cpu, f64)]
    err_tf32 = max(_rel(a, b) for a, b in zip(tf32, cpu))
    phase("powersgd", f"client {c}'s residual seam card vs CPU: "
          + ", ".join(f"{nm} {e:.3e}" for nm, e in zip(names, errs))
          + " (vs float64: card " + ", ".join(f"{e:.3e}" for e in acc_card)
          + "; CPU " + ", ".join(f"{e:.3e}" for e in acc_cpu)
          + f"); tolerance {POWERSGD_RTOL:g}; TF32 control {err_tf32:.3e}")
    if not max(errs) <= POWERSGD_RTOL:
        raise AssertionError("powersgd: the card's seam differs from the "
                             "CPU's")
    if not err_tf32 > POWERSGD_RTOL:
        raise AssertionError("powersgd: the TF32 control passed the limit, "
                             "which therefore cannot tell TF32 from f32")
    del model, loader
    torch.cuda.empty_cache()


def dp_sketch_phase(sc, ac, cv_train, parse_args, data_dir, fclient,
                    fserver, compress, main_ms, tmp):
    """Phase 28: config #2 with --mode dp_sketch --dp_clip 1.0
    --dp_noise_mult 0.5, ROUNDS rounds with a journal: K1 8 times a
    round (each client's table on its own), K2 once; every upload the
    f32 table; one `privacy` event a round with epsilon
    RdpAccountant(0.5, 1e-5).epsilon(n + 1); each client's clipped
    table at Frobenius norm <= dp_clip; one K1 launch on a client's
    gradient bitwise its plain version. Returns the rounds' launches."""
    from commefficient_tpu_torch.telemetry import (
        RunJournal, TelemetrySession,
    )
    from commefficient_tpu_torch.telemetry.journal import read_journal
    live = live_gib()
    jpath = os.path.join(tmp, "dp_sketch.jsonl")
    model, rr, loader = config2_variant(
        "dp_sketch", sc, ac, cv_train, parse_args, data_dir, DP_SKETCH,
        setup=lambda m: m.attach_telemetry(
            TelemetrySession(journal=RunJournal(jpath))))
    model.telemetry.close(ok=True)
    cfg = model.cfg
    assert not cfg.defer_sketch_encode and not cfg.fused_client_backward
    check_launches("dp_sketch", rr.launches, {
        "sketch_encode": 8 * ROUNDS, "sketch_estimate_all": ROUNDS,
        "threshold_sample": 0, "threshold_mask": 0, "flash_fwd": 0})
    wire = 4 * MAIN_R * MAIN_C
    if not all(np.all(np.asarray(up) == wire) for up in rr.uploads):
        raise AssertionError(f"dp_sketch: uploads {rr.uploads}")
    acc = compress.RdpAccountant(DP_SKETCH_SIGMA, DP_SKETCH_DELTA)
    records, problems = read_journal(jpath)
    priv = [r for r in records if r["event"] == "privacy"]
    if problems or [r["round"] for r in priv] != list(range(ROUNDS)) or any(
            r["epsilon"] != round(acc.epsilon(r["round"] + 1), 6)
            for r in priv):
        raise AssertionError(f"dp_sketch: privacy events {priv}, problems "
                             f"{problems}")
    # each client's table through its own local_step, clipped
    ids, data, mask = next(iter(loader.epoch()))
    flat_grad = fclient.make_flat_grad_fn(
        cv_train.make_compute_loss(model.module), model.unravel)
    dummy = model.ps_weights.new_zeros(())
    norms = []
    for c in range(len(ids)):
        res = fclient.local_step(
            flat_grad, model.ps_weights,
            tuple(torch.as_tensor(np.asarray(x[c])).cuda() for x in data),
            torch.as_tensor(mask[c]).cuda(), dummy, dummy, cfg)
        norms.append(float(torch.linalg.vector_norm(res.transmit.double())))
    if not max(norms) <= cfg.dp_clip * (1 + 1e-6):
        raise AssertionError(f"dp_sketch: table norms {norms}")
    # one K1 launch on client 0's gradient against the plain version
    _, _, grad = flat_grad(model.ps_weights,
                           tuple(torch.as_tensor(np.asarray(x[0])).cuda()
                                 for x in data),
                           torch.as_tensor(mask[0]).cuda())
    sk = fserver.args2sketch(cfg)
    off, eps, delta = sk.tables(grad.device)
    t_k = sk.encode(grad)
    t_p = sc.encode_plain(grad, off, delta, eps, sk.c)
    torch.cuda.synchronize()
    if not torch.equal(t_k, t_p):
        raise AssertionError("dp_sketch: K1 differs from its plain version, "
                             f"max abs err {float((t_k - t_p).abs().max())}")
    med = statistics.median
    phase("dp_sketch", f"{ROUNDS} rounds, clip {cfg.dp_clip:g}, noise "
          f"std {cfg.dp_noise_mult * cfg.dp_clip:g}: median "
          f"{med(rr.round_ms[1:]):.2f} ms/round beside config #2's "
          f"{med(main_ms[1:]):.2f}; launches {rr.launches}; every upload "
          f"{wire} bytes; {len(priv)} privacy events, epsilon "
          f"{priv[0]['epsilon']} .. {priv[-1]['epsilon']} as "
          "RdpAccountant(0.5, 1e-5).epsilon(n + 1); client table norms "
          f"max {max(norms):.7f} (clip {cfg.dp_clip:g}); K1 on client 0's "
          f"[{grad.numel()}] gradient equal to its plain version (exact); "
          f"peak {rr.peak / 2 ** 30:.3f} GiB (read in the full script, "
          f"{live:.3f} GiB live before the phase)")
    del model, loader
    torch.cuda.empty_cache()
    return rr.launches


def privacy_drill_phase(cv_train, parse_args, data_dir, compress, tmp
                        ) -> None:
    """Phase 29: phase 28's run with --dp_target_epsilon between
    epsilon(N - 1) and epsilon(N), N = PRIVACY_N: it raises naming the
    flag after round N - 1's event; the journal holds exactly N privacy
    events and the crossing round committed."""
    from commefficient_tpu_torch.telemetry import (
        RunJournal, TelemetrySession,
    )
    from commefficient_tpu_torch.telemetry.journal import read_journal
    acc = compress.RdpAccountant(DP_SKETCH_SIGMA, DP_SKETCH_DELTA)
    target = 0.5 * (acc.epsilon(PRIVACY_N - 1) + acc.epsilon(PRIVACY_N))
    model, opt, sched, loader, val = config2_build(
        cv_train, parse_args, data_dir,
        DP_SKETCH + ["--dp_target_epsilon", repr(target)])
    jpath = os.path.join(tmp, "privacy_drill.jsonl")
    tele = TelemetrySession(journal=RunJournal(jpath))
    model.attach_telemetry(tele)
    try:
        cv_train.train(model, opt, sched, loader, val, model.cfg)
    except RuntimeError as e:
        err = e
    else:
        raise AssertionError("privacy drill: no raise past the budget")
    finally:
        tele.close(ok=False)
    records, _ = read_journal(jpath)
    priv = [r["epsilon"] for r in records if r["event"] == "privacy"]
    if ("dp_target_epsilon" not in str(err) or len(priv) != PRIVACY_N
            or not priv[-1] > target >= priv[-2]
            or model.server.round_idx != PRIVACY_N):
        raise AssertionError(f"privacy drill: {err}; events {priv}, target "
                             f"{target}, rounds {model.server.round_idx}")
    phase("privacy", f"--dp_target_epsilon {target:.6f} (between "
          f"epsilon({PRIVACY_N - 1}) {acc.epsilon(PRIVACY_N - 1):.6f} and "
          f"epsilon({PRIVACY_N}) {acc.epsilon(PRIVACY_N):.6f}): raised "
          f"after round {PRIVACY_N - 1}'s event with {len(priv)} privacy "
          f"events in the journal: {err}")
    del model, loader
    torch.cuda.empty_cache()


class _Rows:
    """A logger that keeps the driver's epoch rows."""

    def __init__(self):
        self.rows = []

    def append(self, row):
        self.rows.append(row)


class TimedRun(NamedTuple):
    ms: float               # wall ms a round, first round to last emit
    busy: float             # device kernel time over that wall, or nan
    host_batch: float       # the host's batch making over that wall
    launches: dict
    rows: list              # the driver's epoch rows (bytes in MiB)


def timed_train(sc, ac, cv_train, model, opt, sched, loader, val, rounds,
                traced=False) -> TimedRun:
    """`rounds` more rounds of `model` through cv_train.train(), timed
    from the call to the last round's emit (the card synchronized
    there, nowhere else), the host's batch making recorded
    (TimedLoader). With `traced`, torch.profiler records the card's
    kernels over the same window: busy share = their device time over
    the wall."""
    from torch.profiler import ProfilerActivity, profile
    spe = loader.steps_per_epoch
    budget = model.cfg.replace(
        num_epochs=(model.server.round_idx + rounds) / spe)
    timed = TimedLoader(loader)
    rows = _Rows()
    prof = (profile(activities=[ProfilerActivity.CUDA]) if traced
            else None)
    end = []

    def on_round(i, out):
        end.append(i)
        if len(end) == rounds:
            torch.cuda.synchronize()
            end.append(time.perf_counter())
            if prof is not None:
                prof.stop()

    if prof is not None:
        prof.start()
    reset_counts(sc, ac)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = cv_train.train(model, opt, sched, timed, val, budget,
                        loggers=(rows,), on_round=on_round)
    launches = read_counts(sc, ac)
    if not ok or len(end) != rounds + 1:
        raise AssertionError(f"{len(end) - 1} of {rounds} rounds ran "
                             f"(ok={ok})")
    wall = end[-1] - t0
    busy = float("nan")
    if prof is not None:
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.key.startswith("ProfilerStep"))
        busy = dev_us / 1e6 / wall
    return TimedRun(1e3 * wall / rounds, busy,
                    sum(timed.seconds[:rounds]) / wall, launches, rows.rows)


def spans_phase(sc, ac, cv_train, parse_args, data_dir, main_ms, tmp
                ) -> None:
    """Phase 30: config #2 for ROUNDS rounds each way of SPANS (the
    plain loop, spans of 4, spans of 4 pipelined with a checkpoint every
    span, and without it), each under deterministic algorithms: the
    final weights, server state, accountant and the run's
    download/upload bytes bitwise equal across them (else within 2x a
    second plain run's spread). For each: ms/round over all ROUNDS
    rounds, the first included (untraced), and the busy share from a
    second, traced run of the same rounds; K1 and K2 once a round. Then
    --profile_spans 1:2 on a pipelined run of 3 spans writes its Chrome
    trace."""
    from commefficient_tpu_torch.telemetry import (
        RunJournal, TelemetrySession,
    )
    live = live_gib()
    finals = {}
    med = statistics.median
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    def run(label, extra, traced=False):
        ck = os.path.join(tmp, f"spans_{label}{'_traced' * traced}")
        model, opt, sched, loader, val = config2_build(
            cv_train, parse_args, data_dir,
            extra + ["--checkpoint_path", ck])
        torch.cuda.reset_peak_memory_stats()
        res = timed_train(sc, ac, cv_train, model, opt, sched, loader, val,
                          ROUNDS, traced=traced)
        model.close_persistence()
        state = [t.detach().cpu().clone() for t in model.server[:3]]
        acct = model.accountant.state_dict()
        nbytes = (res.rows[-1]["down (MiB)"], res.rows[-1]["up (MiB)"])
        peak = torch.cuda.max_memory_allocated()
        del model, opt, loader, val
        torch.cuda.empty_cache()
        return state, acct, nbytes, res, peak

    try:
        for label, extra in SPANS:
            state, acct, nbytes, res, peak = run(label, extra)
            traced = run(label, extra, traced=True)[3]
            check_launches(f"spans_{label}", res.launches, {
                "sketch_encode": ROUNDS, "sketch_estimate_all": ROUNDS})
            finals[label] = (state, acct, nbytes)
            phase("spans", f"{label} ({' '.join(extra) or 'per round'}): "
                  f"{res.ms:.2f} ms/round over {ROUNDS} rounds (phase 4's "
                  f"median {med(main_ms[1:]):.2f}); busy share "
                  f"{traced.busy:.3f} over {ROUNDS} traced rounds "
                  f"({traced.ms:.2f} ms/round traced); host batch "
                  f"{res.host_batch:.3f} of the wall; down/up "
                  f"{nbytes[0]:.6f}/{nbytes[1]:.6f} MiB; peak "
                  f"{peak / 2 ** 30:.3f} GiB (read in the full script, "
                  f"{live:.3f} GiB live before the phase)")
        want = finals["plain"]
        diff = []
        for label in [lb for lb, _ in SPANS[1:]]:
            got = finals[label]
            if not all(torch.equal(a, b) for a, b in zip(got[0], want[0])):
                diff.append(f"{label}: server state")
            if any(not np.array_equal(got[1][k], want[1][k])
                   for k in want[1]):
                diff.append(f"{label}: accountant")
            if got[2] != want[2]:
                diff.append(f"{label}: bytes {got[2]} vs {want[2]}")
        verdict = "bitwise equal"
        if diff:
            again = run("plain2", [])[0]
            spread = max(float((a - b).abs().max())
                         for a, b in zip(again, want[0]))
            dist = max(float((a - b).abs().max()) for label, _ in SPANS[1:]
                       for a, b in zip(finals[label][0], want[0]))
            verdict = (f"NOT bitwise ({'; '.join(diff)}): max |diff| "
                       f"{dist:.3e}, two plain runs {spread:.3e} apart")
            if any("bytes" in d or "accountant" in d for d in diff) or \
                    not dist <= 2 * spread:
                raise AssertionError(f"spans: {verdict}")
        phase("spans", f"final weights, server state, accountant and "
              f"bytes of the {len(SPANS)} runs: {verdict}")
        # --profile_spans 1:2 on a pipelined run of 3 spans of 2
        pdir = os.path.join(tmp, "profile_spans")
        model, opt, sched, loader, val = config2_build(
            cv_train, parse_args, data_dir,
            ["--scan_rounds", "--scan_span", "2", "--pipeline"], rounds=6)
        tele = TelemetrySession(
            journal=RunJournal(os.path.join(tmp, "profile_spans.jsonl")),
            profile_spans="1:2", profile_dir=pdir, profile_cuda=True)
        model.attach_telemetry(tele)
        try:
            ok = cv_train.train(model, opt, sched, loader, val, model.cfg)
        finally:
            tele.close(ok=True)
            model.close_persistence()
        trace = os.path.join(pdir, "spans_1_2.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        if not ok or not kernels:
            raise AssertionError(f"spans: --profile_spans trace {trace} "
                                 f"holds {kernels} kernels (ok={ok})")
        phase("spans", f"--profile_spans 1:2: {trace} written, "
              f"{os.path.getsize(trace)} bytes, {kernels} kernel events")
        del model, opt, loader, val
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det


def imagenet_pipeline_phase(sc, ac, cv_train, parse_args, corpus,
                            imagenet_ms) -> None:
    """Phase 31: config #4 as imagenet.sh runs it (phase 13's flags and
    corpus), IMAGENET_PIPE_ROUNDS rounds each way (IMAGENET_SPANS): ms/round
    untraced, the busy share from a second, traced run of the same
    rounds, and the host batch's share of the wall. No kernel of the
    port launches. No gain is claimed: the measurement."""
    live = live_gib()
    med = statistics.median
    for label, extra in IMAGENET_SPANS:
        cfg = parse_args(argv=CONFIG4 + extra + [
            "--device", "cuda", "--dataset_dir", corpus, "--seed", "21"])
        runs = []
        for traced in (False, True):
            model, opt, sched, loader, val = cv_train.build(cfg,
                                                            device="cuda")
            assert model.cfg.grad_size == FIXUP50_D
            torch.cuda.reset_peak_memory_stats()
            runs.append(timed_train(sc, ac, cv_train, model, opt, sched,
                                    loader, val, IMAGENET_PIPE_ROUNDS,
                                    traced=traced))
            peak = torch.cuda.max_memory_allocated() if not traced else peak
            model.close_persistence()
            del model, opt, loader, val
            torch.cuda.empty_cache()
        res, traced = runs
        check_launches(f"imagenet_{label}", res.launches,
                       {n: 0 for n in SKETCH_AND_ATTENTION})
        phase("imagenet_pipeline", f"{label} "
              f"({' '.join(extra) or 'per round'}): {res.ms:.2f} ms/round "
              f"over {IMAGENET_PIPE_ROUNDS} rounds (phase 13's median "
              f"{med(imagenet_ms[1:]):.2f}); host batch {res.host_batch:.3f} "
              f"of the wall; busy share {traced.busy:.3f} over "
              f"{IMAGENET_PIPE_ROUNDS} traced rounds ({traced.ms:.2f} "
              f"ms/round traced, host batch {traced.host_batch:.3f}); peak "
              f"{peak / 2 ** 30:.3f} GiB (read in the full script, "
              f"{live:.3f} GiB live before the phase)")


# ---------------- items 9d and 9e: phases 32-34 ----------------------------

def scripted_time(round_idx: int) -> float:
    """The scripted clock of phases 32-33, read by the telemetry session
    at the end of each round: a function of the rounds done alone
    (rounds of 0.5, 0.75 and 1.0 s in turn), so a resumed run feeds the
    throughput tracker what the uninterrupted one did."""
    q, m = divmod(int(round_idx), 3)
    return 2.25 * q + (0.0, 0.5, 1.25)[m]


class ScriptedClock:
    """Within the block, the drivers' telemetry sessions
    (persist.attach_run_telemetry) read scripted_time instead of the
    wall clock."""

    def __init__(self, persist):
        self.persist = persist

    def __enter__(self):
        real = self.real = self.persist.attach_run_telemetry

        def attach(model, *args, **kw):
            tele = real(model, *args, **kw)
            if tele is not None:
                tele._clock = lambda: scripted_time(model.server.round_idx)
            return tele

        self.persist.attach_run_telemetry = attach
        return self

    def __exit__(self, *exc):
        self.persist.attach_run_telemetry = self.real
        return False


class Deterministic:
    """cuDNN's deterministic algorithms and torch's (warn_only) within
    the block, the settings restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        return self

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self.saved
        return False


def resume_pair(label, sc, ac, cv_train, parse_args, extra, tmp,
                check=None) -> None:
    """Runs A and B (preempted as epoch 2 opens, resumed) of config #2
    with `extra` on phase 20's corpus, a checkpoint an epoch, the clock
    scripted: the client ids and bytes of every round and the final
    checkpoints bitwise equal, thr_* included (on a miss, A again: B
    within 2x A's own spread). `check(path)` reads B's first
    checkpoint."""
    from commefficient_tpu_torch.training import persist
    c2_data = os.path.join(HERE, "build", "chip_smoke_resume_data")
    c2_spe = math.ceil(RESUME_CIFAR[0] / (8 * 32))
    rounds = RESUME_EPOCHS * c2_spe

    def build(ck, journal, resume):
        cfg = parse_args(argv=CONFIG2 + list(extra) + [
            "--local_batch_size", "32", "--num_clients",
            str(RESUME_CIFAR_CLIENTS), "--device", "cuda",
            "--dataset_dir", c2_data, "--num_epochs", str(RESUME_EPOCHS),
            "--pivot_epoch", "1", "--seed", "21", "--checkpoint_every",
            "1", "--checkpoint_path", ck, "--journal_path", journal]
            + (["--resume"] if resume else []))
        model, opt, sched, loader, val = cv_train.build(
            cfg, device="cuda", synthetic_examples=RESUME_CIFAR)
        return model, loader, lambda tl, on_round: cv_train.run(
            model, opt, sched, tl, val, model.cfg, ck, on_round=on_round)

    with ScriptedClock(persist), Deterministic():
        runs = resume_runs(label, sc, ac, build, tmp)
        (a_ok, a_log, _), (_, b1_log, _), (b_ok, b2_log, _) = (
            runs["A"], runs["B1"], runs["B2"])
        if not (a_ok and b_ok) or len(a_log.ends) != rounds or \
                len(b1_log.ends) + len(b2_log.ends) != rounds:
            raise AssertionError(f"{label}: rounds A {len(a_log.ends)}, B "
                                 f"{len(b1_log.ends)} + {len(b2_log.ends)}")
        b_rows = b1_log.ids + b2_log.ids
        if not (all(np.array_equal(x, y) for x, y in zip(a_log.ids, b_rows))
                and a_log.bytes == b1_log.bytes + b2_log.bytes):
            raise AssertionError(f"{label}: B's client ids or bytes differ "
                                 "from A's")
        if check is not None:
            check(sorted(glob.glob(os.path.join(tmp, "B",
                                                "ResNet9-r*.npz")))[0])
        fa = final_checkpoint(os.path.join(tmp, "A"), "ResNet9")
        fb = final_checkpoint(os.path.join(tmp, "B"), "ResNet9")
        diff = checkpoint_diff(fa, fb, thr=True)
        verdict = "bitwise equal, thr_* included"
        if os.path.basename(fa) != os.path.basename(fb) or diff:
            resume_runs(label, sc, ac, build, tmp,
                        plan=(("A2", "A2", None, False),))
            spread = checkpoint_diff(fa, final_checkpoint(
                os.path.join(tmp, "A2"), "ResNet9"), thr=True)
            verdict = (f"NOT bitwise: differ in {diff}; A from itself by "
                       f"{spread}")
            if not spread or any(v > 2 * spread.get(k, 0.0)
                                 for k, v in diff.items()):
                raise AssertionError(f"{label}: {verdict}")
    phase(label, f"resume: final checkpoints {os.path.basename(fa)} "
          f"{verdict}; client ids and bytes of all {rounds} rounds equal")


def _recorded_plans(model, plans: dict) -> None:
    """Keep every plan the model takes, by round."""
    take = model.scheduler.take_plan

    def recorded(r):
        plans[r] = take(r)
        return plans[r]
    model.scheduler.take_plan = recorded


def sched_phase(sc, ac, cv_train, parse_args, data_dir, main_ms, tmp):
    """Phase 32 (header). Returns the rounds' launches."""
    from commefficient_tpu_torch.telemetry import (
        RunJournal, TelemetrySession,
    )
    from commefficient_tpu_torch.telemetry.journal import read_journal
    from commefficient_tpu_torch.utils import faults
    live = live_gib()
    jpath = os.path.join(tmp, "sched.jsonl")
    plans = {}

    def setup(model):
        model.attach_telemetry(TelemetrySession(
            journal=RunJournal(jpath), tracker=model.throughput,
            clock=lambda: scripted_time(model.server.round_idx)))
        _recorded_plans(model, plans)

    model, rr, loader = config2_variant("sched", sc, ac, cv_train,
                                        parse_args, data_dir, SCHED,
                                        setup=setup)
    model.telemetry.close(ok=True)
    check_launches("sched", rr.launches, {"sketch_encode": ROUNDS,
                                          "sketch_estimate_all": ROUNDS})
    wire = float(model.cfg.upload_bytes)
    idle = truncated = deadlines = 0
    for r, up in enumerate(rr.uploads):
        plan = plans.get(r)
        if plan is None:
            raise AssertionError(f"sched: round {r} had no plan")
        active = (np.ones(8, np.float32) if plan.active is None
                  else plan.active)
        want = active * faults.bernoulli_survivors(model.cfg.seed, r, 8,
                                                   0.1)
        idle += int((active == 0).sum())
        truncated += 0 if plan.work is None else int((plan.work < 1).sum())
        deadlines += plan.deadline_s is not None
        if not np.array_equal(np.asarray(up), wire * want):
            raise AssertionError(f"sched: round {r} uploads {up}, the plan "
                                 f"and the dropout draw keep {want}")
    records, problems = read_journal(jpath)
    events = [rec for rec in records if rec["event"] == "schedule"]
    fail = list(problems)
    if [e["round"] for e in events] != list(range(ROUNDS)):
        fail.append(f"schedule rounds {[e['round'] for e in events]}")
    for e in events:
        want = plans[e["round"]].journal_fields()
        if {k: e[k] for k in want} != want or e["sampler"] != "throughput":
            fail.append(f"schedule event {e} against the plan {want}")
    if fail:
        raise AssertionError("sched journal: " + "; ".join(
            str(f) for f in fail[:5]))
    if not (idle and truncated and deadlines):
        raise AssertionError(f"sched: idle {idle}, truncated {truncated}, "
                             f"deadline rounds {deadlines}")
    med = statistics.median
    phase("sched", f"{ROUNDS} rounds: {idle} idle slots billed 0 bytes, "
          f"{truncated} deadline-truncated slots billed {wire:.0f} (the "
          f"straggler path), {deadlines} rounds with a deadline; "
          f"{len(events)} schedule events equal to the plans; median "
          f"{med(rr.round_ms[1:]):.2f} ms/round beside config #2's "
          f"{med(main_ms[1:]):.2f}; peak {rr.peak / 2 ** 30:.3f} GiB "
          f"({live:.3f} GiB live before the phase); scheduler "
          f"{model.scheduler.state_dict()['rounds_scheduled']} rounds, "
          f"{model.scheduler.clients_sampled} clients sampled; launches "
          f"{rr.launches}")
    launches = rr.launches
    del model, loader
    torch.cuda.empty_cache()
    resume_pair("sched", sc, ac, cv_train, parse_args, SCHED,
                os.path.join(tmp, "sched_resume"))
    return launches


def async_phase(sc, ac, cv_train, parse_args, data_dir, main_ms, tmp):
    """Phase 33 (header). Returns the rounds' launches."""
    from commefficient_tpu_torch.federated.async_agg import AsyncAdmitBuffer
    from commefficient_tpu_torch.utils import faults
    live = live_gib()
    model, rr, loader = config2_variant("async_admit", sc, ac, cv_train,
                                        parse_args, data_dir, ASYNC)
    check_launches("async_admit", rr.launches, {
        "sketch_encode": ROUNDS, "sketch_estimate_all": ROUNDS})
    # the composition replayed on the host: the straggler draw with the
    # cutoff, then the buffer
    wire = float(model.cfg.upload_bytes)
    replay = AsyncAdmitBuffer(2, 0.5)
    deferred = admitted = 0
    dummy = (np.zeros((8, 1), np.float32),)
    for r, up in enumerate(rr.uploads):
        work = faults.straggler_work_fractions(model.cfg.seed, r, 8, 0.5,
                                               0.1)
        surv = (work >= 0.2).astype(np.float32)
        work = np.where(work < 0.2, np.float32(1.0), work)
        if np.all(work >= 1.0):
            work = None
        before = replay.pending_count
        _, _, _, surv_c, _ = replay.compose(
            r, np.arange(8), dummy, np.ones((8, 1), np.float32), surv, work)
        admitted += len(replay.last_admits)
        deferred += replay.pending_count - before + len(replay.last_admits)
        want = np.ones(8, np.float32) if surv_c is None else surv_c
        if not np.array_equal(np.asarray(up), wire * want):
            raise AssertionError(f"async_admit: round {r} uploads {up}, the "
                                 f"composition keeps {want}")
    if model.async_admit.pending_count != replay.pending_count or \
            not (deferred and admitted):
        raise AssertionError(f"async_admit: deferred {deferred}, admitted "
                             f"{admitted}, pending "
                             f"{model.async_admit.pending_count} vs "
                             f"{replay.pending_count}")
    med = statistics.median
    phase("async_admit", f"{ROUNDS} rounds: {deferred} straggling slots "
          f"deferred (billed 0 at their round), {admitted} admitted 2 "
          f"rounds late at 0.25 x their work (billed {wire:.0f}), "
          f"{replay.pending_count} pending at the end, as the host replay "
          f"composes them; median {med(rr.round_ms[1:]):.2f} ms/round "
          f"beside config #2's {med(main_ms[1:]):.2f}; peak "
          f"{rr.peak / 2 ** 30:.3f} GiB ({live:.3f} GiB live before the "
          f"phase); launches {rr.launches}")
    launches = rr.launches
    del model, loader
    torch.cuda.empty_cache()

    k0 = ASYNC[:4] + ["--async_admit_rounds", "0"]
    finals = []
    with Deterministic():
        for label, setup in (
                ("async_k0", None),
                ("async_k0_buffer", lambda m: setattr(
                    m, "async_admit", AsyncAdmitBuffer(0, 0.5)))):
            model, rr, _ = config2_variant(label, sc, ac, cv_train,
                                           parse_args, data_dir, k0,
                                           setup=setup)
            finals.append(([t.detach().cpu() for t in model.server[:3]],
                           [np.asarray(u) for u in rr.uploads]))
            del model
            torch.cuda.empty_cache()
    same = (all(torch.equal(a, b) for a, b in zip(finals[0][0],
                                                  finals[1][0]))
            and all(np.array_equal(a, b) for a, b in zip(finals[0][1],
                                                         finals[1][1])))
    if not same:
        raise AssertionError("async_admit: --async_admit_rounds 0 and a "
                             "k = 0 buffer differ")
    phase("async_admit", "--async_admit_rounds 0 (the synchronous "
          "straggler path) and the same rounds with a k = 0 buffer forced "
          "in: weights, server state and every round's uploads bitwise "
          "equal")

    def pending_at_b(path):
        with np.load(path) as z:
            n = int(z["asyb_ids"].size) if "asyb_ids" in z.files else 0
        if not n:
            raise AssertionError(f"async_admit: {path} holds no pending "
                                 "admission")
        phase("async_admit", f"B's checkpoint {os.path.basename(path)} "
              f"holds {n} pending admissions")

    resume_pair("async_admit", sc, ac, cv_train, parse_args, ASYNC,
                os.path.join(tmp, "async_resume"), check=pending_at_b)
    return launches


def statetier_phase(sc, ac, cv_train, parse_args, ltopk_peak, tmp) -> None:
    """Phase 34 (header)."""
    spe = math.ceil(CLIENTS * EXAMPLES_PER_CLIENT / (8 * 32))
    data_dir = os.path.join(HERE, "build", "chip_smoke_cifar100_data")
    runs = {}

    def run(label, extra):
        # the model and optimizer reference each other: collect the
        # previous run's before this one's peak is read
        live = live_gib()
        n_train = CLIENTS * EXAMPLES_PER_CLIENT
        cfg = parse_args(argv=CONFIG3 + list(extra) + [
            "--num_clients", str(CLIENTS), "--device", "cuda",
            "--dataset_dir", data_dir, "--num_epochs",
            str(LTOPK_ROUNDS / spe), "--pivot_epoch",
            str(LTOPK_ROUNDS / spe / 2), "--seed", "21"])
        model, opt, sched, loader, val = cv_train.build(
            cfg, device="cuda", synthetic_examples=(n_train, 512))
        assert model.cfg.grad_size == CONFIG3_D
        rr = drive_rounds(label, sc, ac, model, loader, LTOPK_ROUNDS,
                          lambda timed, on_round: cv_train.train(
                              model, opt, sched, timed, val, model.cfg,
                              on_round=on_round))
        check_launches(label, rr.launches,
                       {n: 0 for n in SKETCH_AND_ATTENTION})
        model.drain_persistence()
        rows = sum(t.numel() * t.element_size() for t in model.clients)
        store = model.state_store
        if store is None:
            full = {f: getattr(model.clients, f).cpu().numpy()
                    for f in ("errors", "velocities")}
        else:
            payload = model.client_rows_payload()
            full = {}
            for f in ("errors", "velocities"):
                full[f] = np.zeros((CLIENTS, CONFIG3_D), np.float32)
                full[f][payload["ids"]] = payload[f]
        runs[label] = (model.ps_weights.cpu(), full, rows, rr, store and (
            store.spills, store.restores, store.hits, store.misses), live)
        model.close_persistence()
        del model, opt, loader, val
        torch.cuda.empty_cache()

    with Deterministic():
        run("statetier_device", [])
        run("statetier", TIER)
        run("statetier_spill_span", TIER + [
            "--state_spill_dir", os.path.join(tmp, "tail"),
            "--scan_rounds", "--scan_span", "2", "--pipeline"])
    w0, rows0, bytes0, rr0, _, live0 = runs["statetier_device"]
    med = statistics.median
    for label in ("statetier", "statetier_spill_span"):
        w, rows, nbytes, rr, counts, live = runs[label]
        same = torch.equal(w, w0) and all(
            np.array_equal(rows[f], rows0[f]) for f in rows0)
        if not same:
            raise AssertionError(f"{label}: weights or client rows differ "
                                 "from the device tier's")
        if not counts[0]:
            raise AssertionError(f"{label}: the working set never spilled")
        phase(label, f"{' '.join(TIER)}"
              f"{' + spill dir, spans of 2, pipelined' if 'spill' in label else ''}"
              f": weights and all {CLIENTS} clients' error and velocity rows "
              f"bitwise the device tier's; device rows {nbytes / 1e9:.3f} GB "
              f"against {bytes0 / 1e9:.3f} GB; {counts[0]} spills, "
              f"{counts[1]} restores, {counts[2]} hits, {counts[3]} misses; "
              f"{statistics.mean(rr.round_ms):.2f} ms/round over all "
              f"{LTOPK_ROUNDS} rounds, the first included (median "
              f"{med(rr.round_ms[1:]):.2f}) beside the device tier's "
              f"{statistics.mean(rr0.round_ms):.2f} "
              f"({med(rr0.round_ms[1:]):.2f}); peak "
              f"{rr.peak / 2 ** 30:.3f} GiB beside the device tier's "
              f"{rr0.peak / 2 ** 30:.3f} and phase 11's "
              f"{ltopk_peak / 2 ** 30:.3f} ({live:.3f} and {live0:.3f} GiB "
              f"live before the two runs)")


# ---------------- item 9f and item 1's blockwise decode: phases 35-36 -----

# phase 35: config #2 with each controller (CONTROL: label, flags, K1
# launches a round), then the three combined as a resume pair. The
# screen runs under phase 23's trimmed_mean: over 10 rounds the colluding
# clients' updates, sized to the multiplier the screen admits, drive
# config #2 to a divergent loss under the mean (a numeric trip by round
# 8) and under coord_median (by round 9, with the static multiplier
# too), and a scaled poison of half the cohort moves the even cohort's
# median past the screen (H100 runs). The speed run's clock
# alternates rounds of 2.0 s and 0.25 s (control_time), so the clients
# of the slow rounds measure 8x slower and speed matching flags some
BYZANTINE_CTL = BYZANTINE + ["--aggregator", "trimmed_mean",
                             "--target_screened_rate", "0.1"]
CONTROL = (("control_screen", BYZANTINE_CTL, 8),
           ("control_speed", SCHED + ASYNC + ["--speed_match"], 1),
           ("control_staleness", ASYNC + ["--adapt_staleness"], 1))
CONTROL_SPAN = ["--scan_rounds", "--pipeline"]
CONTROL_PALETTE = ["--scan_span_palette", "1,2,4"]
CONTROL_RESUME = (BYZANTINE_CTL + SCHED + ASYNC
                  + ["--speed_match", "--adapt_staleness"])
# phase 36: config #5 on GPT2-medium (24 blocks of width 1024), --remat,
# phase 7's corpus, GPT2M_ROUNDS rounds of 8 clients x GPT2M_EXAMPLES
GPT2M_D = 354_829_313
GPT2M_FLAGS = ["--model_checkpoint", "gpt2-medium", "--remat"]
GPT2M_ROUNDS = 3
GPT2M_EXAMPLES = 8
GPT2M_LAYERS, GPT2M_HEADS = 24, 16
GPT2M_K = 50_000


def control_time(round_idx: int) -> float:
    """Phase 35's scripted clock: rounds of 2.0 s and 0.25 s in turn,
    a function of the rounds done alone."""
    q, m = divmod(int(round_idx), 2)
    return 2.25 * q + (0.0, 0.25)[m]


def _control_run(label, sc, ac, cv_train, parse_args, data_dir, extra,
                 tmp, k1=1, clock=scripted_time, rounds=ROUNDS):
    """One phase 35 run of config #2 with `extra`, a journal, the
    session's clock scripted, the plans and each round's admission decay
    (at compose) kept. Returns (model, rr, plans, decays, journal
    path, live GiB before)."""
    from commefficient_tpu_torch.telemetry import (
        RunJournal, TelemetrySession,
    )
    live = live_gib()
    jpath = os.path.join(tmp, f"{label}.jsonl")
    plans, decays = {}, {}

    def setup(model):
        model.attach_telemetry(TelemetrySession(
            journal=RunJournal(jpath), tracker=model.throughput,
            clock=lambda: clock(model.server.round_idx)))
        _recorded_plans(model, plans)
        buf = model.async_admit
        if buf is not None:
            compose = buf.compose

            def recorded(r, *args, **kw):
                decays[int(r)] = buf.decay
                return compose(r, *args, **kw)
            buf.compose = recorded

    model, rr, _ = config2_variant(label, sc, ac, cv_train, parse_args,
                                   data_dir, extra, rounds=rounds,
                                   setup=setup)
    model.telemetry.close(ok=True)
    model.close_persistence()
    check_launches(label, rr.launches, {"sketch_encode": k1 * rounds,
                                        "sketch_estimate_all": rounds})
    return model, rr, plans, decays, jpath, live


def _journal(label, path):
    from commefficient_tpu_torch.telemetry.journal import read_journal
    records, problems = read_journal(path)
    if problems:
        raise AssertionError(f"{label} journal: {problems[:3]}")
    return records


def _run_line(label, rr, main_ms, live) -> str:
    """ms/round beside phase 4's: the median of rounds 2-N, and the mean
    of all N, the first included (a span's rounds end together, so its
    median is not a round's time), the peak, the launches."""
    med, mean = statistics.median, statistics.mean
    return (f"median {med(rr.round_ms[1:]):.2f}, mean "
            f"{mean(rr.round_ms):.2f} ms/round beside config #2's "
            f"{med(main_ms[1:]):.2f}, {mean(main_ms):.2f}; peak "
            f"{rr.peak / 2 ** 30:.3f} GiB ({live:.3f} GiB live before the "
            f"run); launches {rr.launches}")


def control_phase(sc, ac, cv_train, parse_args, data_dir, main_ms,
                  tmp) -> None:
    """Phase 35 (header)."""
    from commefficient_tpu_torch.control import AdaptiveScreenController
    from commefficient_tpu_torch.federated.async_agg import AsyncAdmitBuffer
    from commefficient_tpu_torch.utils import faults

    # (a) the adaptive screen: every round at its plan's multiplier, a
    # fresh controller fed the journaled screened counts reproduces the
    # journaled moves and the final multiplier bitwise
    label, extra, k1 = CONTROL[0]
    model, rr, plans, _, jpath, live = _control_run(
        label, sc, ac, cv_train, parse_args, data_dir, extra, tmp, k1)
    records = _journal(label, jpath)
    screened = {rec["round"]: rec["n_screened"] for rec in records
                if rec["event"] == "screened"}
    journaled = [(rec["round"], rec["old_mult"], rec["new_mult"],
                  rec["rate"]) for rec in records
                 if rec["event"] == "screen_adapt"]
    replay = AdaptiveScreenController(model.cfg)
    moves, mults = [], []
    for r in range(ROUNDS):
        mults.append(plans[r].screen_mult)
        if plans[r].screen_mult != replay.plan_mult():
            raise AssertionError(f"{label}: round {r} ran at "
                                 f"{plans[r].screen_mult}, the replay's "
                                 f"multiplier is {replay.plan_mult()}")
        moved = replay.observe(r, screened.get(r, 0), 8)
        if moved is not None:
            moves.append((r, *(round(v, 6) for v in moved)))
    if not journaled or moves != journaled or \
            replay.plan_mult() != model.screen_ctl.plan_mult():
        raise AssertionError(f"{label}: journaled moves {journaled}, the "
                             f"replay's {moves}")
    phase(label, f"{' '.join(extra)}: multipliers by round {mults} "
          f"(screen_norm_mult {model.cfg.screen_norm_mult:g}); "
          f"{sum(screened.values())} updates screened; {len(journaled)} "
          "screen_adapt events, reproduced bitwise by a fresh controller "
          "fed the journaled counts; " + _run_line(label, rr, main_ms, live))
    del model
    torch.cuda.empty_cache()

    # (b) speed matching: each slot billed as the plan, the draws and
    # the admission buffer compose it, replayed on the host
    label, extra, k1 = CONTROL[1]
    model, rr, plans, _, jpath, live = _control_run(
        label, sc, ac, cv_train, parse_args, data_dir, extra, tmp, k1,
        clock=control_time)
    wire = float(model.cfg.upload_bytes)
    seed = model.cfg.seed
    replay = AsyncAdmitBuffer(2, 0.5)
    dummy = (np.zeros((8, 1), np.float32),)
    deferred = admitted = 0
    for r, up in enumerate(rr.uploads):
        plan = plans[r]
        surv = faults.bernoulli_survivors(seed, r, 8, 0.1)
        if plan.active is not None:
            surv = surv * plan.active
        work = faults.straggler_work_fractions(seed, r, 8, 0.5, 0.1)
        if plan.work is not None:
            work = np.minimum(work, plan.work)
        below = work < 0.2
        surv = np.where(below, np.float32(0.0), surv).astype(np.float32)
        work = np.where(below, np.float32(1.0), work).astype(np.float32)
        before = replay.pending_count
        _, _, _, surv_c, _ = replay.compose(
            r, np.arange(8), dummy, np.ones((8, 1), np.float32), surv,
            None if np.all(work >= 1.0) else work)
        admitted += len(replay.last_admits)
        deferred += replay.pending_count - before + len(replay.last_admits)
        if not np.array_equal(np.asarray(up), wire * surv_c):
            raise AssertionError(f"{label}: round {r} uploads {up}, the "
                                 f"composition keeps {surv_c}")
    moves = [rec for rec in _journal(label, jpath)
             if rec["event"] == "control"]
    if not (moves and deferred and admitted) or any(
            rec["controller"] != "speed_match" for rec in moves):
        raise AssertionError(f"{label}: control events {moves[:3]}, "
                             f"deferred {deferred}, admitted {admitted}")
    phase(label, f"{' '.join(extra)}, clock control_time: "
          f"{deferred} slots deferred and {admitted} admitted, every "
          "round's uploads as the host replay of the plans, the draws and "
          f"the buffer bills them; ratios "
          f"{[plans[r].controls['speed_ratio'] for r in range(ROUNDS)]}; "
          f"{len(moves)} speed_match control events; "
          + _run_line(label, rr, main_ms, live))
    del model
    torch.cuda.empty_cache()

    # (c) staleness decay: each round composed at its plan's decay
    label, extra, k1 = CONTROL[2]
    model, rr, plans, decays, jpath, live = _control_run(
        label, sc, ac, cv_train, parse_args, data_dir, extra, tmp, k1)
    stamped = [plans[r].controls["staleness_decay"] for r in range(ROUNDS)]
    applied = [decays[r] for r in range(ROUNDS)]
    if applied != [float(np.float32(v)) for v in stamped]:
        raise AssertionError(f"{label}: decays applied {applied}, the "
                             f"plans' {stamped}")
    moves = [rec for rec in _journal(label, jpath)
             if rec["event"] == "control"]
    phase(label, f"{' '.join(extra)}: every round composed at its plan's "
          f"decay {applied}; {len(moves)} staleness_decay control events "
          f"(lag {model.control_bank.controllers[0].lag}); "
          + _run_line(label, rr, main_ms, live))
    del model
    torch.cuda.empty_cache()

    # (d) span cadence: pipelined spans of the palette's picks, bitwise
    # the same flags without a palette
    finals = {}
    with Deterministic():
        for label, extra in (("control_span", CONTROL_SPAN + CONTROL_PALETTE),
                             ("control_span_plain", CONTROL_SPAN)):
            model, rr, plans, _, jpath, live = _control_run(
                label, sc, ac, cv_train, parse_args, data_dir, extra, tmp)
            records = _journal(label, jpath)
            picks = [rec["scan_span"] for rec in records
                     if rec["event"] == "schedule" and "scan_span" in rec]
            spans = [rec["rounds"] for rec in records
                     if rec["event"] == "span"]
            # a span's rows carry no bytes: each round's from the journal
            finals[label] = (
                [t.detach().cpu() for t in model.server[:3]],
                [(rec["round"], rec["down_bytes"], rec["up_bytes"])
                 for rec in records if rec["event"] == "round"],
                model.accountant.state_dict())
            phase(label, f"{' '.join(extra)}: spans of {spans}"
                  + (f", the plans' picks {picks}, "
                     f"{sum(rec['event'] == 'control' for rec in records)} "
                     "span_cadence control events" if picks else "")
                  + "; " + _run_line(label, rr, main_ms, live))
            del model
            torch.cuda.empty_cache()
    (wa, ua, aa), (wb, ub, ab) = (finals["control_span"],
                                  finals["control_span_plain"])
    if not (all(torch.equal(a, b) for a, b in zip(wa, wb))
            and ua == ub and len(ua) == ROUNDS
            and sorted(aa) == sorted(ab)
            and all(np.array_equal(np.asarray(aa[k]), np.asarray(ab[k]))
                    for k in aa)):
        raise AssertionError("control_span: the palette's spans differ from "
                             "the plain spans")
    phase("control_span", "weights, server state, the accountant and every "
          "round's journaled bytes bitwise the run without a palette "
          "(deterministic algorithms)")

    # (e) the three round controllers combined, run A and run B
    # (preempted, resumed) on phase 20's corpus
    def ctl_keys(path):
        with np.load(path) as z:
            keys = [k for k in z.files
                    if k.startswith(("sched_screen_", "sched_ctl_"))]
        if len(keys) < 6:
            raise AssertionError(f"control_resume: {path} holds {keys}")
        phase("control_resume", f"B's checkpoint {os.path.basename(path)} "
              f"holds {sorted(keys)}")

    resume_pair("control_resume", sc, ac, cv_train, parse_args,
                CONTROL_RESUME, os.path.join(tmp, "control_resume"),
                check=ctl_keys)


def gpt2medium_kernels(sc, ac, CSVec):
    """Phase 36's kernel checks at [5, 500,000] and B = 710: K1 at
    d = GPT2M_D and K2 on windows of chunks (the first, a middle one, the
    ragged last chunk) against their plain versions, exact; the whole
    blockwise decode at k = GPT2M_K bitwise its plain version's; K4 on
    GPT2-medium's head views. Returns the kernels-line rows (launches
    filled in after the phase 36 rounds)."""
    from commefficient_tpu_torch.ops import sketch as tsketch
    dev = torch.device("cuda")
    d, c, r = GPT2M_D, MAIN_C, MAIN_R
    sk = CSVec(d=d, c=c, r=r)
    B = sk.n_chunks
    nb = tsketch.window_chunks(c)
    off, eps, delta = sk.tables(dev)
    eps_bits, delta_bits = sk.sign_bits(dev)
    x = torch.randn(d, generator=torch.Generator().manual_seed(36)).to(dev)
    table = sk.encode(x)
    t_p = sc.encode_plain(x, off, delta, eps, c)
    torch.cuda.synchronize()
    err = {"sketch_encode": float((table - t_p).abs().max())}
    if not torch.equal(table, t_p):
        raise AssertionError(f"gpt2medium: K1 differs from its plain "
                             f"version at d={d}: {err['sketch_encode']}")
    del t_p
    windows = ((0, nb), (B // 2, nb), (B - 1, 1))
    err["sketch_estimate_window"] = 0.0
    for b0, n in windows:
        got = sc.estimate_window(table, off, delta_bits, eps_bits, d, b0, n)
        want = sc.estimate_all_plain(table, off, delta, eps, d, b0, n)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err["sketch_estimate_window"] = max(err["sketch_estimate_window"],
                                            e)
        if not torch.equal(got, want):
            raise AssertionError(f"gpt2medium: K2 on chunks [{b0}, "
                                 f"{b0 + n}) differs from its plain "
                                 f"version: {e}")
    tail = d - (B - 1) * c
    phase("gpt2medium", f"[{r}, {c}] table, B = {B}, windows of {nb} "
          f"chunks: K1 at d = {d} and K2 on chunks {windows} (the last "
          f"chunk holds {tail} coordinates) equal to their plain versions "
          "(exact)")

    def plain_decode():
        return tsketch.blockwise_topk(
            lambda b0, n: sc.estimate_all_plain(table, off, delta, eps, d,
                                                b0, n), B, c, d, GPT2M_K)

    def decode():
        return sk.decode_topk_sparse(table, GPT2M_K)

    idx, vals = decode()
    p_idx, p_vals = plain_decode()
    torch.cuda.synchronize()
    if not (torch.equal(idx, p_idx) and torch.equal(vals, p_vals)):
        raise AssertionError("gpt2medium: the blockwise decode's (idx, "
                             "vals) differ between the kernels and the "
                             "plain versions")
    est_ops = 2 * r + r * (r - 1) + 2
    dec_bytes = (4 * r * c + 4 * r * B + sc.bits_bytes(r * c)
                 + sc.bits_bytes(r * B) + 12 * GPT2M_K)
    dec_ms = time_cuda(decode, 10)
    plain_ms = time_cuda(plain_decode, 2, warmup=1)
    t_b = dec_bytes / PEAK_BYTES_PER_S * 1e3
    t_o = d * est_ops / PEAK_F32_FLOPS * 1e3
    phase("gpt2medium", f"blockwise decode at k = {GPT2M_K}: (idx, vals) "
          f"bitwise the plain windows'; {int((vals != 0).sum())} nonzero "
          f"picks; {-(-B // nb)} windows; {dec_ms:.4f} ms (device, L2 "
          f"flushed), plain {plain_ms:.4f} ms, bound {max(t_b, t_o):.4f} ms "
          f"({'bytes' if t_b >= t_o else 'operations'}: "
          f"{dec_bytes / 1e6:.1f} MB, {d * est_ops / 1e9:.2f} GFLOP)")
    del idx, vals, p_idx, p_vals

    heads = GPT2M_HEADS
    E = heads * K4_DH
    qkv = torch.randn(K4_BATCH, GPT2_L, 3 * E,
                      generator=torch.Generator().manual_seed(7)).to(dev)
    q, kk, v = (t.reshape(K4_BATCH, GPT2_L, heads, K4_DH).transpose(1, 2)
                for t in qkv.split(E, dim=-1))
    o, lse = ac.flash_fwd(q, kk, v, 0.125)
    po, plse = ac.flash_fwd_plain(q, kk, v, 0.125)
    torch.cuda.synchronize()
    err["flash_fwd"] = max(float((o - po).abs().max()),
                           float((lse - plse).abs().max()))
    if not (float((o - po).abs().max()) <= K4_RTOL * float(po.abs().max())
            and float((lse - plse).abs().max())
            <= K4_RTOL * float(plse.abs().max())):
        raise AssertionError("gpt2medium: K4 differs from its plain version "
                             f"on [{K4_BATCH}, {heads}, {GPT2_L}, {K4_DH}]")
    del o, lse, po, plse
    rows = [
        encode_row(sc, sk, x, "sketch_encode_gpt2medium", "gpt2medium"),
        # K2 on the first window
        dict(name="sketch_estimate_window", counter="sketch_estimate_window",
             path="gpt2medium", route="cuda",
             source="commefficient_tpu_torch/ops/csrc/sketch.cu",
             replaces="commefficient_tpu/ops/kernels/sketch_pallas.py:191",
             fn=lambda: sc.estimate_window(table, off, delta_bits, eps_bits,
                                           d, 0, nb),
             plain=lambda: sc.estimate_all_plain(table, off, delta, eps, d,
                                                 0, nb),
             library=None, cost=sc.estimate_cost(r, c, nb)),
        dict(name="flash_fwd_gpt2medium", counter="flash_fwd",
             path="gpt2medium", route="cuda",
             source="commefficient_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="commefficient_tpu/ops/attention.py:91",
             fn=lambda: ac.flash_fwd(q, kk, v, 0.125),
             plain=lambda: ac.flash_fwd_plain(q, kk, v, 0.125),
             library=sdpa_efficient(ac, q, kk, v),
             cost=ac.flash_fwd_cost(q), peak_flops=PEAK_TF32_FLOPS),
    ]
    out = [timed_row(row, err[row["counter"]]) for row in rows]
    del rows, table, x, q, kk, v, qkv
    torch.cuda.empty_cache()
    return out


def gpt2medium_phase(sc, ac, gpt2_train, parse_args, HashTokenizer,
                     data_dir, fserver, gpt2_ms=None):
    """Phase 36 (header): the rounds. Returns their launches."""
    live = live_gib()
    spe = math.ceil(GPT2_CORPUS[0] * GPT2_CORPUS[1] * GPT2_CORPUS[2]
                    / (8 * GPT2M_EXAMPLES))
    cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=CONFIG5
                     + GPT2M_FLAGS + [
                         "--local_batch_size", str(GPT2M_EXAMPLES),
                         "--device", "cuda", "--dataset_dir", data_dir,
                         "--num_epochs", str(GPT2M_ROUNDS / spe),
                         "--seed", "21"])
    t0 = time.perf_counter()
    model, opt, sched, train_loader, _ = gpt2_train.build(
        cfg, HashTokenizer(GPT2_VOCAB), device="cuda",
        synthetic_examples=GPT2_CORPUS)
    sk = fserver.args2sketch(model.cfg)
    phase("gpt2medium", f"built in {time.perf_counter() - t0:.2f} s: "
          f"{' '.join(GPT2M_FLAGS)}, d = {model.cfg.grad_size}, "
          f"{sk.n_chunks} chunks, r * B = {sk.r * sk.n_chunks}, padded d "
          f"{sk.n_chunks * sk.c}; train L = {train_loader.dataset.seq_len}, "
          f"8 clients x {GPT2M_EXAMPLES} examples a round")
    assert model.cfg.grad_size == GPT2M_D, model.cfg.grad_size
    assert train_loader.dataset.seq_len == GPT2_L
    assert not sk._threshold_decode and not sk._static_path
    from commefficient_tpu_torch.ops import sketch as tsketch
    windows = -(-sk.n_chunks // tsketch.window_chunks(sk.c))
    rr = drive_rounds("gpt2medium", sc, ac, model, train_loader,
                      GPT2M_ROUNDS,
                      lambda timed, on_round: gpt2_train.train_gpt2(
                          model, opt, sched, timed, model.cfg,
                          on_round=on_round))
    # K1 once a round (the cohort sum): the update's re-sketch takes the
    # scatter route at r * k = 250,000 (ops/sketch.K_SPARSE_DENSE_MIN);
    # K4 twice a block and client under --remat
    check_launches("gpt2medium", rr.launches, {
        "sketch_encode": GPT2M_ROUNDS,
        "sketch_estimate_window": windows * GPT2M_ROUNDS,
        "sketch_estimate_all": 0, "threshold_sample": 0,
        "threshold_mask": 0, "flash_fwd_bf16": 0,
        "flash_fwd": 2 * GPT2M_LAYERS * 8 * GPT2M_ROUNDS})
    wire = 4 * MAIN_R * MAIN_C
    for r, up in enumerate(rr.uploads):
        if not np.array_equal(np.asarray(up), np.full(8, float(wire))):
            raise AssertionError(f"gpt2medium: round {r} uploads {up}, "
                                 f"{wire} a client expected")
    med = statistics.median
    phase("gpt2medium", f"{GPT2M_ROUNDS} rounds: mean client loss "
          f"first/last {float(rr.losses[0].mean()):.4f}/"
          f"{float(rr.losses[-1].mean()):.4f}; every upload {wire} bytes; "
          f"K2 on {windows} windows a round; median "
          f"{med(rr.round_ms[1:]):.2f} ms/round"
          + ("" if gpt2_ms is None else
             f" beside config #5's {med(gpt2_ms[1:]):.2f} (GPT2-small)")
          + f"; peak {rr.peak / 2 ** 30:.3f} GiB ({live:.3f} GiB live "
          f"before the phase); launches {rr.launches}")
    launches = rr.launches
    del model, opt, sched, train_loader, rr
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 37-38: ranks over torch.distributed (item 9g). Each rank is a
# subprocess of this interpreter running this file with --rank; it
# loads build/'s kernels (built by the parent) and writes its results
# to the phase's directory (the coordinator's JSON, logs a rank).

# phase 37: config #2 on GRID_RANKS ranks that share the card over gloo
# (NCCL refuses two ranks on one device), 4 clients a rank; then NCCL
# with two ranks on the card (expected to refuse, its message printed)
# and an NCCL world of one rank against the one-process run, both
# NCCL1_ROUNDS rounds under deterministic algorithms
GRID_RANKS = 2
NCCL1_ROUNDS = 3
RANK_TIMEOUT = 600
# phase 38: config #5's GPT2-small under --model_parallel 2, two ranks
# sharing the card over gloo, with --remat so that both fit beside each
# other; TP_ROUNDS rounds; round one's losses within tests/test_tp.py's
# limit of the one-process round
TP_FLAGS = ["--model_parallel", "2", "--remat"]
TP_ROUNDS = 2
TP_LOSS_RTOL = 2e-5
K4_TP_HEADS = K4_HEADS // 2


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(kind, n, io, backend="gloo"):
    """Start `n` ranks of `kind` (0: one process without
    torch.distributed), each logging to io/<kind><i>.log; returns
    (kind, processes, log paths) for wait_ranks."""
    port = free_port()
    procs, logs = [], []
    for i in range(max(n, 1)):
        path = os.path.join(io, f"{kind}{i}.log")
        logs.append(path)
        with open(path, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", kind,
                 "--process_id", str(i), "--num_processes", str(n),
                 "--port", str(port), "--backend", backend, "--io", io],
                cwd=HERE, stdout=f, stderr=subprocess.STDOUT))
    return kind, procs, logs


def run_ranks(label, kind, n, io, backend="gloo", timeout=RANK_TIMEOUT,
              expect_ok=True):
    """start_ranks, then wait_ranks."""
    return wait_ranks(label, start_ranks(kind, n, io, backend), timeout,
                      expect_ok)


def wait_ranks(label, started, timeout=RANK_TIMEOUT, expect_ok=True):
    """Wait for started ranks (killed at `timeout`). Returns (exit
    codes, logs); with `expect_ok` any non-zero exit fails the phase."""
    kind, procs, logs = started
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{label}: {kind} ranks still running after "
                             f"{timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for path in logs:
        with open(path) as f:
            texts.append(f.read())
    codes = [p.returncode for p in procs]
    if expect_ok:
        for i, (code, text) in enumerate(zip(codes, texts)):
            if code != 0:
                raise AssertionError(f"{label}: {kind} rank {i} exited "
                                     f"{code}:\n{text[-3000:]}")
    return codes, texts


def rank_result(io, kind) -> dict:
    with open(os.path.join(io, f"{kind}.json")) as f:
        return json.load(f)


def save_batch(path, batch, **extra) -> None:
    ids, data, mask = batch
    np.savez(path, ids=np.asarray(ids), mask=np.asarray(mask),
             n_data=len(data), **{f"data{i}": np.asarray(d)
                                  for i, d in enumerate(data)}, **extra)


def load_batch(path):
    z = np.load(path)
    return (z["ids"], tuple(z[f"data{i}"] for i in range(int(z["n_data"]))),
            z["mask"]), z


def per_rank(layout, device, values) -> list:
    """Every rank's `values` (a list of floats), in rank order: one
    all_reduce (the identity without ranks)."""
    n = 1 if layout is None else layout.size
    me = 0 if layout is None else layout.rank
    t = torch.zeros((n, len(values)), dtype=torch.float64, device=device)
    t[me] = torch.tensor(values, dtype=torch.float64)
    if layout is not None and layout.connected:
        import torch.distributed as dist
        dist.all_reduce(t)
    return t.cpu().tolist()


def timed_rank_run(model, run, deterministic=False) -> dict:
    """A rank's rounds: `run(on_round)` drives the driver's loop, each
    round ended by a synchronize; the launch counters and the layout's
    collective counters set to 0 just before and read just after."""
    from commefficient_tpu_torch.ops.kernels import attention_cuda as ac
    from commefficient_tpu_torch.ops.kernels import sketch_cuda as sc
    stamps, losses, uploads = [], [], []

    def on_round(i, out):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append([float(v) for v in torch.as_tensor(out[0]).reshape(-1)])
        uploads.append([float(v) for v in np.asarray(out[-1]).reshape(-1)])

    lay = model.layout
    w_start = model.ps_weights.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(sc, ac)
    if lay is not None:
        lay.stats.reset()
    t0 = time.perf_counter()
    with Deterministic() if deterministic else contextlib.nullcontext():
        ok = run(on_round)
        torch.cuda.synchronize()
    launches = read_counts(sc, ac)
    peak = torch.cuda.max_memory_allocated()
    ms = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
    return dict(ok=bool(ok), round_ms=ms, losses=losses, uploads=uploads,
                launches=launches, peak=peak,
                moved=not torch.equal(model.ps_weights, w_start),
                collectives=None if lay is None else lay.stats.as_dict())


def _rank_flags(args) -> list:
    """The driver's --multihost flags of a rank started by start_ranks
    (none for the one-process run)."""
    if args.num_processes <= 0:
        return []
    return ["--multihost", "--num_processes", str(args.num_processes),
            "--process_id", str(args.process_id), "--coordinator_address",
            f"127.0.0.1:{args.port}"]


def grid_rank(args, mh) -> dict:
    """A rank of phase 37 (`grid`), which then runs phases 40 and 41, or
    one process of its NCCL world of one (`nccl1`) or of the one-process
    run beside it (`single`), both under PLAN_NCCL1."""
    from commefficient_tpu_torch.config import parse_args
    from commefficient_tpu_torch.parallel.mh_worker import ranks_bitwise_equal
    from commefficient_tpu_torch.training import cv_train
    kind = args.rank
    rounds = ROUNDS if kind == "grid" else NCCL1_ROUNDS
    extra = _rank_flags(args) + ([] if kind == "grid" else PLAN_NCCL1)
    model, opt, sched, loader, val = config2_build(
        cv_train, parse_args, os.path.join(HERE, "build", "chip_smoke_data"),
        extra, rounds)
    lay = model.layout
    out = {"layout": None if lay is None else lay.ranks.tolist(),
           "device": str(model.device)}
    if kind == "grid":
        # round one's reduced table from phase 5's weights and batch: a
        # real round on the model's state (the result dropped), the
        # table read where the round's cross-rank sum returns it
        from commefficient_tpu_torch.federated import round as fround
        (ids, data, mask), z = load_batch(os.path.join(args.io,
                                                       "grid_parity.npz"))
        sl = lay.local_row_slice(mask.shape[0])
        dev = model.device
        placed = fround.RoundBatch(
            torch.as_tensor(np.asarray(ids, np.int64).reshape(-1),
                            device=dev),
            tuple(torch.as_tensor(d[sl], device=dev) for d in data),
            torch.as_tensor(mask[sl], device=dev).to(torch.float32))
        server = model.server._replace(
            ps_weights=torch.from_numpy(z["w"]).to(dev))
        tables, reduce = [], fround.reduce_transmit

        def record(*a, **kw):
            out = reduce(*a, **kw)
            tables.append(out.clone())
            return out

        fround.reduce_transmit = record
        try:
            model._train_round(server, model.clients, placed, model._lr(),
                               model._key)
        finally:
            fround.reduce_transmit = reduce
        if len(tables) != 1:
            raise AssertionError(f"grid: the round reduced {len(tables)} "
                                 "tables (1 expected)")
        table = tables[0] / float(mask.sum())
        if mh.is_coordinator():
            np.save(os.path.join(args.io, "grid_table.npy"),
                    table.cpu().numpy())
        del table, tables, server
    res = timed_rank_run(
        model, lambda on_round: cv_train.train(
            model, opt, sched, loader, val, model.cfg, on_round=on_round),
        deterministic=kind != "grid")
    l = res["launches"]
    out.update(res, per_rank=per_rank(lay, model.device, [
        res["peak"], l["sketch_encode"], l["sketch_estimate_all"],
        sum(res["round_ms"][1:]) / max(len(res["round_ms"]) - 1, 1)]),
        equal=bool(ranks_bitwise_equal(model.ps_weights))
        if lay is not None and lay.connected else True)
    if kind != "grid":
        out["transport"] = model.plan_transport.stats.as_dict()
        out["gloo_group"] = model.plan_transport.group is not None
    if kind != "grid" and mh.is_coordinator():
        np.save(os.path.join(args.io, f"{kind}_weights.npy"),
                model.ps_weights.cpu().numpy())
    if kind == "grid":
        # phases 40 and 41 on the same ranks
        del model, opt, sched, loader, val
        torch.cuda.empty_cache()
        out["plangrid"] = plangrid_rank_leg(args, mh, cv_train, parse_args)
        out["ring"] = ring_rank_leg(args, mh)
    return out


def nccl2_rank(args, mh) -> dict:
    """Two NCCL ranks on the one card: the communicator is built at the
    first collective, where NCCL is expected to refuse the duplicate
    device."""
    import torch.distributed as dist
    t = torch.ones(1, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print(f"nccl2: all_reduce over two ranks on one card gave {t.item()}",
          flush=True)
    return {"sum": t.item()}


def tp_rank(args, mh) -> dict:
    """A rank of phase 38: config #5's GPT2-small under TP_FLAGS through
    gpt2_train; the cohort gradient of phase 38's batch at the initial
    weights, then TP_ROUNDS rounds."""
    from commefficient_tpu_torch.config import parse_args
    from commefficient_tpu_torch.data.persona import HashTokenizer
    from commefficient_tpu_torch.parallel.mh_worker import ranks_bitwise_equal
    from commefficient_tpu_torch.training import gpt2_train
    spe = math.ceil(math.prod(GPT2_CORPUS) / (8 * 8))
    cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=CONFIG5 + TP_FLAGS
                     + ["--local_batch_size", "8", "--device", "cuda",
                        "--dataset_dir", os.path.join(
                            HERE, "build", "chip_smoke_gpt2_data"),
                        "--num_epochs", str(TP_ROUNDS / spe), "--seed", "21",
                        "--multihost", "--num_processes",
                        str(args.num_processes), "--process_id",
                        str(args.process_id), "--coordinator_address",
                        f"127.0.0.1:{args.port}"])
    t0 = time.perf_counter()
    model, opt, sched, loader, _ = gpt2_train.build(
        cfg, HashTokenizer(GPT2_VOCAB), device="cuda",
        synthetic_examples=GPT2_CORPUS)
    built_s = time.perf_counter() - t0
    assert model.cfg.grad_size == GPT2_D, model.cfg.grad_size
    assert loader.dataset.seq_len == GPT2_L
    lay = model.layout
    batch, _ = load_batch(os.path.join(args.io, "tp_batch.npz"))
    sl = lay.local_row_slice(batch[2].shape[0])
    opt.param_groups[0]["lr"] = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grad = model.cohort_transmit((batch[0], tuple(d[sl] for d in batch[1]),
                                  batch[2][sl]))
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    if mh.is_coordinator():
        np.save(os.path.join(args.io, "tp_grad.npy"), grad.cpu().numpy())
    del grad
    res = timed_rank_run(model, lambda on_round: gpt2_train.train_gpt2(
        model, opt, sched, loader, model.cfg, logger=_Quiet(),
        on_round=on_round))
    l = res["launches"]
    return dict(res, layout=lay.ranks.tolist(), built_s=built_s,
                grad_s=grad_s, per_rank=per_rank(lay, model.device, [
                    res["peak"], l["flash_fwd"], l["sketch_encode"],
                    l["threshold_sample"], l["threshold_mask"],
                    sum(res["round_ms"][1:]) / max(len(res["round_ms"])
                                                   - 1, 1)]),
                equal=bool(ranks_bitwise_equal(model.ps_weights)))


def rank_main(args) -> int:
    """One rank of phases 37-38 (module docstring)."""
    sys.path.insert(0, HERE)
    from commefficient_tpu_torch.device import resolve_device
    from commefficient_tpu_torch.parallel import multihost as mh
    resolve_device("cuda")
    if args.num_processes > 0:
        mh.initialize(f"127.0.0.1:{args.port}", args.num_processes,
                      args.process_id, backend=args.backend, device="cuda")
    try:
        run = {"grid": grid_rank, "nccl1": grid_rank, "single": grid_rank,
               "nccl2": nccl2_rank, "tpgpt2": tp_rank}[args.rank]
        out = run(args, mh)
        if mh.is_coordinator():
            with open(os.path.join(args.io, f"{args.rank}.json"), "w") as f:
                json.dump(out, f)
    finally:
        mh.shutdown()
    return 0


def grid_rows(sc, CSVec) -> list:
    """K1 and K2 as each rank of phase 37 launches them: K1 on its
    block's [D] sum, K2 on the reduced [5, 500000] table, config #2's
    shapes."""
    dev = torch.device("cuda")
    sk = CSVec(d=MAIN_D, c=MAIN_C, r=MAIN_R)
    x = torch.randn(MAIN_D, generator=torch.Generator().manual_seed(37)
                    ).to(dev)
    off, eps, delta = sk.tables(dev)
    table = sk.encode(x)
    err_e = float((table - sc.encode_plain(x, off, delta, eps,
                                           sk.c)).abs().max())
    eps_bits, delta_bits = sk.sign_bits(dev)
    err_k = float((sc.estimate_all(table, off, delta_bits, eps_bits, sk.d)
                   - sc.estimate_all_plain(table, off, delta, eps,
                                           sk.d)).abs().max())
    if err_e or err_k:
        raise AssertionError(f"grid: K1/K2 differ from their plain versions "
                             f"({err_e}, {err_k})")
    rows = [encode_row(sc, sk, x, "sketch_encode_grid", "grid"),
            estimate_row(sc, sk, table, "sketch_estimate_all_grid", "grid")]
    return [timed_row(rows[0], err_e), timed_row(rows[1], err_k)]


def grid_phase(sc, CSVec, main_ms, keep, w, batch, tmp) -> dict:
    """Phase 37 (module docstring): returns rank 0's launches of the
    10-round run."""
    io = os.path.join(tmp, "grid")
    os.makedirs(io)
    save_batch(os.path.join(io, "grid_parity.npz"), batch,
               w=w.cpu().numpy())
    t0 = time.perf_counter()
    run_ranks("grid", "grid", GRID_RANKS, io)
    res = rank_result(io, "grid")
    phase("grid", f"{GRID_RANKS} ranks over gloo on {res['device']}, "
          f"layout {res['layout']}, {time.perf_counter() - t0:.1f} s with "
          "their start")
    # round one: the reduced table against phase 5's
    table = torch.from_numpy(np.load(os.path.join(io, "grid_table.npy")))
    t_err = _rel(table, keep["table"])
    g64, s64 = _rel(table, keep["table64"]), _rel(keep["table"],
                                                   keep["table64"])
    limit = ACCURACY_RATIO * max(s64, ACCURACY_FLOOR)
    from commefficient_tpu_torch.federated import server as fserver
    zeros = torch.zeros((MAIN_R, MAIN_C), device="cuda")
    upd = fserver.get_server_update(table.cuda(), zeros, zeros,
                                    keep["cfg"], 1.0)
    top = set(torch.nonzero(upd.update).reshape(-1).cpu().tolist())
    overlap = len(top & keep["top"]) / max(len(keep["top"]), 1)
    phase("grid", f"round one from phase 5's weights and batch: the "
          f"reduced table vs the one-process card table rel err "
          f"{t_err:.3e} (<= {PARITY_RTOL:g}); vs the float64 table: grid "
          f"{g64:.3e}, one process {s64:.3e} (grid <= {ACCURACY_RATIO:g} x "
          f"max(one process, {ACCURACY_FLOOR:g})); top-k overlap "
          f"{overlap:.5f} of {len(keep['top'])} (>= {TOPK_OVERLAP:g})")
    if not (t_err <= PARITY_RTOL and g64 <= limit
            and overlap >= TOPK_OVERLAP):
        raise AssertionError("grid: the reduced table disagrees with the "
                             "one-process round")
    want_up = MAIN_R * MAIN_C * 4
    ups = [u for rnd in res["uploads"] for u in rnd]
    losses = [v for rnd in res["losses"] for v in rnd]
    if not (res["ok"] and res["moved"] and res["equal"]
            and len(res["round_ms"]) == ROUNDS
            and all(math.isfinite(v) for v in losses)
            and ups and all(u == want_up for u in ups)):
        raise AssertionError(f"grid: the {ROUNDS}-round run failed its "
                             f"checks: ok {res['ok']}, moved "
                             f"{res['moved']}, ranks bitwise equal "
                             f"{res['equal']}, uploads {sorted(set(ups))}")
    for r, row in enumerate(res["per_rank"]):
        if row[1] != ROUNDS or row[2] != ROUNDS:
            raise AssertionError(f"grid: rank {r} launched K1 {row[1]:g} "
                                 f"and K2 {row[2]:g} times ({ROUNDS} each "
                                 "expected)")
    med = statistics.median
    col = res["collectives"]
    phase("grid", f"{ROUNDS} rounds: ps_weights bitwise equal on both "
          f"ranks; every upload {want_up} bytes; K1 and K2 {ROUNDS} times "
          "on each rank; mean client loss first/last "
          f"{statistics.mean(res['losses'][0]):.4f}/"
          f"{statistics.mean(res['losses'][-1]):.4f}")
    phase("grid", "ms/round (rank 0) " + " ".join(
        f"{t:.2f}" for t in res["round_ms"]) + f"; median (rounds 2-"
        f"{ROUNDS}) {med(res['round_ms'][1:]):.2f} beside config #2's "
        f"{med(main_ms[1:]):.2f} (phase 4); each rank's peak "
        + ", ".join(f"{row[0] / 2 ** 30:.3f}" for row in res["per_rank"])
        + " GiB; rank 0's collectives: " f"{col['calls']} calls, "
        f"{col['bytes'] / 2 ** 20:.1f} MiB, {1e3 * col['seconds']:.1f} ms "
        f"host ({1e3 * col['seconds'] / ROUNDS:.2f} ms a round, the eval's "
        "included)")

    # NCCL: two ranks on one card (expected to be refused), and beside
    # it a world of one rank and the one-process run, to be bitwise equal
    probe = start_ranks("nccl2", 2, io, backend="nccl")
    one_run = start_ranks("nccl1", 1, io, backend="nccl")
    single_run = start_ranks("single", 0, io)
    try:
        codes, texts = wait_ranks("grid", probe, timeout=120,
                                  expect_ok=False)
    except AssertionError as e:     # killed at its timeout
        codes, texts = str(e), []
    said = [ln.strip() for t in texts for ln in t.splitlines()
            if "uplicate" in ln or "Error" in ln or "nccl2:" in ln]
    phase("grid", f"nccl with two ranks on one card: exit codes {codes}; "
          f"it printed: {' | '.join(dict.fromkeys(said))[:600] or '(none)'}")
    wait_ranks("grid", one_run)
    wait_ranks("grid", single_run)
    one, single = rank_result(io, "nccl1"), rank_result(io, "single")
    wa = np.load(os.path.join(io, "nccl1_weights.npy"))
    wb = np.load(os.path.join(io, "single_weights.npy"))
    same = (np.array_equal(wa.view(np.uint32), wb.view(np.uint32))
            and one["uploads"] == single["uploads"])
    phase("grid", f"an NCCL world of one rank (layout {one['layout']}) vs "
          f"the one-process run, {NCCL1_ROUNDS} rounds each under "
          f"{' '.join(PLAN_NCCL1)}, deterministic: "
          f"weights and bytes bitwise equal {same}; NCCL collectives "
          f"{one['collectives']['calls']}; the plan transport's "
          f"{one['transport']['calls']} broadcasts on a gloo group of its "
          f"own ({one['gloo_group']}; the one process's "
          f"{single['transport']['calls']}); ms/round (the two runs side by "
          f"side on the card) {med(one['round_ms'][1:]):.2f} and "
          f"{med(single['round_ms'][1:]):.2f}")
    if not (same and one["gloo_group"]
            and one["transport"]["calls"] == NCCL1_ROUNDS):
        raise AssertionError("grid: the NCCL world of one rank differs "
                             "from the one-process run, or its plans did "
                             "not cross the transport's gloo group")
    # phases 40-41, from the grid's ranks
    plangrid_report(res["plangrid"], res)
    ring_report(res["ring"])
    return res["launches"]


def k4_tp_row(ac) -> dict:
    """K4 on one rank's [16, 6, L, 64] head views under --model_parallel
    2: its heads' columns of GPT2-small's fused projection, a [16, L,
    3 * 384] product (row stride 1152), against its plain version
    (K4_RTOL), timed with SDPA's time on the same views."""
    El = K4_TP_HEADS * K4_DH
    qkv = torch.randn(K4_BATCH, GPT2_L, 3 * El,
                      generator=torch.Generator().manual_seed(38)
                      ).to("cuda")
    q, k, v = (t.reshape(K4_BATCH, GPT2_L, K4_TP_HEADS, K4_DH).transpose(1, 2)
               for t in qkv.split(El, dim=-1))
    o, lse = ac.flash_fwd(q, k, v, 0.125)
    po, plse = ac.flash_fwd_plain(q, k, v, 0.125)
    torch.cuda.synchronize()
    e_o = float((o - po).abs().max())
    e_l = float((lse - plse).abs().max())
    if not (e_o <= K4_RTOL * float(po.abs().max())
            and e_l <= K4_RTOL * float(plse.abs().max())):
        raise AssertionError(f"flash_fwd differs from its plain version on "
                             f"the 6-head views: o {e_o}, lse {e_l}")
    phase("tpgpt2", f"[{K4_BATCH}, {K4_TP_HEADS}, {GPT2_L}, {K4_DH}] head "
          f"views of a rank's fused QKV columns: K4 within {K4_RTOL:g} of "
          f"its plain version (max abs err o {e_o:.3e}, lse {e_l:.3e})")
    return timed_row(dict(
        name="flash_fwd_tp", counter="flash_fwd", path="tpgpt2",
        route="cuda", source="commefficient_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="commefficient_tpu/ops/attention.py:91",
        fn=lambda: ac.flash_fwd(q, k, v, 0.125),
        plain=lambda: ac.flash_fwd_plain(q, k, v, 0.125),
        library=sdpa_efficient(ac, q, k, v), cost=ac.flash_fwd_cost(q),
        peak_flops=PEAK_TF32_FLOPS),
        max(e_o, e_l))


def tpgpt2_phase(gpt2_train, parse_args, HashTokenizer, fserver, g_ms,
                 g_peak, tmp) -> dict:
    """Phase 38 (module docstring): returns rank 0's launches."""
    io = os.path.join(tmp, "tpgpt2")
    os.makedirs(io)
    spe = math.ceil(math.prod(GPT2_CORPUS) / (8 * 8))
    cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=CONFIG5 + [
        "--remat", "--local_batch_size", "8", "--device", "cuda",
        "--dataset_dir", os.path.join(HERE, "build", "chip_smoke_gpt2_data"),
        "--num_epochs", str(TP_ROUNDS / spe), "--seed", "21"])
    model, opt, _, loader, _ = gpt2_train.build(
        cfg, HashTokenizer(GPT2_VOCAB), device="cuda",
        synthetic_examples=GPT2_CORPUS)
    batch = next(iter(loader.epoch()))
    save_batch(os.path.join(io, "tp_batch.npz"), batch)
    opt.param_groups[0]["lr"] = 0.0
    g1 = model.cohort_transmit(batch).cpu()
    count = float(np.asarray(batch[2]).sum())
    m_cfg = model.cfg
    sketch = fserver.args2sketch(m_cfg)
    zeros = torch.zeros(sketch.table_shape, device="cuda")

    def selected(g):
        upd = fserver.get_server_update(sketch.encode(g.cuda()) / count,
                                        zeros, zeros, m_cfg, 1.0)
        return set(torch.nonzero(upd.update).reshape(-1).cpu().tolist())

    top1 = selected(g1)
    losses1 = np.asarray(model(batch)[0].cpu(), np.float64)
    del model, opt, loader, batch
    gc.collect()
    torch.cuda.empty_cache()
    phase("tpgpt2", f"the one-process reference (--model_parallel 1 "
          f"--remat, seed 21): round one's cohort gradient, {len(top1)} "
          "coordinates selected, losses; starting 2 ranks")
    t0 = time.perf_counter()
    _, texts = run_ranks("tpgpt2", "tpgpt2", 2, io)
    res = rank_result(io, "tpgpt2")
    said = [ln.strip() for ln in texts[0].splitlines()
            if ln.startswith("tensor parallel")]
    phase("tpgpt2", f"2 ranks over gloo, layout {res['layout']} "
          f"({'; '.join(said) or 'no TP line'}), {time.perf_counter() - t0:.1f}"
          f" s with their start, the build {res['built_s']:.1f} s, the "
          f"gradient probe {res['grad_s']:.1f} s")
    g2 = torch.from_numpy(np.load(os.path.join(io, "tp_grad.npy")))
    g_err = _rel(g2, g1)
    top2 = selected(g2)
    overlap = len(top1 & top2) / max(len(top1), 1)
    l_tp = np.asarray(res["losses"][0], np.float64)
    l_err = float(np.max(np.abs(l_tp - losses1) / np.abs(losses1)))
    phase("tpgpt2", f"round one vs the one process: losses max rel err "
          f"{l_err:.3e} (<= {TP_LOSS_RTOL:g}); cohort gradient rel err "
          f"{g_err:.3e} (<= {GPT2_PARITY_RTOL:g}); threshold selections "
          f"share {overlap:.5f} of {len(top1)} (>= {TOPK_OVERLAP:g}; TP "
          f"selected {len(top2)})")
    if not (l_err <= TP_LOSS_RTOL and g_err <= GPT2_PARITY_RTOL
            and overlap >= TOPK_OVERLAP):
        raise AssertionError("tpgpt2: tensor parallelism disagrees with the "
                             "one-process round")
    losses = [v for rnd in res["losses"] for v in rnd]
    if not (res["ok"] and res["moved"] and res["equal"]
            and len(res["round_ms"]) == TP_ROUNDS
            and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"tpgpt2: the run failed its checks: ok "
                             f"{res['ok']}, moved {res['moved']}, ranks "
                             f"bitwise equal {res['equal']}")
    want = [2 * 12 * 8 * TP_ROUNDS, 2 * TP_ROUNDS, TP_ROUNDS, TP_ROUNDS]
    for r, row in enumerate(res["per_rank"]):
        if row[1:5] != want:
            raise AssertionError(f"tpgpt2: rank {r} launched K4, K1, K3a, "
                                 f"K3b {row[1:5]} times ({want} expected)")
    med = statistics.median
    col = res["collectives"]
    phase("tpgpt2", f"{TP_ROUNDS} rounds: ps_weights bitwise equal on both "
          f"ranks; on each rank K4 {want[0]} (2 x 12 layers x 8, --remat), "
          f"K1 {want[1]}, K3a and K3b {want[2]}; ms/round (rank 0) "
          + " ".join(f"{t:.2f}" for t in res["round_ms"])
          + (" (phase 7 not run)" if g_ms is None else
             f" beside config #5's median {med(g_ms[1:]):.2f} (phase 7, "
             f"one process, no remat)") + "; each rank's peak "
          + ", ".join(f"{row[0] / 2 ** 30:.3f}" for row in res["per_rank"])
          + (" GiB" if g_peak is None else
             f" GiB beside phase 7's {g_peak / 2 ** 30:.3f}") + "; rank 0's "
          f"collectives {col['calls']} calls, {col['bytes'] / 2 ** 30:.2f} "
          f"GiB, {col['seconds']:.2f} s host over the {TP_ROUNDS} rounds")
    return res["launches"]


# ---------------- item 9g's rest: phases 39-41 ------------------------------

# phase 39: config #2 under the emulated plan transport (3 controllers in
# the process) against the one controller, on phase 32's scripted clock;
# then the takeover drill: TAKEOVER_ROUNDS rounds, a checkpoint after
# round 1, the coordinator killed broadcasting round TAKEOVER_CRASH,
# controller 1 promoted and resumed from the journal
PLAN = ["--sampler", "throughput"]
PLAN_EMULATED = PLAN + ["--plan_transport", "emulated",
                        "--plan_controllers", "3"]
TAKEOVER_ROUNDS = 6
TAKEOVER_CRASH = 4
TAKEOVER_LR = 0.05
# phase 40: the grid's second leg; phase 37's NCCL world of one rank and
# its one-process twin take the collective transport with a plan a
# round (a survivor target of all 8 slots changes nothing)
PLAN_GRID = PLAN + ["--plan_transport", "collective"]
PLAN_NCCL1 = ["--target_survivors", "8", "--plan_transport", "collective"]
# phase 41: ring attention on GPT2-small's head views, the sequence
# split over the grid's two ranks; the gradients within tests/
# test_ring.py's limit, relative to the largest
RING_L = 1024
RING_GRAD_RTOL = 2e-4

# phase 42: config #2 through the paths that own threads (the journal
# writer, the staging thread, the spill writer): phase 34's host tier
# in its pipelined spans of 2 (a span's 2 x 8 clients fill the working
# set of 16), without checkpoints (a tiered checkpoint carries every
# touched client's D-float row: gigabytes a save at full width). Config
# #2 keeps no client rows, so the tier would hold nothing: the download
# top-k (--topk_down) gives each client a stale weight row for the tier
# to spill and restore; the round still encodes once (K1) and decodes
# once (K2)
ANALYSIS = (["--scan_rounds", "--scan_span", "2", "--pipeline"] + TIER
            + ["--topk_down", "--down_k", "50000"])


def _plan_session(model, jpath=None):
    """A telemetry session on phase 32's scripted clock (and a journal
    at `jpath`), attached to `model`."""
    from commefficient_tpu_torch.telemetry import (
        RunJournal, TelemetrySession,
    )
    tele = TelemetrySession(
        journal=None if jpath is None else RunJournal(jpath),
        tracker=model.throughput,
        clock=lambda: scripted_time(model.server.round_idx))
    model.attach_telemetry(tele)
    return tele


def _drive_plan(model, loader, total, start=0, save_after=None,
                prefix=None):
    """The drill's loop (tests/test_torch_plantransport.py's): begin_epoch,
    the loader's stream, a round each at TAKEOVER_LR; after round
    `save_after` the session's one-round-late buffer flushed, as the
    drivers flush it before an epoch's checkpoint (a flushed round feeds
    the tracker nothing), and with a `prefix` a rotated save of the
    whole run state. Returns the rounds' client ids."""
    from commefficient_tpu_torch.utils.checkpoint import save_rotating
    model._optimizer.param_groups[0]["lr"] = TAKEOVER_LR
    done, ids_log = start, []
    while done < total:
        model.scheduler.begin_epoch(done)
        for ids, data, mask in loader.epoch():
            model((ids, data, mask))
            ids_log.append(np.asarray(ids).copy())
            done += 1
            if save_after is not None and done == save_after + 1:
                model.telemetry.flush()
            if prefix is not None and done == save_after + 1:
                save_rotating(
                    prefix, model.server, model.clients, scheduler_step=0,
                    accountant=model.accountant,
                    prev_change_words=model._prev_change_words,
                    fingerprint=model.checkpoint_fingerprint,
                    throughput=model.throughput.state_dict(),
                    scheduler=model.scheduler_state(),
                    sampler=model.sampler_state(),
                    async_admit=model.async_admit_state(),
                    client_rows=model.client_rows_payload())
            if done >= total:
                break
    torch.cuda.synchronize()
    return ids_log


def plan_phase(sc, ac, cv_train, parse_args, data_dir, main_ms, tmp):
    """Phase 39 (header): returns the transport run's launches."""
    from commefficient_tpu_torch.parallel.plantransport import (
        attach_emulated_cluster,
    )
    from commefficient_tpu_torch.utils.checkpoint import load_latest
    from commefficient_tpu_torch.utils.faults import (
        FaultSchedule, InjectedFault,
    )
    os.makedirs(os.path.join(tmp, "ckpt"), exist_ok=True)
    med = statistics.median
    runs = {}
    with Deterministic():
        for label, flags in (("single", PLAN), ("emulated", PLAN_EMULATED)):
            model, rr, _ = config2_variant(
                "plan", sc, ac, cv_train, parse_args, data_dir, flags,
                setup=_plan_session)
            model.telemetry.close(ok=True)
            check_launches("plan", rr.launches,
                           {"sketch_encode": ROUNDS,
                            "sketch_estimate_all": ROUNDS})
            runs[label] = (model.ps_weights.cpu(), rr, model.scheduler)
            del model
            torch.cuda.empty_cache()
    (w1, rr1, _), (w3, rr3, mirror) = runs["single"], runs["emulated"]
    net = mirror.transports[0].network
    delivered = {r: net.deliveries.get(r) for r in range(ROUNDS)}
    same = torch.equal(w1, w3)
    if not same or any(v != 1 for v in delivered.values()):
        raise AssertionError(f"plan: 3 controllers bitwise the one {same}; "
                             f"deliveries {delivered}")
    phase("plan", f"config #2, {ROUNDS} rounds under {' '.join(PLAN)}, "
          "deterministic, scripted clock: 3 emulated controllers bitwise the "
          f"one controller; every round broadcast once; K1 and K2 {ROUNDS} "
          f"times each; median ms/round {med(rr3.round_ms[1:]):.2f} (3 "
          f"controllers) and {med(rr1.round_ms[1:]):.2f} (one) beside config "
          f"#2's {med(main_ms[1:]):.2f} (phase 4)")
    launches = rr3.launches
    del runs, mirror, net

    # the takeover drill
    jpath = os.path.join(tmp, "takeover.jsonl")
    prefix = os.path.join(tmp, "ckpt", "ResNet9")
    with Deterministic():
        model_a, _, _, loader_a, _ = config2_build(
            cv_train, parse_args, data_dir, PLAN_EMULATED, TAKEOVER_ROUNDS)
        tele = _plan_session(model_a)
        ids_a = _drive_plan(model_a, loader_a, TAKEOVER_ROUNDS, save_after=1)
        tele.close(ok=True)
        w_a = model_a.ps_weights.cpu()
        del model_a, loader_a
        torch.cuda.empty_cache()

        model_b, _, _, loader_b, _ = config2_build(
            cv_train, parse_args, data_dir, PLAN_EMULATED, TAKEOVER_ROUNDS)
        net = model_b.scheduler.transports[0].network
        net.schedule = FaultSchedule(coordinator_crash_at=TAKEOVER_CRASH)
        tele = _plan_session(model_b, jpath)
        try:
            _drive_plan(model_b, loader_b, TAKEOVER_ROUNDS, save_after=1,
                        prefix=prefix)
            raise AssertionError("plan: the coordinator did not crash")
        except InjectedFault as e:
            crashed = e.round_idx
        t_crash = time.perf_counter()
        tele.close(ok=False)
        del model_b, loader_b
        torch.cuda.empty_cache()

        promoted = net.promote()
        net.schedule = None
        model_c, _, _, loader_c, _ = config2_build(
            cv_train, parse_args, data_dir, PLAN_EMULATED, TAKEOVER_ROUNDS)
        attach_emulated_cluster(model_c, loader_c, network=net)
        ckpt = load_latest(prefix,
                           expect_fingerprint=model_c.checkpoint_fingerprint)
        model_c.load_state(ckpt)
        model_c.load_plan_stream(jpath)
        done = int(ckpt.server.round_idx)
        replay = sorted(model_c._replay_digests)
        tele = _plan_session(model_c)
        t_ready = time.perf_counter()
        ids_c = _drive_plan(model_c, loader_c, TAKEOVER_ROUNDS, start=done)
        t_done = time.perf_counter()
        tele.close(ok=True)
    left = sorted(model_c._replay_digests)
    same = (torch.equal(model_c.ps_weights.cpu(), w_a)
            and all(np.array_equal(a, c) for a, c in zip(ids_a[done:],
                                                         ids_c)))
    if not (crashed == TAKEOVER_CRASH - 1 and promoted == 1 and done == 2
            and {2, 3} <= set(replay) and not {2, 3} & set(left)
            and same):
        raise AssertionError(
            f"plan: takeover crashed after {crashed}, promoted {promoted}, "
            f"resumed at {done}, replayed {replay} (left {left}), bitwise "
            f"{same}")
    phase("plan", f"takeover drill, {TAKEOVER_ROUNDS} rounds: a checkpoint "
          f"after round 1, the coordinator killed broadcasting round "
          f"{TAKEOVER_CRASH} (InjectedFault after round {crashed}); "
          f"controller {promoted} promoted, resumed at round {done}, the "
          f"journaled plans of rounds {sorted(set(replay) - set(left))} "
          "replayed and their digests consumed: weights and client ids "
          "bitwise the uninterrupted run; "
          f"takeover {t_ready - t_crash:.2f} s wall (promote, build, "
          f"checkpoint, plan stream), replay and rest "
          f"{t_done - t_ready:.2f} s")
    del model_c, loader_c
    torch.cuda.empty_cache()
    return launches


def plangrid_rank_leg(args, mh, cv_train, parse_args) -> dict:
    """Phase 40 on a grid rank: config #2 under PLAN_GRID on the ranks of
    phase 37, the tracker fed each rank's own wall clock."""
    from commefficient_tpu_torch.parallel.mh_worker import ranks_bitwise_equal
    from commefficient_tpu_torch.telemetry import TelemetrySession
    model, opt, sched, loader, val = config2_build(
        cv_train, parse_args, os.path.join(HERE, "build", "chip_smoke_data"),
        PLAN_GRID + _rank_flags(args), ROUNDS)
    model.attach_telemetry(TelemetrySession(tracker=model.throughput))
    t = model.plan_transport
    t.stats.reset()
    res = timed_rank_run(model, lambda on_round: cv_train.train(
        model, opt, sched, loader, val, model.cfg, on_round=on_round))
    l = res["launches"]
    tr = t.stats.as_dict()
    res.update(transport=tr, per_rank=per_rank(model.layout, model.device, [
        tr["calls"], tr["bytes"], tr["seconds"], l["sketch_encode"],
        l["sketch_estimate_all"]]),
        equal=bool(ranks_bitwise_equal(model.ps_weights)),
        gloo_group=t.group is not None)
    del model, opt, sched, loader, val
    torch.cuda.empty_cache()
    return res


def ring_rank_leg(args, mh) -> dict:
    """Phase 41 on a grid rank: ring attention over the two ranks on
    [16, 12, RING_L, 64] head views (this rank's chunk of RING_L // 2),
    against K4 on the whole sequence and autograd of the plain reference
    on the card."""
    import torch.distributed as dist

    from commefficient_tpu_torch.ops.attention import reference_attention
    from commefficient_tpu_torch.ops.kernels import attention_cuda as ac
    from commefficient_tpu_torch.parallel.ring import SeqRing, ring_attention
    n, me = mh.process_count(), mh.process_index()
    ring = SeqRing(range(n)).bind()
    shape = (K4_BATCH, RING_L, 3 * K4_HEADS * K4_DH)
    qkv = torch.randn(*shape, generator=torch.Generator().manual_seed(41)
                      ).to("cuda")
    q, k, v = (t.reshape(K4_BATCH, RING_L, K4_HEADS, K4_DH).transpose(1, 2)
               for t in qkv.split(K4_HEADS * K4_DH, dim=-1))
    lc = RING_L // n
    chunk = slice(me * lc, (me + 1) * lc)
    qc, kc, vc = (t[:, :, chunk].detach().clone().requires_grad_(True)
                  for t in (q, k, v))
    o_k4, _ = ac.flash_fwd(q, k, v, 0.125)
    out = ring_attention(qc, kc, vc, ring, sm_scale=0.125)
    torch.cuda.synchronize()
    want = o_k4[:, :, chunk]
    e_fwd = float((out.detach() - want).abs().max())
    fwd_ok = e_fwd <= K4_RTOL * float(want.abs().max())
    (out ** 2).sum().backward()
    qf, kf, vf = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    (reference_attention(qf, kf, vf, sm_scale=0.125) ** 2).sum().backward()
    e_grad = []
    for got, ref in zip((qc, kc, vc), (qf, kf, vf)):
        w = ref.grad[:, :, chunk]
        e_grad.append(float((got.grad - w).abs().max())
                      / float(w.abs().max()))
    del qf, kf, vf
    ring.stats.reset()

    def fwd():
        with torch.no_grad():
            ring_attention(qc, kc, vc, ring, sm_scale=0.125)

    def fwd_bwd():
        qc.grad = kc.grad = vc.grad = None
        (ring_attention(qc, kc, vc, ring, sm_scale=0.125) ** 2
         ).sum().backward()

    times = {}
    for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        fn()
        dist.barrier(group=ring.group)
        torch.cuda.synchronize()
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        times[name] = statistics.median(ms)
    rot = ring.stats.as_dict()
    # the fold alone: this rank's two chunk folds without the rotation
    with torch.no_grad():
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ring_attention(qc, kc, vc, None, sm_scale=0.125)
            ring_attention(qc, kc, vc, None, sm_scale=0.125)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
    rows = torch.tensor([[float(fwd_ok), e_fwd, *e_grad, times["fwd"],
                          times["fwd_bwd"], statistics.median(ms)]],
                        dtype=torch.float64)
    allr = torch.zeros((n, rows.shape[1]), dtype=torch.float64)
    allr[me] = rows[0]
    dist.all_reduce(allr, group=ring.group)
    return dict(per_rank=allr.tolist(), mode=ring._mode(kc),
                chunk_bytes=kc.numel() * kc.element_size(),
                rotations=rot, calls=12)


def plangrid_report(res, grid_res) -> None:
    """Phase 40's lines (rank 0's results), beside phase 37's run."""
    med = statistics.median
    rows = res["per_rank"]
    if not (res["ok"] and res["moved"] and res["equal"]
            and len(res["round_ms"]) == ROUNDS
            and all(row[0] == 3 * ROUNDS and row[3] == ROUNDS
                    and row[4] == ROUNDS for row in rows)):
        raise AssertionError(f"plangrid: ok {res['ok']}, moved "
                             f"{res['moved']}, ranks bitwise equal "
                             f"{res['equal']}, per rank {rows}")
    tr, col = res["transport"], res["collectives"]
    gcol = grid_res["collectives"]
    phase("plangrid", f"config #2 on {GRID_RANKS} ranks, {ROUNDS} rounds "
          f"under {' '.join(PLAN_GRID)}: ps_weights bitwise equal on both "
          "ranks; on each, a plan broadcast and a plan and an install digest "
          f"gathered every round ({3 * ROUNDS} transport calls), K1 and K2 "
          f"{ROUNDS} times; gloo group of its own: {res['gloo_group']}")
    phase("plangrid", f"transport (rank 0): {tr['calls'] / ROUNDS:.0f} calls, "
          f"{tr['bytes'] / ROUNDS / 2 ** 20:.3f} MiB, "
          f"{1e3 * tr['seconds'] / ROUNDS:.2f} ms host a round (rank 1 "
          f"{1e3 * rows[1][2] / ROUNDS:.2f}); the round's own collectives "
          f"{col['calls'] / ROUNDS:.1f} calls, "
          f"{col['bytes'] / ROUNDS / 2 ** 20:.1f} MiB, "
          f"{1e3 * col['seconds'] / ROUNDS:.2f} ms a round (phase 37's "
          f"{1e3 * gcol['seconds'] / ROUNDS:.2f}); ms/round (rank 0) median "
          f"{med(res['round_ms'][1:]):.2f} beside phase 37's "
          f"{med(grid_res['round_ms'][1:]):.2f}")


def ring_report(res) -> None:
    """Phase 41's lines."""
    rows = res["per_rank"]
    ok = all(row[0] == 1.0 and max(row[2:5]) <= RING_GRAD_RTOL
             for row in rows)
    rot = res["rotations"]
    phase("ring", f"[{K4_BATCH}, {K4_HEADS}, {RING_L}, {K4_DH}] over "
          f"{len(rows)} ranks ({RING_L // len(rows)} positions a rank, "
          f"rotation by {res['mode']}): forward vs K4 on the whole sequence "
          "max abs err " + ", ".join(f"{row[1]:.3e}" for row in rows)
          + f" (<= {K4_RTOL:g} of the largest); gradients vs autograd of the "
          "plain reference, relative to the largest, "
          + "; ".join("/".join(f"{v:.2e}" for v in row[2:5]) for row in rows)
          + f" (<= {RING_GRAD_RTOL:g})")
    phase("ring", "ms a call (rank 0, rank 1): forward "
          + ", ".join(f"{row[5]:.2f}" for row in rows) + "; forward and "
          "backward " + ", ".join(f"{row[6]:.2f}" for row in rows)
          + "; this rank's two folds alone, no rotation "
          + ", ".join(f"{row[7]:.2f}" for row in rows)
          + f"; rotated over the {res['calls']} calls (2 of them warm-up): "
          f"{rot['calls']} collectives, {rot['bytes'] / 2 ** 20:.1f} MiB, "
          f"{rot['seconds']:.2f} s host (rank 0); a chunk of k or v "
          f"{res['chunk_bytes'] / 2 ** 20:.1f} MiB")
    if not ok:
        raise AssertionError(f"ring: a rank failed its checks: {rows}")


def analysis_phase(sc, ac, cv_train, parse_args, data_dir, main_ms, tmp
                   ) -> None:
    """Phase 42 (header): the sanitized run, then its unsanitized twin,
    then the lint and the sync audit over the checkout."""
    from commefficient_tpu_torch.analysis import runtime, syncaudit
    from commefficient_tpu_torch.analysis.engine import lint_paths
    from commefficient_tpu_torch.telemetry.journal import (
        summarize, validate_journal,
    )
    t_phase = time.perf_counter()
    med = statistics.median
    runs = {}

    def run(label, sanitized):
        jpath = os.path.join(tmp, f"{label}.jsonl")
        ck = os.path.join(tmp, label)
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if sanitized:
                locks = stack.enter_context(runtime.LockOrderSanitizer())
                stack.enter_context(runtime.interleaving_stress())
                num = stack.enter_context(runtime.NumericSanitizer())
            # the model and its writers inside the sanitizers: only
            # locks built after install are instrumented
            model, opt, sched, loader, val = config2_build(
                cv_train, parse_args, data_dir, ANALYSIS + [
                    "--checkpoint_path", ck, "--journal_path", jpath])
            # cv_train's epoch row: its byte totals, summed from the
            # accountant's per-round charges
            rows = _Rows()
            rr = drive_rounds(label, sc, ac, model, loader, ROUNDS,
                              lambda timed, on_round: cv_train.run(
                                  model, opt, sched, timed, val, model.cfg,
                                  ck, loggers=(rows,), on_round=on_round))
            store = model.state_store
            spills = (store.spills, store.restores)
            model.close_persistence()
            wall = time.perf_counter() - t0
        check_launches(label, rr.launches, {"sketch_encode": ROUNDS,
                                            "sketch_estimate_all": ROUNDS})
        if not spills[0]:
            raise AssertionError(f"{label}: the tier never spilled")
        recs, problems = validate_journal(jpath)
        if problems:
            raise AssertionError(f"{label}: journal problems {problems}")
        summary = summarize(recs)
        per_round = [(r["down_bytes"], r["up_bytes"]) for r in recs
                     if r["event"] == "round"]
        end = [r for r in recs if r["event"] == "run_end"][-1]
        down, up = (rows.rows[-1]["down (MiB)"] * 2 ** 20,
                    rows.rows[-1]["up (MiB)"] * 2 ** 20)
        journaled = (sum(d for d, _ in per_round),
                     sum(u for _, u in per_round))
        if (summary["rounds"] != ROUNDS or journaled != (down, up)
                or (end["down_bytes_total"], end["up_bytes_total"])
                != (down, up)
                or (summary["down_mib"], summary["up_mib"])
                != (round(down / 2 ** 20, 3), round(up / 2 ** 20, 3))):
            raise AssertionError(
                f"{label}: the journal's {summary['rounds']} rounds and "
                f"bytes {journaled} (run_end {end['down_bytes_total']}, "
                f"{end['up_bytes_total']}) against the accountant's "
                f"{ROUNDS} rounds and {(down, up)}")
        out = {"w": model.ps_weights.detach().cpu(), "rr": rr,
               "wall": wall, "spills": spills, "jpath": jpath,
               "bytes": (down, up)}
        if sanitized:
            locks.assert_acyclic()
            if num.checked < ROUNDS:
                raise AssertionError(f"{label}: the numeric guard saw "
                                     f"{num.checked} metric vectors")
            out.update(edges=len(locks.edges()), locks=locks.locks,
                       checked=num.checked)
        runs[label] = out
        del model, opt, loader, val, store
        torch.cuda.empty_cache()

    with Deterministic():
        run("analysis_sanitized", True)
        run("analysis_plain", False)
    plain, san = runs["analysis_plain"], runs["analysis_sanitized"]
    if not torch.equal(san["w"], plain["w"]):
        raise AssertionError("analysis: the sanitized run's weights differ "
                             "from the unsanitized twin's")
    phase("analysis", f"{' '.join(ANALYSIS)}, {ROUNDS} rounds: lock graph "
          f"acyclic ({san['edges']} edges over {san['locks']} "
          f"instrumented locks), the numeric guard checked "
          f"{san['checked']} metric vectors, weights bitwise the "
          f"unsanitized twin's, K1 and K2 {ROUNDS} each in both runs; "
          f"{san['spills'][0]} spills, {san['spills'][1]} restores; "
          f"journals valid, {ROUNDS} rounds and {san['bytes'][0]:.0f} / "
          f"{san['bytes'][1]:.0f} bytes down / up, the accountant's")
    # spans collect their rounds together: means, not medians
    mean = statistics.mean
    phase("analysis", f"ms/round, the mean over all {ROUNDS} rounds (over "
          f"rounds 2-{ROUNDS}): sanitized {mean(san['rr'].round_ms):.2f} "
          f"({mean(san['rr'].round_ms[1:]):.2f}), then its unsanitized "
          f"twin {mean(plain['rr'].round_ms):.2f} "
          f"({mean(plain['rr'].round_ms[1:]):.2f}); phase 4's median "
          f"{med(main_ms[1:]):.2f}; each run's wall, build to writers "
          f"closed: {san['wall']:.2f} s sanitized, {plain['wall']:.2f} s "
          "unsanitized")
    t0 = time.perf_counter()
    lint = lint_paths([os.path.join(HERE, "commefficient_tpu_torch")])
    report, findings = syncaudit.run_sync_audit(
        [os.path.join(HERE, p) for p in syncaudit.DEFAULT_PATHS])
    syncaudit.journal_digest(san["jpath"], report, len(findings))
    recs, problems = validate_journal(san["jpath"])
    if lint or findings or problems or summarize(recs)[
            "analysis_digests"]["sync_audit_digest"] != report["digest"]:
        raise AssertionError(
            f"analysis: lint {[v.render() for v in lint]}, sync "
            f"{[v.render() for v in findings]}, journal {problems}")
    phase("analysis", f"graftlint: {len(lint)} findings; graftsync: "
          f"{len(findings)} findings over {report['files_scanned']} files, "
          f"{report['registry']['ordering_edges']} ordering edges, digest "
          f"{report['digest'][:12]} journaled and validated; "
          f"{time.perf_counter() - t0:.2f} s; the phase "
          f"{time.perf_counter() - t_phase:.1f} s")


AUDIT_GPT2_ROUNDS = 3       # the first exempt from the guard


class _Guards:
    """Captures the guards the drivers build (runtime.forbid_transfers,
    looked up at each round) so a phase can read their counts. A guard
    raises on the first implicit sync, so a run that ends had none."""

    def __init__(self):
        self.made = []

    def __enter__(self):
        from commefficient_tpu_torch.analysis import runtime
        self.runtime = runtime
        self.orig = runtime.forbid_transfers

        def make(device="cuda"):
            g = self.orig(device)
            self.made.append(g)
            return g

        runtime.forbid_transfers = make
        return self

    def __exit__(self, *exc):
        self.runtime.forbid_transfers = self.orig
        return False

    def explicit(self) -> dict:
        out = {}
        for g in self.made:
            for reason, n in g.explicit.items():
                out[reason] = out.get(reason, 0) + n
        return out


def audit_phase(sc, ac, cv_train, gpt2_train, parse_args, HashTokenizer,
                data_dir, gpt2_dir, main_ms, kernels) -> None:
    """Phase 43 (header); `kernels` the kernels line's timed rows."""
    from commefficient_tpu_torch.analysis import audit, numaudit
    from commefficient_tpu_torch.analysis.costmodel import records_cost
    from commefficient_tpu_torch.analysis.recorder import RoundRecorder
    t_phase = time.perf_counter()
    med = statistics.median

    # (a) the guard on config #2 at full width, and its unguarded twin
    runs = {}
    with Deterministic():
        for label, extra in (("audit_guard", ["--debug_transfer_guard"]),
                             ("audit_twin", [])):
            with _Guards() as guards:
                model, rr, loader = config2_variant(
                    label, sc, ac, cv_train, parse_args, data_dir, extra)
            check_launches(label, rr.launches,
                           {"sketch_encode": ROUNDS,
                            "sketch_estimate_all": ROUNDS})
            runs[label] = dict(
                w=model.ps_weights.detach().cpu(), rr=rr, guards=guards,
                bytes=[u.tolist() for u in rr.uploads],
                acct=model.accountant.state_dict())
            if label == "audit_guard":
                rec_model, rec_loader = model, loader
            else:
                del model
    g, t = runs["audit_guard"], runs["audit_twin"]
    if len(g["guards"].made) != ROUNDS - 1:
        raise AssertionError(f"audit: {len(g['guards'].made)} guarded "
                             f"rounds (want {ROUNDS - 1})")
    if t["guards"].made:
        raise AssertionError("audit: the twin armed a guard")
    same_acct = all(np.array_equal(np.asarray(g["acct"][k]),
                                   np.asarray(t["acct"][k]))
                    for k in t["acct"])
    if not (torch.equal(g["w"], t["w"]) and g["bytes"] == t["bytes"]
            and same_acct and set(g["acct"]) == set(t["acct"])):
        raise AssertionError("audit: the guarded run's weights or billed "
                             "bytes differ from its unguarded twin's")
    per_round = {k: v / (ROUNDS - 1)
                 for k, v in sorted(g["guards"].explicit().items())}
    phase("audit", f"(a) config #2, {ROUNDS} rounds, rounds 2-{ROUNDS} "
          f"under --debug_transfer_guard: 0 implicit syncs; weights, "
          f"every round's billed upload bytes and the accountant bitwise "
          f"the unguarded twin's; explicit boundaries a round: "
          + "; ".join(f"{k}: {v:g}" for k, v in per_round.items()))
    phase("audit", f"(a) ms/round median (rounds 2-{ROUNDS}): guarded "
          f"{med(g['rr'].round_ms[1:]):.2f}, unguarded twin "
          f"{med(t['rr'].round_ms[1:]):.2f}; phase 4's "
          f"{med(main_ms[1:]):.2f}")

    # (b) one steady-state round of config #2 under the recorder, beside
    # the same kind of round unrecorded
    model = rec_model
    batches = iter(rec_loader.epoch())
    times, recs = {}, {}
    # the first recorded round pays the mode's one-time set-up; the
    # profiler over all threads (`foreign`) has its own cost
    for label in ("warm", "plain", "recorded", "plain2", "foreign"):
        client_ids, data, mask = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (RoundRecorder(count_foreign=label == "foreign")
              if label in ("warm", "recorded", "foreign")
              else contextlib.nullcontext()) as r:
            model((client_ids, data, mask))
            torch.cuda.synchronize()
        times[label] = 1e3 * (time.perf_counter() - t0)
        recs[label] = r
    rec = recs["recorded"]
    staged = [r for r in rec.records if r.stage is not None]
    cost = records_cost(staged)
    kern = {k.name: k for k in rec.kernels()}
    counts = {}
    for k in rec.kernels():
        counts[k.name] = counts.get(k.name, 0) + 1
    if counts != {"sketch_encode": 1, "sketch_estimate_all": 1}:
        raise AssertionError(f"audit: kernel entries {counts}")
    # the entries against the bytes and operations the kernels line's
    # config #2 rows divide by
    bound = {k["name"]: (k["bytes"], k["ops"]) for k in kernels
             if k["path"] == "config2"}
    got = {name: (e.bytes, e.flops) for name, e in kern.items()}
    if got != bound:
        raise AssertionError(f"audit: kernel entries {got} against the "
                             f"kernels line's config #2 rows {bound}")
    nondet = sorted({f.message.split("`")[1]
                     for f in numaudit.determinism_findings(
                         "config2", staged, names=rec.names)})
    phase("audit", f"(b) one steady-state config #2 round recorded: "
          f"{len(rec.ops())} aten ops ({len(staged)} in the train round's "
          f"stages, {sum(r.allocates for r in staged)} allocating), "
          f"{cost.flops / 1e9:.3f} GFLOP and {cost.hbm_bytes / 1e9:.3f} GB "
          f"un-fused (costmodel); K1 {kern['sketch_encode'].bytes} bytes "
          f"({kern['sketch_encode'].bytes / PEAK_BYTES_PER_S * 1e3:.4f} "
          f"ms at 3.35 TB/s), K2 {kern['sketch_estimate_all'].bytes} "
          f"bytes ({kern['sketch_estimate_all'].bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms); "
          f"top ops by FLOPs {list(cost.as_dict(4)['by_primitive'])}")
    phase("audit", f"(b) NU004, not bitwise reproducible on the card "
          f"without deterministic algorithms: {nondet}; other threads' "
          f"aten ops while armed: {recs['foreign'].foreign_ops}; the "
          f"round {times['recorded']:.2f} ms recorded against "
          f"{times['plain']:.2f} / {times['plain2']:.2f} ms unrecorded "
          f"(the recorder's cost "
          f"{times['recorded'] - med([times['plain'], times['plain2']]):.2f}"
          f" ms; the first recorded round {times['warm']:.2f} ms, with the "
          f"profiler over all threads {times['foreign']:.2f} ms)")
    del model, rec_model, rec_loader, batches, rec, recs, staged
    torch.cuda.empty_cache()

    # (c) config #5 under the guard
    spe = math.ceil(GPT2_CORPUS[0] * GPT2_CORPUS[1] * GPT2_CORPUS[2]
                    / (8 * 8))
    cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=CONFIG5 + [
        "--local_batch_size", "8", "--device", "cuda", "--dataset_dir",
        gpt2_dir, "--num_epochs", str(AUDIT_GPT2_ROUNDS / spe), "--seed",
        "21", "--debug_transfer_guard"])
    model, opt, sched, loader, _ = gpt2_train.build(
        cfg, HashTokenizer(GPT2_VOCAB), device="cuda",
        synthetic_examples=GPT2_CORPUS)
    assert model.cfg.grad_size == GPT2_D
    with _Guards() as guards:
        rr = drive_rounds("audit_gpt2", sc, ac, model, loader,
                          AUDIT_GPT2_ROUNDS,
                          lambda timed, on_round: gpt2_train.train_gpt2(
                              model, opt, sched, timed, model.cfg,
                              on_round=on_round))
    check_launches("audit_gpt2", rr.launches, {
        "sketch_encode": 2 * AUDIT_GPT2_ROUNDS,
        "threshold_sample": AUDIT_GPT2_ROUNDS,
        "threshold_mask": AUDIT_GPT2_ROUNDS,
        "flash_fwd": 12 * 8 * AUDIT_GPT2_ROUNDS})
    if len(guards.made) != AUDIT_GPT2_ROUNDS - 1:
        raise AssertionError(f"audit_gpt2: {len(guards.made)} guarded "
                             "rounds")
    phase("audit", f"(c) config #5, {AUDIT_GPT2_ROUNDS} rounds, rounds "
          f"2-{AUDIT_GPT2_ROUNDS} guarded: 0 implicit syncs, launches "
          f"{rr.launches}; explicit boundaries "
          f"{guards.explicit()}")
    del model, opt, sched, loader, rr
    torch.cuda.empty_cache()

    # (d) graftaudit at AUDIT_GEOMETRY on the card beside the CPU
    t0 = time.perf_counter()
    cpu, cpu_f = audit.run_audit("cpu")
    card, card_f = audit.run_audit("cuda")
    drift = audit.AuditBaseline.load(audit.DEFAULT_BASELINE).apply_costs(
        cpu["costs"], 0.0)
    if cpu_f or card_f or drift:
        raise AssertionError(f"audit: findings cpu {cpu_f}, card {card_f}, "
                             f"baseline {drift}")
    differ, only = [], {}
    for prog in sorted(cpu["programs"]):
        a, b = cpu["programs"][prog], card["programs"][prog]
        if a["kernels"] != b["kernels"]:
            raise AssertionError(f"audit: {prog} kernel entries "
                                 f"{a['kernels']} (CPU), {b['kernels']} "
                                 "(card)")
        for op in set(a["ops"]) | set(b["ops"]):
            if op in a["ops"] and op in b["ops"]:
                if a["ops"][op] != b["ops"][op]:
                    differ.append(f"{prog}:{op}")
            else:
                side = "CPU only" if op in a["ops"] else "card only"
                only.setdefault(f"{op} ({side})", set()).add(
                    prog.split("/")[0])
    if differ:
        raise AssertionError(f"audit: op counts differ by device: {differ}")
    phase("audit", f"(d) graftaudit at {audit.AUDIT_GEOMETRY}: "
          f"{len(card['programs'])} programs on the card, the CPU's equal "
          f"to the committed baseline, no finding on either; kernel "
          f"entries and the count of every op both dispatch equal; ops "
          f"one device alone dispatches: "
          + ("; ".join(f"{k} in {sorted(v)}" for k, v in sorted(
              only.items())) or "none")
          + f"; {time.perf_counter() - t0:.2f} s; the phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", nargs="?", metavar="DIR", default=None,
                    const=os.path.join(HERE, "chiprun_out"),
                    help="trace three more rounds of each path with "
                         "torch.profiler and write profile_rounds.txt, "
                         "profile_gpt2_rounds.txt and profile_<path>_"
                         "rounds.txt of the dp, gpt2bf16, fedavg, ttopk, "
                         "ltopk, imagenet, imagenet_bf16 and sketch50 "
                         "paths "
                         "into DIR (default chiprun_out/ beside this "
                         "script)")
    # one rank of phases 37-38, started by the script itself
    ap.add_argument("--rank", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--process_id", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--num_processes", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--backend", default="gloo", help=argparse.SUPPRESS)
    ap.add_argument("--io", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if args.rank:
        return rank_main(args)
    sys.path.insert(0, HERE)
    from commefficient_tpu_torch import models
    from commefficient_tpu_torch.config import parse_args
    from commefficient_tpu_torch.device import resolve_device
    from commefficient_tpu_torch.federated import client as fclient
    from commefficient_tpu_torch.data.persona import HashTokenizer
    from commefficient_tpu_torch.federated import server as fserver
    from commefficient_tpu_torch.models import convert
    from commefficient_tpu_torch.models import gpt2 as gpt2_model
    from commefficient_tpu_torch.ops import flat, prng
    from commefficient_tpu_torch.ops.kernels import _build
    from commefficient_tpu_torch.ops.kernels import attention_cuda as ac
    from commefficient_tpu_torch.ops.kernels import sketch_cuda as sc
    from commefficient_tpu_torch.ops.sketch import CSVec
    from commefficient_tpu_torch.training import cv_train, gpt2_train

    t_start = time.perf_counter()
    resolve_device("cuda")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}; nvidia-smi name, power.limit: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build()
    ptxas = ptxas_summary("\n".join(_build.BUILD_LOG.values()))
    phase("build", f"nvcc sm_90a build of {sorted(_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.2f} s (0 when already built); "
          f"ptxas: {ptxas}; flash_fwd_mma_kernel dynamic smem a block: "
          + ", ".join(f"Dh {dh}: {k4_smem_bytes(dh)} bytes (bf16 "
                      f"{k4_smem_bytes(dh, bf16=True)})"
                      for dh in ac.SUPPORTED_DH))

    kernels = kernel_phase(sc, CSVec)
    data_dir = os.path.join(HERE, "build", "chip_smoke_data")
    model, round_ms, peak, launches, batch = main_path(
        sc, ac, cv_train, parse_args, data_dir)
    w = model.ps_weights.detach().cpu()

    def build_resnet9():
        module = models.build_model("ResNet9", num_classes=10)
        convert.load_flat(module, w)
        return module

    # phase 37 holds its ranks' reduced table to this round's
    parity_keep = {"cfg": model.cfg}
    parity_phase("parity", build_resnet9, w, batch[1], batch[2], model.cfg,
                 cv_train.make_compute_loss, PARITY_RTOL, ACCURACY_FLOOR,
                 fclient, fserver, flat, tf32_control=True, keep=parity_keep)
    p5_w, p5_batch = w, batch
    if args.profile:
        profile_rounds(model, cv_train.get_data_loaders(
            model.cfg, (CLIENTS * EXAMPLES_PER_CLIENT, 512))[0],
            model._optimizer, os.path.join(args.profile,
                                           "profile_rounds.txt"))
    del model
    torch.cuda.empty_cache()
    # phases 16-17: config #2 with --dp and --max_grad_norm, and on the
    # quantized wires
    dp_launches = dp_phase(sc, ac, cv_train, parse_args, data_dir, prng,
                           round_ms, args.profile)
    wire_phase(sc, ac, cv_train, parse_args, data_dir, round_ms)

    g_kernels = kernel_phase_gpt2(sc, ac, CSVec)
    gpt2_dir = os.path.join(HERE, "build", "chip_smoke_gpt2_data")
    g_launches, g_ms, g_peak, g_batch, g_cfg = gpt2_main_path(
        sc, ac, gpt2_train, parse_args, HashTokenizer, gpt2_dir,
        args.profile)

    # a 2-layer full-width GPT2 (threshold route), 2 clients x 2
    # examples of a main-path batch
    gcfg = gpt2_model.PRESETS["gpt2"].replace(vocab_size=GPT2_VOCAB,
                                              n_layer=2)
    g_w, _ = flat.flatten_params(gpt2_model.GPT2DoubleHeads(gcfg, seed=5))
    g_cfg = g_cfg.replace(grad_size=int(g_w.shape[0]), num_workers=2)
    assert fserver.args2sketch(g_cfg)._threshold_decode, g_cfg.grad_size
    phase("gparity", f"2-layer GPT2, d={g_cfg.grad_size}, "
          f"L={g_batch[1][0].shape[-1]}, 2 clients x 2 examples")
    parity_phase("gparity",
                 lambda: gpt2_model.GPT2DoubleHeads(gcfg, seed=5), g_w,
                 tuple(a[:2, :2] for a in g_batch[1]), g_batch[2][:2, :2],
                 g_cfg,
                 lambda m: gpt2_train.make_compute_loss_train(m, g_cfg),
                 GPT2_PARITY_RTOL, GPT2_ACCURACY_FLOOR, fclient, fserver,
                 flat, tf32_control=True)

    # phase 18: config #5 with --bf16 (K4 on bf16 operands), then the
    # bf16 accuracy check on the 2-layer GPT2, one example of 2
    # candidates
    gb_launches, gb_ms, gb_peak, gb_batch, _ = gpt2_main_path(
        sc, ac, gpt2_train, parse_args, HashTokenizer, gpt2_dir,
        args.profile, label="gpt2bf16", extra=["--bf16"],
        attn="flash_fwd_bf16")
    phase("gpt2bf16", f"median {statistics.median(gb_ms[1:]):.2f} "
          f"ms/round beside config #5's {statistics.median(g_ms[1:]):.2f}; "
          f"peak {gb_peak / 2 ** 30:.3f} GiB beside "
          f"{g_peak / 2 ** 30:.3f}")
    bf16_parity_phase("gpt2bf16",
                      lambda: gpt2_model.GPT2DoubleHeads(gcfg, seed=5), g_w,
                      tuple(a[0, :1] for a in gb_batch[1]),
                      gb_batch[2][0, :1],
                      lambda m: gpt2_train.make_compute_loss_train(m, g_cfg),
                      fclient, flat)

    # the remaining modes at full width (phases 9-12)
    cifar_dir = os.path.join(HERE, "build", "chip_smoke_data")
    spe = math.ceil(CLIENTS * EXAMPLES_PER_CLIENT / (8 * 32))
    for label, flags, rounds, path_spe, d, data_dir in (
            ("fedavg", CONFIG1, FEDAVG_ROUNDS, CLIENTS // 8, MAIN_D,
             cifar_dir),
            ("ttopk", TTOPK, TTOPK_ROUNDS, spe, MAIN_D, cifar_dir),
            ("ltopk", CONFIG3, LTOPK_ROUNDS, spe, CONFIG3_D,
             os.path.join(HERE, "build", "chip_smoke_cifar100_data"))):
        model, rr, loader = mode_path(
            label, sc, ac, cv_train, flat, parse_args, flags, rounds,
            path_spe, d, data_dir)
        timed = rr.timed
        if label == "ttopk":
            ttopk_checks(model, timed)
        if label == "ltopk":
            ltopk_peak = rr.peak
            ltopk_checks(model, timed)
            ltopk_parity(model, timed, next(iter(loader.epoch())), cv_train,
                         models, convert, fclient, flat)
        if args.profile:
            profile_rounds(model, loader, model._optimizer,
                           os.path.join(args.profile,
                                        f"profile_{label}_rounds.txt"),
                           f"{label} profile")
        del model, rr, timed, loader
        torch.cuda.empty_cache()
    # BASELINE config #4 (phases 13-15), on a corpus written for this run
    corpus = tempfile.mkdtemp(prefix="chip_smoke_imagenet_")
    try:
        write_imagenet_corpus(corpus)
        model, rr, loader = imagenet_path(
            "imagenet", sc, ac, cv_train, parse_args, CONFIG4, FIXUP50_D,
            corpus)
        imagenet_checks(model, rr)
        if args.profile:
            profile_rounds(model, loader, model._optimizer,
                           os.path.join(args.profile,
                                        "profile_imagenet_rounds.txt"),
                           "imagenet profile")
        i_rr = rr
        del model, rr, loader
        torch.cuda.empty_cache()
        # phase 31: config #4 plain against spans pipelined (item 9c)
        imagenet_pipeline_phase(sc, ac, cv_train, parse_args, corpus,
                                i_rr.round_ms)

        # phase 19: config #4 per imagenet.sh with --bf16
        model, rr, loader = imagenet_path(
            "imagenet_bf16", sc, ac, cv_train, parse_args,
            CONFIG4 + ["--bf16"], FIXUP50_D, corpus)
        check_launches("imagenet_bf16", rr.launches,
                       {n: 0 for n in rr.launches})
        med = statistics.median
        phase("imagenet_bf16", "bf16 beside phase 13's f32: median "
              f"{med(rr.round_ms[1:]):.2f}, {med(i_rr.round_ms[1:]):.2f} "
              "ms/round; host batch "
              f"{1e3 * med(rr.timed.seconds[1:]):.2f}, "
              f"{1e3 * med(i_rr.timed.seconds[1:]):.2f} ms; peak "
              f"{rr.peak / 2 ** 30:.3f}, {i_rr.peak / 2 ** 30:.3f} GiB")
        if args.profile:
            profile_rounds(model, loader, model._optimizer,
                           os.path.join(args.profile,
                                        "profile_imagenet_bf16_rounds.txt"),
                           "imagenet_bf16 profile")
        del model, rr, loader, i_rr
        torch.cuda.empty_cache()

        model, rr, loader = imagenet_path(
            "sketch50", sc, ac, cv_train, parse_args, CONFIG4_SKETCH, R50_D,
            corpus)
        s_launches = rr.launches
        sketch50_checks(model, rr, flat, fserver)
        if args.profile:
            profile_rounds(model, loader, model._optimizer,
                           os.path.join(args.profile,
                                        "profile_sketch50_rounds.txt"),
                           "sketch50 profile")
        i_batch = next(iter(loader.epoch()))
        i_cfg = model.cfg.replace(num_workers=2)
        del model, rr, loader
        torch.cuda.empty_cache()

        # phase 15: the phase 14 model's initial weights, bn3 damped
        # (R50_BN3_SCALE) and plain, 2 clients x 2 images of a phase 14
        # batch
        template = models.build_model("ResNet50", num_classes=1000,
                                      seed=i_cfg.seed)
        i_data = tuple(a[:2, :2] for a in i_batch[1]), i_batch[2][:2, :2]
        for scale, rtol in ((R50_BN3_SCALE, PARITY_RTOL), (1.0, None)):
            module = copy.deepcopy(template)
            with torch.no_grad():
                for name, p in module.named_parameters():
                    if name.endswith("bn3.scale"):
                        p.mul_(scale)
            i_w, _ = flat.flatten_params(module)
            phase("iparity", f"ResNet50 at {IMAGENET_HW} px, "
                  f"d={i_w.numel()}, 2 clients x 2 images, bn3 scales x "
                  f"{scale:g}, fused backward {i_cfg.fused_client_backward}")
            parity_phase("iparity", lambda: copy.deepcopy(module), i_w,
                         *i_data, i_cfg, cv_train.make_compute_loss, rtol,
                         ACCURACY_FLOOR, fclient, fserver, flat,
                         tf32_control=rtol is not None)
    finally:
        shutil.rmtree(corpus, ignore_errors=True)

    # phases 20-21: checkpoint/resume and the run journal (ROADMAP item
    # 6c), config #2 and config #5 at full width (RESUME_EPOCHS' note)
    resume_tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        c2_data = os.path.join(HERE, "build", "chip_smoke_resume_data")
        c2_spe = math.ceil(RESUME_CIFAR[0] / (8 * 32))

        def build_c2(ck, journal, resume):
            cfg = parse_args(argv=CONFIG2 + [
                "--local_batch_size", "32", "--num_clients",
                str(RESUME_CIFAR_CLIENTS), "--device", "cuda",
                "--dataset_dir", c2_data, "--num_epochs",
                str(RESUME_EPOCHS), "--pivot_epoch", "1", "--seed", "21",
                "--checkpoint_every", "1", "--checkpoint_path", ck,
                "--trace", "--journal_path", journal]
                + (["--resume"] if resume else []))
            model, opt, sched, loader, val = cv_train.build(
                cfg, device="cuda", synthetic_examples=RESUME_CIFAR)
            assert model.cfg.grad_size == MAIN_D
            return model, loader, lambda tl, on_round: cv_train.run(
                model, opt, sched, tl, val, model.cfg, ck,
                on_round=on_round)

        resume_phase("resume", sc, ac, build_c2, "ResNet9",
                     RESUME_EPOCHS * c2_spe, c2_spe,
                     {"sketch_encode": 1, "sketch_estimate_all": 1},
                     round_ms, "config #2 (phase 4)",
                     os.path.join(resume_tmp, "config2"))

        c5_data = os.path.join(HERE, "build", "chip_smoke_gpt2_resume_data")
        c5_spe = math.prod(RESUME_GPT2_CORPUS) // (8 * 8)

        def build_c5(ck, journal, resume):
            cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=CONFIG5 + [
                "--local_batch_size", "8", "--device", "cuda",
                "--dataset_dir", c5_data, "--num_epochs",
                str(RESUME_EPOCHS), "--seed", "21", "--checkpoint_every",
                "1", "--checkpoint_path", ck, "--trace", "--journal_path",
                journal] + (["--resume"] if resume else []))
            model, opt, sched, loader, _ = gpt2_train.build(
                cfg, HashTokenizer(GPT2_VOCAB), device="cuda",
                synthetic_examples=RESUME_GPT2_CORPUS)
            assert model.cfg.grad_size == GPT2_D
            assert loader.dataset.seq_len == GPT2_L
            assert loader.steps_per_epoch == c5_spe
            return model, loader, lambda tl, on_round: gpt2_train.run(
                model, opt, sched, tl, model.cfg, ck, logger=_Quiet(),
                on_round=on_round)

        resume_phase("gpt2resume", sc, ac, build_c5, "gpt2",
                     RESUME_EPOCHS * c5_spe, c5_spe,
                     {"sketch_encode": 2, "threshold_sample": 1,
                      "threshold_mask": 1, "flash_fwd": 12 * 8,
                      "sketch_estimate_all": 0, "flash_fwd_bf16": 0},
                     g_ms, "config #5 (phase 7)",
                     os.path.join(resume_tmp, "config5"))
    finally:
        shutil.rmtree(resume_tmp, ignore_errors=True)

    # phases 22-26: the fault-tolerant rounds, the numeric rollback and
    # --finetune (ROADMAP items 9a and 7)
    from commefficient_tpu_torch.utils import faults
    c2_dir = os.path.join(HERE, "build", "chip_smoke_data")
    faults_phase(sc, ac, cv_train, parse_args, c2_dir, fclient, faults,
                 round_ms)
    byz_launches = byzantine_phase(sc, ac, cv_train, parse_args, c2_dir,
                                   fclient, fserver, round_ms)
    late_tmp = tempfile.mkdtemp(prefix="chip_smoke_item9a_")
    try:
        os.makedirs(os.path.join(late_tmp, "rollback"))
        rollback_phase(sc, ac, cv_train, parse_args, faults,
                       os.path.join(late_tmp, "rollback"))
        gpt2_finetune_phase(sc, ac, gpt2_train, gpt2_model, convert, flat,
                            parse_args, HashTokenizer, gpt2_dir, g_ms,
                            g_peak, late_tmp)
        cvfinetune_phase(sc, ac, cv_train, parse_args, flat, models,
                         late_tmp)
    finally:
        shutil.rmtree(late_tmp, ignore_errors=True)

    # phases 27-30: the compressor plugins and the privacy budget (item
    # 9b), spans and the pipelined engine on config #2 (item 9c)
    from commefficient_tpu_torch import compress
    plugin_tmp = tempfile.mkdtemp(prefix="chip_smoke_item9bc_")
    try:
        powersgd_phase(sc, ac, cv_train, parse_args, c2_dir, fclient, prng,
                       round_ms)
        dps_launches = dp_sketch_phase(sc, ac, cv_train, parse_args, c2_dir,
                                       fclient, fserver, compress, round_ms,
                                       plugin_tmp)
        privacy_drill_phase(cv_train, parse_args, c2_dir, compress,
                            plugin_tmp)
        spans_phase(sc, ac, cv_train, parse_args, c2_dir, round_ms,
                    plugin_tmp)
    finally:
        shutil.rmtree(plugin_tmp, ignore_errors=True)

    # phases 32-34: the round scheduler, async admission and the tiered
    # client state (items 9d and 9e)
    sched_tmp = tempfile.mkdtemp(prefix="chip_smoke_item9de_")
    try:
        sched_launches = sched_phase(sc, ac, cv_train, parse_args, c2_dir,
                                     round_ms, sched_tmp)
        async_launches = async_phase(sc, ac, cv_train, parse_args, c2_dir,
                                     round_ms, sched_tmp)
        statetier_phase(sc, ac, cv_train, parse_args, ltopk_peak,
                        sched_tmp)
    finally:
        shutil.rmtree(sched_tmp, ignore_errors=True)

    # phases 35-36: the controller bank (item 9f) on config #2, and
    # GPT2-medium sketched through the blockwise decode (item 1)
    ctl_tmp = tempfile.mkdtemp(prefix="chip_smoke_item9f_")
    try:
        control_phase(sc, ac, cv_train, parse_args, c2_dir, round_ms,
                      ctl_tmp)
    finally:
        shutil.rmtree(ctl_tmp, ignore_errors=True)
    m_kernels = gpt2medium_kernels(sc, ac, CSVec)
    m_launches = gpt2medium_phase(sc, ac, gpt2_train, parse_args,
                                  HashTokenizer, gpt2_dir, fserver, g_ms)

    # phases 37-38: config #2 on a grid of ranks and GPT2-small tensor
    # parallel (item 9g), ranks sharing the card over gloo
    grid_kernels = grid_rows(sc, CSVec)
    tp_kernel = k4_tp_row(ac)
    grid_tmp = tempfile.mkdtemp(prefix="chip_smoke_item9g_")
    try:
        grid_launches = grid_phase(sc, CSVec, round_ms, parity_keep, p5_w,
                                   p5_batch, grid_tmp)
        tp_launches = tpgpt2_phase(gpt2_train, parse_args, HashTokenizer,
                                   fserver, g_ms, g_peak, grid_tmp)
    finally:
        shutil.rmtree(grid_tmp, ignore_errors=True)

    # phase 39: the plan transport in process (item 9g's rest); phases
    # 40-41 ran on phase 37's ranks
    plan_tmp = tempfile.mkdtemp(prefix="chip_smoke_plan_")
    try:
        plan_phase(sc, ac, cv_train, parse_args, c2_dir, round_ms, plan_tmp)
    finally:
        shutil.rmtree(plan_tmp, ignore_errors=True)

    # phase 42: the analysis tiers' host half (item 10 a-d) on config #2
    ana_tmp = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    try:
        analysis_phase(sc, ac, cv_train, parse_args, c2_dir, round_ms,
                       ana_tmp)
    finally:
        shutil.rmtree(ana_tmp, ignore_errors=True)

    # phase 43: the trace tiers (item 10f) on config #2 and config #5
    audit_phase(sc, ac, cv_train, gpt2_train, parse_args, HashTokenizer,
                c2_dir, gpt2_dir, round_ms, kernels)

    # launches: each entry's count from its own main path's run
    path_launches = {"config2": launches, "config5": g_launches,
                     "gpt2medium": m_launches,
                     "config4": s_launches, "dp": dp_launches,
                     "config5_bf16": gb_launches,
                     "byzantine": byz_launches, "dp_sketch": dps_launches,
                     "grid": grid_launches, "tpgpt2": tp_launches}
    kernels += g_kernels + m_kernels + grid_kernels + [tp_kernel]
    for k in kernels:
        k["launches"] = path_launches[k["path"]][k.pop("counter")]

    phase("wall", f"chip_smoke.py ran {time.perf_counter() - t_start:.1f} s "
          "from the device check to here")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:   # report the failing phase, exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
