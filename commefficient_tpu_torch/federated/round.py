"""The federated round engine: the port of
commefficient_tpu/federated/round.py, single process, mask-free.

One round: the cohort's clients compute on the server weights (one
fused backward over all of them when Config.fused_client_backward
holds, else one local_step each, or fedavg_step's local SGD), their
transmits are summed, the sum is sketched ONCE in sketch mode (kernel
K1 on the card; once per client instead under --dp or
--max_grad_norm), rides the --sketch_table_dtype wire, is divided by
the cohort's example total, and is handed to the server step
(federated/server.py), whose update is applied to the weights. The
clients compute in bfloat16 under --bf16. The participants' per-client
rows (local error, local velocity, the stale weights of --topk_down)
are gathered before the round and scattered back after it.

Keys (ops/prng.py) as in the JAX engine: the round's is
fold_in(key, round_idx), client c's (c its place in the cohort)
fold_in(round_key, c), the server's fold_in(round_key, num_workers).

What the JAX engine runs as one jitted SPMD program over a `clients`
mesh axis runs here as eager PyTorch on one device: the `lax.psum`
over the clients axis is the identity. The dropout / straggler /
screened program variants (RoundBatch.survivors, .work, .poison) are
ROADMAP.md Queue 1 item 9; Config.validate refuses the options that
would need them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.federated import client as fclient
from commefficient_tpu_torch.federated import server as fserver
from commefficient_tpu_torch.ops.flat import masked_topk
from commefficient_tpu_torch.ops.kernels.quant import wire_roundtrip
from commefficient_tpu_torch.ops.prng import fold_in
from commefficient_tpu_torch.telemetry import metrics as tmetrics
from commefficient_tpu_torch.telemetry.trace import TRACE


class ServerState(NamedTuple):
    """All server-side mutable state."""
    ps_weights: torch.Tensor     # [D]
    Vvelocity: torch.Tensor      # [D] or [r, c]
    Verror: torch.Tensor         # [D] or [r, c]
    round_idx: int


class ClientState(NamedTuple):
    """Per-client persistent rows, [num_clients, D] per tracked block
    (local error, local velocity, --topk_down's stale weights) or a [0]
    placeholder."""
    errors: torch.Tensor
    velocities: torch.Tensor
    weights: torch.Tensor


class CohortState(NamedTuple):
    """The participants' rows of ClientState for one round, or
    [num_workers] dummies for untracked blocks."""
    errors: torch.Tensor
    velocities: torch.Tensor
    weights: torch.Tensor


class RoundBatch(NamedTuple):
    """One round's input: num_workers clients, each with a padded
    local batch and its validity mask."""
    client_ids: torch.Tensor                 # [W] int
    data: Tuple[torch.Tensor, ...]           # each [W, B, ...]
    mask: torch.Tensor                       # [W, B] f32


class RoundMetrics(NamedTuple):
    losses: torch.Tensor                     # [W] per-client mean loss
    metrics: Tuple[torch.Tensor, ...]        # each [W]
    num_examples: torch.Tensor               # [W]
    # telemetry/metrics.round_vector under Config.telemetry, else a [0]
    # placeholder; read-only, so the state is bitwise the same either way
    telemetry: torch.Tensor


def init_server_state(cfg: Config, ps_weights: torch.Tensor) -> ServerState:
    shape = cfg.state_shape
    dev = ps_weights.device
    return ServerState(
        ps_weights=ps_weights.detach().to(torch.float32).clone(),
        Vvelocity=torch.zeros(shape, dtype=torch.float32, device=dev),
        Verror=torch.zeros(shape, dtype=torch.float32, device=dev),
        round_idx=0)


def _has_errors(cfg: Config) -> bool:
    return cfg.compressor.has_errors(cfg)


def _has_velocities(cfg: Config) -> bool:
    return cfg.compressor.has_velocities(cfg)


def init_client_state(cfg: Config, num_clients: int, device,
                      ps_weights: Optional[torch.Tensor] = None
                      ) -> ClientState:
    """Per-client rows for the blocks the config tracks, [0]
    placeholders otherwise. --topk_down's weight rows start as copies
    of `ps_weights` (the clients' download at init)."""
    D = cfg.grad_size

    def block(tracked: bool):
        shape = (num_clients, D) if tracked else (0,)
        return torch.zeros(shape, dtype=torch.float32, device=device)

    if cfg.do_topk_down:
        if ps_weights is None:
            raise ValueError("--topk_down needs the initial ps_weights "
                             "for the per-client weight rows")
        weights = ps_weights.detach().to(device, torch.float32).expand(
            num_clients, D).clone()
    else:
        weights = block(False)
    return ClientState(block(_has_errors(cfg)),
                       block(_has_velocities(cfg)), weights)


def gather_cohort(cfg: Config, clients: ClientState,
                  ids: torch.Tensor) -> CohortState:
    W = ids.shape[0]
    dev = ids.device

    def rows(block, tracked):
        return (block[ids] if tracked
                else torch.zeros(W, dtype=torch.float32, device=dev))

    return CohortState(rows(clients.errors, _has_errors(cfg)),
                       rows(clients.velocities, _has_velocities(cfg)),
                       rows(clients.weights, cfg.do_topk_down))


def scatter_back(cfg: Config, clients: ClientState, ids: torch.Tensor,
                 cohort: CohortState) -> ClientState:
    if _has_errors(cfg):
        clients.errors[ids] = cohort.errors
    if _has_velocities(cfg):
        clients.velocities[ids] = cohort.velocities
    if cfg.do_topk_down:
        clients.weights[ids] = cohort.weights
    return clients


def compute_dtype(cfg: Config):
    """The client body's type: torch.bfloat16 under --bf16, else None
    (the parameters' own float32)."""
    return torch.bfloat16 if cfg.do_bf16 else None


def make_train_fn(loss_fn: fclient.LossFn, unravel: Callable, cfg: Config):
    """The train-round callable:
        train_round(server, clients, batch, lr, key) -> (server, clients,
                                                         RoundMetrics)
    `lr` is the scheduler's learning rate for this round (a float),
    `key` the run's threefry key (ops/prng.py)."""
    cfg.validate()
    flat_grad = fclient.make_flat_grad_fn(loss_fn, unravel,
                                          compute_dtype(cfg))
    flat_loss = fclient.make_flat_loss_fn(loss_fn, unravel,
                                          compute_dtype(cfg))
    comp = cfg.compressor

    def client_weights(ps_weights, w_stale):
        """What one client trains on: the server weights, or with
        --topk_down its stale weights plus the top-k of the gap (down_k
        decouples the download budget from the upload k)."""
        if not cfg.do_topk_down:
            return ps_weights
        return w_stale + masked_topk(ps_weights - w_stale,
                                     k=cfg.down_k or cfg.k)

    def client_phase(ps_weights, batch: RoundBatch, cohort: CohortState,
                     lr, round_key):
        """The cohort's summed transmit, example counts, per-client
        losses/metrics and updated rows."""
        if cfg.fused_client_backward:
            local_sum, losses, metrics, counts = fclient.fused_shard_grads(
                flat_loss, ps_weights, batch.data, batch.mask, cfg)
            return local_sum, counts, losses, metrics, cohort
        results, new_w = [], []
        for c in range(batch.mask.shape[0]):
            weights = client_weights(ps_weights, cohort.weights[c])
            data = tuple(x[c] for x in batch.data)
            if comp.local_sgd:
                res = fclient.fedavg_step(flat_grad, weights, data,
                                          batch.mask[c], cfg, lr)
            else:
                res = fclient.local_step(flat_grad, weights, data,
                                         batch.mask[c], cohort.errors[c],
                                         cohort.velocities[c], cfg,
                                         fold_in(round_key, c))
            results.append(res)
            new_w.append(weights)
        local_sum = torch.stack([r.transmit for r in results]).sum(dim=0)
        counts = torch.stack([r.num_examples for r in results])
        losses = torch.stack([r.loss for r in results])
        metrics = tuple(torch.stack([r.metrics[i] for r in results])
                        for i in range(len(results[0].metrics)))
        if _has_errors(cfg):
            cohort = cohort._replace(
                errors=torch.stack([r.error for r in results]))
        if _has_velocities(cfg):
            cohort = cohort._replace(
                velocities=torch.stack([r.velocity for r in results]))
        if cfg.do_topk_down:
            # each participant's post-download weights, so its staleness
            # is tracked
            cohort = cohort._replace(weights=torch.stack(new_w))
        return local_sum, counts, losses, metrics, cohort

    def round_step(server: ServerState, cohort: CohortState,
                   batch: RoundBatch, lr, key):
        round_key = fold_in(key, server.round_idx)
        W = batch.mask.shape[0]
        local_sum, counts, losses, metrics, cohort = client_phase(
            server.ps_weights, batch, cohort, lr, round_key)
        if cfg.defer_sketch_encode:
            # sketch linearity: encode the cohort's sum once (K1)
            local_sum = fserver.args2sketch(cfg).encode(local_sum)
        if cfg.mode == "sketch":
            # the quantized wire (the identity for f32). The JAX engine
            # rounds each mesh shard's sum; one device holds one shard
            local_sum = wire_roundtrip(local_sum, cfg.sketch_table_dtype)
        # the sum over the clients axis of the JAX engine (lax.psum) is
        # the identity on one device
        transmit = comp.post_aggregate(cfg, local_sum, round_key)
        total = counts.sum()
        gradient = transmit / torch.clamp(total, min=1.0)
        upd = fserver.get_server_update(gradient, server.Vvelocity,
                                        server.Verror, cfg, lr,
                                        key=fold_in(round_key, W))
        new_ps = server.ps_weights - upd.update
        new_server = ServerState(new_ps, upd.Vvelocity, upd.Verror,
                                 server.round_idx + 1)
        if _has_velocities(cfg) and upd.velocity_mask is not None:
            # true_topk momentum factor masking, participants' rows only
            cohort = cohort._replace(
                velocities=cohort.velocities * upd.velocity_mask[None, :])
        if cfg.telemetry:
            tele = tmetrics.round_vector(
                losses=losses, counts=counts,
                delta=new_ps - server.ps_weights, verror=upd.Verror,
                vvelocity=upd.Vvelocity, survivors=W)
        else:
            tele = tmetrics.empty_vector(new_ps.device)
        return new_server, cohort, RoundMetrics(losses, metrics, counts,
                                                tele)

    def train_round(server: ServerState, clients: ClientState,
                    batch: RoundBatch, lr, key):
        # host spans of the three dispatches (telemetry/trace.py); the
        # round tag comes from the caller's enclosing `dispatch` span
        with TRACE.span("gather"):
            cohort = gather_cohort(cfg, clients, batch.client_ids)
        with TRACE.span("round_dispatch"):
            server, cohort, metrics = round_step(server, cohort, batch,
                                                 lr, key)
        with TRACE.span("scatter"):
            clients = scatter_back(cfg, clients, batch.client_ids, cohort)
        return server, clients, metrics

    train_round.round_step = round_step
    train_round.client_phase = client_phase
    return train_round


def make_eval_fn(loss_fn: fclient.LossFn, unravel: Callable, cfg: Config):
    """eval_batch(ps_weights, data [S, vb, ...], mask [S, vb]) ->
    per-shard (loss [S], metrics, count [S]), forward only, in the
    train round's compute type."""
    flat_loss = fclient.make_flat_loss_fn(loss_fn, unravel,
                                          compute_dtype(cfg))

    @torch.no_grad()
    def eval_batch(ps_weights, data, mask):
        outs = [fclient.forward_grad(flat_loss, ps_weights,
                                     tuple(x[s] for x in data), mask[s],
                                     cfg, compute_grad=False)
                for s in range(mask.shape[0])]
        loss = torch.stack([o[1] for o in outs])
        metrics = tuple(torch.stack([o[2][i] for o in outs])
                        for i in range(len(outs[0][2])))
        count = torch.stack([o[3] for o in outs])
        return loss, metrics, count

    return eval_batch
