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
mesh axis runs here as eager PyTorch, on one device or, given a
parallel/mesh.Layout, on one rank of a process grid. Each rank then
computes its contiguous W / n block of the cohort (RoundBatch carries
only its rows, but the whole cohort's client ids), and the JAX
engine's collectives become the layout's:
  * the `lax.psum` of the transmit is an all_reduce over the clients
    group. In sketch mode each rank encodes its block's sum once (K1)
    and rounds it on the --sketch_table_dtype wire first, JAX's
    per-shard rounding, so the [r, c] table is what crosses ranks;
  * the per-client vectors (losses, metrics, example counts, the
    survivor and admission masks) are gathered in cohort order, so
    everything after the sum (the example total, the server step:
    K2, the stable top-k, the re-sketch; the telemetry row) runs
    replicated on every rank from identical inputs, and every rank
    holds bitwise the same ps_weights;
  * the screened family's `lax.all_gather`s (the cohort-median l2, the
    adversary's honest statistics, the robust aggregators' [W, ...]
    tables) are gathers in cohort order, and its `axis_index` the
    rank's clients position;
  * the per-client rows are sharded by rank: each holds its contiguous
    block of ceil(population / n) rows, the round's gather of the
    cohort's rows by client id is one all_reduce of a [W, D] buffer a
    tracked block, and so is the scatter back.
Without a layout (or on a layout of one rank) every collective is the
identity.

The fault variants (utils/faults.py) ride RoundBatch operands, as in
the JAX engine, and keep its NaN rules:
  * `survivors` ([W] {0,1}): a dropped client adds nothing to the sum
    or the example total, its rows come back as gathered, and a round
    with no survivor leaves the server state bitwise untouched (only
    round_idx advances);
  * `work` ([W] fractions in (0, 1]): a straggler processes the first
    ceil(f * valid) of its valid examples (a prefix), or under fedavg
    its first ceil(f * steps) local steps, and is weighted by what it
    processed;
  * `poison` ([W] {0,1}) with `screen` (a scalar): the screened family.
    Flagged transmits are corrupted (`corrupt`) or, under
    --byzantine_rate, replaced by the attack (`attack`); the admission
    screen (`admission`) takes the finite bit of every transmit and,
    under --update_screen norm, the cohort-median l2 check, and applies
    only when `screen` > 0. Excluded clients are zeroed with `where`,
    never a multiply (NaN * 0 is NaN), so a screened client is bitwise a
    dropped one. The screened family always takes the per-client path.
    Under a robust --aggregator each client's transmit is encoded on
    its own (K1, W times a round in sketch mode) and rides the wire
    before `robust_aggregate` takes order statistics over the [W, ...]
    tables; `masked_median` takes medians as jnp.nanmedian does (the
    mean of the two middles of an even count).
`grad_mask` ([D], 0 at frozen coordinates, --finetune) is applied to
every client gradient before compression.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from commefficient_tpu_torch import hooks
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
    """Per-client persistent rows, [client_state_rows, D] per tracked
    block (local error, local velocity, --topk_down's stale weights) or
    a [0] placeholder. The round addresses them by `RoundBatch.
    client_ids`: client ids, or under --state_tier host device slots."""
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
    local batch and its validity mask, and the fault operands (module
    docstring; None where the round has none). `work` rides with
    `survivors`, and `screen` with `poison`."""
    client_ids: torch.Tensor                 # [W] int
    data: Tuple[torch.Tensor, ...]           # each [W, B, ...]
    mask: torch.Tensor                       # [W, B] f32
    survivors: Optional[torch.Tensor] = None  # [W] f32 {0,1}
    work: Optional[torch.Tensor] = None       # [W] f32 in (0, 1]
    poison: Optional[torch.Tensor] = None     # [W] f32 {0,1}
    screen: Optional[torch.Tensor] = None     # scalar f32


class RoundMetrics(NamedTuple):
    losses: torch.Tensor                     # [W] per-client mean loss
    metrics: Tuple[torch.Tensor, ...]        # each [W]
    num_examples: torch.Tensor               # [W]
    # telemetry/metrics.round_vector under Config.telemetry, else a [0]
    # placeholder; read-only, so the state is bitwise the same either way
    telemetry: torch.Tensor
    # screened family: survivors x admission, the mask the accountant
    # bills and the rows merge by; None elsewhere
    admitted: Optional[torch.Tensor] = None
    # robust aggregators: the admitted clients some cell of the
    # aggregate kept (a client trimmed out of every cell is billed as
    # dropped), and (mean clients trimmed a cell, clients clipped, l2
    # of robust minus mean aggregate, contributors)
    contributors: Optional[torch.Tensor] = None
    agg_stats: Optional[torch.Tensor] = None


# the "scale" poison kind's factor: past any norm screen, finite in f32
POISON_SCALE = 2.0 ** 40


def screened_family(cfg: Config) -> bool:
    """Whether `cfg` runs the screened rounds in its steady state
    (screening, poison, adversaries or a robust aggregator); a rollback
    forces them for a window on any config (FedModel)."""
    return (cfg.update_screen != "off" or cfg.poison_rate > 0
            or cfg.byzantine_rate > 0 or cfg.robust_aggregation)


def _rows(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[W] -> [W, 1, ...] to broadcast against the [W, ...] tensor t."""
    return v.reshape(v.shape + (1,) * (t.dim() - 1))


def masked_median(vals: torch.Tensor, valid: torch.Tensor,
                  dim: int = 0) -> torch.Tensor:
    """jnp.nanmedian(where(valid, vals, nan), axis=dim): the median of
    the valid entries, the MEAN of the two middles of an even count
    ((lo + hi) * 0.5, jnp's midpoint), NaN where none is valid.
    torch.median would take the lower middle."""
    s = torch.where(valid, vals, torch.full_like(vals, float("nan")))
    s = torch.sort(s, dim=dim).values          # NaN sorts last
    n = valid.sum(dim=dim, keepdim=True)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    lo_v = torch.gather(s, dim, lo).squeeze(dim)
    hi_v = torch.gather(s, dim, hi).squeeze(dim)
    return (lo_v + hi_v) * 0.5


def corrupt(t: torch.Tensor, pois: torch.Tensor, kind: str) -> torch.Tensor:
    """The value fault on flagged clients' transmits ([W, ...]): NaN,
    Inf, or times POISON_SCALE."""
    flag = _rows(pois, t) > 0
    if kind == "scale":
        return t * torch.where(flag, t.new_tensor(POISON_SCALE),
                               t.new_tensor(1.0))
    bad = float("inf") if kind == "inf" else float("nan")
    return torch.where(flag, t.new_tensor(bad), t)


def attack(t: torch.Tensor, pois: torch.Tensor, surv: torch.Tensor,
           cfg: Config, screen: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """The adversary's replacement of flagged clients' transmits
    ([W, ...]): `sign_flip` (-v), `scaled` (100 v), or one crafted
    update from the honest cohort's statistics (honest: unflagged,
    surviving, finite): `little_is_enough` (mean minus one standard
    deviation a coordinate) or `colluding` (the negated honest mean at
    0.9 x the norm screen's envelope, mult x the honest median norm;
    under --target_screened_rate mult is the value of `screen`)."""
    W = t.shape[0]
    V = t.reshape(W, -1).to(torch.float32)
    if cfg.attack == "sign_flip":
        A = -V
    elif cfg.attack == "scaled":
        A = V * 100.0
    else:
        honest = (~(pois > 0)) & (surv > 0) & torch.isfinite(V).all(dim=1)
        nh = torch.clamp(honest.sum(), min=1)
        hm = honest[:, None]
        hmean = torch.where(hm, V, torch.zeros_like(V)).sum(0) / nh
        if cfg.attack == "little_is_enough":
            hvar = torch.where(hm, torch.square(V - hmean[None, :]),
                               torch.zeros_like(V)).sum(0) / nh
            crafted = hmean - torch.sqrt(hvar)
        else:  # colluding
            hnorm = torch.sqrt(torch.square(V).sum(1))
            med = masked_median(hnorm, honest)
            med = torch.where(honest.sum() > 0, med, med.new_tensor(1.0))
            # the envelope the norm screen admits (>= 1 keeps the
            # attack meaningful with the screen off)
            amult = (torch.clamp(screen.to(torch.float32), min=1.0)
                     if cfg.adaptive_screen
                     else med.new_tensor(max(float(cfg.screen_norm_mult),
                                             1.0)))
            d = -hmean
            crafted = d * (med.new_tensor(0.9) * amult * med / torch.clamp(
                torch.sqrt(torch.square(d).sum()), min=1e-12))
        A = crafted[None, :].expand_as(V)
    out = torch.where(pois[:, None] > 0, A, V)
    return out.reshape(t.shape).to(t.dtype)


def client_checks(t: torch.Tensor, cfg: Config):
    """Per-client (finite [W] bool, l2 [W] f32 or None) of the transmits
    t ([W, ...]): what admission reads of each client; the l2 only
    under --update_screen norm."""
    W = t.shape[0]
    ok = torch.isfinite(t).reshape(W, -1).all(dim=1)
    l2 = None
    if cfg.update_screen == "norm":
        l2 = torch.sqrt(torch.square(t.to(torch.float32))
                        .reshape(W, -1).sum(dim=1))
    return ok, l2


def admission(t: torch.Tensor, surv: torch.Tensor, screen: torch.Tensor,
              cfg: Config) -> torch.Tensor:
    """[W] f32 admit mask of the transmits t ([W, ...]): finite, and
    under --update_screen norm an l2 at most mult x the median l2 of the
    eligible clients (surviving, finite, nonzero; a round with none
    eligible admits all), mult being screen_norm_mult or, under
    --target_screened_rate, the value of `screen`. All ones when
    `screen` is 0: the mask is computed and not applied."""
    return admit(*client_checks(t, cfg), surv, screen, cfg)


def admit(ok: torch.Tensor, l2: Optional[torch.Tensor], surv: torch.Tensor,
          screen: torch.Tensor, cfg: Config) -> torch.Tensor:
    """admission from the whole cohort's client_checks."""
    if cfg.update_screen == "norm":
        elig = (surv > 0) & torch.isfinite(l2) & (l2 > 0)
        med = masked_median(l2, elig)
        mult = (screen.to(torch.float32) if cfg.adaptive_screen
                else cfg.screen_norm_mult)
        norm_ok = torch.where(elig.sum() > 0, l2 <= mult * med,
                              torch.ones_like(ok))
        ok = ok & norm_ok
    return torch.where(screen > 0, ok.to(torch.float32),
                       torch.ones_like(surv))


def robust_aggregate(V: torch.Tensor, counts: torch.Tensor,
                     admitted: torch.Tensor, cfg: Config):
    """Order statistics over the clients' aggregation-space transmits
    V [W, n] (example-weighted sums) in place of the mean: per-cell
    coord_median or trim_beta-trimmed mean, or norm_clip to the cohort
    median. Cells of clients not admitted or not finite are excluded
    (`where`). Ranks and norms are taken on the per-client MEAN updates
    V / counts; the kept aggregate stays example-weighted. Returns (agg
    [n], contributors [W] f32, agg_stats [4])."""
    n_w = counts
    adm = admitted > 0
    E = adm[:, None] & torch.isfinite(V)
    zero = torch.zeros_like(V)
    wcol = n_w[:, None]
    total_w = n_w.sum()
    U = V / torch.clamp(n_w, min=1.0)[:, None]
    mean_agg = torch.where(E, V, zero).sum(0) / torch.clamp(total_w, min=1.0)
    n_trim = n_clip = V.new_zeros(())
    keep = E
    if cfg.aggregator == "coord_median":
        med = masked_median(U, E)
        agg = torch.where(E.any(dim=0), med, torch.zeros_like(med))
    elif cfg.aggregator == "trimmed_mean":
        vals = torch.where(E, U, torch.full_like(U, float("inf")))
        order = torch.argsort(vals, dim=0, stable=True)
        ranks = torch.argsort(order, dim=0, stable=True)
        n_e = E.sum(dim=0)
        # floor(beta * n_e) a side, at least one value left in a
        # nonempty cell
        m = torch.minimum(
            torch.floor(cfg.trim_beta * n_e.to(torch.float32)).to(n_e.dtype),
            torch.clamp(n_e - 1, min=0) // 2)
        keep = E & (ranks >= m[None, :]) & (ranks < (n_e - m)[None, :])
        ksum = torch.where(keep, wcol, torch.zeros_like(wcol)).sum(0)
        agg = torch.where(keep, V, zero).sum(0) / torch.clamp(ksum, min=1.0)
        n_trim = ((E & ~keep).to(torch.float32).sum()
                  / float(V.shape[1]))
    else:  # norm_clip
        l2u = torch.sqrt(torch.where(E, torch.square(U), zero).sum(1))
        elign = adm & (l2u > 0) & torch.isfinite(l2u)
        medn = masked_median(l2u, elign)
        clip = torch.where(elign & (l2u > medn),
                           medn / torch.clamp(l2u, min=1e-30),
                           torch.ones_like(l2u))
        n_clip = (clip < 1.0).sum().to(torch.float32)
        agg = (torch.where(E, V * clip[:, None], zero).sum(0)
               / torch.clamp(total_w, min=1.0))
    resid = torch.sqrt(torch.square(agg - mean_agg).sum())
    contrib = (adm & keep.any(dim=1)).to(torch.float32)
    stats = torch.stack([n_trim, n_clip, resid, contrib.sum()])
    return agg, contrib, stats


def straggler_budget(mask: torch.Tensor, work: torch.Tensor) -> torch.Tensor:
    """Each client's first ceil(f * valid) valid examples ([W, B]
    validity times the prefix): the examples a straggler got through."""
    kept = torch.cumsum(mask, dim=1) <= torch.ceil(work * mask.sum(dim=1)
                                                   )[:, None]
    return mask * kept.to(mask.dtype)


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


def client_state_rows(cfg: Config, num_clients: int) -> int:
    """The rows of the ClientState blocks: the population, or under
    --state_tier host the working set (federated/statestore.py)."""
    if cfg.state_tier != "device":
        return int(cfg.state_working_set)
    return int(num_clients)


def _sharded(layout) -> bool:
    """Whether the rows and the cohort are split over ranks."""
    return layout is not None and layout.connected


def local_rows(num_clients: int, layout=None) -> int:
    """The client rows one rank holds: the population padded to a
    multiple of the clients axis, divided by it (padding rows are inert:
    client ids stay below the population)."""
    n = 1 if layout is None else layout.clients
    return -(-int(num_clients) // n)


def init_client_state(cfg: Config, num_clients: int, device,
                      ps_weights: Optional[torch.Tensor] = None,
                      layout=None) -> ClientState:
    """Per-client rows for the blocks the config tracks, [0]
    placeholders otherwise. --topk_down's weight rows start as copies
    of `ps_weights` (the clients' download at init). With a layout,
    the rank's block of local_rows rows."""
    D = cfg.grad_size
    num_clients = local_rows(num_clients, layout)

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


def _tracked(cfg: Config):
    return (_has_errors(cfg), _has_velocities(cfg), cfg.do_topk_down)


def _owned(clients: ClientState, ids: torch.Tensor, layout):
    """(mask of the cohort slots whose client row this rank holds, their
    local row indices)."""
    R = next(b.shape[0] for b in clients if b.ndim == 2)
    lo = layout.clients_index * R
    mine = (ids >= lo) & (ids < lo + R)
    return mine, ids[mine] - lo


def gather_cohort(cfg: Config, clients: ClientState,
                  ids: torch.Tensor, layout=None) -> CohortState:
    """The participants' rows. `ids` is the whole cohort's; with a
    layout, each rank fills the rows it holds into a [tracked, W, D]
    zero buffer, one all_reduce over the clients group completes it,
    and the rank keeps its block's rows."""
    W = ids.shape[0]
    dev = ids.device
    tracked = _tracked(cfg)
    sharded = _sharded(layout)
    Wl = W // layout.clients if sharded else W
    full = None
    if sharded and any(tracked):
        mine, local = _owned(clients, ids, layout)
        blocks = [b for b, t in zip(clients, tracked) if t]
        buf = torch.zeros((len(blocks), W, cfg.grad_size),
                          dtype=torch.float32, device=dev)
        for j, b in enumerate(blocks):
            buf[j, mine] = b[local]
        full = iter(layout.block(layout.all_reduce(buf), dim=1))

    def rows(block, tracked):
        if not tracked:
            return torch.zeros(Wl, dtype=torch.float32, device=dev)
        return next(full) if full is not None else block[ids]

    return CohortState(*[rows(b, t) for b, t in zip(clients, tracked)])


def scatter_back(cfg: Config, clients: ClientState, ids: torch.Tensor,
                 cohort: CohortState, layout=None) -> ClientState:
    """The participants' updated rows back into the blocks. With a
    layout, the blocks' rows are gathered in cohort order (one
    all_reduce) and each rank writes the rows it holds."""
    tracked = _tracked(cfg)
    if _sharded(layout):
        if not any(tracked):
            return clients
        full = layout.gather(torch.stack(
            [r for r, t in zip(cohort, tracked) if t]), dim=1)
        mine, local = _owned(clients, ids, layout)
        for j, b in enumerate(b for b, t in zip(clients, tracked) if t):
            b[local] = full[j, mine]
        return clients
    for block, rows, t in zip(clients, cohort, tracked):
        if t:
            block[ids] = rows
    return clients


def gather_rows_by_id(block: torch.Tensor, ids: torch.Tensor, layout,
                      chunk_rows: int = 256) -> torch.Tensor:
    """[len(ids), D]: the rows of the clients `ids` of a block sharded
    by rank (each rank's local_rows), on every rank, in chunks of
    `chunk_rows` ids (one all_reduce each)."""
    if not _sharded(layout) or not len(ids):
        return block[ids]
    R, D = block.shape
    lo = layout.clients_index * R
    out = []
    for a in range(0, len(ids), chunk_rows):
        part = ids[a:a + chunk_rows]
        buf = block.new_zeros((len(part), D))
        mine = (part >= lo) & (part < lo + R)
        buf[mine] = block[part[mine] - lo]
        out.append(layout.all_reduce(buf))
    return torch.cat(out)


def gather_population(block: torch.Tensor, layout, chunk_rows: int = 256,
                      keep: bool = True):
    """A block sharded by rank as the whole [rows, D] population, in
    chunks of `chunk_rows` rows (one all_reduce each, every rank takes
    part): a host array where `keep`, else None (a rank that does not
    write the checkpoint never holds the whole block)."""
    if not _sharded(layout) or block.ndim < 2:
        return block.detach().cpu().numpy() if keep else None  # graftlint: disable=GL002 -- the checkpoint's copy of the rows, between rounds
    R, D = block.shape
    rows = R * layout.clients
    me = layout.clients_index
    out = np.empty((rows, D), np.float32) if keep else None
    for a in range(0, rows, chunk_rows):
        b = min(a + chunk_rows, rows)
        buf = block.new_zeros((b - a, D))
        # the overlap of [a, b) with this rank's rows [me R, (me+1) R)
        lo, hi = max(a, me * R), min(b, (me + 1) * R)
        if lo < hi:
            buf[lo - a:hi - a] = block[lo - me * R:hi - me * R]
        layout.all_reduce(buf)
        if keep:
            out[a:b] = buf.cpu().numpy()  # graftlint: disable=GL002 -- the checkpoint's copy of the rows, between rounds
    return out


def own_block(rows: np.ndarray, num_clients: int, layout,
              fill: Optional[np.ndarray] = None) -> np.ndarray:
    """The rank's block of a whole-population [rows, D] host array (a
    checkpoint's dense block, padded or not): local_rows rows from its
    clients position, missing rows taken from `fill` (a [D] row, or
    zeros)."""
    R = local_rows(num_clients, layout)
    lo = layout.clients_index * R
    got = np.asarray(rows[lo:lo + R], np.float32)
    if got.shape[0] == R:
        return got
    pad = np.zeros((R - got.shape[0], rows.shape[1]), np.float32)
    if fill is not None:
        pad[:] = fill
    return np.concatenate([got, pad])


def compute_dtype(cfg: Config):
    """The client body's type: torch.bfloat16 under --bf16, else None
    (the parameters' own float32)."""
    return torch.bfloat16 if cfg.do_bf16 else None


def reduce_transmit(cfg: Config, local_sum: torch.Tensor, layout=None,
                    encode: bool = True) -> torch.Tensor:
    """A rank's block sum of the client transmits as the whole cohort's,
    the round's one cross-rank sum. With `encode`: sketch linearity's
    one K1 encode of the block's sum (--defer_sketch_encode), then in
    sketch mode the quantized wire (the identity for f32), each rank
    rounding its block's sum as the JAX engine rounds each mesh
    shard's. Then the all_reduce over the clients group (the JAX
    engine's lax.psum). FedModel.cohort_transmit runs it too, without
    the encode."""
    if encode and cfg.defer_sketch_encode:
        local_sum = fserver.args2sketch(cfg).encode(local_sum)
    if encode and cfg.mode == "sketch":
        local_sum = wire_roundtrip(local_sum, cfg.sketch_table_dtype)
    if _sharded(layout):
        local_sum = layout.all_reduce(local_sum)
    return local_sum


def make_train_fn(loss_fn: fclient.LossFn, unravel: Callable, cfg: Config,
                  grad_mask: Optional[torch.Tensor] = None, layout=None):
    """The train-round callable:
        train_round(server, clients, batch, lr, key) -> (server, clients,
                                                         RoundMetrics)
    `lr` is the scheduler's learning rate for this round (a float, or a
    [D] tensor with per-parameter scales), `key` the run's threefry key
    (ops/prng.py), `grad_mask` an optional [D] float mask, 0 at frozen
    coordinates, `layout` the rank layout (module docstring). The
    RoundMetrics are the whole cohort's on every rank."""
    cfg.validate()
    sharded = _sharded(layout)
    n_blocks = layout.clients if sharded else 1
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

    def screen_and_aggregate(tx, counts, surv, pois, screen):
        """The screened family's tail over the per-client transmits tx
        [W, ...]: fault or attack, admission, then the where-sum, or
        under a robust aggregator the per-client encode, the wire and
        the order statistics. Returns (local_sum or the normalized
        robust aggregate, counts, admitted, contributors, agg_stats)."""
        gather = layout.gather if sharded else (lambda t: t)
        block = layout.block if sharded else (lambda t: t)
        if cfg.byzantine_rate > 0:
            if sharded and cfg.attack in ("little_is_enough", "colluding"):
                # the crafted update reads the whole cohort's transmits
                tx = block(attack(gather(tx), gather(pois), gather(surv),
                                  cfg, screen))
            else:
                tx = attack(tx, pois, surv, cfg, screen)
        else:
            tx = corrupt(tx, pois, cfg.poison_kind)
        ok, l2 = client_checks(tx, cfg)
        if sharded:
            # the cohort-median l2 over the whole cohort
            ok = gather(ok.to(torch.float32)) > 0
            l2 = None if l2 is None else gather(l2)
            admitted = surv * block(admit(ok, l2, gather(surv), screen,
                                          cfg))
        else:
            admitted = surv * admit(ok, l2, surv, screen, cfg)
        counts = counts * admitted
        if not cfg.robust_aggregation:
            keep = _rows(admitted, tx) > 0
            return (torch.where(keep, tx, torch.zeros_like(tx)).sum(dim=0),
                    counts, admitted, None, None)
        if cfg.defer_sketch_encode:
            # aggregation space: each client's table (K1 once a client,
            # on the rank that owns the client)
            sketch = fserver.args2sketch(cfg)
            tx = torch.stack([sketch.encode(t) for t in tx])
        if cfg.mode == "sketch":
            tx = wire_roundtrip(tx, cfg.sketch_table_dtype)
        Wl = tx.shape[0]
        # the order statistics over the whole cohort's tables, computed
        # replicated on every rank
        agg, contrib, stats = robust_aggregate(
            gather(tx.reshape(Wl, -1).to(torch.float32)), gather(counts),
            gather(admitted), cfg)
        return (agg.reshape(tx.shape[1:]).to(tx.dtype), counts, admitted,
                block(contrib), stats)

    def client_phase(ps_weights, batch: RoundBatch, cohort: CohortState,
                     lr, round_key):
        """The cohort's aggregate transmit, example counts, per-client
        losses/metrics, updated rows, and the screened family's masks:
        (transmit, counts, losses, metrics, cohort, admitted,
        contributors, agg_stats). The transmit is the summed one, or
        under a robust aggregator its normalized location estimate."""
        surv, work, pois = batch.survivors, batch.work, batch.poison
        mask = batch.mask
        if work is not None and not comp.local_sgd:
            mask = straggler_budget(mask, work)
        if cfg.fused_client_backward and pois is None:
            local_sum, losses, metrics, counts = fclient.fused_shard_grads(
                flat_loss, ps_weights, batch.data, mask, cfg,
                grad_mask=grad_mask, survivors=surv)
            return (local_sum, counts, losses, metrics, cohort, None,
                    None, None)
        results, new_w = [], []
        # a client's key is its place in the whole cohort
        base = (layout.clients_index * mask.shape[0]) if sharded else 0
        for c in range(mask.shape[0]):
            weights = client_weights(ps_weights, cohort.weights[c])
            data = tuple(x[c] for x in batch.data)
            if comp.local_sgd:
                res = fclient.fedavg_step(
                    flat_grad, weights, data, mask[c], cfg, lr,
                    grad_mask=grad_mask,
                    work=None if work is None else work[c])
            else:
                res = fclient.local_step(flat_grad, weights, data, mask[c],
                                         cohort.errors[c],
                                         cohort.velocities[c], cfg,
                                         fold_in(round_key, base + c),
                                         grad_mask=grad_mask)
            results.append(res)
            new_w.append(weights)
        tx = torch.stack([r.transmit for r in results])
        counts = torch.stack([r.num_examples for r in results])
        losses = torch.stack([r.loss for r in results])
        metrics = tuple(torch.stack([r.metrics[i] for r in results])
                        for i in range(len(results[0].metrics)))
        admitted = contrib = stats = None
        if pois is not None:
            local_sum, counts, admitted, contrib, stats = \
                screen_and_aggregate(tx, counts, surv, pois, batch.screen)
        elif surv is not None:
            # dropped clients' uploads zeroed before the sum
            local_sum = (tx * _rows(surv, tx)).sum(dim=0)
            counts = counts * surv
        else:
            local_sum = tx.sum(dim=0)
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
        return (local_sum, counts, losses, metrics, cohort, admitted,
                contrib, stats)

    def gather_rows(*vecs):
        """The [W_local] per-client vectors of the rank's block as the
        whole cohort's [W], in cohort order: one gather of them all
        (None stays None)."""
        if not sharded:
            return vecs
        full = layout.gather(torch.stack(
            [v.to(torch.float32) for v in vecs if v is not None], dim=1))
        cols = iter(full.unbind(1))
        return tuple(None if v is None else next(cols).to(v.dtype)
                     for v in vecs)

    def round_step(server: ServerState, cohort: CohortState,
                   batch: RoundBatch, lr, key):
        round_key = fold_in(key, server.round_idx)
        # the local block's slots, and the whole cohort's
        Wl = batch.mask.shape[0]
        W = Wl * n_blocks
        dev = batch.mask.device
        if batch.poison is not None:
            # the screened family always has survivors and a screen flag
            batch = batch._replace(
                survivors=(torch.ones(Wl, device=dev)
                           if batch.survivors is None
                           else batch.survivors.float()),
                poison=batch.poison.float(),
                screen=(torch.ones((), device=dev) if batch.screen is None
                        else torch.as_tensor(batch.screen, dtype=torch.float32,
                                             device=dev)))
        elif batch.work is not None and batch.survivors is None:
            batch = batch._replace(survivors=torch.ones(Wl, device=dev))
        (local_sum, counts, losses, metrics, new_cohort, admitted, contrib,
         agg_stats) = client_phase(server.ps_weights, batch, cohort, lr,
                                   round_key)
        robust = admitted is not None and cfg.robust_aggregation
        if not robust:
            # a robust aggregate is already the whole cohort's
            local_sum = reduce_transmit(cfg, local_sum, layout)
        transmit = comp.post_aggregate(cfg, local_sum, round_key)
        # the rows the rank's block keeps, before the cohort's gather
        eff_local = admitted if admitted is not None else batch.survivors
        counts, losses, admitted, contrib, survivors, *metrics = \
            gather_rows(counts, losses, admitted, contrib,
                        batch.survivors, *metrics)
        metrics = tuple(metrics)
        total = counts.sum()
        # a robust aggregate is already the normalized estimate
        gradient = (transmit if robust
                    else transmit / torch.clamp(total, min=1.0))
        eff = admitted if admitted is not None else survivors
        # a round nobody completed (or every client was screened out)
        # leaves the server state bitwise untouched
        alive = None if eff is None else eff.sum() > 0
        upd = fserver.get_server_update(gradient, server.Vvelocity,
                                        server.Verror, cfg, lr,
                                        key=fold_in(round_key, W),
                                        alive=alive)
        if alive is None:
            new_ps = server.ps_weights - upd.update
        else:
            new_ps = torch.where(alive, server.ps_weights - upd.update,
                                 server.ps_weights)
        # round_idx advances on a dead round too: it indexes the key
        # stream and the fault draws
        new_server = ServerState(new_ps, upd.Vvelocity, upd.Verror,
                                 server.round_idx + 1)
        keep = None if eff_local is None else eff_local[:, None] > 0
        if _has_errors(cfg) and keep is not None:
            new_cohort = new_cohort._replace(errors=torch.where(
                keep, new_cohort.errors, cohort.errors))
        if _has_velocities(cfg):
            vel = new_cohort.velocities
            if upd.velocity_mask is not None:
                # true_topk momentum factor masking, participants' rows
                vel = vel * upd.velocity_mask[None, :]
            if keep is not None:
                vel = torch.where(keep, vel, cohort.velocities)
            new_cohort = new_cohort._replace(velocities=vel)
        if cfg.do_topk_down and keep is not None:
            # a dropped client never received the download
            new_cohort = new_cohort._replace(weights=torch.where(
                keep, new_cohort.weights, cohort.weights))
        if cfg.telemetry:
            tele = tmetrics.round_vector(
                losses=losses, counts=counts,
                delta=new_ps - server.ps_weights, verror=upd.Verror,
                vvelocity=upd.Vvelocity,
                survivors=W if eff is None else eff.sum())
        else:
            tele = tmetrics.empty_vector(new_ps.device)
        return new_server, new_cohort, RoundMetrics(
            losses, metrics, counts, tele, admitted, contrib, agg_stats)

    def train_round(server: ServerState, clients: ClientState,
                    batch: RoundBatch, lr, key):
        # host spans of the three dispatches (telemetry/trace.py); the
        # round tag comes from the caller's enclosing `dispatch` span.
        # The recorder's stages are the JAX engine's three programs
        # (the round, and the two state-motion programs around it)
        with hooks.program():
            with TRACE.span("gather"), hooks.stage("gather"):
                cohort = gather_cohort(cfg, clients, batch.client_ids,
                                       layout)
            with TRACE.span("round_dispatch"), hooks.stage("round"):
                server, cohort, metrics = round_step(server, cohort, batch,
                                                     lr, key)
            with TRACE.span("scatter"), hooks.stage("scatter"):
                clients = scatter_back(cfg, clients, batch.client_ids,
                                       cohort, layout)
        return server, clients, metrics

    train_round.round_step = round_step
    train_round.client_phase = client_phase
    return train_round


def make_eval_fn(loss_fn: fclient.LossFn, unravel: Callable, cfg: Config,
                 layout=None):
    """eval_batch(ps_weights, data [S, vb, ...], mask [S, vb]) ->
    per-shard (loss [S], metrics, count [S]), forward only, in the
    train round's compute type. With a layout each rank evaluates its
    block of the shards and the per-shard values are gathered in shard
    order."""
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
        if _sharded(layout):
            out = layout.gather(torch.stack([loss, *metrics, count], dim=1))
            loss, *metrics, count = out.unbind(1)
            metrics = tuple(metrics)
        return loss, metrics, count

    return eval_batch
