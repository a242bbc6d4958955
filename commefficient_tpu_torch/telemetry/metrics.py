"""Round metrics: the port of commefficient_tpu/telemetry/metrics.py.

Every round with Config.telemetry on yields one [NUM_METRICS] f32
tensor on the round's device, computed from values the round already
has (losses, counts, the applied weight delta, the new server
momentum and error). It feeds nothing back, so server and client state
are bitwise the same with telemetry on and off.

  train_loss        example-weighted mean client loss
  update_l2         l2 norm of the applied weight delta
  error_l2          l2 norm of the new server error accumulator
  velocity_l2       l2 norm of the new server momentum
  survivors         clients that completed the round
  examples          examples processed
  realized_k        nonzero count of the applied delta
  estimate_residual error_l2 / (error_l2 + update_l2): the share of
                    accumulated update mass the compressed channel did
                    not send this round
"""
from __future__ import annotations

import torch

METRIC_NAMES = (
    "train_loss",
    "update_l2",
    "error_l2",
    "velocity_l2",
    "survivors",
    "examples",
    "realized_k",
    "estimate_residual",
)
NUM_METRICS = len(METRIC_NAMES)
METRIC_INDEX = {name: i for i, name in enumerate(METRIC_NAMES)}

_EPS = 1e-12


def empty_vector(device=None) -> torch.Tensor:
    """The telemetry-off placeholder, a [0] f32 tensor."""
    return torch.zeros((0,), dtype=torch.float32, device=device)


def round_vector(losses, counts, delta, verror, vvelocity,
                 survivors) -> torch.Tensor:
    """[NUM_METRICS] f32 from values the round already computed.

    losses [W] per-client mean losses; counts [W] examples each client
    processed; delta [D] the applied update (new_ps - old_ps); verror,
    vvelocity the new server state (any shape, may be size 0);
    survivors the number of clients that completed the round."""
    counts = counts.to(torch.float32)
    total = counts.sum()
    train_loss = (losses * counts).sum() / torch.clamp(total, min=1.0)
    update_l2 = torch.sqrt(torch.sum(delta * delta))
    error_l2 = torch.sqrt(torch.sum(verror.to(torch.float32) ** 2))
    velocity_l2 = torch.sqrt(torch.sum(vvelocity.to(torch.float32) ** 2))
    realized_k = torch.sum(delta != 0).to(torch.float32)
    estimate_residual = error_l2 / (error_l2 + update_l2 + _EPS)
    return torch.stack([
        train_loss,
        update_l2,
        error_l2,
        velocity_l2,
        # a count on the device (a tensor under faults) or a fill, not
        # a host copy (which would wait for the queued round)
        (survivors.to(torch.float32).reshape(())
         if isinstance(survivors, torch.Tensor)
         else total.new_full((), float(survivors))),
        total,
        realized_k,
        estimate_residual,
    ])


def named(vec) -> dict:
    """{metric name: float} from one host [NUM_METRICS] vector, {} for
    the placeholder."""
    if vec is None or getattr(vec, "size", 0) == 0:
        return {}
    return {name: float(vec[i]) for i, name in enumerate(METRIC_NAMES)}
