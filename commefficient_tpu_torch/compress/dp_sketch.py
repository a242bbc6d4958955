"""dp_sketch: differentially private FetchSGD transport, the port of
commefficient_tpu/compress/dp_sketch.py.

The Gaussian mechanism in sketch space:
  * every client encodes its gradient into the [r, c] count-sketch
    table on its own (K1 once a client; never the deferred cohort
    encode, because the clip below is nonlinear) and, after the count
    scaling that makes the table its SUM contribution, clips the
    table's Frobenius norm to --dp_clip: the sum's l2 sensitivity to
    one client is dp_clip;
  * once a round, noise of std dp_noise_mult * dp_clip is added to the
    aggregate table, drawn on the "dp" PRNG domain folded into the
    round key (ops/prng.py), so a resumed run replays the same noise;
  * the divide by the example total and the sketch-mode server step
    (K2 and the top-k) are post-processing.

compress/privacy.RdpAccountant tracks the composition over rounds
(federated/api.py journals a `privacy` event a round and raises once
--dp_target_epsilon is exceeded). validate() refuses --dp (two
mechanisms would spend the budget twice) and the robust aggregators
(an order statistic is not the bounded-sensitivity sum the noise is
calibrated for), as the JAX package does.
"""
from __future__ import annotations

from commefficient_tpu_torch.compress.base import Compressor
from commefficient_tpu_torch.ops import prng
from commefficient_tpu_torch.ops.flat import clip_to_l2
from commefficient_tpu_torch.utils.faults import DOMAINS


def _fserver():
    from commefficient_tpu_torch.federated import server as fserver
    return fserver


class DpSketchCompressor(Compressor):
    name = "dp_sketch"
    sketch_like = True

    # ---- static specs -------------------------------------------------
    def wire_floats(self, cfg) -> int:
        # the table rides the wire at f32 (wire_bytes: 4 x this)
        return cfg.num_rows * cfg.num_cols

    def validate(self, cfg) -> None:
        if cfg.dp_noise_mult <= 0:
            raise ValueError(
                "dp_sketch requires --dp_noise_mult > 0: zero noise "
                "is not differential privacy — use --mode sketch for "
                "the noise-free transport (compress/dp_sketch.py)")
        if cfg.dp_clip <= 0:
            raise ValueError(
                f"dp_clip={cfg.dp_clip} must be > 0 (the per-client "
                "sketch-table sensitivity bound)")
        if not 0.0 < cfg.dp_delta < 1.0:
            raise ValueError(
                f"dp_delta={cfg.dp_delta} must be in (0, 1)")
        if cfg.dp_target_epsilon < 0:
            raise ValueError(
                f"dp_target_epsilon={cfg.dp_target_epsilon} must be "
                ">= 0 (0 = track epsilon but never fail)")
        if cfg.error_type == "local":
            raise ValueError(
                "dp_sketch cannot use per-client local error "
                "accumulation (same table-space contract as sketch "
                "mode)")
        if cfg.local_momentum != 0:
            raise ValueError(
                "dp_sketch cannot use local momentum (same table-"
                "space contract as sketch mode)")
        if cfg.do_dp:
            raise ValueError(
                "--dp (the per-gradient worker/server DP path) and "
                "--mode dp_sketch are mutually exclusive: two "
                "mechanisms would each consume privacy budget the "
                "accountant tracks only once (compress/dp_sketch.py)")
        if cfg.robust_aggregation:
            raise ValueError(
                "dp_sketch does not compose with robust aggregators "
                f"(--aggregator {cfg.aggregator}): the Gaussian noise "
                "is calibrated for the bounded-sensitivity SUM of "
                "dp_clip-clipped tables, and an order statistic has "
                "no such sensitivity bound — pick one "
                "(compress/dp_sketch.py)")

    # ---- round seams --------------------------------------------------
    def encode(self, cfg, grad, key=None):
        return _fserver().args2sketch(cfg).encode(grad)

    def residual(self, cfg, to_transmit, error, velocity, key=None):
        # the count-scaled [r, c] table, Frobenius-clipped to dp_clip
        return clip_to_l2(to_transmit, cfg.dp_clip), error, velocity

    def post_aggregate(self, cfg, transmit, key=None):
        sigma = cfg.dp_noise_mult * cfg.dp_clip
        noise = prng.normal(prng.fold_in(key, DOMAINS["dp"]),
                            tuple(transmit.shape), device=transmit.device)
        return transmit + sigma * noise

    def decode(self, cfg, gradient, Vvelocity, Verror, lr, key=None):
        return _fserver()._sketched(gradient, Vvelocity, Verror, cfg,
                                    lr, key)
