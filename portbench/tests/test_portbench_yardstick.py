"""The frozen formulas: the model FLOPs against the port's round
recorder on one tiny round, and each region's bound against hand counts
at the cells' shapes."""
import os
import tempfile

import pytest
import torch

from portbench.tests import tiny
from portbench import corpus, harness, yardstick

GIB = 2 ** 30


@pytest.fixture(autouse=True)
def _threads():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def test_model_flops_are_the_recorded_matmuls(tmp_path):
    """One tiny round under analysis/recorder.py: its matrix products'
    FLOPs are the formula's, plus the MC head's 6 x n_embd a sequence
    (forward and both backward products), which the formula leaves
    out. The tiny L is under 256, so attention runs as products the
    recorder sees."""
    from commefficient_tpu_torch.analysis import costmodel
    from commefficient_tpu_torch.analysis.recorder import RoundRecorder
    from commefficient_tpu_torch.config import parse_args
    from commefficient_tpu_torch.data.persona import HashTokenizer
    from commefficient_tpu_torch.training import gpt2_train
    cell = tiny.load(tmp_path)
    data = tempfile.mkdtemp(dir=str(tmp_path))
    corpus.write_raw(data, corpus.make_raw(tiny.CORPUS, 5))
    cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR,
                     argv=harness.program_flags(cell, 5, "cpu", data))
    model, opt, _, loader, _ = gpt2_train.build(cfg, HashTokenizer(500),
                                                device="cpu")
    opt.param_groups[0]["lr"] = 0.04
    batch = next(iter(loader.epoch()))
    with RoundRecorder() as rec:
        model(batch)
    got = costmodel.class_flops(rec.records)["matmul"]
    L = loader.dataset.seq_len
    assert L < 256
    sequences = 4 * 2 * 2
    want = sequences * L * yardstick.model_flops_per_token(2, 32, 500, L)
    assert got == want + 6 * 32 * sequences


def test_gpt2_small_round_flops():
    # 8 x 8 x 2 x 299 tokens: 2.97e13, the issue's count
    f = 8 * 8 * 2 * 299 * yardstick.model_flops_per_token(12, 768, 50262,
                                                          299)
    assert 2.96e13 < f < 2.98e13


D_S, D_M, C, R = 124_444_417, 354_829_313, 500_000, 5


def test_encode_bound():
    s, kind = yardstick.region_bound("sketch_encode", ((D_S,), (R, 249)),
                                     D_S, C)
    assert kind == "bytes"
    assert s == pytest.approx((4 * D_S + 4 * R * C) / 3.35e12)


def test_threshold_bounds():
    B = -(-D_S // C)
    assert B == 249
    stride = (B * C) // 2 ** 20
    assert stride == 118 and yardstick.sample_columns(D_S, C) == C // 118
    s, _ = yardstick.region_bound("threshold_sample", ((R, C), (R, B)),
                                  D_S, C)
    assert s == pytest.approx((4 * R * C + 4 * B * (C // 118)) / 3.35e12)
    s, _ = yardstick.region_bound("threshold_mask", ((R, C), (R, B)),
                                  D_S, C)
    assert s == pytest.approx((4 * R * C + 4 * D_S) / 3.35e12)


def test_window_bounds():
    sizes = yardstick.window_sizes(D_M, C)
    assert sizes == [134] * 5 + [40]
    total = sum(yardstick.region_bound(
        "sketch_estimate_window", ((R, C), (R, 710)), D_M, C, nb)[0]
        for nb in sizes)
    assert total == pytest.approx((6 * 4 * R * C + 4 * 710 * C) / 3.35e12)


@pytest.mark.parametrize("H", [12, 16])
def test_attention_bound(H):
    B, L, dh = 16, 299, 64
    s, kind = yardstick.region_bound("flash_fwd", ((B, H, L, dh),), 0, 0)
    t_bytes = (4 * 4 * B * H * L * dh + 4 * B * H * L) / 3.35e12
    t_ops = 4 * dh * B * H * L * (L + 1) / 2 / 495e12
    assert s == pytest.approx(max(t_bytes, t_ops))
    assert kind == ("bytes" if t_bytes >= t_ops else "ops")


def test_unknown_region_has_no_bound():
    assert yardstick.region_bound("something_else", ((1,),), 1, 1) is None
