"""The lower-precision control on the card: the plain reference with
TF32 matrix products put in the program's place is not correct against
the float32 reference, at the first cell's own size. Needs a CUDA card
(run it there with `python3 -m pytest portbench/tests -m gpu`)."""
import os

import pytest
import torch

from portbench.tests import tiny  # noqa: F401  (puts the repo on sys.path)
from portbench import check, harness, spec


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202,
                                  2 ** 31 + 303])
def test_the_tf32_control_is_not_correct(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32 on its tensor "
                    "cores")
    harness.set_cache_dirs(tiny.ROOT)
    cell = spec.load_cell("gpt2s-sketch.c8x8",
                          os.path.join(tiny.ROOT, "BENCHMARK.json"))
    raw, batches, leaves = harness.first_batches(cell, seed, "cuda")
    numbers = check.against_reference(
        cell.config, cell.traffic, raw, {"batches": batches}, seed, leaves,
        torch.device("cuda"), tf32_program=True)
    correct, checks = check.verdict(numbers, cell.limits)
    assert not correct, checks
