"""The compressor plugins and spans on a CUDA card: PowerSGD's residual
seam, dp_sketch's per-client encode and noise, and spanned / pipelined
rounds of a small model, each on card tensors against the same
functions on the CPU. The cases carry the `gpu` marker and skip without
a card; on the card:
`python -m pytest tests/test_torch_compress_gpu.py -m gpu --noconftest`
(this file imports no jax; tests/conftest.py does). Tolerances: K1
exact; the seams within 1e-5 relative L2 (the GEMMs sum in another
order; TF32 off); the noise draw within 1e-6 relative (prng.normal's
erf_inv on the card); spans bitwise the plain loop ON THE CARD."""
import numpy as np
import pytest
import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.federated.api import FedModel, FedOptimizer
from commefficient_tpu_torch.federated.server import args2sketch
from commefficient_tpu_torch.ops import prng
from commefficient_tpu_torch.ops.kernels import sketch_cuda
from commefficient_tpu_torch.training.scanloop import run_scanned_rounds

pytestmark = pytest.mark.torch_port


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the card half of the plugins and "
                    "spans; the CPU half is tests/test_torch_compress.py "
                    "and tests/test_torch_pipeline.py)")
    return torch.device("cuda")


def _rel(a, b) -> float:
    return float((a.double().cpu() - b.double().cpu()).norm()
                 / b.double().cpu().norm())


@pytest.mark.gpu
@pytest.mark.parametrize("d,rank", [(99_242, 2), (1_000_003, 1)])
def test_powersgd_seam_on_the_card_matches_the_cpu(cuda_device, d, rank):
    cfg = Config(mode="powersgd", error_type="local", local_momentum=0.0,
                 powersgd_rank=rank, grad_size=d)
    rng = np.random.RandomState(d)
    acc = torch.from_numpy(rng.randn(d).astype(np.float32))
    key = prng.fold_in(prng.PRNGKey(21), 3)
    for vel in (torch.zeros(d), torch.from_numpy(
            rng.randn(d).astype(np.float32))):
        cpu = cfg.compressor.residual(cfg, acc, None, vel, key)
        card = cfg.compressor.residual(cfg, acc.to(cuda_device), None,
                                       vel.to(cuda_device), key)
        for a, b in zip(card, cpu):
            assert _rel(a, b) <= 1e-5


@pytest.mark.gpu
def test_dp_sketch_encode_and_noise_on_the_card(cuda_device):
    cfg = Config(mode="dp_sketch", error_type="virtual", local_momentum=0.0,
                 num_rows=5, num_cols=50_000, dp_noise_mult=0.5,
                 grad_size=654_321)
    g = torch.from_numpy(np.random.RandomState(1).randn(cfg.grad_size)
                         .astype(np.float32))
    before = sketch_cuda.LAUNCHES["sketch_encode"]
    t_card = cfg.compressor.encode(cfg, g.to(cuda_device))
    assert sketch_cuda.LAUNCHES["sketch_encode"] == before + 1
    sk = args2sketch(cfg)
    assert torch.equal(t_card.cpu(), sk.encode(g))
    clipped, _, _ = cfg.compressor.residual(cfg, 40.0 * t_card, None, None)
    assert float(torch.linalg.vector_norm(clipped.double())) <= 1.0 + 1e-6
    key = prng.fold_in(prng.PRNGKey(21), 7)
    zero = torch.zeros(5, 50_000)
    n_cpu = cfg.compressor.post_aggregate(cfg, zero, key)
    n_card = cfg.compressor.post_aggregate(cfg, zero.to(cuda_device), key)
    assert float((n_card.cpu() - n_cpu).abs().max()) <= \
        1e-6 * float(n_cpu.abs().max())


class _Linear(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(d))


def _loss(params, batch, mask):
    x, y = batch
    per_ex = 0.5 * (x @ params["w"] - y) ** 2
    loss = (per_ex * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, (loss,)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sketch", "powersgd", "dp_sketch"])
@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["spanned", "pipelined"])
def test_spans_on_the_card_are_bitwise_the_plain_loop(cuda_device, mode,
                                                      pipeline):
    # pinned, asynchronous placement and the queue running ahead change
    # nothing: the same kernels in the same order on one stream
    d, W = 4096, 8
    kw = {"sketch": dict(error_type="virtual", k=64, num_rows=3,
                         num_cols=512),
          "powersgd": dict(error_type="local", powersgd_rank=2),
          "dp_sketch": dict(error_type="virtual", k=64, num_rows=3,
                            num_cols=512, dp_noise_mult=0.5)}[mode]
    rng = np.random.RandomState(5)
    stream = [(r, np.arange(W), (rng.randn(W, 4, d).astype(np.float32),
                                 rng.randn(W, 4).astype(np.float32)),
               np.ones((W, 4), np.float32), 0.1) for r in range(5)]

    def model():
        m = FedModel(_Linear(d), _loss,
                     Config(mode=mode, local_momentum=0.0,
                            virtual_momentum=0.9, num_workers=W,
                            num_clients=W, weight_decay=0.0,
                            client_dropout=0.25, pipeline=pipeline, **kw),
                     device=cuda_device, num_clients=W)
        FedOptimizer(m).param_groups[0]["lr"] = 0.1
        return m

    plain = model()
    for _, ids, data, mask, _ in stream:
        plain((ids, data, mask))
    spanned = model()
    assert run_scanned_rounds(spanned, iter(stream), 2,
                              lambda *a: True, pipeline=pipeline)
    spanned.close_persistence()
    torch.cuda.synchronize()
    for a, b in zip((*plain.server[:3], *plain.clients),
                    (*spanned.server[:3], *spanned.clients)):
        assert torch.equal(a, b)
    for k, v in plain.accountant.state_dict().items():
        np.testing.assert_array_equal(spanned.accountant.state_dict()[k], v)
