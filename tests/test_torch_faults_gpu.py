"""The fault-tolerant round on a CUDA card: the screen and the robust
aggregators on card tensors against the same functions on the CPU, and
faulted uncompressed rounds of cv_train's model (no top-k, whose ties
a last-bit difference may reorder) on the card against the CPU. The
cases carry the `gpu` marker and skip without a card; on the card:
`python -m pytest tests/test_torch_faults_gpu.py -m gpu --noconftest`
(this file imports no jax; tests/conftest.py does). Tolerances: the
masks equal; the aggregates within 1e-6 relative (the card sums in
another order); the rounds' weights within 1e-5 of their scale, the
bytes equal."""
import numpy as np
import pytest
import torch

from commefficient_tpu_torch.config import Config, parse_args
from commefficient_tpu_torch.federated import round as fround
from commefficient_tpu_torch.training import cv_train

pytestmark = pytest.mark.torch_port


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the card half of the fault round; "
                    "the CPU half is tests/test_torch_faults.py)")
    return torch.device("cuda")


def _tables(W, seed, r=5, c=1000):
    rng = np.random.RandomState(seed)
    t = rng.randn(W, r, c).astype(np.float32)
    t[1, 0, :7] = np.nan
    t[W - 1] *= 10.0
    surv = np.ones(W, np.float32)
    surv[0] = 0.0
    counts = rng.randint(2, 33, size=W).astype(np.float32)
    return t, surv, counts


@pytest.mark.gpu
@pytest.mark.parametrize("W", [7, 8])
@pytest.mark.parametrize("aggregator", ["coord_median", "trimmed_mean",
                                        "norm_clip"])
def test_screen_and_aggregators_on_the_card_match_the_cpu(cuda_device,
                                                          aggregator, W):
    t, surv, counts = _tables(W, 3)
    cfg = Config(update_screen="norm", aggregator=aggregator, trim_beta=0.25)
    out = {}
    for dev in ("cpu", cuda_device):
        tt = torch.from_numpy(t).to(dev)
        ss = torch.from_numpy(surv).to(dev)
        admit = fround.admission(tt, ss, torch.ones((), device=dev), cfg)
        adm = ss * admit
        V = (tt * torch.from_numpy(counts).to(dev)[:, None, None]
             ).reshape(W, -1)
        agg, contrib, stats = fround.robust_aggregate(
            V, torch.from_numpy(counts).to(dev) * adm, adm, cfg)
        out[str(dev)] = [x.cpu().numpy() for x in (admit, agg, contrib,
                                                   stats)]
    cpu, card = out["cpu"], out[str(cuda_device)]
    np.testing.assert_array_equal(card[0], cpu[0])
    np.testing.assert_array_equal(card[2], cpu[2])
    for got, want in ((card[1], cpu[1]), (card[3], cpu[3])):
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [
    ("--client_dropout", "0.3", "--straggler_rate", "0.5",
     "--straggler_cutoff", "0.2"),
    ("--update_screen", "norm", "--byzantine_rate", "0.3", "--attack",
     "colluding", "--aggregator", "coord_median"),
], ids=["dropout-stragglers", "byzantine-coord_median"])
def test_faulted_rounds_on_the_card_match_the_cpu(cuda_device, tmp_path,
                                                  flags):
    results = {}
    for device in ("cpu", "cuda"):
        cfg = parse_args(argv=[
            "--test", "--device", device, "--mode", "uncompressed",
            "--local_momentum", "0",
            "--num_workers", "4", "--local_batch_size", "8",
            "--num_clients", "20", "--dataset_dir", str(tmp_path / "ds"),
            "--no_telemetry", *flags])
        model, opt, _, loader, _ = cv_train.build(
            cfg, device=device, synthetic_examples=(160, 32))
        nbytes = []
        for batch in list(loader.epoch())[:3]:
            opt.param_groups[0]["lr"] = 0.1
            _, _, down, up = model(batch)
            nbytes.append((down.tolist(), up.tolist()))
        results[device] = (model.ps_weights.cpu().numpy(), nbytes)
    w_cpu, b_cpu = results["cpu"]
    w_card, b_card = results["cuda"]
    assert b_card == b_cpu
    np.testing.assert_allclose(w_card, w_cpu, rtol=0,
                               atol=1e-5 * np.abs(w_cpu).max())
