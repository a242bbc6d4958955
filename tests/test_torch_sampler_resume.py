"""The port's FedSampler stream state (data/sampler.py): the cases of
tests/test_sampler_resume.py that need no scheduler, run on the port's
sampler; its state_dict key for key equal to the JAX sampler's after the
same draws; a state written by one package continuing the identical
stream in the other; and the train loader's augmentation stream
carried through a resume. Exact equality throughout: the draws are
numpy's, in the same order."""
import numpy as np
import pytest

from commefficient_tpu.data.sampler import FedSampler as JFedSampler
from commefficient_tpu.utils.checkpoint import (
    load_checkpoint as j_load_checkpoint, save_checkpoint as j_save_checkpoint,
)
from commefficient_tpu_torch.data.sampler import FedSampler
from commefficient_tpu_torch.federated.round import ServerState
from commefficient_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint,
)

pytestmark = pytest.mark.torch_port

N_CLIENTS = 12
W = 4
B = 3
DPC = np.array([7, 5, 9, 6, 8, 5, 7, 6, 9, 8, 7, 9])


def drain(sampler, n, gen=None):
    """Draw `n` rounds across epoch boundaries (a fresh epoch() per
    exhaustion), as the drivers' epoch loops do, continuing `gen` when
    given. Returns the rounds (and with `gen`, the live generator)."""
    out, keep = [], gen is not None
    while len(out) < n:
        if gen is None:
            gen = sampler.epoch()
        try:
            out.append(next(gen))
        except StopIteration:
            gen = None
    return (out, gen) if keep else out


def assert_streams_equal(a, b):
    assert len(a) == len(b)
    for i, (r1, r2) in enumerate(zip(a, b)):
        assert np.array_equal(r1.client_ids, r2.client_ids), i
        assert np.array_equal(r1.idx_within, r2.idx_within), i
        assert np.array_equal(r1.mask, r2.mask), i


def _capped_epoch(sampler, cap, collect):
    """The drivers' protocol: pull at most `cap` rounds of one epoch
    (the cap checked before each pull), then mark abandonment."""
    gen = sampler.epoch()
    drawn = 0
    while drawn < cap:
        try:
            collect.append(next(gen))
        except StopIteration:
            return drawn
        drawn += 1
    sampler.abandon_epoch()
    return drawn


# ---------------- the JAX package's bare-sampler cases ---------------------

def test_mid_epoch_state_roundtrip_is_stream_bit_exact():
    reference = drain(FedSampler(DPC, W, B, seed=7), 14)
    crashed = FedSampler(DPC, W, B, seed=7)
    head = drain(crashed, 5)
    state = crashed.state_dict()
    assert int(state["in_epoch"]) == 1
    resumed = FedSampler(DPC, W, B, seed=7)
    resumed.load_state_dict(state)
    assert resumed.resume_pending
    assert resumed.resolve_resume(5) == 0
    assert_streams_equal(reference, head + drain(resumed, 9))


def test_epoch_boundary_state_discards_pending():
    ref = FedSampler(DPC, W, B, seed=3)
    for _ in ref.epoch():
        pass
    state = ref.state_dict()
    assert int(state["in_epoch"]) == 0
    after_ref = drain(ref, 4)
    resumed = FedSampler(DPC, W, B, seed=3)
    resumed.load_state_dict(state)
    assert resumed.resolve_resume(0) == 0
    assert not resumed.resume_pending
    assert_streams_equal(after_ref, drain(resumed, 4))


def test_resolve_resume_is_identity_without_state():
    s = FedSampler(DPC, W, B, seed=0)
    assert s.resolve_resume(5) == 5
    assert s.resolve_resume(0) == 0


def test_abandon_epoch_marks_checkpoint_fresh():
    ref = FedSampler(DPC, W, B, seed=9)
    gen = ref.epoch()
    for _ in range(5):
        next(gen)
    ref.abandon_epoch()
    state = ref.state_dict()
    assert int(state["in_epoch"]) == 0
    after_ref = drain(ref, 5)
    resumed = FedSampler(DPC, W, B, seed=9)
    resumed.load_state_dict(state)
    assert not resumed.resume_pending
    assert resumed.resolve_resume(5) == 0
    assert_streams_equal(after_ref, drain(resumed, 5))


def test_mid_epoch_pending_survives_zero_skip():
    reference = drain(FedSampler(DPC, W, B, seed=13), 9)
    crashed = FedSampler(DPC, W, B, seed=13)
    drain(crashed, 4)
    state = crashed.state_dict()
    resumed = FedSampler(DPC, W, B, seed=13)
    resumed.load_state_dict(state)
    assert resumed.resolve_resume(0) == 0
    assert resumed.resume_pending
    assert_streams_equal(reference[4:], drain(resumed, 5))


def test_resume_from_at_cap_checkpoint_matches_abandonment():
    CAP = 5
    ref = FedSampler(DPC, W, B, seed=17)
    assert _capped_epoch(ref, CAP, []) == CAP
    ref_next = []
    _capped_epoch(ref, CAP, ref_next)

    crashed = FedSampler(DPC, W, B, seed=17)
    gen = crashed.epoch()
    for _ in range(CAP):
        next(gen)
    state = crashed.state_dict()
    assert int(state["in_epoch"]) == 1
    resumed = FedSampler(DPC, W, B, seed=17)
    resumed.load_state_dict(state)
    assert resumed.resolve_resume(0) == 0
    assert resumed.pending_pos == CAP
    resumed.discard_pending()
    res_next = []
    _capped_epoch(resumed, CAP, res_next)
    assert_streams_equal(ref_next, res_next)


def test_resumed_epoch_budget_is_cap_remainder():
    CAP = 6
    ref = FedSampler(DPC, W, B, seed=19)
    ref_rounds, ref_next = [], []
    _capped_epoch(ref, CAP, ref_rounds)
    _capped_epoch(ref, CAP, ref_next)

    crashed = FedSampler(DPC, W, B, seed=19)
    gen = crashed.epoch()
    for _ in range(4):
        next(gen)
    resumed = FedSampler(DPC, W, B, seed=19)
    resumed.load_state_dict(crashed.state_dict())
    assert resumed.resolve_resume(4) == 0
    pos = resumed.pending_pos
    assert pos == 4
    tail, res_next = [], []
    _capped_epoch(resumed, CAP - pos, tail)
    assert_streams_equal(ref_rounds[4:], tail)
    _capped_epoch(resumed, CAP, res_next)
    assert_streams_equal(ref_next, res_next)


def test_restored_boundary_state_never_skips_despite_spe_drift():
    ref = FedSampler(DPC, W, B, seed=5)
    drain(ref, 3)
    for _ in ref.epoch():
        pass
    state = ref.state_dict()
    assert int(state["in_epoch"]) == 0
    after_ref = drain(ref, 4)
    resumed = FedSampler(DPC, W, B, seed=5)
    resumed.load_state_dict(state)
    assert resumed.resolve_resume(3) == 0
    assert_streams_equal(after_ref, drain(resumed, 4))


def test_state_rejects_mismatched_dataset():
    s = FedSampler(DPC, W, B, seed=0)
    drain(s, 2)
    with pytest.raises(ValueError, match="does not match"):
        FedSampler(DPC[:-1], W, B, seed=0).load_state_dict(s.state_dict())


# ---------------- against the JAX sampler ----------------------------------

# (rounds drawn, then abandon?) — mid-epoch, an exhausted epoch, an
# abandoned one, and before any draw
POINTS = [(5, False), (10, False), (5, True), (0, False)]


def _advance(sampler, n, abandon):
    drain(sampler, n)
    if abandon:
        sampler.abandon_epoch()


@pytest.mark.parametrize("n,abandon", POINTS,
                         ids=["mid-epoch", "two-epochs", "abandoned",
                              "fresh"])
def test_state_dict_equals_jax_key_for_key(n, abandon):
    t, j = FedSampler(DPC, W, B, seed=23), JFedSampler(DPC, W, B, seed=23)
    _advance(t, n, abandon)
    _advance(j, n, abandon)
    ts, js = t.state_dict(), j.state_dict()
    assert list(ts) == list(js)
    for k in js:
        assert np.asarray(ts[k]).dtype == np.asarray(js[k]).dtype, k
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def _server():
    z = np.zeros(4, np.float32)
    return ServerState(z, z, z, 0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_written_state_continues_the_identical_stream(tmp_path, writer):
    # one package draws 6 rounds (mid-epoch) and writes its checkpoint;
    # the other loads it and must draw what the writer draws next
    src = (JFedSampler if writer == "jax" else FedSampler)(DPC, W, B,
                                                          seed=29)
    live = src.epoch()
    _, live = drain(src, 6, live)
    path = str(tmp_path / "ck")
    if writer == "jax":
        import jax.numpy as jnp
        from commefficient_tpu.federated.round import (
            ServerState as JServerState,
        )
        z = jnp.zeros(4, jnp.float32)
        path = j_save_checkpoint(path, JServerState(z, z, z, jnp.int32(0)),
                                 sampler=src.state_dict())
        state = load_checkpoint(path).sampler
        dst = FedSampler(DPC, W, B, seed=0)
    else:
        path = save_checkpoint(path, _server(), sampler=src.state_dict())
        state = j_load_checkpoint(path).sampler
        dst = JFedSampler(DPC, W, B, seed=0)
    dst.load_state_dict(state)
    assert dst.resume_pending and dst.resolve_resume(6) == 0
    assert_streams_equal(drain(src, 12, live)[0], drain(dst, 12))


def test_loader_resume_continues_the_augmentation_stream(tmp_path):
    # the CIFAR train transform's crop/flip generator rides in the
    # sampler state (`aug_rng_*`), so a resumed loader yields the very
    # batches the uninterrupted one does
    from commefficient_tpu_torch.data import FedCIFAR10, FedLoader, transforms

    def loader():
        train_t, _ = transforms.cifar10_transforms(seed=3)
        ds = FedCIFAR10(str(tmp_path), transform=train_t, train=True,
                        num_clients=10, seed=3, synthetic_examples=(320, 64))
        return FedLoader(ds, 4, 8, seed=3)

    ref, crashed = loader(), loader()
    ref_rounds = list(ref.epoch()) + list(ref.epoch())
    first = list(crashed.epoch())
    state = crashed.sampler.state_dict()
    assert "aug_rng_key" in state and int(state["in_epoch"]) == 0
    resumed = loader()
    resumed.sampler.load_state_dict(state)
    for got, want in zip(first + list(resumed.epoch()), ref_rounds):
        np.testing.assert_array_equal(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[2], want[2])
