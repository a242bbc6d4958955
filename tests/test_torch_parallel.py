"""The port's rank layout (commefficient_tpu_torch/parallel/mesh.py)
against the JAX package's meshes: shapes, the --num_slices slice-major
permutation, the validation messages word for word, the slice-balanced
prefix on fake devices, FedModel's default rule, the tensor-parallel
rules, and the multihost validations of Config against JAX's. Mirrors
tests/test_mesh.py:22-133 on ranks (one rank a mesh position) instead of
devices; the grids themselves run in tests/test_torch_multihost.py and
tests/test_torch_tp.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.parallel import mesh as jmesh
from commefficient_tpu.parallel import tp as jtp
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.parallel import mesh as tmesh
from commefficient_tpu_torch.parallel import multihost as tmh
from commefficient_tpu_torch.parallel import tp as ttp

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RANKS = list(range(8))


def _ids(mesh) -> list:
    return [d.id for d in mesh.devices.flat]


def test_axis_names_are_the_jax_packages():
    from commefficient_tpu.analysis.domains import CLIENTS_AXIS, MODEL_AXIS
    assert (tmesh.CLIENTS_AXIS, tmesh.MODEL_AXIS) == (CLIENTS_AXIS,
                                                      MODEL_AXIS)


def test_multihost_mesh_shapes():
    m = tmesh.make_multihost_client_mesh(num_slices=2, devices=RANKS)
    assert m.axis_names == ("clients",)
    assert m.devices.shape == (8,) and m.shape == {"clients": 8}
    m2 = tmesh.make_multihost_client_mesh(model_parallel=2, num_slices=2,
                                          devices=RANKS)
    assert m2.axis_names == ("clients", "model")
    assert m2.devices.shape == (4, 2)
    assert m2.shape == {"clients": 4, "model": 2}
    j2 = jmesh.make_multihost_client_mesh(model_parallel=2, num_slices=2,
                                          devices=jax.devices()[:8])
    assert m2.shape == dict(j2.shape)


@pytest.mark.parametrize("num_slices,mp", [(2, 1), (4, 1), (2, 2)])
def test_slice_major_order_is_jax_device_order(num_slices, mp):
    """Rank order of the port's layout = device order of the JAX mesh:
    the emulated slice grouping is the same genuine permutation."""
    t = tmesh.make_multihost_client_mesh(model_parallel=mp, devices=RANKS,
                                         num_slices=num_slices)
    j = jmesh.make_multihost_client_mesh(model_parallel=mp,
                                         devices=jax.devices()[:8],
                                         num_slices=num_slices)
    assert t.ranks.reshape(-1).tolist() == _ids(j)
    assert t.ranks.reshape(-1).tolist() != RANKS


def test_flat_and_model_meshes_are_jax_device_order():
    assert tmesh.make_client_mesh(4, RANKS).ranks.reshape(-1).tolist() == \
        _ids(jmesh.make_client_mesh(4))
    t = tmesh.make_client_model_mesh(4, 2, RANKS)
    j = jmesh.make_client_model_mesh(4, 2)
    assert t.ranks.tolist() == [[d.id for d in row] for row in j.devices]


def test_four_rank_noncontig_positions():
    # rank i joins slice i % 2: positions 0..3 hold ranks 0, 2, 1, 3
    t = tmesh.make_multihost_client_mesh(devices=list(range(4)),
                                         num_slices=2)
    assert t.ranks.reshape(-1).tolist() == [0, 2, 1, 3]
    j = jmesh.make_multihost_client_mesh(devices=jax.devices()[:4],
                                         num_slices=2)
    assert _ids(j) == [0, 2, 1, 3]


@pytest.mark.parametrize("call", [
    lambda m, d: m.make_multihost_client_mesh(num_slices=3, devices=d),
    lambda m, d: m.make_multihost_client_mesh(model_parallel=3, devices=d),
    lambda m, d: m.make_client_mesh(9, devices=d),
    lambda m, d: m.make_client_model_mesh(4, 3, devices=d),
], ids=["slices", "model_parallel", "shards", "need"])
def test_validation_messages_are_jax_word_for_word(call):
    with pytest.raises(ValueError) as want:
        call(jmesh, jax.devices()[:8])
    with pytest.raises(ValueError) as got:
        call(tmesh, RANKS)
    assert str(got.value) == str(want.value)
    assert "not divisible" in str(got.value) or "have 8" in str(got.value)


class _FakeDev:
    """Stand-in with the slice_index the balanced prefix reads."""

    def __init__(self, i, sl):
        self.id = i
        self.slice_index = sl


def test_slice_balanced_prefix_single_slice_is_flat_prefix():
    assert tmesh.slice_balanced_prefix(RANKS, 6) == RANKS[:6]
    assert tmesh.slice_balanced_prefix(RANKS, 9) is None


@pytest.mark.parametrize("count", [6, 4, 5, 8])
def test_slice_balanced_prefix_multislice_is_jax(count):
    devs = [_FakeDev(i, i // 4) for i in range(8)]
    got = tmesh.slice_balanced_prefix(devs, count)
    want = jmesh.slice_balanced_prefix(devs, count)
    assert (None if got is None else [d.id for d in got]) == (
        None if want is None else [d.id for d in want])
    small = [_FakeDev(i, i % 2) for i in range(4)]
    assert tmesh.slice_balanced_prefix(small, 8) is None
    assert jmesh.slice_balanced_prefix(small, 8) is None


def test_real_slices_win_and_disagreeing_count_raises():
    devs = [_FakeDev(i, i // 4) for i in range(8)]
    t = tmesh.make_multihost_client_mesh(devices=devs)
    assert t.ranks.reshape(-1).tolist() == list(range(8))
    with pytest.raises(ValueError, match="physical slices"):
        tmesh.make_multihost_client_mesh(devices=devs, num_slices=4)


@pytest.mark.parametrize("workers,mp,slices", [
    (4, 2, 1), (8, 1, 2), (6, 1, 1), (8, 2, 2), (3, 2, 1)])
def test_default_layout_is_jax_fedmodel_rule(workers, mp, slices):
    """--model_parallel without a given layout gives a (clients, model)
    layout, the widest clients axis dividing num_workers: the mesh the
    JAX FedModel builds over 8 devices (tests/test_mesh.py:50-65)."""
    from commefficient_tpu.federated.api import FedModel as JFedModel
    from tests.test_round import D, loss_fn
    cfg = dict(mode="uncompressed", weight_decay=0.0, num_workers=workers,
               num_clients=8, local_momentum=0.0, virtual_momentum=0.0,
               error_type="none", microbatch_size=-1, model_parallel=mp,
               num_slices=slices)
    jm = JFedModel(None, loss_fn, JConfig(grad_size=D, **cfg),
                   params={"w": jnp.zeros(D)}, num_clients=8)
    t = tmesh.default_layout(TConfig(**cfg), devices=RANKS)
    assert t.shape == dict(jm.mesh.shape)
    assert t.ranks.reshape(-1).tolist() == _ids(jm.mesh)


def test_single_process_binding_and_feeding():
    lay = tmesh.make_client_mesh(1, [0]).bind()
    assert lay.position == (0, 0) and not lay.connected
    t = torch.arange(4.0)
    assert lay.all_reduce(t) is t and lay.gather(t) is t
    assert tmh.local_row_slice(lay, 8) == slice(0, 8)
    with pytest.raises(ValueError, match="world 1 ranks"):
        tmesh.make_client_mesh(2, [0, 1]).bind(0)


@pytest.mark.parametrize("position,want", [(0, slice(0, 2)),
                                           (3, slice(6, 8))])
def test_local_row_slice_of_a_position(position, want):
    lay = tmesh.make_client_mesh(4, list(range(4)))
    lay.position = (position, 0)
    assert lay.local_row_slice(8) == want
    with pytest.raises(ValueError, match="not divisible by the 4-way"):
        lay.local_row_slice(9)


def test_tp_rules_are_the_jax_rules():
    assert [rx for rx, _ in ttp.GPT2_TP_RULES] == \
        [rx for rx, _ in jtp.GPT2_TP_RULES]
    assert [tuple(spec) for _, spec in ttp.GPT2_TP_RULES] == \
        [tuple(spec) for _, spec in jtp.GPT2_TP_RULES]


def test_sharded_coordinates_cover_the_rule_leaves():
    from commefficient_tpu_torch.models.gpt2 import (
        GPT2Config, GPT2DoubleHeads,
    )
    from commefficient_tpu_torch.ops.flat import module_layout
    m = GPT2DoubleHeads(GPT2Config(vocab_size=64, n_positions=8,
                                   n_embd=16, n_layer=2, n_head=2))
    mask = ttp.sharded_coordinates(m)
    want = sum(e.size for e in module_layout(m)
               if e.path[-2:] in (("c_attn", "kernel"), ("c_attn", "bias"),
                                  ("c_fc", "kernel"), ("c_fc", "bias"),
                                  ("wte", "embedding"))
               or (e.path[-2] == "c_proj" and e.path[-1] == "kernel"))
    assert int(mask.sum()) == want
    assert 0 < want < mask.size      # both kinds of leaves
    assert ttp.shard_module(m, object()) == 2 * 2 + 1


def test_split_ranges_cover_the_vocabulary():
    lay = tmesh.make_client_model_mesh(1, 2, [0, 1])
    spans = []
    for m in range(2):
        lay.position = (0, m)
        spans.append(ttp.split_range(50257, lay))
    assert spans == [(0, 25129), (25129, 50257)]
    with pytest.raises(ValueError, match="n_head=3 not divisible"):
        ttp.even_range(3, lay, "n_head")


# the multihost validations of Config, word for word JAX's
MULTIHOST_REFUSED = {
    "scheduler": dict(sampler="throughput"),
    "deadline": dict(deadline_quantile=0.5),
    "target": dict(target_survivors=4),
    "async": dict(async_admit_rounds=1),
    "host-tier": dict(mode="local_topk", error_type="local",
                      state_tier="host", state_working_set=8),
    "pipeline": dict(scan_rounds=True, pipeline=True),
    "emulated": dict(plan_transport="emulated", plan_controllers=2),
}


@pytest.mark.parametrize("case", sorted(MULTIHOST_REFUSED))
def test_multihost_validations_are_jax_word_for_word(case):
    kw = {**dict(mode="uncompressed", local_momentum=0.0, num_workers=8,
                 multihost=True), **MULTIHOST_REFUSED[case]}
    with pytest.raises(ValueError) as want:
        JConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        TConfig(**kw).validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(multihost=True),
                                dict(model_parallel=2),
                                dict(num_slices=2),
                                dict(multihost=True, scan_rounds=True,
                                     model_parallel=2)],
                         ids=["multihost", "mp", "slices", "spans"])
def test_ported_flags_validate_with_the_collective_transport(kw):
    base = dict(mode="uncompressed", local_momentum=0.0, num_workers=8)
    assert TConfig(**{**base, **kw}).validate()
    JConfig(**{**base, **kw}).validate()
    with_transport = {**base, **kw, "plan_transport": "collective"}
    cfg = TConfig(**with_transport)
    assert cfg.validate() is cfg
    jcfg = JConfig(**with_transport).validate()
    assert cfg.plan_transport == jcfg.plan_transport == "collective"
