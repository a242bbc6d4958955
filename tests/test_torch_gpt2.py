"""GPT2 parity: the port's models/gpt2.py against the JAX package's, from
the same flax parameters (loaded through models/convert.py) and the same
numpy batches — the flat layout, the weight bridge, logits on both
attention routes, and the flat gradient of the double-heads train loss.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.models import gpt2 as JG
from commefficient_tpu.training.gpt2_train import (
    make_compute_loss_train as j_make_loss,
)
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.federated.client import make_flat_loss_fn
from commefficient_tpu_torch.models import gpt2 as TG
from commefficient_tpu_torch.models.convert import (
    from_jax_params, to_jax_params,
)
from commefficient_tpu_torch.ops.flat import flatten_params, module_layout
from commefficient_tpu_torch.training.gpt2_train import (
    make_compute_loss_train as t_make_loss,
)

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker: torch's default of a thread
# a core in each of several test processes oversubscribes the cores
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# f32 forward through a few layers, reductions in another order: logits
# to 2e-6 absolute (they are O(1)); the flat gradient to 1e-5 of its
# largest entry
LOGIT_ATOL = 2e-6
GRAD_RTOL = 1e-5


def _pair(vocab=61, L=16, n_layer=2, n_embd=32, n_head=2, seed=0):
    """A JAX GPT2DoubleHeads with its init params, the port's model
    loaded with the same weights, and one numpy batch."""
    jcfg = JG.GPT2Config(vocab_size=vocab, n_positions=max(L, 16),
                         n_embd=n_embd, n_layer=n_layer, n_head=n_head)
    jm = JG.GPT2DoubleHeads(jcfg)
    rng = np.random.RandomState(seed)
    B, C = 2, 2
    ids = rng.randint(0, vocab, (B, C, L)).astype(np.int32)
    tt = rng.randint(0, vocab, (B, C, L)).astype(np.int32)
    mc = rng.randint(0, L, (B, C)).astype(np.int32)
    labels = np.where(rng.rand(B, C, L) < 0.3, -1,
                      rng.randint(0, vocab, (B, C, L))).astype(np.int32)
    mc_labels = rng.randint(0, C, (B,)).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(ids),
                     jnp.asarray(tt), jnp.asarray(mc))
    tm = TG.GPT2DoubleHeads(TG.GPT2Config(
        vocab_size=vocab, n_positions=max(L, 16), n_embd=n_embd,
        n_layer=n_layer, n_head=n_head))
    from_jax_params(tm, params)
    return jm, params, tm, (ids, mc, labels, mc_labels, tt)


def test_flat_layout_is_ravel_pytree_order_at_12_layers():
    # 12 layers expose the string sort h_0, h_1, h_10, h_11, h_2, ...
    jm, params, tm, _ = _pair(n_layer=12)
    vec, _ = flatten_params(tm)
    np.testing.assert_array_equal(vec.numpy(),
                                  np.asarray(ravel_pytree(params)[0]))
    paths = [e.path for e in module_layout(tm)]
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    want = [tuple(k.key for k in path) for path, _ in leaves]
    assert paths == want
    blocks = [p[1] for p in paths if p[0] == "transformer"
              and p[1].startswith("h_")]
    order = list(dict.fromkeys(blocks))
    assert order[:4] == ["h_0", "h_1", "h_10", "h_11"]
    assert paths[0][0] == "mc_head"
    # the tied embedding is one entry
    assert sum(p[-1] == "embedding" and p[1] == "wte" for p in paths) == 1
    D = sum(e.size for e in module_layout(tm))
    assert D == vec.shape[0] == ravel_pytree(params)[0].shape[0]


def test_from_jax_params_round_trips():
    _, params, tm, _ = _pair(n_layer=3)
    back = to_jax_params(tm)
    want = jax.tree_util.tree_leaves(params)
    got = jax.tree_util.tree_leaves(back)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    vec = from_jax_params(tm, back)
    np.testing.assert_array_equal(vec.numpy(),
                                  np.asarray(ravel_pytree(params)[0]))


@pytest.mark.parametrize("L", [16, 300], ids=["einsum", "flash"])
def test_logits_match_jax(L):
    jm, params, tm, (ids, mc, _, _, tt) = _pair(L=L)
    assert (L >= TG.FLASH_ATTENTION_MIN_LEN) == (L >= JG.FLASH_ATTENTION_MIN_LEN)
    jl, jmc = jm.apply(params, *map(jnp.asarray, (ids, tt, mc)))
    with torch.no_grad():
        tl, tmc = tm(*map(torch.from_numpy, (ids, tt, mc)))
    assert tl.shape == jl.shape and tmc.shape == jmc.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(tmc.numpy(), np.asarray(jmc), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("L", [16, 300], ids=["einsum", "flash"])
def test_train_loss_flat_gradient_matches_jax(L):
    jm, params, tm, batch = _pair(L=L, seed=1)
    kw = dict(lm_coef=2.0, mc_coef=0.5)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw, device="cpu")
    mask = np.array([1.0, 0.0], np.float32)       # one padded example
    vec, unravel = ravel_pytree(params)

    def jflat(v):
        return j_make_loss(jm, jcfg)(unravel(v), tuple(map(jnp.asarray,
                                                           batch)),
                                     jnp.asarray(mask))

    (jloss, (jlm, jmc)), jgrad = jax.value_and_grad(jflat, has_aux=True)(vec)
    tvec, tunravel = flatten_params(tm)
    w = tvec.clone().requires_grad_(True)
    tloss, (tlm, tmc) = make_flat_loss_fn(t_make_loss(tm, tcfg), tunravel)(
        w, tuple(map(torch.from_numpy, batch)), torch.from_numpy(mask))
    tgrad, = torch.autograd.grad(tloss, w)
    for got, want in ((tloss, jloss), (tlm, jlm), (tmc, jmc)):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-6)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=0,
                               atol=GRAD_RTOL * np.abs(jgrad).max())


def test_hf_state_dict_matches_jax():
    _, params, tm, _ = _pair(n_layer=2)
    want = JG.hf_state_dict_from_params(params, JG.GPT2Config(n_layer=2))
    got = TG.hf_state_dict_from_params(to_jax_params(tm),
                                       TG.GPT2Config(n_layer=2))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)


def test_full_width_parameter_count():
    # GPT2-small sized for the PersonaChat vocabulary (50,257 + 5
    # specials): D = 124,444,417 — counted from the layout, not built
    cfg = TG.GPT2Config(vocab_size=50262)
    E, V, P, n = cfg.n_embd, cfg.vocab_size, cfg.n_positions, cfg.n_layer
    per_block = 2 * 2 * E + (E * 3 * E + 3 * E) + (E * E + E) \
        + (E * 4 * E + 4 * E) + (4 * E * E + E)
    assert V * E + P * E + n * per_block + 2 * E + E + 1 == 124_444_417
    small = TG.GPT2DoubleHeads(cfg.replace(n_layer=1, vocab_size=50))
    per = {e.path[1] if e.path[0] == "transformer" else e.path[0]: 0
           for e in module_layout(small)}
    for e in module_layout(small):
        key = e.path[1] if e.path[0] == "transformer" else e.path[0]
        per[key] += e.size
    assert per["h_0"] == per_block and per["mc_head"] == E + 1
