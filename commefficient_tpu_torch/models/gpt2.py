"""GPT-2 with double heads (LM + multiple-choice): the port of
commefficient_tpu/models/gpt2.py.

The same architecture and the same parameter tree:
  * pre-LN transformer blocks (eps 1e-5) with a fused QKV projection
    (`c_attn`, one [E, 3E] product a block);
  * the candidate axis folded into the batch before the transformer
    ([B, C, L] -> [B*C, L]);
  * token types looked up in the SAME token embedding, and the LM head
    tied to it (one [V, E] parameter);
  * attention: below FLASH_ATTENTION_MIN_LEN the product form with
    float32 logits (from bfloat16 operands under --bf16, as JAX's
    `preferred_element_type=float32` einsum), a -1e9 causal fill and a
    float32 softmax; at and above it `ops/attention.flash_attention`
    (kernel K4 on the card, float32 or bfloat16 q/k/v), which never
    materializes [B, H, L, L];
  * LayerNorm statistics and normalization in float32 whatever the
    input type, rounded to it once at the end (flax's
    `force_float32_reductions`);
  * the MC head reads the hidden state at `mc_token_ids` and projects to
    one scalar a candidate.

Submodules carry the flax names (transformer, h_0 .. h_{n-1}, attn,
c_attn, ln_1, mc_head, ...) so `jax_layout()` can state where each
parameter sits in the JAX package's flat vector (ops/flat.py): keys
sort as strings (h_0, h_1, h_10, h_11, h_2, ...), `bias` before
`kernel` and `scale`, `mc_head` before `transformer`; Dense kernels are
[in, out] (a torch Linear weight transposed), LayerNorm's weight is
flax's `scale`, and the tied `wte` is one entry.

Under --model_parallel > 1 (parallel/tp.py) the attention, the MLP
and the tied embedding take their slices of the layout's model group:
heads and hidden units column-parallel, the output projections
row-parallel, `wte` over the vocabulary. Kernel K4 then runs on a
rank's [B, H / mp, L, hd] head views.

`GPT2Config.remat` (--remat) recomputes each block in the backward
(torch.utils.checkpoint, non-reentrant): activation memory drops to
about one block's, values and gradients are bitwise those without it,
and the recompute runs the block's attention again (K4 twice a block).

The HF bridge both ways, on numpy trees in the flax shapes (what
models/convert.to_jax_params gives): `hf_state_dict_from_params` and
`save_pretrained` write the artifact (config.json + pytorch_model.bin),
`params_from_hf_state_dict`, `load_pretrained_dir` and
`try_load_pretrained` read one (the JAX package's artifact included),
and `resize_token_embeddings` / `resize_position_embeddings` grow the
tables with N(0, initializer_range) rows drawn by the port's threefry
(ops/prng.normal, jax.random.normal's draw within 1e-6). Nothing here
downloads weights.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from commefficient_tpu_torch.ops import prng
from commefficient_tpu_torch.ops.attention import flash_attention
from commefficient_tpu_torch.ops.flat import LayoutEntry
from commefficient_tpu_torch.parallel.tp import (
    copy_to_model, even_range, reduce_from_model, vocab_embedding,
    vocab_logits,
)
from commefficient_tpu_torch.utils.atomic_io import atomic_write_text

_IO_TO_OI = (1, 0)


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    # recompute each block in the backward (--remat): a memory schedule,
    # not part of the artifact
    remat: bool = False

    def replace(self, **kw) -> "GPT2Config":
        return dataclasses.replace(self, **kw)


# GPT2-family presets (model_checkpoint flag values)
PRESETS = {
    "gpt2": GPT2Config(),
    "gpt2-medium": GPT2Config(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-large": GPT2Config(n_embd=1280, n_layer=36, n_head=20),
    "gpt2-xl": GPT2Config(n_embd=1600, n_layer=48, n_head=25),
}

# sequences at/above this length route through flash attention
# (ops/attention.py) instead of materializing [B, H, L, L]; read at call
# time
FLASH_ATTENTION_MIN_LEN = 256


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm computed in float32 for a bfloat16 input, then
    rounded to the input's type once: flax's LayerNorm takes its
    statistics and normalizes in float32 (force_float32_reductions)."""

    def forward(self, x):
        if x.dtype in (torch.float32, torch.float64):
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class SelfAttention(nn.Module):
    """Causal multi-head self-attention with a fused QKV projection.
    Sharded (parallel/tp.shard_module), a rank computes its heads'
    columns of the projection and its rows of c_proj."""

    supports_tensor_parallel = True
    _tp = None

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        E = cfg.n_embd
        self.c_attn = nn.Linear(E, 3 * E)
        self.c_proj = nn.Linear(E, E)

    def forward(self, h):
        B, L, E = h.shape
        hd = E // self.cfg.n_head
        tp = self._tp
        if tp is None:
            H, El = self.cfg.n_head, E
            q, k, v = self.c_attn(h).split(E, dim=-1)
        else:
            h0, h1 = even_range(self.cfg.n_head, tp, "n_head")
            H, lo, hi = h1 - h0, h0 * hd, h1 * hd
            El = hi - lo
            W, b = self.c_attn.weight, self.c_attn.bias
            rows = [slice(o + lo, o + hi) for o in (0, E, 2 * E)]
            q, k, v = F.linear(copy_to_model(h, tp),
                               torch.cat([W[r] for r in rows]),
                               torch.cat([b[r] for r in rows])
                               ).split(El, dim=-1)

        def heads(x):  # [B, L, H * hd] -> [B, H, L, hd]
            return x.reshape(B, L, H, hd).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        if L >= FLASH_ATTENTION_MIN_LEN:
            out = flash_attention(q, k, v)
        else:
            # float32 (or float64) logits: bfloat16 products are exact
            # in float32
            acc = torch.promote_types(q.dtype, torch.float32)
            att = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)
                               ) / math.sqrt(hd)
            causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                           device=h.device))
            att = att.masked_fill(~causal, -1e9)
            att = torch.softmax(att, dim=-1).to(v.dtype)
            out = torch.matmul(att, v)
        out = out.transpose(1, 2).reshape(B, L, El)
        if tp is None:
            return self.c_proj(out)
        part = F.linear(out, self.c_proj.weight[:, lo:hi])
        return reduce_from_model(part, tp) + self.c_proj.bias


class MLP(nn.Module):
    """Sharded, a rank computes its hidden units' columns of c_fc and
    its rows of c_proj."""

    supports_tensor_parallel = True
    _tp = None

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        E = cfg.n_embd
        self.c_fc = nn.Linear(E, 4 * E)
        self.c_proj = nn.Linear(4 * E, E)

    def forward(self, h):
        tp = self._tp
        if tp is None:
            return self.c_proj(F.gelu(self.c_fc(h), approximate="tanh"))
        lo, hi = even_range(self.c_fc.out_features, tp, "4 * n_embd")
        a = F.gelu(F.linear(copy_to_model(h, tp), self.c_fc.weight[lo:hi],
                            self.c_fc.bias[lo:hi]), approximate="tanh")
        part = F.linear(a, self.c_proj.weight[:, lo:hi])
        return reduce_from_model(part, tp) + self.c_proj.bias


class Block(nn.Module):
    """Pre-LN transformer block (GPT-2 ordering)."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln_1 = LayerNorm(cfg.n_embd, eps=eps)
        self.attn = SelfAttention(cfg)
        self.ln_2 = LayerNorm(cfg.n_embd, eps=eps)
        self.mlp = MLP(cfg)

    def forward(self, h):
        h = h + self.attn(self.ln_1(h))
        return h + self.mlp(self.ln_2(h))


def _remat_block(block: nn.Module, h: torch.Tensor) -> torch.Tensor:
    """block(h) with its activations recomputed in the backward. The
    parameters the block holds now (under functional_call, views of the
    flat vector) are passed to the checkpoint explicitly and re-bound
    for the recompute, which runs after functional_call has put the
    module's own parameters back."""
    names, tensors = zip(*block.named_parameters())

    def run(x, *params):
        return torch.func.functional_call(block, dict(zip(names, params)),
                                          (x,))

    return checkpoint(run, h, *tensors, use_reentrant=False)


class GPT2Transformer(nn.Module):
    """Sharded, the tied `wte` is split over the vocabulary: a rank
    looks up and scores its own range (parallel/tp.vocab_embedding,
    vocab_logits; the logits are gathered before the loss)."""

    supports_tensor_parallel = True
    _tp = None

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd)
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd)
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg))
        self.ln_f = LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)

    def forward(self, input_ids, token_type_ids=None):
        L = input_ids.shape[-1]
        tp = self._tp

        def embed(ids):
            if tp is None:
                return self.wte(ids)
            return vocab_embedding(ids, self.wte.weight, tp)

        h = embed(input_ids) + self.wpe(
            torch.arange(L, device=input_ids.device))
        if token_type_ids is not None:
            # token types are ordinary special-token ids of the SAME
            # embedding
            h = h + embed(token_type_ids)
        for i in range(self.cfg.n_layer):
            block = getattr(self, f"h_{i}")
            if self.cfg.remat and torch.is_grad_enabled():
                h = _remat_block(block, h)
            else:
                h = block(h)
        h = self.ln_f(h)
        # weight-tied LM logits
        if tp is not None:
            return h, vocab_logits(h, self.wte.weight, tp)
        return h, F.linear(h, self.wte.weight)


class GPT2DoubleHeads(nn.Module):
    """LM head + multiple-choice head over candidate sequences.

    forward(input_ids [..., C, L], token_type_ids [..., C, L],
            mc_token_ids [..., C]) ->
        (lm_logits [..., C, L, V], mc_logits [..., C])
    """

    def __init__(self, cfg: GPT2Config, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.transformer = GPT2Transformer(cfg)
        self.mc_head = nn.Linear(cfg.n_embd, 1)
        self.reset_parameters(seed)

    def forward(self, input_ids, token_type_ids=None, mc_token_ids=None):
        lead = input_ids.shape[:-1]
        L = input_ids.shape[-1]
        flat_ids = input_ids.reshape(-1, L).long()
        flat_tt = (token_type_ids.reshape(-1, L).long()
                   if token_type_ids is not None else None)
        h, lm_logits = self.transformer(flat_ids, flat_tt)
        if mc_token_ids is None:
            mc_pos = torch.full((h.shape[0],), L - 1, dtype=torch.long,
                                device=h.device)
        else:
            mc_pos = mc_token_ids.reshape(-1).long()
        summary = h[torch.arange(h.shape[0], device=h.device), mc_pos]
        mc_logits = self.mc_head(summary)[:, 0]
        return (lm_logits.reshape(lead + (L, lm_logits.shape[-1])),
                mc_logits.reshape(lead))

    def jax_layout(self) -> List[LayoutEntry]:
        """Where each parameter sits in the JAX package's flat vector:
        its flax path and flax shape (Dense kernels [in, out])."""
        out = []
        for mod_name, mod in self.named_modules():
            prefix = tuple(mod_name.split(".")) if mod_name else ()
            for pname, p in mod.named_parameters(recurse=False):
                name = ".".join(prefix + (pname,))
                if isinstance(mod, nn.Linear) and pname == "weight":
                    o, i = p.shape
                    out.append(LayoutEntry(prefix + ("kernel",), name,
                                           (i, o), _IO_TO_OI))
                    continue
                flax = pname
                if pname == "weight" and isinstance(mod, nn.LayerNorm):
                    flax = "scale"
                elif pname == "weight" and isinstance(mod, nn.Embedding):
                    flax = "embedding"
                out.append(LayoutEntry(prefix + (flax,), name,
                                       tuple(p.shape)))
        return out

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Random weights from numpy `RandomState(seed)` with the JAX
        model's initializers: N(0, initializer_range) for Dense kernels
        and embeddings, zeros for biases, ones for LayerNorm scales. Not
        the JAX package's random numbers (tests load those through
        models/convert.py)."""
        rng = np.random.RandomState(seed)
        params = dict(self.named_parameters())
        std = self.cfg.initializer_range
        for e in sorted(self.jax_layout(), key=lambda e: e.path):
            p = params[e.name]
            if e.path[-1] in ("kernel", "embedding"):
                t = torch.from_numpy(
                    (rng.standard_normal(e.flat_shape) * std)
                    .astype(np.float32))
                if e.to_torch is not None:
                    t = t.permute(*e.to_torch)
                p.copy_(t)
            elif e.path[-1] == "scale":
                p.fill_(1.0)
            else:
                p.zero_()


def build_gpt2(model_checkpoint: str = "gpt2", seed: int = 0,
               **overrides) -> GPT2DoubleHeads:
    """Resolve a GPT2 preset by flag name, with config overrides."""
    cfg = PRESETS.get(model_checkpoint, PRESETS["gpt2"])
    if overrides:
        cfg = cfg.replace(**overrides)
    return GPT2DoubleHeads(cfg, seed=seed)


# ---- the HF bridge and the HF-style artifact -----------------------------

def _normal_rows(key, shape, std: float) -> np.ndarray:
    """jax.random.normal(key, shape) * std, float32, on the host."""
    if key is None:
        key = prng.PRNGKey(0)
    return (prng.normal(key, shape) * std).numpy()


def _grow_rows(params, path: Tuple[str, ...], n: int, key,
               initializer_range: float):
    """A copy of the tree with the [old, E] table at `path` grown to n
    rows (N(0, initializer_range) rows appended); the tree itself when
    it already has n rows or more."""
    node = params["params"]
    for k in path:
        node = node[k]
    old, E = node.shape
    if n <= old:
        return params
    grown = np.concatenate(
        [np.asarray(node, np.float32),
         _normal_rows(key, (n - old, E), initializer_range)], axis=0)

    def rebuild(tree, keys):
        out = dict(tree)
        out[keys[0]] = grown if len(keys) == 1 else rebuild(tree[keys[0]],
                                                            keys[1:])
        return out

    return {**params, "params": rebuild(params["params"], path)}


def resize_token_embeddings(params, new_vocab_size: int, key=None,
                            initializer_range: float = 0.02):
    """The tree with the tied token embedding grown to
    `new_vocab_size` rows (special tokens added to the tokenizer); pair
    it with a module of `cfg.replace(vocab_size=new_vocab_size)`."""
    return _grow_rows(params, ("transformer", "wte", "embedding"),
                      new_vocab_size, key, initializer_range)


def resize_position_embeddings(params, new_n_positions: int, key=None,
                               initializer_range: float = 0.02):
    """The tree with the position table grown to `new_n_positions`
    rows, for a corpus that pads longer than the artifact's."""
    return _grow_rows(params, ("transformer", "wpe", "embedding"),
                      new_n_positions, key, initializer_range)


def params_from_hf_state_dict(state_dict: Dict[str, Any], cfg: GPT2Config,
                              key=None) -> dict:
    """A HuggingFace GPT-2 state dict (torch tensors or numpy arrays;
    GPT2LMHeadModel, GPT2Model or double-heads naming) -> the flax-shaped
    numpy tree. HF's Conv1D weights are [in, out] like the tree's
    kernels; LayerNorm weight/bias map to scale/bias; the MC head (a
    torch Linear, [out, in]) is transposed, or drawn fresh as
    N(0, initializer_range) from `key` when the checkpoint has none."""
    def t(name):
        arr = state_dict[name]
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        return np.asarray(arr, np.float32)

    prefix = ("transformer." if any(k.startswith("transformer.")
                                    for k in state_dict) else "")
    tr: Dict[str, Any] = {
        "wte": {"embedding": t(prefix + "wte.weight")},
        "wpe": {"embedding": t(prefix + "wpe.weight")},
        "ln_f": {"scale": t(prefix + "ln_f.weight"),
                 "bias": t(prefix + "ln_f.bias")},
    }
    for i in range(cfg.n_layer):
        p = f"{prefix}h.{i}."

        def dense(name):
            return {"kernel": t(p + name + ".weight"),
                    "bias": t(p + name + ".bias")}

        tr[f"h_{i}"] = {
            "ln_1": {"scale": t(p + "ln_1.weight"),
                     "bias": t(p + "ln_1.bias")},
            "ln_2": {"scale": t(p + "ln_2.weight"),
                     "bias": t(p + "ln_2.bias")},
            "attn": {"c_attn": dense("attn.c_attn"),
                     "c_proj": dense("attn.c_proj")},
            "mlp": {"c_fc": dense("mlp.c_fc"),
                    "c_proj": dense("mlp.c_proj")},
        }
    mc = "multiple_choice_head.summary."
    if mc + "weight" in state_dict:
        mc_kernel = np.ascontiguousarray(t(mc + "weight").T)
        mc_bias = t(mc + "bias")
    else:
        mc_kernel = _normal_rows(key, (cfg.n_embd, 1), cfg.initializer_range)
        mc_bias = np.zeros((1,), np.float32)
    return {"params": {"transformer": tr,
                       "mc_head": {"kernel": mc_kernel, "bias": mc_bias}}}


def load_pretrained_dir(path: str, key=None
                        ) -> Optional[Tuple[dict, GPT2Config]]:
    """Read a `save_pretrained` artifact of either package (config.json
    plus pytorch_model.bin, or the .npz a torch-less JAX run writes):
    (the flax-shaped tree, its GPT2Config), or None when `path` holds
    no such artifact."""
    cfg_path = os.path.join(path, "config.json")
    bin_path = os.path.join(path, "pytorch_model.bin")
    npz_path = os.path.join(path, "pytorch_model.npz")
    if not os.path.isfile(cfg_path):
        return None
    if os.path.isfile(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    elif os.path.isfile(npz_path):
        with np.load(npz_path) as z:
            sd = {k: z[k] for k in z.files}
    else:
        return None
    with open(cfg_path) as f:
        raw = json.load(f)
    cfg = GPT2Config(
        vocab_size=raw["vocab_size"],
        n_positions=raw.get("n_positions", 1024),
        n_embd=raw["n_embd"], n_layer=raw["n_layer"], n_head=raw["n_head"],
        layer_norm_epsilon=raw.get("layer_norm_epsilon", 1e-5),
        initializer_range=raw.get("initializer_range", 0.02))
    return params_from_hf_state_dict(sd, cfg, key=key), cfg


def try_load_pretrained(model_checkpoint: str, cfg: GPT2Config,
                        key=None) -> Optional[dict]:
    """A locally cached HF checkpoint through `transformers`, or None
    when the package or the checkpoint is missing. Never downloads."""
    try:
        from transformers import GPT2LMHeadModel
        pt = GPT2LMHeadModel.from_pretrained(model_checkpoint,
                                             local_files_only=True)
    except (ImportError, OSError, ValueError, RuntimeError):
        # transformers missing, nothing cached, or a torn cache
        return None
    return params_from_hf_state_dict(pt.state_dict(), cfg, key=key)

def hf_state_dict_from_params(params, cfg: GPT2Config
                              ) -> Dict[str, np.ndarray]:
    """A HuggingFace GPT2DoubleHeadsModel-style state dict (numpy
    values) from a flax-shaped parameter tree ({'params': ...}, as
    models/convert.to_jax_params gives it). Projection kernels keep the
    Conv1D [in, out] layout; the MC head transposes to torch Linear
    [out, in]; `lm_head.weight` aliases the tied token embedding."""
    def a(x):
        return np.asarray(x)

    p = params["params"]
    tr = p["transformer"]
    sd: Dict[str, np.ndarray] = {
        "transformer.wte.weight": a(tr["wte"]["embedding"]),
        "transformer.wpe.weight": a(tr["wpe"]["embedding"]),
        "transformer.ln_f.weight": a(tr["ln_f"]["scale"]),
        "transformer.ln_f.bias": a(tr["ln_f"]["bias"]),
        "lm_head.weight": a(tr["wte"]["embedding"]),
        "multiple_choice_head.summary.weight": a(p["mc_head"]["kernel"]).T,
        "multiple_choice_head.summary.bias": a(p["mc_head"]["bias"]),
    }
    for i in range(cfg.n_layer):
        b = tr[f"h_{i}"]
        pre = f"transformer.h.{i}."
        sd[pre + "ln_1.weight"] = a(b["ln_1"]["scale"])
        sd[pre + "ln_1.bias"] = a(b["ln_1"]["bias"])
        sd[pre + "ln_2.weight"] = a(b["ln_2"]["scale"])
        sd[pre + "ln_2.bias"] = a(b["ln_2"]["bias"])
        sd[pre + "attn.c_attn.weight"] = a(b["attn"]["c_attn"]["kernel"])
        sd[pre + "attn.c_attn.bias"] = a(b["attn"]["c_attn"]["bias"])
        sd[pre + "attn.c_proj.weight"] = a(b["attn"]["c_proj"]["kernel"])
        sd[pre + "attn.c_proj.bias"] = a(b["attn"]["c_proj"]["bias"])
        sd[pre + "mlp.c_fc.weight"] = a(b["mlp"]["c_fc"]["kernel"])
        sd[pre + "mlp.c_fc.bias"] = a(b["mlp"]["c_fc"]["bias"])
        sd[pre + "mlp.c_proj.weight"] = a(b["mlp"]["c_proj"]["kernel"])
        sd[pre + "mlp.c_proj.bias"] = a(b["mlp"]["c_proj"]["bias"])
    return sd


def save_pretrained(log_dir: str, params, cfg: GPT2Config,
                    tokenizer=None) -> str:
    """HF-style final artifact: `pytorch_model.bin` (the state dict in HF
    double-heads naming), `config.json`, and the tokenizer's own files
    when it can save itself (a HashTokenizer records its class and
    vocabulary size)."""
    os.makedirs(log_dir, exist_ok=True)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in hf_state_dict_from_params(params, cfg).items()}
    torch.save(sd, os.path.join(log_dir, "pytorch_model.bin"))
    conf = {
        "model_type": "gpt2",
        "architectures": ["GPT2DoubleHeadsModel"],
        "vocab_size": cfg.vocab_size,
        "n_positions": cfg.n_positions,
        "n_ctx": cfg.n_positions,
        "n_embd": cfg.n_embd,
        "n_layer": cfg.n_layer,
        "n_head": cfg.n_head,
        "layer_norm_epsilon": cfg.layer_norm_epsilon,
        "initializer_range": cfg.initializer_range,
    }
    atomic_write_text(os.path.join(log_dir, "config.json"),
                      json.dumps(conf, indent=1))
    if tokenizer is not None:
        inner = getattr(tokenizer, "tok", tokenizer)
        if hasattr(inner, "save_pretrained"):
            inner.save_pretrained(log_dir)
        else:
            atomic_write_text(
                os.path.join(log_dir, "tokenizer_config.json"),
                json.dumps({"tokenizer_class": "HashTokenizer",
                            "vocab_size": len(tokenizer)}))
    return log_dir
