"""The plain reference's model: GPT2 with double heads (LM and multiple
choice) in plain PyTorch, on one flat float32 weight vector.

The flat vector is laid out as the program lays out its weights (a
frozen copy of that convention): every parameter under its flax path,
the paths sorted as strings (`mc_head` before `transformer`, `h_10`
before `h_2`, `bias` before `kernel` and `scale`), dense kernels as
[in, out] row-major, the LM head tied to `wte`.

The model follows openai-community/gpt2's published block: token and
position embeddings (token types are ids of the same token embedding),
pre-LN blocks (LayerNorm eps 1e-5, a fused [E, 3E] QKV projection,
causal softmax attention with 1/sqrt(head) scaling, a tanh-approximated
GELU MLP of 4E), a final LayerNorm, logits against `wte`, and one MC
logit a candidate read at its `mc_token_id`. No dropout.

Losses as the federated GPT2 training defines them: the LM loss is the
shifted next-token NLL over the labelled tokens of the client's valid
examples, the MC loss the candidate cross-entropy over its valid
examples, the client loss their sum (lm_coef = mc_coef = 1).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F


class Leaf(NamedTuple):
    path: str
    shape: Tuple[int, ...]
    offset: int

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def layout(n_layer: int, n_embd: int, vocab: int, n_positions: int
           ) -> List[Leaf]:
    E = n_embd
    block = {"attn.c_attn.bias": (3 * E,), "attn.c_attn.kernel": (E, 3 * E),
             "attn.c_proj.bias": (E,), "attn.c_proj.kernel": (E, E),
             "ln_1.bias": (E,), "ln_1.scale": (E,),
             "ln_2.bias": (E,), "ln_2.scale": (E,),
             "mlp.c_fc.bias": (4 * E,), "mlp.c_fc.kernel": (E, 4 * E),
             "mlp.c_proj.bias": (E,), "mlp.c_proj.kernel": (4 * E, E)}
    shapes = {"mc_head.bias": (1,), "mc_head.kernel": (E, 1),
              "transformer.ln_f.bias": (E,), "transformer.ln_f.scale": (E,),
              "transformer.wpe.embedding": (n_positions, E),
              "transformer.wte.embedding": (vocab, E)}
    for i in range(n_layer):
        for k, s in block.items():
            shapes[f"transformer.h_{i}.{k}"] = s
    out, off = [], 0
    for path in sorted(shapes, key=lambda p: tuple(p.split("."))):
        out.append(Leaf(path, shapes[path], off))
        off += math.prod(shapes[path])
    return out


def unflatten(w: torch.Tensor, leaves: List[Leaf]) -> Dict[str, torch.Tensor]:
    return {lf.path: w[lf.offset:lf.offset + lf.size].view(lf.shape)
            for lf in leaves}


def init_weights(leaves: List[Leaf], seed: int, device, std: float = 0.02
                 ) -> torch.Tensor:
    """GPT2's initialization from `seed`, made on `device` in one draw:
    N(0, std) for kernels and embeddings, zeros for biases, ones for
    LayerNorm scales."""
    d = leaves[-1].offset + leaves[-1].size
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    w = torch.randn(d, generator=gen, device=device, dtype=torch.float32)
    w.mul_(std)
    for lf in leaves:
        kind = lf.path.rsplit(".", 1)[1]
        if kind in ("bias", "scale"):
            w[lf.offset:lf.offset + lf.size] = 1.0 if kind == "scale" else 0.0
    return w


def forward(p: Dict[str, torch.Tensor], n_layer: int, n_head: int,
            input_ids: torch.Tensor, token_type_ids: torch.Tensor,
            mc_token_ids: torch.Tensor):
    """(lm_logits [..., C, L, V], mc_logits [..., C])."""
    lead, L = input_ids.shape[:-1], input_ids.shape[-1]
    ids = input_ids.reshape(-1, L).long()
    types = token_type_ids.reshape(-1, L).long()
    wte = p["transformer.wte.embedding"]
    h = wte[ids] + p["transformer.wpe.embedding"][:L] + wte[types]
    E = h.shape[-1]
    hd = E // n_head
    causal = torch.ones(L, L, dtype=torch.bool, device=h.device).tril()

    def ln(x, name):
        return F.layer_norm(x, (E,), p[name + ".scale"], p[name + ".bias"],
                            1e-5)

    def dense(x, name):
        return x @ p[name + ".kernel"] + p[name + ".bias"]

    for i in range(n_layer):
        b = f"transformer.h_{i}."
        q, k, v = dense(ln(h, b + "ln_1"), b + "attn.c_attn").split(E, -1)
        q, k, v = (t.reshape(-1, L, n_head, hd).transpose(1, 2)
                   for t in (q, k, v))
        att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        att = torch.softmax(att.masked_fill(~causal, float("-inf")), -1)
        a = (att @ v).transpose(1, 2).reshape(-1, L, E)
        h = h + dense(a, b + "attn.c_proj")
        m = dense(ln(h, b + "ln_2"), b + "mlp.c_fc")
        h = h + dense(F.gelu(m, approximate="tanh"), b + "mlp.c_proj")
    h = ln(h, "transformer.ln_f")
    lm = h @ wte.t()
    summary = h[torch.arange(h.shape[0], device=h.device),
                mc_token_ids.reshape(-1).long()]
    mc = (summary @ p["mc_head.kernel"] + p["mc_head.bias"])[:, 0]
    return lm.reshape(lead + (L, lm.shape[-1])), mc.reshape(lead)


def client_loss(p, n_layer: int, n_head: int, batch, mask: torch.Tensor
                ) -> torch.Tensor:
    """One client's loss over its [B] examples (`batch`: input_ids,
    mc_token_ids, lm_labels, mc_labels, token_type_ids)."""
    input_ids, mc_token_ids, lm_labels, mc_labels, token_type_ids = batch
    lm, mc = forward(p, n_layer, n_head, input_ids, token_type_ids,
                     mc_token_ids)
    labels = lm_labels[..., 1:].long()
    valid = (labels != -1).float() * mask[:, None, None]
    logp = torch.log_softmax(lm[..., :-1, :], -1)
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    lm_loss = (nll * valid).sum() / valid.sum().clamp(min=1.0)
    mc_nll = -torch.log_softmax(mc, -1).gather(
        1, mc_labels.long()[:, None])[:, 0]
    mc_loss = (mc_nll * mask).sum() / mask.sum().clamp(min=1.0)
    return lm_loss + mc_loss
