"""The plain reference's data layer: PersonaChat JSON to the arrays a
GPT2 double-heads step trains on, worked out again from the raw corpus
file the benchmark writes.

Frozen copies of the dataset contract the program implements: the
word-hash tokenizer (md5 of the lower-cased word into
[5, vocab_size), the five special tokens at 0..4), the segment grammar
(`[<bos> persona*] [<spk> turn]... [<spk2> reply <eos>]`, the speaker
of turn i being `<speaker2>` when (n - i) is even, token types
alternating by segment, LM labels on the reply of the last candidate,
which is the correct one), history cut to the last 2 * max_history + 1
turns, candidates to the last num_candidates, and padding with `<pad>`
(labels -1) to the longest example of the split. Clients are the
distinct personality tuples in their order of first appearance.

Numpy and the standard library only.
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

SPECIAL = ("<bos>", "<eos>", "<speaker1>", "<speaker2>", "<pad>")
IGNORE = -1


def tokenize(text: str, vocab_size: int) -> List[int]:
    n = len(SPECIAL)
    return [n + int(hashlib.md5(w.encode()).hexdigest(), 16) % (vocab_size - n)
            for w in text.lower().split()]


def candidate_sequence(persona: Sequence[Sequence[int]],
                       history: Sequence[Sequence[int]],
                       reply: Sequence[int], labelled: bool) -> Dict:
    bos, eos, spk1, spk2 = 0, 1, 2, 3
    segments = [[bos] + [t for s in persona for t in s]]
    segments += [list(h) for h in history] + [list(reply) + [eos]]
    n = len(segments)
    segments = [segments[0]] + [[spk2 if (n - i) % 2 == 0 else spk1] + seg
                                for i, seg in enumerate(segments[1:])]
    ids = [t for s in segments for t in s]
    types = [spk2 if i % 2 else spk1
             for i, s in enumerate(segments) for _ in s]
    labels = [IGNORE] * len(ids)
    if labelled:
        prefix = sum(len(s) for s in segments[:-1])
        labels = [IGNORE] * (prefix + 1) + segments[-1][1:]
    return {"ids": ids, "types": types, "labels": labels,
            "mc": len(ids) - 1}


def train_examples(raw: dict, vocab_size: int, num_candidates: int,
                   max_history: int
                   ) -> Tuple[List[List[int]], Dict[str, np.ndarray]]:
    """(the example indices of each client, the train arrays
    input_ids / token_type_ids / lm_labels [N, C, L], mc_token_ids
    [N, C], mc_labels [N]) of the raw corpus, examples in client order."""
    by_client: Dict[tuple, list] = {}
    for dialog in raw["train"]:
        by_client.setdefault(tuple(dialog["personality"]), []).append(dialog)
    seqs, owners = [], []
    for c, dialogs in enumerate(by_client.values()):
        for dialog in dialogs:
            persona = [tokenize(p, vocab_size) for p in dialog["personality"]]
            for utt in dialog["utterances"]:
                hist = [tokenize(h, vocab_size)
                        for h in utt["history"][-(2 * max_history + 1):]]
                cands = [tokenize(x, vocab_size)
                         for x in utt["candidates"][-num_candidates:]]
                seqs.append([candidate_sequence(persona, hist, r,
                                                j == len(cands) - 1)
                             for j, r in enumerate(cands)])
                owners.append(c)
    N, C = len(seqs), max(len(s) for s in seqs)
    L = max(len(x["ids"]) for s in seqs for x in s)
    pad = SPECIAL.index("<pad>")
    arrays = {"input_ids": np.full((N, C, L), pad, np.int32),
              "token_type_ids": np.full((N, C, L), pad, np.int32),
              "lm_labels": np.full((N, C, L), IGNORE, np.int32),
              "mc_token_ids": np.zeros((N, C), np.int32),
              "mc_labels": np.zeros((N,), np.int32)}
    for i, s in enumerate(seqs):
        for j, x in enumerate(s):
            n = len(x["ids"])
            arrays["input_ids"][i, j, :n] = x["ids"]
            arrays["token_type_ids"][i, j, :n] = x["types"]
            arrays["lm_labels"][i, j, :n] = x["labels"]
            arrays["mc_token_ids"][i, j] = x["mc"]
        arrays["mc_labels"][i] = len(s) - 1
    clients: List[List[int]] = [[] for _ in by_client]
    for i, c in enumerate(owners):
        clients[c].append(i)
    return clients, arrays


def load_raw(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
