"""The traffic's corpus: a PersonaChat-format JSON made from the seed and
a traffic file's `corpus` parameters, the one generator every GPT2 mix
reads. Every sentence has a fixed number of words, so every seed gives
the same example count and the same padded length; the seed picks the
words.

  personas, dialogs_per_persona, utterances_per_dialog: the train
      split (one client per persona);
  valid_dialogs: the validation split's dialogs;
  traits, trait_words: each persona's sentences and their length;
  turn_words, candidate_words, candidates: history turns and replies;
  vocabulary: how many distinct words the seed draws from.
"""
from __future__ import annotations

import json
import os

import numpy as np

RAW_NAME = "personachat_self_original.json"


def make_raw(params: dict, seed: int) -> dict:
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    words = np.array([f"w{i}" for i in range(int(params["vocabulary"]))])

    def sent(n: int) -> str:
        return " ".join(rng.choice(words, size=n))

    def dialog(pid: int) -> dict:
        persona = [f"persona {pid} trait {t} "
                   + sent(params["trait_words"] - 4)
                   for t in range(params["traits"])]
        history, utts = [sent(params["turn_words"])], []
        for _ in range(params["utterances_per_dialog"]):
            cands = [sent(params["candidate_words"])
                     for _ in range(params["candidates"])]
            utts.append({"history": list(history), "candidates": cands})
            history += [cands[-1], sent(params["turn_words"])]
        return {"personality": persona, "utterances": utts}

    train = [dialog(p) for p in range(params["personas"])
             for _ in range(params["dialogs_per_persona"])]
    valid = [dialog(100_000 + p) for p in range(params["valid_dialogs"])]
    return {"train": train, "valid": valid}


def write_raw(root: str, raw: dict, dataset_name: str = "PERSONA") -> str:
    """Write the corpus where the data layer looks for a user's
    PersonaChat file; returns its path."""
    folder = os.path.join(root, dataset_name)
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, RAW_NAME)
    with open(path, "w") as f:
        json.dump(raw, f)
    return path
