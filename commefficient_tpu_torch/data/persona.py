"""Federated PersonaChat: the port's copy of
commefficient_tpu/data/persona.py (reference data_utils/fed_persona.py).

One client per personality tuple; the whole corpus is tokenized once at
prepare time into .npz arrays padded to the corpus-wide max sequence
length (static shapes), and fetches are numpy slices. Segment building,
the last-candidate-is-correct multiple choice, the `% 2 == 0` speaker
quirk, the synthetic corpus and the npz layout are the JAX package's,
line for line, so the same seed and tokenizer give the same arrays.
Host-side numpy only.

Tokenization is injectable: `transformers`' GPT2 BPE when a local cache
exists (it never needs jax); otherwise `HashTokenizer`, a deterministic
offline vocabulary (what the synthetic corpus and tests use).

An example is (input_ids [C, L], mc_token_ids [C], lm_labels [C, L],
mc_labels scalar, token_type_ids [C, L]); lm_labels use -1 as ignore.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset
from commefficient_tpu_torch.telemetry.trace import TRACE
from commefficient_tpu_torch.utils.atomic_io import atomic_savez

SPECIAL_TOKENS = ("<bos>", "<eos>", "<speaker1>", "<speaker2>", "<pad>")
IGNORE_INDEX = -1


class HashTokenizer:
    """Deterministic offline word-level tokenizer: words hash into
    [num_special, vocab_size); the 5 PersonaChat special tokens take
    ids 0..4. Stands in for GPT2 BPE in zero-egress environments."""

    def __init__(self, vocab_size: int = 1000):
        assert vocab_size > len(SPECIAL_TOKENS) + 1
        self.vocab_size = vocab_size
        self._special = {t: i for i, t in enumerate(SPECIAL_TOKENS)}

    def __len__(self):
        return self.vocab_size

    def tokenize(self, text: str) -> List[int]:
        out = []
        for w in text.lower().split():
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            n = len(self._special)
            out.append(n + h % (self.vocab_size - n))
        return out

    def special_ids(self) -> Dict[str, int]:
        return dict(self._special)


class GPT2BPETokenizer:
    """transformers GPT2 BPE with PersonaChat special tokens appended
    (the reference adds them the same way, gpt2_train.py:26-32,226-232).
    Requires a local HF cache — raises if none exists."""

    def __init__(self, model_checkpoint: str = "gpt2"):
        from transformers import GPT2Tokenizer
        self.tok = GPT2Tokenizer.from_pretrained(
            model_checkpoint, local_files_only=True)
        self.base_vocab = len(self.tok)
        self.tok.add_special_tokens({
            "bos_token": "<bos>", "eos_token": "<eos>",
            "pad_token": "<pad>",
            "additional_special_tokens": ["<speaker1>", "<speaker2>"]})

    def __len__(self):
        return len(self.tok)

    def tokenize(self, text: str) -> List[int]:
        return self.tok.convert_tokens_to_ids(self.tok.tokenize(text))

    def special_ids(self) -> Dict[str, int]:
        ids = self.tok.convert_tokens_to_ids(list(SPECIAL_TOKENS))
        return dict(zip(SPECIAL_TOKENS, ids))


def make_tokenizer(model_checkpoint: str = "gpt2",
                   fallback_vocab: int = 1000):
    """GPT2 BPE when locally cached, HashTokenizer otherwise."""
    try:
        return GPT2BPETokenizer(model_checkpoint)
    except (ImportError, OSError, ValueError, RuntimeError, TypeError):
        # transformers missing / no locally-cached vocab files / torn
        # cache — the expected offline failure modes. TypeError is on
        # the list because transformers resolves missing cached vocab
        # files to None and dies in open(None). Anything else (incl.
        # InjectedFault from the fault harness) raises.
        return HashTokenizer(fallback_vocab)


class _MemoTokenizer:
    """String->tokens memo held for the duration of prepare(): persona
    sentences recur once per utterance x permutation and history turns
    once per subsequent utterance, so caching cuts BPE work several-
    fold on the real corpus."""

    def __init__(self, tok):
        self._tok = tok
        self._cache: Dict[str, List[int]] = {}

    def __len__(self):
        return len(self._tok)

    def tokenize(self, text: str) -> List[int]:
        got = self._cache.get(text)
        if got is None:
            got = self._cache[text] = self._tok.tokenize(text)
        return got

    def special_ids(self) -> Dict[str, int]:
        return self._tok.special_ids()


# ---- segment building (reference build_input_from_segments,
#      fed_persona.py:330-358) --------------------------------------------

def build_input_from_segments(persona: Sequence[Sequence[int]],
                              history: Sequence[Sequence[int]],
                              reply: Sequence[int],
                              special: Dict[str, int],
                              lm_labels: bool = False,
                              with_eos: bool = True) -> Dict[str, list]:
    """Assemble one candidate sequence from tokenized segments:
    [<bos> persona*] [<spk> turn]... [<spk2> reply <eos>], with
    per-segment token types and LM labels only on the reply tokens of
    the correct candidate. Formula-identical to the reference (the
    segment grammar IS the dataset contract)."""
    bos, eos = special["<bos>"], special["<eos>"]
    spk1, spk2 = special["<speaker1>"], special["<speaker2>"]

    persona_flat = [t for seg in persona for t in seg]
    segments = [[bos] + persona_flat] + [list(h) for h in history]
    segments += [list(reply) + ([eos] if with_eos else [])]
    # prepend alternating speaker tokens; the reply always gets
    # <speaker2>. NB: with odd-length history (the real-PersonaChat
    # case) the prepended speaker and the segment's token_type disagree
    # — that quirk is the reference's exact formula
    # (fed_persona.py:343-347 uses `% 2 == 0`, diverging from upstream
    # HF convai's `% 2`), kept verbatim for dataset-level parity.
    n = len(segments)
    segments = [segments[0]] + [
        [spk2 if (n - i) % 2 == 0 else spk1] + seg
        for i, seg in enumerate(segments[1:])]

    input_ids = [t for seg in segments for t in seg]
    token_type_ids = [spk2 if i % 2 else spk1
                      for i, seg in enumerate(segments) for _ in seg]
    out = {
        "input_ids": input_ids,
        "token_type_ids": token_type_ids,
        "mc_token_ids": len(input_ids) - 1,
        "lm_labels": [IGNORE_INDEX] * len(input_ids),
    }
    if lm_labels:
        prefix = sum(len(s) for s in segments[:-1])
        out["lm_labels"] = ([IGNORE_INDEX] * prefix
                            + [IGNORE_INDEX] + segments[-1][1:])
    return out


def utterance_to_arrays(persona, history, candidates, tokenizer,
                        num_candidates: int, max_history: int,
                        seq_len: Optional[int] = None):
    """One utterance -> padded candidate arrays. The LAST candidate is
    the ground truth (reference fed_persona.py:304). Truncates history
    to the last 2*max_history+1 turns and candidates to the last
    num_candidates (reference :249-255). Returns
    (input_ids [C, L], mc_token_ids [C], lm_labels [C, L],
     mc_label scalar, token_type_ids [C, L]) with L = seq_len (or the
    utterance max when None)."""
    special = tokenizer.special_ids()
    if num_candidates > 0:
        candidates = candidates[-num_candidates:]
    history = history[-(2 * max_history + 1):]

    tp = [tokenizer.tokenize(p) for p in persona]
    th = [tokenizer.tokenize(h) for h in history]
    tc = [tokenizer.tokenize(c) for c in candidates]

    instances = [
        build_input_from_segments(tp, th, cand, special,
                                  lm_labels=(j == len(tc) - 1))
        for j, cand in enumerate(tc)]

    L = seq_len or max(len(inst["input_ids"]) for inst in instances)
    C = len(instances)
    pad = special["<pad>"]
    input_ids = np.full((C, L), pad, np.int32)
    token_type = np.full((C, L), pad, np.int32)
    labels = np.full((C, L), IGNORE_INDEX, np.int32)
    mc_token_ids = np.zeros((C,), np.int32)
    for j, inst in enumerate(instances):
        ln = min(len(inst["input_ids"]), L)
        input_ids[j, :ln] = inst["input_ids"][:ln]
        token_type[j, :ln] = inst["token_type_ids"][:ln]
        labels[j, :ln] = inst["lm_labels"][:ln]
        mc_token_ids[j] = min(inst["mc_token_ids"], L - 1)
    return input_ids, mc_token_ids, labels, np.int32(C - 1), token_type


def _synthetic_personachat(num_personas: int, dialogs_per_persona: int,
                           utterances_per_dialog: int,
                           num_candidates: int, seed: int) -> dict:
    """Deterministic synthetic corpus in the raw personachat JSON
    schema, for zero-egress environments (mirrors the CIFAR/EMNIST
    synthetic-fallback pattern)."""
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(200)]

    def sent(n):
        return " ".join(rng.choice(words, size=n))

    personas = {}

    def persona_of(pid):
        if pid not in personas:
            personas[pid] = [f"persona {pid} trait {t} " + sent(3)
                             for t in range(4)]
        return personas[pid]

    def dialog(pid):
        persona = persona_of(pid)
        utts = []
        history = [sent(5)]
        for _ in range(utterances_per_dialog):
            cands = [sent(rng.randint(3, 8)) for _ in range(num_candidates)]
            utts.append({"history": list(history),
                         "candidates": cands})
            history.append(cands[-1])
            history.append(sent(5))
        return {"personality": persona, "utterances": utts}

    train = [dialog(p) for p in range(num_personas)
             for _ in range(dialogs_per_persona)]
    valid = [dialog(10_000 + p) for p in range(max(2, num_personas // 4))]
    return {"train": train, "valid": valid}


class FedPERSONA(FedDataset):
    """Persona-partitioned PersonaChat with prepare-time tokenization.

    Storage layout under <dataset_dir>/PERSONA/:
      raw .json           — personachat_self_original.json (if present)
      train_<key>.npz     — input_ids/token_type_ids/lm_labels
                            [N, C, L] int32, mc_token_ids [N, C],
                            mc_labels [N] (+ client offsets)
      val_<key>.npz       — same arrays for the validation dialogs
      stats.json          — utterances per client + val count + seq_len
    where <key> encodes (num_candidates, max_history,
    personality_permutations) so differently-configured runs don't
    collide."""

    RAW_NAME = "personachat_self_original.json"

    def __init__(self, dataset_dir, dataset_name="PERSONA", tokenizer=None,
                 num_candidates: int = 2, max_history: int = 2,
                 personality_permutations: int = 1,
                 transform=None, do_iid=False, num_clients=None,
                 train=True, download=False,
                 synthetic_examples: Optional[Tuple[int, int, int]] = None,
                 seed: int = 0):
        self.tokenizer = tokenizer or make_tokenizer()
        self.num_candidates = num_candidates
        self.max_history = max_history
        self.personality_permutations = personality_permutations
        self._synthetic_examples = synthetic_examples
        self._seed = seed
        self._z: dict = {}
        super().__init__(dataset_dir, dataset_name, transform, do_iid,
                         num_clients, train, download, seed)

    # ---- paths ----------------------------------------------------------
    def _dir(self):
        return os.path.join(self.dataset_dir, self.dataset_name)

    def _key(self):
        # the cache key must pin the tokenizer identity: ids from a
        # different tokenizer/vocab are silently wrong if reused
        tok = f"{type(self.tokenizer).__name__}{len(self.tokenizer)}"
        syn = ("" if self._synthetic_examples is None
               else "_s" + "x".join(map(str, self._synthetic_examples)))
        return (f"c{self.num_candidates}_h{self.max_history}"
                f"_p{self.personality_permutations}_{tok}{syn}")

    def _npz_path(self, split: str) -> str:
        return os.path.join(self._dir(), f"{split}_{self._key()}.npz")

    def stats_path(self) -> str:
        return os.path.join(self._dir(), f"stats_{self._key()}.json")

    # ---- preparation ----------------------------------------------------
    def prepare(self, download: bool = False):
        raw_path = os.path.join(self._dir(), self.RAW_NAME)
        if os.path.exists(raw_path):
            with open(raw_path) as f:
                raw = json.load(f)
        elif self._synthetic_examples is not None:
            n_personas, dpp, upd = self._synthetic_examples
            raw = _synthetic_personachat(
                n_personas, dpp, upd, max(self.num_candidates, 2),
                self._seed)
        else:
            raise FileNotFoundError(
                f"No {self.RAW_NAME} under {self._dir()} and no network "
                f"egress; pass synthetic_examples=(num_personas, "
                f"dialogs_per_persona, utterances_per_dialog)")

        # partition train dialogs by persona tuple (reference :144-147)
        clients: Dict[tuple, list] = {}
        for dialog in raw["train"]:
            clients.setdefault(tuple(dialog["personality"]), []).append(
                dialog)

        os.makedirs(self._dir(), exist_ok=True)
        counts = self._write_split(
            "train", [d for ds in clients.values() for d in ds],
            per_client_dialogs=[len(ds) for ds in clients.values()],
            train=True)
        n_val = self._write_split("val", raw["valid"], None, train=False)
        self.write_stats(counts, n_val)

    def _examples_of(self, dialog, train: bool):
        """Yield (persona_rotation, history, candidates) tuples for
        every utterance, applying persona rotations for train."""
        persona = list(dialog["personality"])
        perms = self.personality_permutations if train else 1
        for utt in dialog["utterances"]:
            for p in range(perms):
                rot = persona[p % len(persona):] + persona[:p % len(persona)]
                yield rot, utt["history"], utt["candidates"]

    def _write_split(self, split: str, dialogs: list,
                     per_client_dialogs: Optional[List[int]], train: bool):
        examples = []
        for dialog in dialogs:
            for ex in self._examples_of(dialog, train):
                examples.append(ex)

        # two passes over a streamed build: pass 1 finds the corpus
        # (C, L) envelope, pass 2 fills the preallocated block directly
        # — per-utterance arrays are never held all at once (the memo
        # makes the second tokenization pass nearly free)
        ncand = self.num_candidates if train else 0  # val keeps all
        memo = _MemoTokenizer(self.tokenizer)

        def stream():
            for p, h, c in examples:
                yield utterance_to_arrays(p, h, c, memo, ncand,
                                          self.max_history)

        C = L = 1
        for arrs in stream():
            C = max(C, int(arrs[0].shape[0]))
            L = max(L, int(arrs[0].shape[1]))

        N = len(examples)
        pad = self.tokenizer.special_ids()["<pad>"]
        input_ids = np.full((N, C, L), pad, np.int32)
        token_type = np.full((N, C, L), pad, np.int32)
        labels = np.full((N, C, L), IGNORE_INDEX, np.int32)
        mc_token_ids = np.zeros((N, C), np.int32)
        mc_labels = np.zeros((N,), np.int32)
        for i, arrs in enumerate(stream()):
            ii, mt, lb, ml, tt = arrs
            c, l = ii.shape
            input_ids[i, :c, :l] = ii
            token_type[i, :c, :l] = tt
            labels[i, :c, :l] = lb
            mc_token_ids[i, :c] = mt
            mc_labels[i] = ml

        arrays = dict(input_ids=input_ids, mc_token_ids=mc_token_ids,
                      lm_labels=labels, mc_labels=mc_labels,
                      token_type_ids=token_type)
        if train:
            # utterances per client = dialog utterance counts x perms
            counts, start = [], 0
            for nd in per_client_dialogs:
                n_utt = sum(
                    len(d["utterances"]) * self.personality_permutations
                    for d in dialogs[start:start + nd])
                counts.append(n_utt)
                start += nd
            arrays["offsets"] = np.concatenate([[0], np.cumsum(counts)])
            atomic_savez(self._npz_path(split), **arrays)
            return counts
        atomic_savez(self._npz_path(split), **arrays)
        return N

    # ---- fetch ----------------------------------------------------------
    def _load(self, split: str):
        if split not in self._z:
            self._z[split] = np.load(self._npz_path(split), mmap_mode="r")
        return self._z[split]

    @staticmethod
    def _member(z, key: str) -> np.ndarray:
        """One .npz member, read whole (a zip member maps no pages), its
        bytes counted into the open span's `bytes_read`."""
        a = z[key]
        TRACE.add("bytes_read", a.nbytes)
        return a

    def _batch_from(self, z, sel: np.ndarray):
        return tuple(np.asarray(self._member(z, k)[sel])
                     for k in ("input_ids", "mc_token_ids", "lm_labels",
                               "mc_labels", "token_type_ids"))

    def _get_train_batch(self, nat_client_id: int, idxs: np.ndarray):
        z = self._load("train")
        sel = self._member(z, "offsets")[nat_client_id] + np.asarray(idxs)
        return self._batch_from(z, sel)

    def _get_val_batch(self, idxs: np.ndarray):
        return self._batch_from(self._load("val"), np.asarray(idxs))

    @property
    def seq_len(self) -> int:
        return int(self._load("train" if self.train else "val")
                   ["input_ids"].shape[-1])

    @property
    def vocab_size(self) -> int:
        return len(self.tokenizer)
