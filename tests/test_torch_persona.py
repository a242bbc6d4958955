"""PersonaChat data parity: the port's data/persona.py against the JAX
package's — HashTokenizer ids, segment building, the synthetic corpus,
FedPERSONA's npz arrays and partition, and the loader's rounds — all
equal exactly (the same numpy draws and the same integer arithmetic)."""
import numpy as np
import pytest

from commefficient_tpu.data import persona as jp
from commefficient_tpu.data.loader import FedLoader as JLoader
from commefficient_tpu_torch.data import FedLoader, FedValLoader
from commefficient_tpu_torch.data import persona as tp

pytestmark = pytest.mark.torch_port


def test_hash_tokenizer_and_segments_match_jax():
    jt, tt = jp.HashTokenizer(50262), tp.HashTokenizer(50262)
    text = "Persona 3 trait 1 w17 w5 W199 hello, world!"
    assert tt.tokenize(text) == jt.tokenize(text)
    assert tt.special_ids() == jt.special_ids() and len(tt) == 50262
    assert tp.SPECIAL_TOKENS == jp.SPECIAL_TOKENS
    assert tp.IGNORE_INDEX == jp.IGNORE_INDEX
    sp = tt.special_ids()
    # odd and even history lengths: the `% 2 == 0` speaker quirk
    for history in ([[20, 21], [22]], [[20], [21], [22, 23]]):
        for labels in (True, False):
            args = ([[10, 11], [12]], history, [30, 31], sp)
            assert (tp.build_input_from_segments(*args, lm_labels=labels)
                    == jp.build_input_from_segments(*args,
                                                    lm_labels=labels))
    raw = jp._synthetic_personachat(3, 2, 4, 2, seed=5)
    assert tp._synthetic_personachat(3, 2, 4, 2, seed=5) == raw
    utt = raw["train"][0]["utterances"][3]
    for want, got in zip(
            jp.utterance_to_arrays(raw["train"][0]["personality"],
                                   utt["history"], utt["candidates"], jt, 2,
                                   1),
            tp.utterance_to_arrays(raw["train"][0]["personality"],
                                   utt["history"], utt["candidates"], tt, 2,
                                   1)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(max_history=2, personality_permutations=1),
    dict(max_history=20, personality_permutations=2),
], ids=["config5", "long-history-perms"])
def test_fed_persona_arrays_and_rounds_match_jax(tmp_path, kw):
    common = dict(tokenizer=None, num_candidates=2,
                  synthetic_examples=(6, 2, 8), seed=3, **kw)
    sets = {}
    for name, mod in (("j", jp), ("t", tp)):
        c = dict(common, tokenizer=mod.HashTokenizer(1000))
        sets[name] = (
            mod.FedPERSONA(str(tmp_path / name), train=True, **c),
            mod.FedPERSONA(str(tmp_path / name), train=False, **c))
    (jtr, jva), (ttr, tva) = sets["j"], sets["t"]
    for split in ("train", "val"):
        jz = np.load(jtr._npz_path(split))
        tz = np.load(ttr._npz_path(split))
        assert sorted(tz.files) == sorted(jz.files)
        for key in jz.files:
            np.testing.assert_array_equal(tz[key], jz[key],
                                          err_msg=f"{split}/{key}")
    assert ttr.seq_len == jtr.seq_len and tva.seq_len == jva.seq_len
    assert ttr.num_clients == jtr.num_clients == 6
    np.testing.assert_array_equal(ttr.data_per_client, jtr.data_per_client)
    # the five arrays go through the loaders unchanged
    jl, tl = JLoader(jtr, 3, 4, seed=3), FedLoader(ttr, 3, 4, seed=3)
    assert tl.steps_per_epoch == jl.steps_per_epoch
    jrounds, trounds = list(jl.epoch()), list(tl.epoch())
    assert len(trounds) == len(jrounds) > 0
    for (jid, jd, jm), (tid, td, tm) in zip(jrounds, trounds):
        np.testing.assert_array_equal(tid, jid)
        np.testing.assert_array_equal(tm, jm)
        assert len(td) == len(jd) == 5
        for a, b in zip(jd, td):
            np.testing.assert_array_equal(b, a)
    vb = list(FedValLoader(tva, 4, num_shards=1).batches())
    assert sum(int(m.sum()) for _, m in vb) == tva.num_val_images
    data, mask = vb[0]
    assert data[0].shape == (1, 4, 2, tva.seq_len) and mask.shape == (1, 4)
    np.testing.assert_array_equal(data[0][0], jva.get_val_batch(
        np.arange(4))[0])


def test_long_history_corpus_reaches_the_flash_route(tmp_path):
    # config #5's flags with --max_history 20, over the synthetic corpus
    # chip_smoke.py trains on (16 personas x 2 dialogs x 24 utterances,
    # 50,262-word hash ids), pad both splits past
    # FLASH_ATTENTION_MIN_LEN (256), in both packages alike
    from commefficient_tpu_torch.models.gpt2 import FLASH_ATTENTION_MIN_LEN
    lens = {}
    for name, mod in (("j", jp), ("t", tp)):
        kw = dict(tokenizer=mod.HashTokenizer(50262), num_candidates=2,
                  max_history=20, synthetic_examples=(16, 2, 24), seed=21)
        lens[name] = tuple(
            mod.FedPERSONA(str(tmp_path / name), train=train, **kw).seq_len
            for train in (True, False))
    assert lens["t"] == lens["j"] == (299, 282)
    assert min(lens["t"]) >= FLASH_ATTENTION_MIN_LEN
