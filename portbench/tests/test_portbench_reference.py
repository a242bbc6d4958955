"""The plain reference against the port on the CPU, at tiny sizes, with
the port's kernels in their plain versions: the weight layout, the
tokenized corpus, the count sketch and both decodes, and whole runs of
the harness with and without faults planted under the timed path."""
import os

import numpy as np
import pytest
import torch

from portbench.tests import tiny  # noqa: F401  (puts the repo on sys.path)
from portbench import corpus, faults, harness
from portbench.reference import gpt2 as ref_gpt2
from portbench.reference import sketch as ref_sketch
from portbench.reference import tokens


@pytest.fixture(autouse=True)
def _threads():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


@pytest.mark.parametrize("n_layer,n_embd,vocab,n_pos",
                         [(3, 8, 50, 16), (12, 32, 97, 40)])
def test_layout_is_the_programs(n_layer, n_embd, vocab, n_pos):
    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads)
    from commefficient_tpu_torch.ops.flat import module_layout
    m = GPT2DoubleHeads(GPT2Config(vocab_size=vocab, n_positions=n_pos,
                                   n_embd=n_embd, n_layer=n_layer,
                                   n_head=2))
    want = [(".".join(e.path), tuple(e.flat_shape))
            for e in module_layout(m)]
    got = [(lf.path, lf.shape)
           for lf in ref_gpt2.layout(n_layer, n_embd, vocab, n_pos)]
    assert got == want


def test_published_sizes():
    # D as the port's bring-up reported it on the card (PERF.md)
    for args, d in (((12, 768, 50262, 1024), 124_444_417),
                    ((24, 1024, 50262, 1024), 354_829_313)):
        lv = ref_gpt2.layout(*args)
        assert lv[-1].offset + lv[-1].size == d


def test_tokens_are_the_data_layers(tmp_path):
    from commefficient_tpu_torch.data.persona import (FedPERSONA,
                                                      HashTokenizer)
    raw = corpus.make_raw(tiny.CORPUS, 2 ** 31 + 5)
    corpus.write_raw(str(tmp_path), raw)
    ds = FedPERSONA(str(tmp_path), tokenizer=HashTokenizer(500),
                    num_candidates=2, max_history=2, train=True)
    clients, arrays = tokens.train_examples(raw, 500, 2, 2)
    z = np.load(ds._npz_path("train"))
    for name, a in arrays.items():
        np.testing.assert_array_equal(z[name], a)
    offsets = np.concatenate([[0], np.cumsum([len(c) for c in clients])])
    np.testing.assert_array_equal(z["offsets"], offsets)


def test_corpus_sizes_do_not_depend_on_the_seed():
    shapes = set()
    for seed in (0, 1, 2 ** 31 + 11):
        _, a = tokens.train_examples(corpus.make_raw(tiny.CORPUS, seed),
                                     500, 2, 2)
        shapes.add(a["input_ids"].shape)
    assert len(shapes) == 1


def test_sketch_and_exact_decode_are_the_programs():
    from commefficient_tpu_torch.ops.sketch import CSVec
    d, c, r, k = 5003, 301, 5, 40
    v = torch.randn(d, generator=torch.Generator().manual_seed(3))
    prog, ref = CSVec(d, c, r), ref_sketch.Sketch(d, c, r, "cpu")
    table = prog.encode(v)
    torch.testing.assert_close(ref.encode(v), table, rtol=0, atol=1e-5)
    idx, vals = prog.decode_topk_sparse(table, k)
    want = torch.zeros(d)
    want[idx[idx < d]] = vals[idx < d]
    torch.testing.assert_close(ref.decode(table, k), want, rtol=0, atol=0)


def test_threshold_decode_is_the_programs(monkeypatch):
    from commefficient_tpu_torch.ops import flat
    from commefficient_tpu_torch.ops.kernels import sketch_cuda as sc
    from commefficient_tpu_torch.ops.sketch import CSVec
    d, c, r, k = 40_000, 3_000, 5, 400
    monkeypatch.setattr(ref_sketch, "THRESHOLD_MIN_D", 0)
    monkeypatch.setattr(ref_sketch, "SAMPLE_TARGET", 4096)
    monkeypatch.setattr(sc, "_SAMPLE_TARGET", 4096)
    v = torch.randn(d, generator=torch.Generator().manual_seed(4))
    prog, ref = CSVec(d, c, r), ref_sketch.Sketch(d, c, r, "cpu")
    table = prog.encode(v)
    off, eps, delta = prog.tables("cpu")
    stride, ns = sc.threshold_sample_geometry(prog.n_chunks, c)
    sample = sc.threshold_sample_plain(table, off, delta, eps, d, stride, ns)
    thr = flat.threshold_from_sq_sample((sample * sample).reshape(-1), k,
                                        prog.n_chunks * c)
    want = sc.threshold_mask_plain(table, off, delta, eps, thr, d)
    got = ref.decode(table, k)
    assert int((want != 0).sum()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_a_sound_run_is_correct(tmp_path):
    cell = tiny.load(tmp_path)
    r = harness.run(cell, 2 ** 31 + 3, 0.5, False, "cpu")
    assert r.rounds >= 1 and r.correct, r.checks
    assert r.numbers["batch_rows_bad"] == 0
    assert r.numbers["upload_bytes_gap"] == 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    cell = tiny.load(tmp_path)
    r = harness.run(cell, 2 ** 31 + 3, 0.5, False, "cpu",
                    fault=faults.FAULTS[fault])
    assert not r.correct, r.checks


def test_an_altered_batch_row_is_caught(tmp_path, monkeypatch):
    """A token altered where the data layer produces it."""
    from commefficient_tpu_torch.data.persona import FedPERSONA
    inner = FedPERSONA._batch_from

    def altered(self, z, sel):
        out = inner(self, z, sel)
        out[0][0, 0, 1] += 1
        return out

    monkeypatch.setattr(FedPERSONA, "_batch_from", altered)
    cell = tiny.load(tmp_path)
    r = harness.run(cell, 7, 0.5, False, "cpu")
    assert not r.correct and r.numbers["batch_rows_bad"] > 0
