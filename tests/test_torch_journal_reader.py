"""The journal's reader half (commefficient_tpu_torch/telemetry/
journal.py: validate_journal, summarize, _cadence_bucket) and its entry
point (telemetry/journal_summary.py) against the JAX package's
(commefficient_tpu/telemetry/journal.py, scripts/journal_summary.py).

The same events go through each package's RunJournal on the same
clocks, so the two files are byte for byte one journal; each journal is
then damaged the same way (a torn last line, a duplicate round, a wrong
`v`, non-finite values, an unregistered controller), and both packages'
validate_journal must report the same problems on both journals and
summarize must give equal dicts."""
import itertools
import json
import os
import subprocess
import sys

import pytest
import torch

from commefficient_tpu.telemetry import journal as jj
from commefficient_tpu_torch.telemetry import journal as tj
from commefficient_tpu_torch.telemetry import journal_summary as tsummary

pytestmark = pytest.mark.torch_port

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGEST = "ab" * 32


def _events():
    """(kind, fields) of a run touching every kind the validators check,
    with the plan transport's plan / digest fields on the schedule
    events."""
    ev = [("run_start", {"config": {"mode": "sketch"}, "resumed_round": 0})]
    for r in range(4):
        ev.append(("schedule", {
            "round": r, "sampler": "throughput", "n_sampled": 4,
            "deadline_s": 0.5, "est_round_s": 0.25,
            "digest": f"{r:064x}",
            "plan": {"slots": [0, 1, 2, 3], "controls": {
                "screen_mult": 3.0}}}))
        ev.append(("round", {
            "round": r, "seconds": 0.125,
            "metrics": {"train_loss": 2.5 - r, "update_l2": 1.0},
            "down_bytes": 1024.0 * (r + 1), "up_bytes": 512.0}))
        ev.append(("compressor", {"round": r, "mode": "sketch",
                                  "wire_bytes": 40, "up_bytes": 512.0}))
        ev.append(("privacy", {"round": r, "epsilon": 0.5 * (r + 1),
                               "sigma": 0.5, "clip": 1.0,
                               "delta": 1e-5}))
    ev += [
        ("control", {"round": 2, "controller": "screen_adapt",
                     "signal": 0.25, "old": 3.0, "new": 2.5,
                     "clamped": False}),
        ("control", {"round": 3, "controller": "speed_match",
                     "signal": 2.0, "old": 1.0, "new": 1.25,
                     "clamped": True}),
        ("state_tier", {"round": 3, "hits": 5, "misses": 3, "spills": 2,
                        "restores": 3, "spill_bytes": 4096,
                        "restore_bytes": 4096, "resident": 4,
                        "working_set": 4}),
        ("screened", {"round": 1, "n_screened": 1, "kind": "norm"}),
        ("aggregator", {"round": 1, "aggregator": "trimmed_mean",
                        "n_trimmed": 0.5, "n_clipped": 0,
                        "residual_l2": 0.125, "n_contrib": 4}),
        ("screen_adapt", {"round": 2, "old_mult": 3.0, "new_mult": 2.5,
                          "rate": 0.25, "target": 0.1}),
        ("state_quarantine", {"client": 7, "field": "errors"}),
        ("span", {"first_round": 0, "rounds": 4, "dispatch_s": 0.25,
                  "block_s": 0.5}),
        ("checkpoint", {"path": "ck/ResNet9-r4.npz", "seconds": 0.75}),
        ("trace", {"controller": 0, "dropped": 1, "spans": [
            {"name": "device_execute", "thread": "MainThread",
             "t0": 1.0, "dur": 0.5, "round": 0},
            {"name": "device_execute", "thread": "MainThread",
             "t0": 1.25, "dur": 0.5, "round": 1},
            {"name": "journal_enqueue", "thread": "MainThread",
             "t0": 1.5, "dur": 0.0, "q": 3},
            {"name": "collect", "thread": "journal-writer", "t0": 1.75,
             "dur": 0.25}]}),
        ("sync_audit_digest", {"digest": DIGEST, "findings": 0,
                               "rules": {"SY001": 0, "SY006": 0},
                               "registry": {"shared_state": 8}}),
        ("num_audit_digest", {"digest": "cd" * 32, "findings": 2,
                              "rules": {"NU001": 2},
                              "ulp": {"round": 4}}),
        ("audit_digest", {"digest": "x1", "programs": {
            "round": {"flops": 10, "hbm_bytes": 20}}}),
        ("mesh_audit_digest", {"digest": "x2", "programs": {
            "round": {"ici_bytes": 1, "dcn_bytes": 2,
                      "dcn_collectives": 1}}}),
        ("numeric_trip", {"round": 3, "metrics": ["update_l2"]}),
        ("round", {"round": 3, "seconds": 0.125, "metrics": {
            "train_loss": float("nan"), "update_l2": float("inf")},
            "down_bytes": 64.0, "up_bytes": 64.0}),
        ("run_end", {"ok": True, "down_bytes_total": 10304.0,
                     "up_bytes_total": 2112.0}),
    ]
    return ev


def _write(journal_mod, path, events=None):
    clock = itertools.count(1000)
    mono = itertools.count(5, 0.25)
    j = journal_mod.RunJournal(path, run_id="r1",
                               clock=lambda: float(next(clock)),
                               mono_clock=lambda: float(next(mono)))
    for kind, fields in (events or _events()):
        j.event(kind, **fields)
    j.close()
    return path


def _damage(path, how):
    with open(path, "a") as f:
        if how == "torn":
            f.write('{"v": 1, "event": "round", "ro')
        elif how == "duplicate":
            f.write(json.dumps({"v": 1, "event": "round", "ts": 2.0,
                                "round": 3}) + "\n")
        elif how == "wrong_v":
            f.write(json.dumps({"v": 2, "event": "epoch", "ts": 2.0})
                    + "\n")
        elif how == "nonfinite":
            f.write(json.dumps({"v": 1, "event": "privacy", "ts": 2.0,
                                "round": 9, "epsilon": "NaN",
                                "sigma": "Infinity", "clip": 1.0,
                                "delta": 1e-5}) + "\n")
            f.write(json.dumps({"v": 1, "event": "round", "ts": 2.0,
                                "round": 10, "metrics": {"x": "nan"},
                                "down_bytes": -1}) + "\n")
        elif how == "controller":
            f.write(json.dumps({"v": 1, "event": "control", "ts": 2.0,
                                "round": 9, "controller": "rogue",
                                "signal": 1, "old": 1, "new": 1,
                                "clamped": 0}) + "\n")
        elif how == "interior":
            f.write("not json\n")
            f.write(json.dumps({"v": 1, "event": "epoch", "ts": 3.0})
                    + "\n")
        elif how == "digest":
            f.write(json.dumps({"v": 1, "event": "sync_audit_digest",
                                "ts": 2.0, "digest": "ABC",
                                "rules": {"SY001": -1},
                                "findings": 1.5}) + "\n")


def test_both_writers_write_one_journal(tmp_path):
    a = _write(tj, str(tmp_path / "port.jsonl"))
    b = _write(jj, str(tmp_path / "jax.jsonl"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("how", [None, "torn", "duplicate", "wrong_v",
                                 "nonfinite", "controller", "interior",
                                 "digest"])
def test_validators_and_summaries_agree(tmp_path, how):
    for writer in (tj, jj):
        path = _write(writer, str(tmp_path / f"{writer.__name__}.jsonl"))
        if how:
            _damage(path, how)
        got = {}
        for reader in (tj, jj):
            counters = {}
            recs, problems = reader.validate_journal(path,
                                                     counters=counters)
            got[reader.__name__] = (problems, counters, reader.summarize(
                recs, corrupt_lines=counters["corrupt_interior"]))
        # through json: a NaN summary field is equal to itself there
        a, b = got.values()
        assert json.dumps(a, sort_keys=True) == json.dumps(
            b, sort_keys=True), how
        problems, counters, summary = a
        assert bool(problems) == (how not in (None, "interior")), problems
        assert summary["rounds"] == 5 + (how in ("duplicate", "nonfinite"))
        assert summary["analysis_digests"]["sync_audit_digest"] == (
            "ABC" if how == "digest" else DIGEST)
        assert summary["controllers"]["screen_adapt"]["adjustments"] == 1
        if how == "interior":
            assert summary["corrupt_lines"] == 1
    # the wording of the problems the reader found
    if how == "controller":
        assert any("CONTROL_FIELDS" in p for p in problems)
    if how == "torn":
        assert problems[-1].endswith("(torn tail?)")


def test_summary_blocks(tmp_path):
    recs, problems = tj.validate_journal(_write(tj, str(tmp_path /
                                                        "j.jsonl")))
    assert not problems
    s = tj.summarize(recs)
    assert (s["first_round"], s["last_round"], s["rounds"]) == (0, 3, 5)
    assert s["down_mib"] == round(10304.0 / 2 ** 20, 3)
    assert s["epsilon_spent"] == 2.0 and s["numeric_trips"] == 1
    assert s["compressor_modes"]["sketch"]["rounds"] == 4
    assert s["state_hit_rate"] == 0.625
    assert s["writer_queue_max"] == {"journal": 3}
    assert s["overlap_efficiency"] == 0.75 and s["trace_dropped"] == 1
    assert s["cadence"]["rounds"] == 4
    assert s == jj.summarize(recs)


@pytest.mark.parametrize("dt", [0.0, 0.0009, 0.001, 0.05, 0.3, 2.9, 3.0,
                                9.99, 10.0, 1e6])
def test_cadence_buckets_match(dt):
    assert tj._CADENCE_EDGES == jj._CADENCE_EDGES
    assert tj._cadence_bucket(dt) == jj._cadence_bucket(dt)


def _run_summary(cmd, path):
    out = subprocess.run(cmd + [path], cwd=REPO, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return out.returncode, out.stdout, out.stderr


@pytest.mark.parametrize("how", [None, "duplicate", "empty", "missing"])
def test_summary_entry_matches_the_jax_script(tmp_path, how):
    path = str(tmp_path / "j.jsonl")
    if how == "empty":
        open(path, "w").close()
    elif how != "missing":
        _write(tj, path)
        if how:
            _damage(path, how)
    port = _run_summary([sys.executable, "-m",
                         "commefficient_tpu_torch.telemetry."
                         "journal_summary"], path)
    jax = _run_summary([sys.executable, "scripts/journal_summary.py"],
                       path)
    assert port[:2] == jax[:2]
    assert [ln for ln in port[2].splitlines() if "INVALID" in ln] == \
        [ln for ln in jax[2].splitlines() if "INVALID" in ln]
    assert port[0] == {None: 0, "duplicate": 1, "empty": 1,
                       "missing": 2}[how]
    # in process, --quiet prints no summary
    assert tsummary.main([path, "--quiet"]) == port[0]
