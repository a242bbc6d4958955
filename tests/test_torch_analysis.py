"""The analysis tiers' host half (commefficient_tpu_torch/analysis/)
against the JAX package's (commefficient_tpu/analysis/): graftlint's
six host rules, graftsync's SY001-SY006 and the runtime sanitizers, on
the same sources and the same threads; then the port's own tree (clean
under both tools) and small CPU runs of the threaded paths under the
port's sanitizers."""
import ast
import os
import queue
import threading

import numpy as np
import pytest
import torch

from commefficient_tpu.analysis import engine as jengine
from commefficient_tpu.analysis import rules as jrules
from commefficient_tpu.analysis import syncaudit as jsync
from commefficient_tpu_torch.analysis import __main__ as tlint_cli
from commefficient_tpu_torch.analysis import domains as tdomains
from commefficient_tpu_torch.analysis import engine as tengine
from commefficient_tpu_torch.analysis import rules as trules
from commefficient_tpu_torch.analysis import runtime as truntime
from commefficient_tpu_torch.analysis import syncaudit as tsync

pytestmark = pytest.mark.torch_port

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the host rules, which the two packages share word for word (the rules
# over the round's path are test_torch_audit.py's)
SHARED = sorted(trules.HOST_RULES)


@pytest.fixture
def at_repo(monkeypatch):
    monkeypatch.chdir(REPO)


def _keys(violations):
    return sorted((v.rule, v.path, v.line, v.col) for v in violations)


# ---------------- graftlint's host rules -------------------------------

def test_rules_and_docs_are_the_jax_packages():
    assert SHARED == ["GL005", "GL006", "GL009", "GL011", "GL012",
                      "GL014"]
    assert sorted(trules.ALL_RULES) == sorted(jrules.ALL_RULES)
    for code in SHARED:
        assert trules.RULE_DOCS[code] == jrules.RULE_DOCS[code], code


def _jax_lint(paths):
    """JAX's engine over `paths` with only the six shared rules (its
    in-line suppressions applied, its baseline not)."""
    rules = {k: jrules.ALL_RULES[k] for k in SHARED}
    out = []
    for path in jengine.iter_python_files(paths):
        with open(path, encoding="utf-8") as f:
            src = f.read()
        rel = os.path.relpath(path).replace(os.sep, "/")
        out.extend(jengine.lint_source(rel, src, rules))
    return out


@pytest.mark.parametrize("tree", ["commefficient_tpu",
                                  "commefficient_tpu_torch"])
def test_lint_parity_on_both_trees(at_repo, tree):
    port = tengine.lint_paths([tree], rules={k: trules.ALL_RULES[k]
                                              for k in SHARED})
    jax = _jax_lint([tree])
    assert _keys(port) == _keys(jax)
    assert [v.message for v in port] == [v.message for v in
                                          sorted(jax)]
    if tree == "commefficient_tpu_torch":
        assert port == [] and tengine.lint_paths([tree]) == []


def test_port_lints_clean_through_the_cli(at_repo, capsys):
    assert tlint_cli.main([]) == 0
    assert capsys.readouterr().out.strip() == "graftlint: clean"
    assert tlint_cli.main(["no/such/path"]) == 2
    assert tlint_cli.main(["--list-rules"]) == 0
    assert capsys.readouterr().out.count("GL0") == 14


# (rule, path the source is linted as, a source that fires it, the
# line it fires on)
SYNTHETIC = {
    "GL005": ("pkg/a.py", "try:\n    f()\nexcept Exception:\n    pass\n",
              3),
    "GL006": ("pkg/a.py", "def w(p):\n    with open(p, 'w') as f:\n"
              "        f.write('x')\n", 2),
    "GL009": ("pkg/a.py", "import numpy as np\n"
              "r = np.random.SeedSequence([1, 0xBEEF, 2])\n", 2),
    "GL011": ("pkg/a.py", "import time\nt0 = time.time()\n"
              "dt = time.time() - t0\n", 3),
    "GL012": ("pkg/a.py", "import threading\n"
              "t = threading.Thread(target=print)\n", 2),
    "GL014": ("pkg/a.py", "class C:\n    WIRE_FIELD = 'rogue_field'\n",
              2),
}
REGISTRY = {
    "GL009": "DOMAINS = {\n    'a': 0x1,\n    'b': 0x1,\n}\n",
    "GL014": "CONTROL_FIELDS = {\n    'a': 'x',\n    'b': 'x',\n}\n",
}


@pytest.mark.parametrize("code", SHARED)
def test_each_rule_fires_and_is_suppressed(code):
    path, src, line = SYNTHETIC[code]
    for lint_source in (tengine.lint_source, jengine.lint_source):
        hits = lint_source(path, src)
        assert [(v.rule, v.line) for v in hits] == [(code, line)], hits
    lines = src.splitlines()
    lines[line - 1] += f"  # graftlint: disable={code} -- test"
    quiet = "\n".join(lines) + "\n"
    assert tengine.lint_source(path, quiet) == []
    assert jengine.lint_source(path, quiet) == []
    assert _keys(tengine.lint_source(path, src)) == _keys(
        jengine.lint_source(path, src))
    if code in REGISTRY:
        reg = "x/analysis/domains.py"
        got = tengine.lint_source(reg, REGISTRY[code])
        assert [(v.rule, v.line) for v in got] == [(code, 3)]
        assert _keys(got) == _keys(jengine.lint_source(reg,
                                                       REGISTRY[code]))


def test_registries_are_the_jax_packages():
    from commefficient_tpu.analysis import domains as jdomains
    from commefficient_tpu_torch.control import base
    from commefficient_tpu_torch.utils import faults
    assert tdomains.DOMAINS == jdomains.DOMAINS
    assert tdomains.CONTROL_FIELDS == jdomains.CONTROL_FIELDS
    assert tdomains.SHARED_STATE == jdomains.SHARED_STATE
    assert sorted(tdomains.ORDERING_EDGES) == sorted(
        jdomains.ORDERING_EDGES)
    assert faults.DOMAINS is tdomains.DOMAINS
    assert base.CONTROL_FIELDS is tdomains.CONTROL_FIELDS
    assert tdomains.domain("dp") == jdomains.domain("dp")
    with pytest.raises(KeyError, match="unknown PRNG domain"):
        tdomains.domain("rogue")
    for edge in tdomains.ORDERING_EDGES.values():
        assert edge["path"].startswith("commefficient_tpu_torch/")
        assert os.path.exists(os.path.join(REPO, edge["path"]))


def test_baseline_matches(tmp_path):
    path, src, _ = SYNTHETIC["GL005"]
    hits = tengine.lint_source(path, src)
    twice = tengine.lint_source(path, src + src)
    got = {}
    for eng in (tengine, jengine):
        base = eng.Baseline.from_violations(hits)
        got[eng] = [base.apply(hits), base.apply(twice), base.apply([])]
        assert got[eng][0] == ([], [])
        assert len(got[eng][1][0]) == 2 and not got[eng][2][0]
    for (tnew, tstale), (jnew, jstale) in zip(got[tengine], got[jengine]):
        assert [v.render() for v in tnew] == [v.render() for v in jnew]
        # the same verdicts; the JAX wording adds its --write-baseline
        # hint, which the port (no baseline file) has no use for
        assert len(tstale) == len(jstale)
        assert all(j.startswith(t) for t, j in zip(tstale, jstale))
    # the JAX package's baseline file reads the same in both
    shipped = os.path.join(REPO, "graftlint.baseline.json")
    assert tengine.Baseline.load(shipped).entries == \
        jengine.Baseline.load(shipped).entries


def test_find_cycles_matches():
    graph = {"a": ["b"], "b": ["c"], "c": ["a", "d"], "d": ["b"],
             "e": []}
    assert tengine.find_cycles(graph) == jengine.find_cycles(graph)
    assert tengine.find_cycles(graph)


# ---------------- graftsync ---------------------------------------------

JAX_HOST = ["commefficient_tpu/" + p for p in
            ("telemetry", "utils", "federated", "parallel", "training",
             "scheduler", "control")]


@pytest.mark.parametrize("tree", ["port", "jax"])
def test_sync_parity_per_file(at_repo, tree):
    paths = tsync.DEFAULT_PATHS if tree == "port" else JAX_HOST
    edges = (tdomains.ORDERING_EDGES if tree == "port"
             else jsync.ORDERING_EDGES)
    n = 0
    for path in tengine.iter_python_files(paths):
        with open(path, encoding="utf-8") as f:
            src = f.read()
        rel = os.path.relpath(path).replace(os.sep, "/")
        port = tsync.sync_source(rel, src, edges)
        jax = jsync.sync_source(rel, src, edges)
        assert _keys(port) == _keys(jax), rel
        files = {rel: (src, ast.parse(src))}
        assert _keys(tsync.ordering_findings(files, edges)) == _keys(
            jsync.ordering_findings(files, edges)), rel
        n += 1
    assert n > 40


SY_SOURCES = {
    "SY001": ("import threading\nclass W:\n    def __init__(self):\n"
              "        self._x = []\n"
              "        self._t = threading.Thread(target=self._run, "
              "name='w')\n"
              "    def _run(self):\n        self._x.append(1)\n"
              "    def poke(self):\n        self._x.append(2)\n"
              "    def close(self):\n        self._t.join()\n"),
    "SY002": ("def f(a_lock, b_lock):\n    with a_lock:\n"
              "        with b_lock:\n            pass\n"
              "def g(a_lock, b_lock):\n    with b_lock:\n"
              "        with a_lock:\n            pass\n"),
    "SY003": ("def f(q):\n    rec = {}\n    q.put(rec)\n"
              "    rec['x'] = 1\n"),
    "SY004": ("import os\ndef f(lock, fd):\n    with lock:\n"
              "        os.fsync(fd)\n"),
    "SY005": ("import threading\n"
              "t = threading.Thread(target=print, name='t')\n"),
}


@pytest.mark.parametrize("code", sorted(SY_SOURCES))
def test_sync_rules_fire_in_both(code):
    src = SY_SOURCES[code]
    port = tsync.sync_source("pkg/a.py", src)
    assert {v.rule for v in port} == {code}, port
    assert _keys(port) == _keys(jsync.sync_source("pkg/a.py", src))
    line = port[0].line
    lines = src.splitlines()
    lines[line - 1] += f"  # graftsync: disable={code} -- test"
    quiet = "\n".join(lines) + "\n"
    assert not any(v.line == line for v in
                   tsync.sync_source("pkg/a.py", quiet))


def test_sync_device_sync_under_a_lock_is_blocking():
    # the port's device sync (.synchronize()) joins the JAX package's
    # block_until_ready in SY004's blocking set
    src = "def f(lock, ev):\n    with lock:\n        ev.synchronize()\n"
    assert [v.rule for v in tsync.sync_source("a.py", src)] == ["SY004"]


def test_port_audits_clean(at_repo, tmp_path, capsys):
    report, findings = tsync.run_sync_audit(tsync.DEFAULT_PATHS)
    assert findings == []
    assert report["registry"]["ordering_edges"] == 6
    assert report["registry"]["shared_state"] == 8
    assert report["files_scanned"] > 40
    assert report["digest"] == tsync.run_sync_audit(
        tsync.DEFAULT_PATHS)[0]["digest"]
    # and the JAX audit finds nothing either on the same files, with the
    # port's edges
    _, jfind = jsync.run_sync_audit(tsync.DEFAULT_PATHS)
    parsed = {}
    for path in tengine.iter_python_files(tsync.DEFAULT_PATHS):
        with open(path, encoding="utf-8") as f:
            src = f.read()
        parsed[os.path.relpath(path)] = (src, ast.parse(src))
    assert jsync.ordering_findings(parsed, tdomains.ORDERING_EDGES) == []
    assert [v for v in jfind if v.rule != "SY006"] == []
    # the CLI: clean, its digest journaled and accepted by the validator
    from commefficient_tpu_torch.telemetry.journal import validate_journal
    jpath = str(tmp_path / "j.jsonl")
    assert tsync.main(["--journal", jpath]) == 0
    assert capsys.readouterr().out.startswith("graftsync: clean")
    recs, problems = validate_journal(jpath)
    assert not problems
    assert recs[0]["event"] == "sync_audit_digest"
    assert recs[0]["digest"] == report["digest"]
    assert recs[0]["findings"] == 0
    assert tsync.main(["no/such/path"]) == 3


def _move_or_delete(src, edge, how):
    """The file's source with `edge`'s barrier (its `before` call's
    statement) deleted, or moved to the end of the function."""
    tree = ast.parse(src)
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef)
              and n.name == edge["function"])
    stmts = [s for s in ast.walk(fn) if isinstance(s, ast.stmt)
             and s is not fn and any(
                 isinstance(c, ast.Call)
                 and tsync._terminal(tsync._dotted(c.func)) ==
                 edge["before"] for c in ast.walk(s))]
    # the innermost statement holding the first barrier call
    first = min(stmts, key=lambda s: (s.lineno, -s.col_offset))
    inner = [s for s in stmts if s.lineno >= first.lineno
             and s.end_lineno <= first.end_lineno]
    stmt = max(inner, key=lambda s: s.col_offset)
    lines = src.splitlines()
    body = lines[stmt.lineno - 1:stmt.end_lineno]
    rest = lines[:stmt.lineno - 1] + lines[stmt.end_lineno:]
    if how == "moved":
        # the function's last line, shifted by the removed lines
        end = fn.end_lineno - len(body)
        ind = " " * fn.body[0].col_offset
        strip = len(body[0]) - len(body[0].lstrip())
        rest[end:end] = [ind + ln[strip:] for ln in body]
    return "\n".join(rest) + "\n"


@pytest.mark.parametrize("how", ["deleted", "moved"])
@pytest.mark.parametrize("name", sorted(tdomains.ORDERING_EDGES))
def test_each_edge_turns_red_without_its_barrier(name, how):
    edge = tdomains.ORDERING_EDGES[name]
    with open(os.path.join(REPO, edge["path"]), encoding="utf-8") as f:
        src = f.read()
    one = {name: edge}
    clean = {edge["path"]: (src, ast.parse(src))}
    assert tsync.ordering_findings(clean, one) == []
    broken = _move_or_delete(src, edge, how)
    files = {edge["path"]: (broken, ast.parse(broken))}
    red = tsync.ordering_findings(files, one)
    assert [v.rule for v in red] == ["SY006"], red
    assert name in red[0].message
    assert _keys(red) == _keys(jsync.ordering_findings(files, one))


# ---------------- the runtime sanitizers ---------------------------------

def _abba(san_cls, lock_factory):
    san = san_cls()
    with san:
        a, b = lock_factory(), lock_factory()

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    pass

        for target in (ab, ba):   # one after the other: no real deadlock
            t = threading.Thread(target=target, name=target.__name__)
            t.start()
            t.join()
    return san


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_abba_raises_lock_order_error(pkg):
    if pkg == "jax":
        from commefficient_tpu.analysis import runtime as rt
    else:
        rt = truntime
    san = _abba(rt.LockOrderSanitizer, lambda: threading.Lock())
    assert san.find_cycle() is not None
    with pytest.raises(rt.LockOrderError, match="lock-order cycle"):
        san.assert_acyclic()
    assert threading.Lock is not None and not isinstance(
        threading.Lock(), rt._SanitizedLock)


def test_rlock_reentry_adds_no_edge_and_conditions_work():
    with truntime.LockOrderSanitizer() as san:
        r = threading.RLock()
        with r:
            with r:
                pass
        q = queue.Queue(maxsize=1)

        def drain():
            q.get()
            q.task_done()

        t = threading.Thread(target=drain, name="drain")
        t.start()
        q.put(1)
        q.join()
        t.join()
    assert san.edges() == {}
    assert san.locks >= 2
    san.assert_acyclic()


def test_interleaving_stress_restores_queue():
    put, get = queue.Queue.put, queue.Queue.get
    with truntime.interleaving_stress(delay=0.0001):
        assert queue.Queue.put is not put
        q = queue.Queue()
        for i in range(5):
            q.put(i)
        assert [q.get() for _ in range(5)] == list(range(5))
    assert (queue.Queue.put, queue.Queue.get) == (put, get)
    with pytest.raises(RuntimeError):
        with truntime.interleaving_stress():
            raise RuntimeError("boom")
    assert (queue.Queue.put, queue.Queue.get) == (put, get)


def test_numeric_sanitizer_guards_named():
    from commefficient_tpu_torch.telemetry import metrics as tmetrics
    orig = tmetrics.named
    vec = np.zeros(len(tmetrics.METRIC_NAMES), np.float32)
    with truntime.NumericSanitizer() as san:
        assert tmetrics.named(vec)["train_loss"] == 0.0
        assert tmetrics.named(None) == {}
        vec[1] = np.nan
        with pytest.raises(truntime.NumericError,
                           match=tmetrics.METRIC_NAMES[1]):
            tmetrics.named(vec)
    assert san.checked == 3
    assert tmetrics.named is orig


def test_assert_finite_and_replay_drill():
    N = truntime.NumericSanitizer
    N.assert_finite({"a": torch.ones(2, dtype=torch.bfloat16),
                     "b": [np.arange(3), (1.0, None)]})
    with pytest.raises(truntime.NumericError, match="1/3"):
        N.assert_finite([torch.tensor([1.0, float("inf"), 0.0])])
    x = torch.arange(4.0)
    out = N.replay_drill(lambda t: {"y": t * 2, "z": [t.sum()]}, x)
    assert torch.equal(out["y"], x * 2)
    # a deterministic NaN replays clean
    N.replay_drill(lambda: torch.tensor([float("nan")]))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(truntime.NumericError, match="replay divergence"):
        N.replay_drill(lambda: torch.rand(3, generator=gen))


# ---------------- the threaded paths under the sanitizers ----------------

CV = ["--test", "--device", "cpu", "--num_workers", "4",
      "--num_epochs", "0.5"]
THREADED = {
    "pipelined_spans": ["--mode", "sketch", "--error_type", "virtual",
                        "--local_momentum", "0", "--scan_rounds",
                        "--scan_span", "2", "--pipeline",
                        "--checkpoint_every", "1", "--ckpt_every_spans",
                        "1", "--trace"],
    "tier_spill_restore": ["--mode", "local_topk", "--error_type",
                           "local", "--local_momentum", "0.9",
                           "--state_tier", "host", "--state_working_set",
                           "8", "--num_clients", "20", "--scan_rounds",
                           "--scan_span", "2", "--pipeline"],
    "emulated_plan_transport": ["--mode", "sketch", "--error_type",
                                "virtual", "--local_momentum", "0",
                                "--sampler", "throughput",
                                "--plan_transport", "emulated",
                                "--plan_controllers", "3"],
}


@pytest.mark.parametrize("label", sorted(THREADED))
def test_threaded_paths_stay_acyclic_under_the_sanitizers(
        tmp_path, monkeypatch, label):
    from commefficient_tpu_torch.telemetry.journal import (
        summarize, validate_journal,
    )
    from commefficient_tpu_torch.training import cv_train
    monkeypatch.chdir(tmp_path)
    jpath = str(tmp_path / "j.jsonl")
    argv = CV + THREADED[label] + [
        "--dataset_dir", str(tmp_path / "ds"), "--journal_path", jpath,
        "--checkpoint_path", str(tmp_path / "ck")]
    locks = truntime.LockOrderSanitizer()
    with locks, truntime.interleaving_stress(), \
            truntime.NumericSanitizer() as num:
        assert cv_train.main(argv)
    locks.assert_acyclic()
    assert locks.locks > 0
    recs, problems = validate_journal(jpath)
    assert not problems, problems
    rounds = summarize(recs)["rounds"]
    assert rounds > 0 and num.checked == rounds
    if label == "tier_spill_restore":
        tier = [r for r in recs if r["event"] == "state_tier"]
        assert sum(r["spills"] for r in tier) > 0
