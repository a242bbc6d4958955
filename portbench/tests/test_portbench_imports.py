"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the plain reference imports nothing of the program."""
import ast
import os
import subprocess
import sys

from portbench.tests import tiny

DRY = '''
import sys, tempfile
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from portbench import harness, run
from portbench.tests import tiny
harness.set_cache_dirs(tempfile.mkdtemp())
cell = tiny.load(tempfile.mkdtemp())
r = harness.run(cell, 99, 0.3, True, "cpu")
run.result_line(r, True, {{"platform": "cpu"}})
assert r.correct, r.checks
print("LOADED", run.forbidden_modules(),
      sorted(m for m in sys.modules if m.startswith("commefficient_tpu")
             and m.split(".")[0] != "commefficient_tpu_torch"))
'''


def test_a_dry_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", DRY.format(root=tiny.ROOT)],
                         capture_output=True, text=True, timeout=600,
                         cwd=tiny.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED [] []" in out.stdout, out.stdout[-2000:]


def test_forbidden_names_are_compared_whole():
    from portbench import run
    saved = dict(sys.modules)
    try:
        sys.modules["commefficient_tpu_torch_x"] = sys
        sys.modules["jaxtyping"] = sys
        assert "jax" not in run.forbidden_modules()
        sys.modules["commefficient_tpu.ops"] = sys
        assert "commefficient_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(tiny.BENCH, "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top in ("numpy", "torch", "hashlib", "json", "math",
                               "typing", "contextlib", "__future__",
                               "portbench"), (f, m)
                assert not m.startswith("portbench.") or m.startswith(
                    "portbench.reference"), (f, m)
