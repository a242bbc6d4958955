"""The benchmark harness's own CPU tests (portbench/tests/), collected
here too: the repository's test run collects tests/ alone, and these
guard the harness that reads the port's spans and kernel regions. The
tests themselves stay in portbench/tests/, beside the harness."""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench.tests import (  # noqa: E402
    test_portbench_control, test_portbench_discovery, test_portbench_imports,
    test_portbench_reference, test_portbench_yardstick,
)

pytestmark = pytest.mark.torch_port

# one intra-op thread in each xdist worker (the harness tests' own
# fixture, which this module does not import)
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# tests of a process that has loaded no JAX, as the benchmark's have not:
# tests/conftest.py loads it into this one, so each runs in a fresh
# interpreter
NO_JAX = ("test_forbidden_names_are_compared_whole",)


def _in_a_fresh_process(mod, name):
    def test():
        code = (f"import sys; sys.path.insert(0, {REPO!r})\n"
                f"from {mod.__name__} import {name}\n{name}()\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
    test.__name__ = test.__qualname__ = name
    return test


for _mod in (test_portbench_control, test_portbench_discovery,
             test_portbench_imports, test_portbench_reference,
             test_portbench_yardstick):
    for _name, _obj in vars(_mod).items():
        if _name.startswith("test_") and callable(_obj):
            assert _name not in globals(), _name
            globals()[_name] = (_in_a_fresh_process(_mod, _name)
                                if _name in NO_JAX else _obj)
