"""Multi-controller (jax.distributed) demonstration test.

Two separate controller processes on localhost (CPU backend), channels
sharded across them, psum'd counters crossing the process boundary —
the N>=2-host code path (SURVEY.md section 5.8; BASELINE scale target).
The tool spawns the workers itself; this test drives it end to end at
small sizes and asserts the distributed run is bit-identical to the
single-process one.  The workers force the CPU platform: several JAX
processes must not share one GPU.
"""

import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_two_controller_processes_match_single_process(tmp_path):
    out = tmp_path / "MULTIHOST.json"
    r = subprocess.run(
        [sys.executable, str(REPO / "tools" / "multihost_demo.py"),
         "--channels", "32", "--frames", "4", "--points", "4",
         "--port", "47321",
         "--scratch", str(tmp_path / "mh"), "--out", str(out)],
        cwd=str(REPO), capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    doc = json.loads(out.read_text())
    assert doc["processes"] == 2
    assert doc["global_devices"] == 8
    assert doc["processes_agree"]
    assert doc["distributed_equals_single_process"]
    assert doc["totals_equal_single_process"]
    assert doc["ok"]
