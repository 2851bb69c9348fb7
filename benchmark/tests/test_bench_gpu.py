"""One short run of every cell on the card, through the benchmark's
command (`python -m pytest benchmark/tests -m gpu` on the GPU)."""

import json
import os
import subprocess
import sys

import pytest

import inputs

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      inputs.manifest()["workloads"]])
def test_a_short_run_is_correct(gpu, workload):
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         workload, "--seed", str(2**31 + 9), "--seconds", "2", "--trace",
         "1"], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert list(result)[-1] == "check"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
