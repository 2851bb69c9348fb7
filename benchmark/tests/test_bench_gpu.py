"""One short run of every cell on the card, through the benchmark's
command, and the device tail under host stalls (`python -m pytest
benchmark/tests -m gpu` on the GPU)."""

import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import pytest

import inputs

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Longer than the queue's slack: 3 frames in flight of the 1-light cell
# hold about 19 ms of device work.
STALL_S = 0.05


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


@pytest.mark.gpu
def test_the_device_tail_sees_host_stalls_that_starve_the_device(
        gpu, monkeypatch):
    """A host that sleeps past the queue's slack on every 10th frame leaves
    the device idle, and the frame after the sleep ends late on the device:
    the device tail rises 1.5x or more over the same window without sleeps,
    in which it lies within 2% of the median device interval."""
    import harness
    from vulkan_renderer_tpu_torch.core import app as app_module
    workload = "planes_central7_1light128spp_psa"
    records = []

    class Kept(harness.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            records.append(self)
    monkeypatch.setattr(harness, "Run", Kept)

    def window():
        entry, config, traffic = inputs.cell_files(workload)
        result, _ = harness.run(workload, entry, config, traffic,
                                2**31 + 11, 3.0, False, gpu)
        assert result["correct"], result["check"]
        return result["metrics"]["frame_device_p95_ms"]["value"]

    steady = window()
    assert steady <= 1.02 * statistics.median(records[-1].device_intervals)
    original = app_module.Application.render_frame_async
    calls = itertools.count(1)

    def stalled(self):
        if next(calls) % 10 == 0:
            time.sleep(STALL_S)
        return original(self)
    monkeypatch.setattr(app_module.Application, "render_frame_async",
                        stalled)
    starved = window()
    assert starved >= 1.5 * steady, (starved, steady)
