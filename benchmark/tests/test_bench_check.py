"""The check that decides `correct`, driven on the CPU at a small size:
the harness's run with its look for a chip skipped (the port takes its
kernels' plain versions on CPU tensors), through the same window, sample
and reference as on the card.

- A sound run comes out correct.
- The control, the reference in bfloat16 put in the program's place,
  comes out above a limit in every cell (the chip run of the control at
  the cells' own sizes is in PERF.md).
- Each fault a cell can have, planted in the port underneath, comes out
  not correct: a frame loop that returns its first frame again (its state
  unchanged), half of each frame's pixels left out, and the shading
  kernel's answer altered by 2% where it is produced. A cell runs on one
  card, so there is no exchange between cards to leave out.
- Without a card the measuring command exits non-zero and prints no
  result.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import harness
import inputs

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOADS = [w["name"] for w in inputs.manifest()["workloads"]]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_data"))


def tiny(workload):
    """The cell at a size the CPU renders in a second or two: a small city
    or at most 4 lights and 4 samples, 96x48 pixels."""
    entry, config, traffic = inputs.cell_files(workload)
    if config["scene"]["generator"] == "city":
        config["scene"].update(n_buildings=20, detail=3)
    config["resolution"] = [96, 48]
    lights = traffic["lights"]
    if lights["layout"] == "timing":
        lights["light_count"] = min(lights["light_count"], 4)
    traffic["settings"]["sample_count"] = min(
        traffic["settings"]["sample_count"], 4)
    traffic.update(warmup_frames=4)
    traffic["check"].update(frames=2, pixels=512)
    return entry, config, traffic


def run_tiny(workload, data_dir, monkeypatch, seconds=1.0):
    monkeypatch.setattr(inputs, "DATA_DIR", data_dir)
    torch.manual_seed(0)
    entry, config, traffic = tiny(workload)
    return harness.run(workload, entry, config, traffic, 2**31 + 77, seconds,
                       False, "cpu")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct(workload, data_dir, monkeypatch):
    result, lines = run_tiny(workload, data_dir, monkeypatch)
    assert result["correct"], lines
    assert list(result)[-1] == "check"
    assert result["attempted"] >= 1 and result["failed"] == 0
    # No peak device memory and no device stamps on the CPU: those readers
    # find nothing.
    assert {m["name"] for m in harness.cell_metrics(workload, False)} - \
        {"peak_mem_gib", "frame_device_p95_ms"} == set(result["metrics"])
    limits = inputs.read_json("checks", f"{workload}.json")["limits"]
    assert len(lines) == len(limits) and all("limit" in l for l in lines)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload, data_dir, monkeypatch):
    monkeypatch.setattr(inputs, "DATA_DIR", data_dir)
    entry, config, traffic = tiny(workload)
    limits = inputs.read_json("checks", f"{workload}.json")["limits"]
    fields = inputs.settings_fields(config, traffic)
    inputs.write_noise(fields["noise_type"])
    # The reference in the nearest lower precision, put in the program's
    # place (a frame of None).
    rows = harness.check_frames(workload, config, traffic,
                                [(3, None), (11, None)], 2**31 + 5, "cpu")
    assert any(row[name] > limit for row in rows
               for name, limit in limits.items()), rows


def stale_frames(monkeypatch):
    from vulkan_renderer_tpu_torch.core.app import Application
    first = {}
    original = Application.render_frame_async

    def stale(self):
        frame = original(self)
        if frame is not None:
            first.setdefault(id(self), frame)
            return first[id(self)]
        return frame
    monkeypatch.setattr(Application, "render_frame_async", stale)


def half_frames(monkeypatch):
    from vulkan_renderer_tpu_torch.core import app
    original = app.render_frame_constants

    def half(*args, **kwargs):
        image = original(*args, **kwargs)
        image[image.shape[0] // 2:] = 0.0
        return image
    monkeypatch.setattr(app, "render_frame_constants", half)


def altered_shading(monkeypatch):
    from vulkan_renderer_tpu_torch.render import fused
    k4, k5 = fused.fused_light_shading_plain, \
        fused.fused_light_shading_resolved_plain

    def k4_altered(*args, **kwargs):
        out = k4(*args, **kwargs).clone()
        out[0:3] *= 1.02
        slots = (out.shape[0] - 3) // 7
        out[3:].view(slots, 7, -1)[:, 0:3] *= 1.02
        return out

    def k5_altered(*args, **kwargs):
        return k5(*args, **kwargs) * 1.02
    monkeypatch.setattr(fused, "fused_light_shading_plain", k4_altered)
    monkeypatch.setattr(fused, "fused_light_shading_resolved_plain",
                        k5_altered)


@pytest.mark.parametrize("fault", [stale_frames, half_frames,
                                   altered_shading])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_fault_is_not_correct(workload, fault, data_dir, monkeypatch):
    fault(monkeypatch)
    result, lines = run_tiny(workload, data_dir, monkeypatch, seconds=2.0)
    assert not result["correct"], lines
    assert result["failed"] >= 1


def test_without_a_card_the_command_fails_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         WORKLOADS[0], "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_the_result_line_is_one_json_object(data_dir, monkeypatch):
    result, _ = run_tiny(WORKLOADS[-1], data_dir, monkeypatch)
    line = json.dumps(result)
    assert "\n" not in line
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(json.loads(line))
