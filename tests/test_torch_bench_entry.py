"""The port's bench entry (vulkan_renderer_tpu_torch/bench.py), the
counterpart of the JAX package's bench.py, on the CPU.

- Run as `python -m vulkan_renderer_tpu_torch.bench --device cpu` on a
  tiny city (make_city(20, detail=3), 64x32), it exits 0 and its last
  line is bench.py's record (bench.py's keys and `card`, and
  `host_contended` where the host was loaded), reading
  `uncertain=0, overflow=0`, with the options it was given.
- Its frame (tools/bench_frame.py: bench.py's city, four street lights,
  camera and settings) equals the JAX package's render of the same .vks,
  lights, camera and settings (traversal="bruteforce") at the
  whole-frame tests' tolerance: mean |sRGB difference| <= 1e-3, >= 99%
  of pixels within 1e-2.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_shading_inputs import to_port
from vulkan_renderer_tpu.core.settings import (PolygonSamplingTechnique,
                                               RenderSettings,
                                               SamplingStrategy)
from vulkan_renderer_tpu.render.pipeline import render_frame as j_render
from vulkan_renderer_tpu.render.shading import SceneStatic as JSceneStatic
from vulkan_renderer_tpu.scene.camera import FirstPersonCamera as JCamera
from vulkan_renderer_tpu.scene.lights import PolygonalLightSpec as JLight
from vulkan_renderer_tpu.scene.scene import load_scene as j_load_scene
from vulkan_renderer_tpu_torch.tools import bench_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT = 64, 32
# bench.py's record (bench.py:270-289), and the card beside it.
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "loadavg",
               "pipelined_reps_ms", "sync_latency_ms", "card"}


def jax_bench_settings():
    """bench.py's RenderSettings at its defaults."""
    return RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_SPECULAR_MIS,
        polygon_sampling_technique=(
            PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE),
        sample_count=1, trace_shadow_rays=True)


@pytest.mark.parametrize("extra, stem", [
    ([], "city_20x3"),
    (["--no-shadows", "--materials", "3", "--cluster-size", "16",
      "--spp", "2", "--stop-after", "shade"], "city_20x3_m3")])
def test_entry_prints_benchs_record(tmp_path, extra, stem):
    data = str(tmp_path / "data")
    run = subprocess.run(
        [sys.executable, "-m", "vulkan_renderer_tpu_torch.bench",
         "--device", "cpu", "--width", str(WIDTH), "--height", str(HEIGHT),
         "--buildings", "20", "--detail", "3", "--frames", "2",
         "--pipelined-reps", "1", "--data", data] + extra,
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-2000:]
    record = json.loads(run.stdout.strip().splitlines()[-1])
    # bench.py adds host_contended where every pipelined run read over
    # 1.2x the sync latency, as a loaded host (the test workers) can make
    # it; its metric then says so.
    assert set(record) - {"host_contended"} == RECORD_KEYS
    if "host_contended" in record:
        assert record["host_contended"] is True
        assert "CONTENDED host" in record["metric"]
    assert record["card"] == "cpu" and record["unit"] == "ms"
    metric = record["metric"]
    assert "uncertain=0, overflow=0" in metric
    assert f"{WIDTH}x{HEIGHT}" in metric
    shadows = "--no-shadows" not in extra
    assert f"shadows={shadows}" in metric
    assert ("stop_after=shade" in metric) == ("--stop-after" in extra)
    assert os.path.exists(os.path.join(data, f"{stem}.vks"))
    assert len(record["pipelined_reps_ms"]) == 1
    value = record["value"]
    assert value > 0 and np.isclose(
        record["vs_baseline"], value * 1920 * 1080 / (WIDTH * HEIGHT) / 20.0,
        rtol=1e-3)


def test_settings_are_benchs():
    """The port's bench settings are bench.py's, with --spp and
    --no-shadows reaching them."""
    assert bench_frame.settings() == to_port(jax_bench_settings())
    s = bench_frame.settings(spp=4, shadows=False)
    assert s.sample_count == 4 and not s.trace_shadow_rays


def test_bench_frame_matches_jax(tmp_path):
    d = str(tmp_path)
    vks, textures = bench_frame.city_files(d, buildings=20, detail=3)
    jlights = [JLight(translation=l.translation,
                      rotation_angles=l.rotation_angles,
                      scaling_x=l.scaling_x, scaling_y=l.scaling_y,
                      radiant_flux=l.radiant_flux)
               for l in bench_frame.lights()]
    jscene = j_load_scene(vks, textures, jlights, data_directory=d)
    camera = JCamera(
        position_world_space=np.array([0.0, 0.0, 2.0], np.float32),
        rotation_x=0.55 * np.pi, rotation_z=0.5 * np.pi)
    port_camera = bench_frame.camera()
    for field in ("position_world_space", "rotation_x", "rotation_z",
                  "vertical_fov", "near", "far"):
        np.testing.assert_array_equal(getattr(port_camera, field),
                                      getattr(camera, field))
    want = np.asarray(j_render(
        jscene, JSceneStatic(light_count=4, light_texturing=(0,) * 4,
                             traversal="bruteforce"),
        camera, jax_bench_settings(), WIDTH, HEIGHT,
        bench_frame.noise_numbers()))
    scene, static = bench_frame.load_city(d, "cpu", buildings=20, detail=3)
    got = bench_frame.render(scene, static, bench_frame.settings(),
                             width=WIDTH, height=HEIGHT).numpy()
    assert got.shape == want.shape == (HEIGHT, WIDTH, 3)
    assert np.isfinite(got).all() and got.mean() > 0.01
    diff = np.abs(got - want)
    assert diff.mean() <= 1e-3, diff.mean()
    assert (diff.max(axis=-1) <= 1e-2).mean() >= 0.99
