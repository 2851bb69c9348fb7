"""The benchmark's frozen copies write what the port's own generators
write (vulkan_renderer_tpu_torch at the commit they were copied from), at
a small size: scenes byte for byte, noise tables, light layouts, cameras,
and the profiler's interval arithmetic."""

import os
import types

import numpy as np
import pytest

import inputs
import timing


def files_under(directory):
    out = {}
    for base, _, names in os.walk(directory):
        for name in names:
            with open(os.path.join(base, name), "rb") as f:
                out[os.path.relpath(os.path.join(base, name), directory)] = \
                    f.read()
    return out


def test_city_scene(tmp_path):
    from vulkan_renderer_tpu_torch.tools.city import write_city_scene
    port_vks = write_city_scene(str(tmp_path / "port"), "city",
                                n_buildings=20, detail=3, n_materials=6)
    scene = {"generator": "city", "n_buildings": 20, "detail": 3, "seed": 7,
             "n_materials": 6, "texture_resolution": 64}
    vks, textures = inputs.write_scene(scene, str(tmp_path / "bench"))
    with open(port_vks, "rb") as a, open(vks, "rb") as b:
        assert a.read() == b.read()
    assert files_under(textures) == files_under(
        str(tmp_path / "port" / "city_textures"))


def test_planes_scene(tmp_path):
    from vulkan_renderer_tpu_torch.tools.export_scene import write_test_scene
    port_vks = write_test_scene(str(tmp_path / "port"), "roughness_planes")
    scene = inputs.read_json("configs", "timing_sweep.json")["scene"]
    vks, textures = inputs.write_scene(scene, str(tmp_path / "bench"))
    with open(port_vks, "rb") as a, open(vks, "rb") as b:
        assert a.read() == b.read()
    assert files_under(textures) == files_under(
        str(tmp_path / "port" / "roughness_planes_textures"))


def test_noise_table(tmp_path):
    from frozen.tools import generate_noise as frozen
    from vulkan_renderer_tpu_torch.assets.noise import load_noise_table
    from vulkan_renderer_tpu_torch.tools import generate_noise as port
    assert np.array_equal(frozen.ahmed_blob(64, 64, 16),
                          port.ahmed_blob(64, 64, 16))
    assert np.array_equal(frozen.sobol_family_blob("owen_2d", 64, 64, 16),
                          port.sobol_family_blob("owen_2d", 64, 64, 16))
    # The port's loader finds the benchmark's table under its first name.
    path = inputs.write_noise("ahmed_2d", str(tmp_path))
    table = load_noise_table("ahmed_2d", str(tmp_path))
    assert np.array_equal(table.table, np.fromfile(path, np.uint16).reshape(
        table.table.shape))


@pytest.mark.parametrize("vertex_count,central,count",
                         [(7, True, 128), (7, True, 1), (3, False, 128)])
def test_timing_lights(vertex_count, central, count):
    from vulkan_renderer_tpu_torch.experiments.setups import timing_lights
    port = timing_lights(vertex_count, central, count)
    bench = inputs.load_module("layouts", "timing").lights(
        vertex_count, central, count)
    assert len(port) == len(bench)
    for p, b in zip(port, bench):
        for key, value in b.items():
            assert np.array_equal(np.asarray(getattr(p, key)),
                                  np.asarray(value)), key


def test_street_lights_and_cameras():
    from vulkan_renderer_tpu_torch.experiments.setups import \
        _scene_default_camera
    from vulkan_renderer_tpu_torch.tools import bench_frame
    traffic = inputs.read_json("traffic", "city_shadows.json")
    for p, b in zip(bench_frame.lights(), inputs.lights(traffic)):
        for key, value in b.items():
            assert np.array_equal(np.asarray(getattr(p, key)),
                                  np.asarray(value)), key
    for config, port in (("city_bench", bench_frame.camera()),
                         ("timing_sweep",
                          _scene_default_camera("roughness_planes"))):
        bench = inputs.camera(inputs.read_json("configs", f"{config}.json"))
        for key, value in bench.items():
            assert np.allclose(np.asarray(getattr(port, key)),
                               np.asarray(value), rtol=0, atol=1e-12), key


def test_busy_time_is_profile_frames_arithmetic():
    from torch.autograd import DeviceType

    from vulkan_renderer_tpu_torch.tools.profile_frame import summarize
    spans = [(0.0, 100.0), (50.0, 300.0), (400.0, 450.0), (420.0, 430.0),
             (900.0, 1000.0)]
    events = [types.SimpleNamespace(
        device_type=DeviceType.CUDA,
        time_range=types.SimpleNamespace(start=lo, end=hi))
        for lo, hi in spans]
    prof = types.SimpleNamespace(events=lambda: events,
                                 key_averages=lambda: [])
    summary = summarize(prof, window_ms=2.0, frames=1)
    assert summary["device_busy_ms_per_frame"] == pytest.approx(
        timing.busy_time(spans) / 1e3)
