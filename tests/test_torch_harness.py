"""The port's experiment harness, scene setups, Application and noise-type
wiring against the JAX package: the same experiment at every index, the
same roughness-planes files byte for byte, the same timing layouts, a
timing experiment run end to end on the CPU, and settings.noise_type
reaching the frame (a white-noise frame differs from an Ahmed one and each
matches the JAX frame rendered with the same noise, at PR 1's frame
tolerance: mean |sRGB difference| <= 1e-3, >= 99% of pixels within
1e-2)."""

import csv
import dataclasses
import filecmp
import os

import numpy as np
import pytest

from _torch_shading_inputs import to_jax, to_port
from vulkan_renderer_tpu.assets.noise import (INITIAL_RANDOM_SEED as
                                              J_SEED, NoiseType,
                                              advance_noise_random_numbers as
                                              j_advance)
from vulkan_renderer_tpu.core.settings import (PolygonSamplingTechnique,
                                               RenderSettings,
                                               SamplingStrategy)
from vulkan_renderer_tpu.experiments import harness as j_harness
from vulkan_renderer_tpu.experiments import setups as j_setups
from vulkan_renderer_tpu.render.pipeline import render_frame as j_render
from vulkan_renderer_tpu.render.shading import SceneStatic as JSceneStatic
from vulkan_renderer_tpu.scene.scene import load_scene as j_load_scene
from vulkan_renderer_tpu.tools import export_scene as j_export
from vulkan_renderer_tpu_torch.assets import noise as t_noise
from vulkan_renderer_tpu_torch.core.app import (Application,
                                                SceneSpecification)
from vulkan_renderer_tpu_torch.experiments import harness, setups
from vulkan_renderer_tpu_torch.render.screenshot import read_hdr
from vulkan_renderer_tpu_torch.tools import export_scene


def test_experiment_lists_agree():
    """-e N means the same experiment in both packages."""
    ours = harness.create_experiment_list()
    ref = j_harness.create_experiment_list()
    assert len(ours) == len(ref) == 328
    for i, (a, b) in enumerate(zip(ours, ref)):
        # Each package has its own settings class: compare field values.
        assert dataclasses.asdict(dataclasses.replace(
            a, settings=to_jax(a.settings))) == dataclasses.asdict(b), i
    sweep = [i for i, e in enumerate(ours)
             if "timings_" in e.screenshot_path]
    assert sweep == list(range(50, 310))


def test_roughness_planes_files_match_reference_bytes(tmp_path):
    a, b = tmp_path / "port", tmp_path / "jax"
    export_scene.write_test_scene(str(a), "roughness_planes",
                                  texture_resolution=8)
    j_export.write_test_scene(str(b), "roughness_planes",
                              texture_resolution=8)
    names = []
    for root, _, files in os.walk(a):
        for f in files:
            p = os.path.join(root, f)
            assert filecmp.cmp(p, os.path.join(b, os.path.relpath(p, a)),
                               shallow=False), f
            names.append(f)
    assert len(names) == 1 + 5 * 3
    with pytest.raises(ValueError):
        export_scene.write_test_scene(str(a), "attic")


@pytest.mark.parametrize("layout", ["timing:3:central:128",
                                    "timing:7:decentral:1", "heptagon",
                                    "small_light", "default"])
def test_layouts_match_reference(layout):
    exp = j_harness.Experiment(1, 1, "arcade", RenderSettings(), "x",
                               light_layout=layout)
    ours = setups.experiment_lights(harness.Experiment(
        1, 1, "arcade", to_port(RenderSettings()), "x", light_layout=layout))
    ref = j_setups.experiment_lights(exp)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                          np.asarray(getattr(b, f.name)))


def test_unported_experiments_are_named(tmp_path, capsys):
    """No experiment is left unported: the --hdr experiments (6, 46, 315,
    324; the reference's HDR switch) are in the list, and
    `-e 6 --hdr --device cpu` writes a Radiance .hdr that reads back as the
    measured frame within RGBE quantization (a pixel's channels truncated
    to 8 bits below its largest channel's power of two)."""
    exps = harness.create_experiment_list(take_hdr_screenshots=True)
    for i in (6, 46, 315, 324):
        assert exps[i].hdr and exps[i].screenshot_path.endswith(".hdr")
    frames = []

    def build(exp):
        app = setups.build_default_application(
            exp, str(tmp_path / "data"), device="cpu")
        render_sync = app.render_frame_sync

        def keep():
            frames.append(render_sync())
            return frames[-1]
        app.render_frame_sync = keep
        return app

    exp = dataclasses.replace(
        exps[6], width=32, height=16,
        screenshot_path=str(tmp_path / "run" / "error_%.3f.hdr"))
    result = harness.run_experiments(
        [exp], build, min_warmup_seconds=0.0, min_warmup_frames=1,
        measure_frames=2, data_directory=str(tmp_path / "data"),
        device="cpu")[0]
    assert result.screenshot_path.endswith("_standin_cpu.hdr")
    frame = frames[-1].numpy()
    hdr = read_hdr(result.screenshot_path)
    assert hdr.shape == frame.shape == (16, 32, 3)
    _, exponent = np.frexp(frame.max(axis=-1, keepdims=True))
    assert np.all(np.abs(hdr - frame) <= np.ldexp(1.0, exponent - 8))
    assert float(hdr.mean()) > 0.0

    rc = harness.main(["-e", "6", "--hdr", "--device", "cpu", "--width",
                       "32", "--height", "16", "--warmup-frames", "1",
                       "--measure-frames", "2",
                       "--output-dir", str(tmp_path / "out"),
                       "--data-directory", str(tmp_path / "data"),
                       "--results-csv", str(tmp_path / "r.csv")])
    assert rc == 0 and "006: " in capsys.readouterr().out
    (shot,) = os.listdir(tmp_path / "out")
    assert shot.endswith("_standin_cpu.hdr")
    image = read_hdr(str(tmp_path / "out" / shot))
    assert image.shape == (16, 32, 3) and np.isfinite(image).all()


def test_ies_and_linear_layouts_match_reference(tmp_path):
    """The IES-profile light (its stand-in profile texture byte for byte)
    and the linear-light layout of the HPG figures."""
    exp = j_harness.Experiment(1, 1, "attic", RenderSettings(), "x",
                               light_layout="ies_profile")
    port_exp = harness.Experiment(1, 1, "attic", to_port(RenderSettings()),
                                  "x", light_layout="ies_profile")
    (tmp_path / "jax").mkdir()
    ours = setups.experiment_lights(port_exp, str(tmp_path / "port"))
    ref = j_setups.experiment_lights(exp, str(tmp_path / "jax"))
    assert len(ours) == len(ref) == 1
    assert filecmp.cmp(ours[0].texture_file_path, ref[0].texture_file_path,
                       shallow=False)
    for f in dataclasses.fields(ours[0]):
        if f.name != "texture_file_path":
            np.testing.assert_array_equal(np.asarray(getattr(ours[0],
                                                             f.name)),
                                          np.asarray(getattr(ref[0],
                                                             f.name)))
    linear = dataclasses.replace(exp, light_layout="linear")
    port_linear = dataclasses.replace(port_exp, light_layout="linear")
    assert setups.experiment_lights(port_linear) == []
    ours = setups.experiment_linear_lights(port_linear)
    ref = j_setups.experiment_linear_lights(linear)
    assert len(ours) == len(ref) == 1
    for f in dataclasses.fields(ours[0]):
        np.testing.assert_array_equal(getattr(ours[0], f.name),
                                      getattr(ref[0], f.name))


def test_every_experiment_passes_check(tmp_path):
    """All 328 experiments render: K4/K5 where fused_supported holds, the
    per-pixel path for the rest (error displays 6-8, the IES light 46,
    GGX MIS 315, the linear lights 324-327 among them)."""
    from vulkan_renderer_tpu_torch.render.fused import fused_supported
    from vulkan_renderer_tpu_torch.render.shading import SceneStatic
    exps = harness.create_experiment_list()
    assert len(exps) == 328
    per_pixel = []
    for i, e in enumerate(exps):
        lights = setups.experiment_lights(e, str(tmp_path))
        static = SceneStatic(
            light_count=len(lights),
            light_texturing=tuple(s.texturing_technique for s in lights),
            light_vertex_counts=tuple(s.vertex_count for s in lights),
            linear_light_count=len(setups.experiment_linear_lights(e)))
        if not fused_supported(static, e.settings):
            per_pixel.append(i)
    assert per_pixel == [6, 7, 8, 46, 315, 324, 325, 326, 327]


@pytest.mark.parametrize("index", [6, 46, 315, 324])
def test_per_pixel_experiment_runs_on_cpu(tmp_path, index):
    """An error display, the IES light, GGX MIS and a linear light through
    the CLI at 32x16."""
    rc = harness.main([
        "-e", str(index), "--device", "cpu", "--width", "32", "--height",
        "16", "--warmup-frames", "1", "--measure-frames", "2",
        "--output-dir", str(tmp_path / "out"),
        "--data-directory", str(tmp_path / "data"),
        "--results-csv", str(tmp_path / "r.csv")])
    assert rc == 0
    assert len(os.listdir(tmp_path / "out")) == 1


def test_timing_experiment_runs_on_cpu(tmp_path):
    """Experiment 193 (decentral pentagon, 1 light at 128 spp, baseline)
    through the CLI at 32x16 with 2 warm-up and 2 measured frames."""
    csv_path = tmp_path / "results.csv"
    rc = harness.main([
        "-e", "193", "--device", "cpu", "--width", "32", "--height", "16",
        "--warmup-frames", "2", "--measure-frames", "2",
        "--output-dir", str(tmp_path / "out"),
        "--data-directory", str(tmp_path / "data"),
        "--results-csv", str(csv_path)])
    assert rc == 0
    shots = os.listdir(tmp_path / "out")
    assert len(shots) == 1 and shots[0].startswith(
        "roughness_planes_timings_decentral_5_baseline_")
    assert shots[0].endswith("_standin_cpu.png")
    assert os.path.exists(tmp_path / "data" / "roughness_planes.vks.standin")
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    row = rows[0]
    assert (row["index"], row["backend"], row["device"], row["spp"]) == \
        ("193", "cpu", "cpu", "128")
    assert float(row["frame_ms"]) > 0 and row["stand_in"] == "1"


def test_unknown_noise_type_takes_white(tmp_path):
    got = t_noise.noise_table_for_settings("no_such_noise", str(tmp_path))
    assert got.noise_type == "white"
    np.testing.assert_array_equal(got.table,
                                  t_noise.white_noise_table().table)


@pytest.fixture(scope="module")
def planes_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("noise_planes"))
    export_scene.write_test_scene(d, "roughness_planes",
                                  texture_resolution=16)
    return d


def _app_frame(planes_dir, noise_type):
    settings = RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
        polygon_sampling_technique=PolygonSamplingTechnique.SOLID_ANGLE,
        trace_shadow_rays=False, noise_type=noise_type)
    spec = SceneSpecification(
        "roughness_planes", planes_dir + "/roughness_planes.vks",
        planes_dir + "/roughness_planes_textures",
        camera=setups._scene_default_camera("roughness_planes"),
        lights=setups.timing_lights(4, True, 2))
    app = Application(spec, to_port(settings), width=64, height=32,
                      data_directory=planes_dir, device="cpu")
    return app, app.render_frame_sync().numpy()


def _jax_frame(planes_dir, app, noise):
    jscene = j_load_scene(planes_dir + "/roughness_planes.vks",
                          planes_dir + "/roughness_planes_textures",
                          to_jax(app.scene_spec.lights), noise_type=noise,
                          data_directory=planes_dir)
    _, randoms = j_advance(J_SEED, True)
    return np.asarray(j_render(
        jscene, JSceneStatic(light_count=2, light_texturing=(0, 0),
                             traversal="bruteforce"),
        to_jax(app.scene_spec.camera), to_jax(app.settings), 64, 32,
        randoms))


def test_noise_type_reaches_the_frame(planes_dir):
    frames = {}
    for name, noise in (("white", NoiseType.WHITE),
                        ("ahmed_2d", NoiseType.AHMED)):
        app, got = _app_frame(planes_dir, name)
        assert app.scene.noise_texture_index_mask == 63
        want = _jax_frame(planes_dir, app, noise)
        diff = np.abs(got - want)
        assert diff.mean() <= 1e-3, (name, diff.mean())
        assert (diff.max(axis=-1) <= 1e-2).mean() >= 0.99, name
        frames[name] = got
    assert np.abs(frames["white"] - frames["ahmed_2d"]).mean() > 1e-3


def test_generated_stand_in_stays_tagged(tmp_path):
    """A scene whose stand-in is another scene's generator output (the
    attic takes the cornell box) leaves that file tagged too, so the
    cornell box resolved later still reports stand_in."""
    from vulkan_renderer_tpu_torch.experiments.registry import resolve_scene
    assert resolve_scene("attic", str(tmp_path)).stand_in
    assert resolve_scene("cornell_box", str(tmp_path)).stand_in
