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


@pytest.mark.parametrize("name,noise,mask", [
    ("blue_noise", NoiseType.BLUE, 3), ("dithered_2d",
                                        NoiseType.BLUE_NOISE_DITHERED, 0)])
def test_blue_noise_and_dithered_tables_reach_the_frame(planes_dir, name,
                                                        noise, mask):
    """The packaged 64x64x4 blue-noise table (layer mask 3) and a 128x128x1
    dithered table (mask 0, seeded u16 values in the data directory: the
    frame holds the table's shape and mask, not the generator) reach the
    frame as in the JAX package, at test_noise_type_reaches_the_frame's
    tolerance."""
    if name == "dithered_2d":
        path = os.path.join(planes_dir, "noise",
                            "dithered_2d_rgba_128x128_01.blob")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.random.default_rng(17).integers(
            0, 65536, 128 * 128 * 4, dtype=np.uint16).tofile(path)
    app, got = _app_frame(planes_dir, name)
    assert app.scene.noise_texture_index_mask == mask
    assert tuple(app.scene.noise_table.shape) == (
        (4, 64, 64, 4) if mask else (1, 128, 128, 4))
    want = _jax_frame(planes_dir, app, noise)
    diff = np.abs(got - want)
    assert diff.mean() <= 1e-3, (name, diff.mean())
    assert (diff.max(axis=-1) <= 1e-2).mean() >= 0.99, name
    white = _app_frame(planes_dir, "white")[1]
    assert np.abs(got - white).mean() > 1e-3


def test_generated_stand_in_stays_tagged(tmp_path):
    """A scene whose stand-in is another scene's generator output (the
    attic takes the cornell box) leaves that file tagged too, so the
    cornell box resolved later still reports stand_in."""
    from vulkan_renderer_tpu_torch.experiments.registry import resolve_scene
    assert resolve_scene("attic", str(tmp_path)).stand_in
    assert resolve_scene("cornell_box", str(tmp_path)).stand_in


# --- the timing gate: _timing_cell, _cell_band and main's re-measurement
# (the JAX harness's, with the card as part of a cell) ----------------------

def test_timing_cell_matches_reference():
    ours = harness.create_experiment_list()
    ref = j_harness.create_experiment_list()
    cells = [harness._timing_cell(e.screenshot_path) for e in ours]
    assert cells == [j_harness._timing_cell(e.screenshot_path)
                     for e in ref]
    assert [i for i, c in enumerate(cells) if c] == list(range(50, 310))
    assert len(set(c for c in cells if c)) == 20


def _sweep_rows(seed, card, count=150):
    """Seeded CSV rows of timing-sweep experiments measured on `card`:
    random indices, ms and sizes (the sweep's own or a scaled one)."""
    rng = np.random.default_rng(seed)
    experiments = harness.create_experiment_list()
    rows = []
    for i in rng.choice(np.arange(50, 310), count, replace=False):
        e = experiments[int(i)]
        width, height = (e.width, e.height) if rng.random() < 0.8 \
            else (960, 540)
        ms = float(rng.uniform(5.0, 90.0))
        s = e.settings
        rows.append([int(i), e.scene, s.polygon_sampling_technique.value,
                     s.sampling_strategy.value, s.sample_count, width,
                     height, f"{ms:.3f}", "cuda", card, 1, 0, 0,
                     e.screenshot_path % ms])
    return rows


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(harness.CSV_HEADER)
        writer.writerows(rows)


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_band_matches_reference(tmp_path, seed):
    """On a seeded CSV of one card the band equals the JAX package's for
    every experiment (None for the figures and for cells of fewer than 4
    rows)."""
    path = str(tmp_path / "r.csv")
    _write_csv(path, _sweep_rows(seed, "card A"))
    ours = harness.create_experiment_list()
    ref = j_harness.create_experiment_list()
    bands = [harness._cell_band(path, a, "card A") for a in ours]
    assert bands == [j_harness._cell_band(path, b) for b in ref]
    assert sum(b is not None for b in bands) > 100


def test_cell_band_leaves_out_other_cards(tmp_path):
    """Rows of another card are no siblings: the band of card A on a CSV
    that also holds card B's rows (10x slower) is the JAX band of card
    A's rows alone, and card B's band is of its own rows."""
    a_rows = _sweep_rows(2, "card A")
    b_rows = [row[:7] + [f"{10.0 * float(row[7]):.3f}"] + row[8:9]
              + ["card B"] + row[10:] for row in _sweep_rows(3, "card B")]
    both, only_a, only_b = (str(tmp_path / n) for n in ("ab", "a", "b"))
    _write_csv(both, a_rows + b_rows)
    _write_csv(only_a, a_rows)
    _write_csv(only_b, b_rows)
    ref = j_harness.create_experiment_list()
    for e, j in zip(harness.create_experiment_list(), ref):
        assert harness._cell_band(both, e, "card A") == \
            j_harness._cell_band(only_a, j)
        assert harness._cell_band(both, e, "card B") == \
            j_harness._cell_band(only_b, j)
        assert harness._cell_band(both, e, "card C") is None


def _stub_runs(monkeypatch, tmp_path, times):
    """Replace run_experiments by a stub whose i-th call measures times[i]
    ms and writes its screenshot; returns the screenshots written."""
    shots = []

    def run_experiments(experiments, build_application=None, **kwargs):
        e = experiments[0]
        ms = times[len(shots)]
        path = str(tmp_path / "out" / (os.path.basename(
            e.screenshot_path) % ms))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(b"frame")
        shots.append(path)
        return [harness.ExperimentResult(e, ms, path)]

    monkeypatch.setattr(harness, "run_experiments", run_experiments)
    return shots


@pytest.mark.parametrize("times, written, note", [
    ((12.0,), 12.0, None),
    ((35.0, 34.0), 34.0, "reproduced"),
    ((35.0, 10.5), 10.5, "outlier replaced"),
    ((3.0, 11.0), 11.0, "outlier replaced")])
def test_gate_measures_an_outlier_again(monkeypatch, tmp_path, capsys,
                                        times, written, note):
    """Four rows of experiment 106's cell on this card at 10 ms: a result
    within 3x of their median is written as it is; one further off is
    measured again after its screenshot is removed, and the re-run's
    result is written, whether it reproduced the first within 1.5x (kept)
    or not (replaced), as the JAX harness's main does."""
    csv_path = str(tmp_path / "r.csv")
    experiments = harness.create_experiment_list()
    siblings = []
    for i in (102, 103, 104, 105):
        e, s = experiments[i], experiments[i].settings
        siblings.append([i, e.scene, s.polygon_sampling_technique.value,
                         s.sampling_strategy.value, s.sample_count, 32, 16,
                         "10.000", "cpu", "cpu", 1, 0, 0,
                         e.screenshot_path % 10.0])
    _write_csv(csv_path, siblings)
    shots = _stub_runs(monkeypatch, tmp_path, times)
    assert harness.main(["-e", "106", "--device", "cpu", "--width", "32",
                         "--height", "16", "--results-csv", csv_path]) == 0
    assert len(shots) == len(times)
    out = capsys.readouterr().out
    if note is None:
        assert "re-measur" not in out
    else:
        assert f"({note})" in out
        assert not os.path.exists(shots[0])
    assert os.path.exists(shots[-1])
    with open(csv_path, newline="") as f:
        rows = {r["index"]: r for r in csv.DictReader(f)}
    assert float(rows["106"]["frame_ms"]) == written
    assert rows["106"]["screenshot"] == shots[-1]
