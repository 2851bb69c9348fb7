"""The port's viewer (tools/viewer.py) against the JAX package's: the
reference's movement math (camera.c:86-131), key handling whose toggles
stay legal (core/settings.py legalize_settings against the JAX
package's), and the headless orbit rendering PNGs on the CPU without
matplotlib."""

import os
import sys

import numpy as np
import pytest

from _torch_shading_inputs import to_jax, to_port
from vulkan_renderer_tpu.core import settings as j_settings
from vulkan_renderer_tpu.tools import viewer as j_viewer
from vulkan_renderer_tpu_torch.core import settings as t_settings
from vulkan_renderer_tpu_torch.core.app import SceneSpecification
from vulkan_renderer_tpu_torch.core.settings import (RenderSettings,
                                                     legalize_settings,
                                                     settings_violations)
from vulkan_renderer_tpu_torch.experiments.harness import Experiment
from vulkan_renderer_tpu_torch.experiments.setups import \
    build_default_application
from vulkan_renderer_tpu_torch.scene.camera import FirstPersonCamera
from vulkan_renderer_tpu_torch.tools import viewer


@pytest.mark.parametrize("move", [
    dict(forward=2.0, right=1.0, vertical=0.5), dict(rotate_x=-4.0),
    dict(rotate_x=4.0), dict(rotate_z=0.7, forward=-1.0)])
def test_move_camera_matches_reference(move):
    cam = FirstPersonCamera(
        position_world_space=np.array([0.3, -1.0, 2.0], np.float32),
        rotation_x=0.5, rotation_z=0.3)
    got = viewer.move_camera(cam, **move)
    want = j_viewer.move_camera(to_jax(cam), **move)
    np.testing.assert_array_equal(got.position_world_space,
                                  want.position_world_space)
    assert (got.rotation_x, got.rotation_z) == (want.rotation_x,
                                                want.rotation_z)


class _FakeApp:
    """Settings and camera holder; no rendering."""

    def __init__(self, settings, camera):
        self.scene_spec = SceneSpecification(camera=camera)
        self.settings = settings
        self.width = self.height = 0


def test_viewer_keys_match_reference():
    """The same key presses give the same legal settings and cameras in
    both packages (the GUI-masking parity)."""
    cam = FirstPersonCamera(position_world_space=np.zeros(3, np.float32))
    ours = viewer.InteractiveViewer(_FakeApp(RenderSettings(), cam), 32, 32)
    ref = j_viewer.InteractiveViewer(
        _FakeApp(j_settings.RenderSettings(), to_jax(cam)), 32, 32)
    keys = ["t", "y", "u", "r", "T", "w", "left", "a", "up", "e"] * 6
    for key in keys + ["unmapped"]:
        assert ours.handle_key(key) == ref.handle_key(key)
        assert not settings_violations(ours.app.settings)
        assert ours.app.settings == to_port(ref.app.settings)
        c, r = ours.app.scene_spec.camera, ref.app.scene_spec.camera
        np.testing.assert_array_equal(c.position_world_space,
                                      r.position_world_space)
        assert (c.rotation_x, c.rotation_z) == (r.rotation_x, r.rotation_z)


def test_legalize_settings_matches_reference():
    for strategy in j_settings.SamplingStrategy:
        for tech in j_settings.PolygonSamplingTechnique:
            for heuristic in j_settings.MisHeuristic:
                fields = dict(sampling_strategy=strategy,
                              polygon_sampling_technique=tech,
                              mis_heuristic=heuristic,
                              error_display=(
                                  j_settings.ErrorDisplay.SPECULAR_FORWARD))
                want = j_settings.legalize_settings(**fields)
                got = legalize_settings(**{
                    k: getattr(t_settings, type(v).__name__)[v.name]
                    for k, v in fields.items()})
                assert got == to_port(want)


def test_run_orbit_renders_pngs_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    exp = Experiment(16, 16, "cornell_box", RenderSettings(), "unused.png")
    app = build_default_application(exp, str(tmp_path / "data"),
                                    device="cpu")
    paths = viewer.run_orbit(app, frames=2, output_dir=str(tmp_path / "o"),
                             width=16, height=16)
    assert len(paths) == 2 and all(os.path.exists(p) for p in paths)
    assert viewer.main(["--orbit", "--device", "cpu", "--width", "16",
                        "--height", "8", "--data-directory",
                        str(tmp_path / "data"), "--output-dir",
                        str(tmp_path / "cli")]) == 0
    assert len(os.listdir(tmp_path / "cli")) == 8
