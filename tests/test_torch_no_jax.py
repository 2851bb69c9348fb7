"""The PyTorch port imports neither JAX nor anything of the JAX package: in
a fresh interpreter, import every module of vulkan_renderer_tpu_torch (the
experiment harness, setups, registry, Application and the technique
modules among them), write and load a tiny scene with the port's own
tools, render a shadowed frame and a no-shadow DIFFUSE_ONLY frame (the K5
path), a per-pixel frame (DIFFUSE_SPECULAR_SEPARATELY with shadows) and a
linear-light frame on the CPU, run a timing-sweep experiment through the
harness, run the modules ported last (the two-frame HDR capture, image-row
bands, the RMSE table, the report, texture conversion, an LTC fit and the
viewer's headless orbit) at tiny sizes, and check that sys.modules holds
no jax and no module of vulkan_renderer_tpu (data files of the JAX
package are read by path, not by import)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys, tempfile
assert "jax" not in sys.modules, "jax was imported before the port"
import numpy as np
import vulkan_renderer_tpu_torch as port
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(info.name)
from vulkan_renderer_tpu_torch.core.settings import (
    PolygonSamplingTechnique, RenderSettings, SamplingStrategy)
from vulkan_renderer_tpu_torch.scene.camera import FirstPersonCamera
from vulkan_renderer_tpu_torch.scene.lights import PolygonalLightSpec
from vulkan_renderer_tpu_torch.assets.noise import white_noise_table
from vulkan_renderer_tpu_torch.render.pipeline import render_frame
from vulkan_renderer_tpu_torch.render.shading import SceneStatic
from vulkan_renderer_tpu_torch.scene.scene import load_scene
from vulkan_renderer_tpu_torch.tools.export_scene import write_test_scene
d = tempfile.mkdtemp()
vks = write_test_scene(d, texture_resolution=8)
light = PolygonalLightSpec(
    translation=np.array([1.0, 1.0, 1.99], np.float32),
    rotation_angles=np.array([np.pi, 0, 0], np.float32),
    scaling_x=0.4, scaling_y=0.4,
    radiant_flux=np.array([40.0, 35.0, 30.0], np.float32))
scene = load_scene(vks, d + "/cornell_box_textures", [light], "cpu",
                   noise=white_noise_table(32, 32, 4))
camera = FirstPersonCamera(
    position_world_space=np.array([1.0, 0.15, 1.0], np.float32),
    rotation_x=np.pi / 2, rotation_z=np.pi)
img = render_frame(scene, SceneStatic.for_scene(scene), camera,
                   RenderSettings(trace_shadow_rays=True), 32, 16)
assert img.shape == (16, 32, 3) and bool(img.isfinite().all())
img = render_frame(scene, SceneStatic.for_scene(scene), camera,
                   RenderSettings(
                       sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
                       polygon_sampling_technique=(
                           PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE_ARVO)),
                   32, 16)
assert bool(img.isfinite().all())
img = render_frame(scene, SceneStatic.for_scene(scene, fused="off"), camera,
                   RenderSettings(
                       sampling_strategy=(
                           SamplingStrategy.DIFFUSE_SPECULAR_SEPARATELY),
                       trace_shadow_rays=True), 32, 16)
assert bool(img.isfinite().all()) and float(img.mean()) > 0.0
from vulkan_renderer_tpu_torch.scene.linear_lights import LinearLightSpec
tube = LinearLightSpec(start=np.array([0.2, 1.0, 1.9], np.float32),
                       end=np.array([1.8, 1.0, 1.9], np.float32),
                       radiant_flux=np.array([40.0, 36.0, 30.0], np.float32))
linear = load_scene(vks, d + "/cornell_box_textures", [], "cpu",
                    noise=white_noise_table(32, 32, 4),
                    linear_light_specs=[tube])
img = render_frame(linear, SceneStatic.for_scene(linear), camera,
                   RenderSettings(), 32, 16)
assert bool(img.isfinite().all()) and float(img.mean()) > 0.0
from vulkan_renderer_tpu_torch.experiments import harness
assert harness.main(["-e", "193", "--device", "cpu", "--width", "16",
                     "--height", "8", "--warmup-frames", "1",
                     "--measure-frames", "2",
                     "--output-dir", d + "/out", "--data-directory",
                     d + "/data", "--results-csv", d + "/r.csv"]) == 0
from vulkan_renderer_tpu_torch.parallel.tiles import render_frame_bands
bands = render_frame_bands(["cpu", "cpu"], scene, SceneStatic.for_scene(scene),
                           camera, RenderSettings(), 32, 16)
assert bool((bands == render_frame(scene, SceneStatic.for_scene(scene), camera,
                                   RenderSettings(), 32, 16)).all())
from vulkan_renderer_tpu_torch.tools import (experiment_report, fit_ltc,
                                             hdr_capture, rmse_table,
                                             texture_conversion, viewer)
_, _, mismatches = hdr_capture.capture("cornell_box", 16, 16, d + "/hdr",
                                       "cpu", d + "/data")
assert mismatches == 0
assert rmse_table.run_config(1, 1, 2, d + "/data", d + "/rmse.csv", "cpu",
                             16, 16).rmse > 0.0
assert experiment_report.write_report(d + "/r.csv", d + "/R.md",
                                      d + "/rmse.csv") == 1
from vulkan_renderer_tpu_torch.render.screenshot import write_png
write_png(d + "/t.png", np.zeros((4, 4, 3), np.uint8))
texture_conversion.convert(132, d + "/t.png", d + "/t.vkt")
fit_ltc.main(["--output", d + "/fits", "--resolution", "2",
              "--fresnel-count", "1", "--samples", "4", "--steps", "1",
              "--device", "cpu"])
assert viewer.main(["--orbit", "--device", "cpu", "--width", "8",
                    "--height", "8", "--data-directory", d + "/data",
                    "--output-dir", d + "/orbit"]) == 0
print("JAX_IMPORTED", "jax" in sys.modules)
used = {m for m in sys.modules if m.split(".")[0] == "vulkan_renderer_tpu"}
print("REFERENCE_MODULES", sorted(used))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_IMPORTED False" in proc.stdout, proc.stdout
    assert "REFERENCE_MODULES []" in proc.stdout, proc.stdout
