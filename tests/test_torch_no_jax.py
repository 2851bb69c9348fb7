"""The PyTorch port never imports JAX: in a fresh interpreter, import every
module of vulkan_renderer_tpu_torch (the experiment harness, setups,
registry, Application and the technique modules among them), write and
load a tiny scene with the port's own tools, render a shadowed frame and a
no-shadow DIFFUSE_ONLY frame (the K5 path) on the CPU, run a timing-sweep
experiment through the harness, and check sys.modules."""

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
from vulkan_renderer_tpu.core.settings import RenderSettings
from vulkan_renderer_tpu.scene.camera import FirstPersonCamera
from vulkan_renderer_tpu.scene.lights import PolygonalLightSpec
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
from vulkan_renderer_tpu.core.settings import (PolygonSamplingTechnique,
                                               SamplingStrategy)
img = render_frame(scene, SceneStatic.for_scene(scene), camera,
                   RenderSettings(
                       sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
                       polygon_sampling_technique=(
                           PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE_ARVO)),
                   32, 16)
assert bool(img.isfinite().all())
from vulkan_renderer_tpu_torch.experiments import harness
assert harness.main(["-e", "193", "--device", "cpu", "--width", "16",
                     "--height", "8", "--warmup-frames", "1",
                     "--measure-frames", "2",
                     "--output-dir", d + "/out", "--data-directory",
                     d + "/data", "--results-csv", d + "/r.csv"]) == 0
print("JAX_IMPORTED", "jax" in sys.modules)
# The JAX-free host modules of the reference package the port may use.
allowed = {"vulkan_renderer_tpu", "vulkan_renderer_tpu.core",
           "vulkan_renderer_tpu.core.settings",
           "vulkan_renderer_tpu.core.timer", "vulkan_renderer_tpu.scene",
           "vulkan_renderer_tpu.scene.camera",
           "vulkan_renderer_tpu.scene.lights", "vulkan_renderer_tpu.assets",
           "vulkan_renderer_tpu.assets.vks",
           "vulkan_renderer_tpu.assets.quicksave",
           "vulkan_renderer_tpu.tools",
           "vulkan_renderer_tpu.tools.generate_noise",
           "vulkan_renderer_tpu.render",
           "vulkan_renderer_tpu.render.screenshot"}
used = {m for m in sys.modules if m.split(".")[0] == "vulkan_renderer_tpu"}
print("OTHER_REFERENCE_MODULES", sorted(used - allowed))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_IMPORTED False" in proc.stdout, proc.stdout
    assert "OTHER_REFERENCE_MODULES []" in proc.stdout, proc.stdout
