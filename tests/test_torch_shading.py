"""Parity of the port's per-pixel preamble (render/pipeline.py
pixel_preamble: K6's plain version for the texture fetch, material decode,
normal mapping and LTC coefficients, then the light display) with the JAX
package's _pixel_preamble on the same scene, rays, attribute planes and
hit positions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_shading_inputs import to_port
from vulkan_renderer_tpu.assets.noise import NoiseType
from vulkan_renderer_tpu.core.settings import RenderSettings
from vulkan_renderer_tpu.render import pipeline as j_pipeline
from vulkan_renderer_tpu.render import shading as j_shading
from vulkan_renderer_tpu.render.visibility import trace_primary_bruteforce
from vulkan_renderer_tpu.scene.camera import FirstPersonCamera
from vulkan_renderer_tpu.scene.lights import PolygonalLightSpec
from vulkan_renderer_tpu.scene.scene import load_scene
from vulkan_renderer_tpu.tools.export_scene import write_test_scene
from vulkan_renderer_tpu_torch.render import pipeline
from vulkan_renderer_tpu_torch.render.shading import SceneStatic
from vulkan_renderer_tpu_torch.scene.scene import (scene_from_numpy,
                                                   tree_leaves)


def test_preamble_matches_reference(tmp_path):
    vks = write_test_scene(str(tmp_path), "cornell_box", texture_resolution=16)
    light = PolygonalLightSpec(
        translation=np.array([1.0, 1.0, 1.99], np.float32),
        rotation_angles=np.array([np.pi, 0, 0], np.float32),
        scaling_x=0.4, scaling_y=0.4,
        radiant_flux=np.array([40.0, 35.0, 30.0], np.float32))
    jscene = load_scene(vks, str(tmp_path / "cornell_box_textures"), [light],
                        noise_type=NoiseType.WHITE,
                        data_directory=str(tmp_path))
    scene = scene_from_numpy(tree_leaves(jscene), "cpu")
    static = SceneStatic.for_scene(scene)
    jstatic = j_shading.SceneStatic(light_count=1, light_texturing=(0,))
    settings = RenderSettings()
    # Looking up at the ceiling light from below, so some rays see it.
    camera = FirstPersonCamera(
        position_world_space=np.array([1.0, 0.15, 1.0], np.float32),
        rotation_x=0.77 * np.pi, rotation_z=np.pi)
    w, h = 32, 24
    constants = pipeline.make_frame_constants(
        to_port(camera), w, h, to_port(settings), np.zeros(4, np.uint32),
        "cpu")
    jconstants = j_pipeline.make_frame_constants(
        camera, w, h, settings, np.zeros(4, np.uint32))
    dirs = pipeline.camera_rays(constants, w, h)

    prim, t_hit = trace_primary_bruteforce(jscene.triangle_positions,
                                           jconstants.camera_position,
                                           jnp.asarray(dirs.numpy()))
    prim = np.asarray(prim)
    hit = prim != 0xFFFFFFFF
    assert hit.mean() > 0.5
    safe = jnp.asarray(np.where(hit, prim, 0).astype(np.int32))
    geom, _ = jax.vmap(functools.partial(
        j_shading.geometry_attributes, jscene, jconstants))(
        safe, jnp.asarray(dirs.numpy()))
    planes = np.asarray(jax.vmap(j_pipeline._pack_geom_planes)(geom))
    planes = np.where(hit[:, None], planes, 0.0).astype(np.float32)
    jgeom = jax.vmap(j_shading.geometry_attributes_from_planes)(
        jnp.asarray(planes))

    _, data, ltc, _, base = pipeline.pixel_preamble(
        scene, static, to_port(settings), constants,
        torch.from_numpy(planes.T.copy()),
        torch.from_numpy(np.where(hit, prim, -1).astype(np.int32)),
        torch.from_numpy(np.array(t_hit, np.float32)), dirs)
    # Both packages shade the port's hit positions.
    _, jdata, jltc, jbase = jax.vmap(functools.partial(
        j_pipeline._pixel_preamble, jscene, jstatic, settings, jconstants))(
        jnp.asarray(prim), jnp.asarray(dirs.numpy()), jgeom,
        jnp.asarray(data.position.numpy()))

    # The light display is exact set logic on the same float inputs.
    np.testing.assert_array_equal(base.numpy(), np.asarray(jbase))
    assert base.numpy().max() > 0
    # Texture fetch, normalize, acos and sqrt: float32 rounding only.
    for field in ("position", "normal", "outgoing", "lambert_outgoing",
                  "diffuse_albedo", "fresnel_0", "roughness"):
        np.testing.assert_allclose(getattr(data, field).numpy()[hit],
                                   np.asarray(getattr(jdata, field))[hit],
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    for field in ("world_to_shading_space", "shading_to_cosine_space",
                  "world_to_cosine_space", "cosine_to_shading_space",
                  "albedo", "shading_to_cosine_space_determinant"):
        np.testing.assert_allclose(getattr(ltc, field).numpy()[hit],
                                   np.asarray(getattr(jltc, field))[hit],
                                   rtol=1e-4, atol=1e-4, err_msg=field)
