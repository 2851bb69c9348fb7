"""Parity of the port's fused-shading module (render/fused.py, kernel K4)
with the JAX package: the plain version against
render/fused.py::fused_light_shading_xla on the same shading data, LTC
coefficients, noise and light records, for PSA and PSA-biased with
DIFFUSE_SPECULAR_MIS under all five MIS heuristics."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_renderer_tpu.core.settings import (MisHeuristic,
                                               PolygonSamplingTechnique,
                                               RenderSettings,
                                               SamplingStrategy)
from vulkan_renderer_tpu.ops.brdf import ShadingData as JShadingData
from vulkan_renderer_tpu.ops.ltc import (LtcTable as JLtcTable,
                                         get_ltc_coefficients,
                                         make_ltc_constants)
from vulkan_renderer_tpu.render import fused as j_fused
from vulkan_renderer_tpu.render.shading import SceneStatic as JSceneStatic
from vulkan_renderer_tpu.scene.lights import (PolygonalLightSpec,
                                              stack_lights,
                                              update_polygonal_light)
from vulkan_renderer_tpu_torch.assets.ltc_table import default_ltc_table
from vulkan_renderer_tpu_torch.ops.ltc import LtcCoefficients
from vulkan_renderer_tpu_torch.render import fused
from vulkan_renderer_tpu_torch.render.shading import SceneStatic, ShadingData
from vulkan_renderer_tpu_torch.scene.scene import lights_from_specs

SPECS = [
    PolygonalLightSpec(
        translation=np.array([0.5, -0.5, 2.0], np.float32),
        rotation_angles=np.array([np.pi, 0, 0], np.float32),
        scaling_x=0.8, scaling_y=0.6,
        radiant_flux=np.array([9.0, 7.0, 5.0], np.float32)),
    PolygonalLightSpec(
        translation=np.array([-1.0, 1.0, 1.5], np.float32),
        rotation_angles=np.array([2.5, 0.3, 0.1], np.float32),
        scaling_x=0.5, scaling_y=0.5,
        radiant_flux=np.array([4.0, 4.0, 6.0], np.float32),
        vertices_plane_space=np.array(
            [[-1, -1], [1, -1], [1.2, 0.4], [0, 1.1], [-1.3, 0.6]],
            np.float32)),
]
STATIC = SceneStatic(light_count=2, light_texturing=(0, 0),
                     light_vertex_counts=(4, 5))


@pytest.fixture(scope="module")
def inputs():
    """Seeded shading data, LTC coefficients from the packaged fits, hit
    mask and noise, as numpy, shared by both packages."""
    rng = np.random.default_rng(11)
    p = 256
    position = rng.normal(size=(p, 3)).astype(np.float32)
    normal = rng.normal(size=(p, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    outgoing = rng.normal(size=(p, 3)).astype(np.float32) + normal
    outgoing /= np.linalg.norm(outgoing, axis=-1, keepdims=True)
    lam = np.sum(normal * outgoing, axis=-1, keepdims=True)
    outgoing = np.where(lam > 0.01, outgoing, normal).astype(np.float32)
    data = dict(
        position=position, normal=normal, outgoing=outgoing,
        lambert_outgoing=np.sum(normal * outgoing, axis=-1),
        diffuse_albedo=rng.uniform(0, 1, (p, 3)).astype(np.float32),
        fresnel_0=(0.02 + 0.9 * rng.uniform(0, 1, (p, 3)))
        .astype(np.float32),
        roughness=(0.01 + 0.9 * rng.uniform(0, 1, p)).astype(np.float32))
    table, constants = default_ltc_table()
    jtable = JLtcTable(jnp.asarray(table), make_ltc_constants(
        table.shape[0], table.shape[2], table.shape[1]))
    lum = data["fresnel_0"] @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    ltc = jax.vmap(functools.partial(get_ltc_coefficients, jtable))(
        jnp.asarray(lum), jnp.asarray(data["roughness"]),
        jnp.asarray(position), jnp.asarray(normal), jnp.asarray(outgoing))
    ltc = {f: np.array(getattr(ltc, f)) for f in ltc._fields
           if f != "quad"}
    hit = rng.uniform(0, 1, p) > 0.1
    noise = rng.uniform(0, 1, (p, 2 * 2 * 2, 2)).astype(np.float32)
    return data, ltc, hit, noise


def _settings(heuristic, biased):
    return RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_SPECULAR_MIS,
        polygon_sampling_technique=(
            PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE_BIASED if biased
            else PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE),
        mis_heuristic=heuristic, sample_count=2)


def test_light_scalars_match_reference():
    got = fused.pack_light_scalars(lights_from_specs(SPECS, "cpu"), 2)
    want = j_fused._pack_light_scalars(
        stack_lights([update_polygonal_light(s) for s in SPECS]), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("heuristic,biased", [
    (MisHeuristic.BALANCE, False), (MisHeuristic.POWER, False),
    (MisHeuristic.WEIGHTED, False), (MisHeuristic.OPTIMAL_CLAMPED, False),
    (MisHeuristic.OPTIMAL, False), (MisHeuristic.OPTIMAL_CLAMPED, True)])
def test_fused_plain_matches_reference(inputs, heuristic, biased):
    """Tolerance: the same float32 operations in the same order, but XLA
    may fuse multiply-adds and its rsqrt/cos/sin differ from torch's by an
    ulp, which can move a sample across a sector boundary. So >= 99.5% of
    the output values agree within 1e-4 of their plane's scale (+1e-3
    relative), and the rest are sector flips of single slots."""
    data, ltc, hit, noise = inputs
    settings = _settings(heuristic, biased)
    jstatic = JSceneStatic(light_count=2, light_texturing=(0, 0),
                           light_vertex_counts=(4, 5))
    lights = stack_lights([update_polygonal_light(s) for s in SPECS])
    want = j_fused.fused_light_shading_xla(
        JShadingData(**{k: jnp.asarray(v) for k, v in data.items()}),
        type("Ltc", (), {k: jnp.asarray(v) for k, v in ltc.items()}),
        jnp.asarray(hit), jnp.asarray(noise),
        j_fused._pack_light_scalars(lights, 2),
        jnp.float32(settings.mis_visibility_estimate), jstatic, settings)
    want = [np.asarray(w) for w in want]

    planes = fused.pack_planes(
        ShadingData(**{k: torch.from_numpy(v) for k, v in data.items()}),
        LtcCoefficients(**{k: torch.from_numpy(v) for k, v in ltc.items()}),
        torch.from_numpy(hit),
        torch.from_numpy(noise.reshape(noise.shape[0], -1).T))
    out = fused.fused_light_shading(
        planes, fused.pack_light_scalars(lights_from_specs(SPECS, "cpu"), 2),
        STATIC, settings)
    got = [g.numpy() for g in fused.unpack_outputs(out, 8)]
    for name, g, w in zip(("base", "b", "dirs", "t_max"), got, want):
        assert g.shape == w.shape, name
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=name)
        scale = np.abs(w[fin]).max()
        ok = np.abs(g[fin] - w[fin]) <= 1e-4 * scale + 1e-3 * np.abs(w[fin])
        assert ok.mean() >= 0.995, (name, ok.mean())
    assert np.abs(got[1]).max() > 0  # the shading did contribute


def test_unsupported_settings_raise():
    for kwargs in (dict(sampling_strategy=(
                       SamplingStrategy.DIFFUSE_SPECULAR_SEPARATELY)),
                   dict(sampling_strategy=SamplingStrategy.DIFFUSE_GGX_MIS,
                        mis_heuristic=MisHeuristic.BALANCE,
                        polygon_sampling_technique=(
                            PolygonSamplingTechnique.SOLID_ANGLE))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fused.check_supported(STATIC, RenderSettings(**kwargs))
    # Every technique is fused under DIFFUSE_ONLY.
    for tech in PolygonSamplingTechnique:
        fused.check_supported(STATIC, RenderSettings(
            sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
            polygon_sampling_technique=tech))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused.check_supported(
            dataclasses.replace(STATIC, light_texturing=(1, 0)),
            RenderSettings())
    fused.check_supported(STATIC, RenderSettings())
