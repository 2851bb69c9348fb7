"""Shared inputs of the port's fused-shading parity tests: seeded shading
data, LTC coefficients from the packaged fits, hit mask, noise and light
records, made with numpy and handed to both packages, and a comparison of
the JAX package's plain-XLA shading with the port's plain versions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vulkan_renderer_tpu.ops.brdf import ShadingData as JShadingData
from vulkan_renderer_tpu.ops.ltc import (LtcTable as JLtcTable,
                                         get_ltc_coefficients,
                                         make_ltc_constants)
from vulkan_renderer_tpu.render import fused as j_fused
from vulkan_renderer_tpu.render.shading import SceneStatic as JSceneStatic
from vulkan_renderer_tpu.render.shading import pairs_per_light
from vulkan_renderer_tpu.scene.lights import (PolygonalLightSpec,
                                              stack_lights,
                                              update_polygonal_light)
from vulkan_renderer_tpu_torch.assets.ltc_table import default_ltc_table
from vulkan_renderer_tpu_torch.ops.ltc import LtcCoefficients
from vulkan_renderer_tpu_torch.render import fused
from vulkan_renderer_tpu_torch.render.shading import SceneStatic, ShadingData
from vulkan_renderer_tpu_torch.scene.scene import lights_from_specs

PIXELS = 160


def regular_polygon(n):
    a = 2.0 * np.pi * (np.arange(n) + 0.5) / n
    return np.stack([np.cos(a), np.sin(a)], axis=-1).astype(np.float32)


def light_specs(vertex_counts):
    """One light per entry; 4 keeps the default rectangle (Urena needs
    one), other counts are regular polygons. Placed above and beside the
    pixels so both central and decentral cases and clipping occur."""
    specs = []
    for i, nv in enumerate(vertex_counts):
        shape = {} if nv == 4 else {"vertices_plane_space":
                                    regular_polygon(nv)}
        specs.append(PolygonalLightSpec(
            translation=np.array([1.2 * i - 1.0, 0.6 - 0.5 * i, 1.2 + 0.4 * i],
                                 np.float32),
            rotation_angles=np.array([np.pi - 0.3 * i, 0.2 * i, 0.1],
                                     np.float32),
            scaling_x=0.6 + 0.1 * i, scaling_y=0.5,
            radiant_flux=np.array([9.0, 7.0, 5.0], np.float32) / (i + 1),
            **shape))
    return specs


def shading_inputs(seed=11, p=PIXELS):
    """(data, ltc, hit) as numpy dictionaries / arrays."""
    rng = np.random.default_rng(seed)
    position = rng.normal(size=(p, 3)).astype(np.float32)
    position[:, 2] *= 0.3
    normal = rng.normal(size=(p, 3)).astype(np.float32)
    normal[:, 2] = np.abs(normal[:, 2]) + 0.5
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
    table, _ = default_ltc_table()
    jtable = JLtcTable(jnp.asarray(table), make_ltc_constants(
        table.shape[0], table.shape[2], table.shape[1]))
    lum = data["fresnel_0"] @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    ltc = jax.vmap(functools.partial(get_ltc_coefficients, jtable))(
        jnp.asarray(lum), jnp.asarray(data["roughness"]),
        jnp.asarray(position), jnp.asarray(normal), jnp.asarray(outgoing))
    ltc = {f: np.array(getattr(ltc, f)) for f in ltc._fields if f != "quad"}
    hit = rng.uniform(0, 1, p) > 0.1
    return data, ltc, hit


def noise_pairs(settings, light_count, seed=5, p=PIXELS):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (p, pairs_per_light(settings) * light_count,
                              2)).astype(np.float32)


def jax_reference(data, ltc, hit, noise, specs, settings):
    """The JAX package's fused_light_shading_xla: (base, b, dirs, t_max)."""
    counts = tuple(s.vertex_count for s in specs)
    jstatic = JSceneStatic(light_count=len(specs),
                           light_texturing=(0,) * len(specs),
                           light_vertex_counts=counts)
    lights = stack_lights([update_polygonal_light(s) for s in specs])
    out = j_fused.fused_light_shading_xla(
        JShadingData(**{k: jnp.asarray(v) for k, v in data.items()}),
        type("Ltc", (), {k: jnp.asarray(v) for k, v in ltc.items()}),
        jnp.asarray(hit), jnp.asarray(noise),
        j_fused._pack_light_scalars(lights, len(specs)),
        jnp.float32(settings.mis_visibility_estimate), jstatic, settings)
    return [np.asarray(o) for o in out]


def port_inputs(data, ltc, hit, noise, specs):
    """(planes with noise, light records, static) for the port."""
    static = SceneStatic(light_count=len(specs),
                         light_texturing=(0,) * len(specs),
                         light_vertex_counts=tuple(s.vertex_count
                                                   for s in specs))
    planes = fused.pack_planes(
        ShadingData(**{k: torch.from_numpy(v) for k, v in data.items()}),
        LtcCoefficients(**{k: torch.from_numpy(v) for k, v in ltc.items()}),
        torch.from_numpy(hit),
        torch.from_numpy(noise.reshape(noise.shape[0], -1).T))
    light_scalars = fused.pack_light_scalars(
        lights_from_specs(specs, "cpu"), len(specs))
    return planes, light_scalars, static


def agreement(got, want, name):
    """Fraction of finite reference values within 1e-4 of their array's
    scale + 1e-3 relative; the finite pattern must match exactly."""
    assert got.shape == want.shape, name
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=name)
    if not fin.any():
        return 1.0
    scale = np.abs(want[fin]).max()
    ok = np.abs(got[fin] - want[fin]) <= 1e-4 * scale + 1e-3 * np.abs(
        want[fin])
    return float(ok.mean())
