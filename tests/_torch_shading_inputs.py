"""Shared inputs of the port's parity tests: seeded shading data, LTC
coefficients from the packaged fits, hit mask, a noise table and light
records, made with numpy and handed to both packages (the JAX package gets
the noise as get_noise_image of the table, the port the table itself as a
FrameNoise), and a comparison of the JAX package's plain-XLA shading with
the port's plain versions.

The two packages have their own RenderSettings, PolygonalLightSpec and
FirstPersonCamera classes (the port imports nothing of the JAX package).
to_port / to_jax rebuild one package's object as the other's from the same
field values, mapping enum members by name, so each package is handed its
own class."""

import dataclasses
import enum
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vulkan_renderer_tpu.core import settings as j_settings
from vulkan_renderer_tpu.ops.noise import get_noise_image as j_noise_image
from vulkan_renderer_tpu.ops.brdf import ShadingData as JShadingData
from vulkan_renderer_tpu.ops.ltc import (LtcTable as JLtcTable,
                                         get_ltc_coefficients,
                                         make_ltc_constants)
from vulkan_renderer_tpu.render import fused as j_fused
from vulkan_renderer_tpu.render.shading import SceneStatic as JSceneStatic
from vulkan_renderer_tpu.render.shading import pairs_per_light
from vulkan_renderer_tpu.scene import camera as j_camera
from vulkan_renderer_tpu.scene import lights as j_lights
from vulkan_renderer_tpu.scene.lights import (PolygonalLightSpec,
                                              stack_lights,
                                              update_polygonal_light)
from vulkan_renderer_tpu_torch.assets.ltc_table import default_ltc_table
from vulkan_renderer_tpu_torch.core import settings as t_settings
from vulkan_renderer_tpu_torch.ops.ltc import LtcCoefficients
from vulkan_renderer_tpu_torch.ops.noise import frame_noise
from vulkan_renderer_tpu_torch.render import fused
from vulkan_renderer_tpu_torch.render.shading import SceneStatic, ShadingData
from vulkan_renderer_tpu_torch.scene import camera as t_camera
from vulkan_renderer_tpu_torch.scene import lights as t_lights
from vulkan_renderer_tpu_torch.scene.scene import lights_from_specs

# The pixels are a FRAME_WIDTH x (PIXELS / FRAME_WIDTH) frame for the noise;
# the width is no multiple of the noise table's 16-texel side, so the
# table wraps inside a row.
PIXELS = 160
FRAME_WIDTH = 20

_JAX_MODULES = (j_settings, j_lights, j_camera)
_PORT_MODULES = (t_settings, t_lights, t_camera)


def _named(modules, name):
    return next(getattr(m, name) for m in modules if hasattr(m, name))


def _rebuild(obj, modules):
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rebuild(o, modules) for o in obj)
    values = {}
    for field in dataclasses.fields(obj):
        value = getattr(obj, field.name)
        if isinstance(value, enum.Enum):
            value = _named(modules, type(value).__name__)[value.name]
        values[field.name] = value
    return _named(modules, type(obj).__name__)(**values)


def to_port(obj):
    """A RenderSettings, PolygonalLightSpec or FirstPersonCamera (or a list
    of them) of either package as the port's class."""
    return _rebuild(obj, _PORT_MODULES)


def to_jax(obj):
    """The same as the JAX package's class."""
    return _rebuild(obj, _JAX_MODULES)


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


def noise_inputs(settings, light_count, seed=5, p=PIXELS,
                 width=FRAME_WIDTH):
    """A seeded (layers 8, 32 x 16 texels) noise table read by a width x
    (p / width) frame: (the JAX package's (p, pairs, 2) noise from its
    get_noise_image, the port's FrameNoise of the same table)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 65536, size=(8, 32, 16, 4)).astype(np.uint16)
    randoms = rng.integers(0, 2**32, size=4, dtype=np.uint64) \
        .astype(np.uint32)
    pairs = pairs_per_light(settings) * light_count
    height = p // width
    want = np.asarray(j_noise_image(jnp.asarray(table), width, height, pairs,
                                    np.uint32(7), jnp.asarray(randoms)))
    noise = frame_noise(torch.from_numpy(table.astype(np.int32)), width,
                        height, pairs, 7, randoms)
    return want, noise


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
    return [np.array(o) for o in out]


def port_inputs(data, ltc, hit, specs):
    """(planes, light records, static) for the port."""
    static = SceneStatic(light_count=len(specs),
                         light_texturing=(0,) * len(specs),
                         light_vertex_counts=tuple(s.vertex_count
                                                   for s in specs))
    planes = fused.pack_planes(
        ShadingData(**{k: torch.from_numpy(v) for k, v in data.items()}),
        LtcCoefficients(**{k: torch.from_numpy(v) for k, v in ltc.items()}),
        torch.from_numpy(hit))
    light_scalars = fused.pack_light_scalars(
        lights_from_specs(to_port(specs), "cpu"), len(specs))
    return planes, light_scalars, static


def agreement(got, want, name, exact_finite_pattern=True):
    """Fraction of finite reference values within 1e-4 of their array's
    scale + 1e-3 relative. The finite pattern must match exactly, or,
    with exact_finite_pattern False, a value finite in one array only
    counts as a disagreement."""
    assert got.shape == want.shape, name
    fin = np.isfinite(want)
    if exact_finite_pattern:
        np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=name)
    if not fin.any():
        return 1.0
    scale = np.abs(want[fin]).max()
    if not exact_finite_pattern:
        either = fin | np.isfinite(got)
        both = fin & np.isfinite(got)
        close = np.zeros_like(both)
        close[both] = np.abs(got[both] - want[both]) <= 1e-4 * scale \
            + 1e-3 * np.abs(want[both])
        return float(close[either].mean())
    ok = np.abs(got[fin] - want[fin]) <= 1e-4 * scale + 1e-3 * np.abs(
        want[fin])
    return float(ok.mean())


# ---------------------------------------------------------------------------
# The per-pixel path (render/shading.py, render/line_shading.py)
# ---------------------------------------------------------------------------


def per_pixel_scenes(specs, light_textures=None, linear_specs=()):
    """(JAX scene, port scene) namespaces holding what the per-pixel
    shading reads: the stacked lights, a float32 light atlas of
    `light_textures` (default: one white texture; specs name theirs by
    texture_index) and the linear lights."""
    import types

    from vulkan_renderer_tpu.render import texture as j_texture
    from vulkan_renderer_tpu.scene import linear_lights as j_linear
    from vulkan_renderer_tpu_torch.render import texture as t_texture
    from vulkan_renderer_tpu_torch.scene import linear_lights as t_linear
    textures = light_textures or [[np.ones((4, 4, 4), np.float32)]]
    jscene = types.SimpleNamespace(
        lights=stack_lights([update_polygonal_light(s) for s in specs]),
        light_atlas=j_texture.build_texture_atlas(textures),
        linear_lights=j_linear.stack_linear_lights(list(linear_specs)))
    port_linear = [t_linear.LinearLightSpec(**dataclasses.asdict(s))
                   for s in linear_specs]
    scene = types.SimpleNamespace(
        lights=lights_from_specs(to_port(specs), "cpu"),
        light_atlas=t_texture.atlas_from_numpy(
            t_texture.build_texture_atlas_np(textures, channels=4,
                                             unorm16=False), "cpu"),
        linear_lights=t_linear.stack_linear_lights(port_linear, "cpu"))
    return jscene, scene


def quantized_noise(shape, seed):
    """Noise pairs as the UNORM16 tables hold them: k / 65535, 0 and 1
    included."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 65536, size=shape) / 65535.0).astype(np.float32)


def jax_frame_constants(settings):
    """The JAX FrameConstants fields the per-pixel shading reads."""
    from vulkan_renderer_tpu.render.shading import FrameConstants
    return FrameConstants(
        camera_position=jnp.zeros(3), pixel_to_ray=jnp.eye(3),
        exposure_factor=jnp.float32(settings.exposure_factor),
        roughness_factor=jnp.float32(settings.roughness_factor),
        mis_visibility_estimate=jnp.float32(settings.mis_visibility_estimate),
        error_factor=jnp.float32(10.0 ** (-settings.error_min_exponent)),
        noise_random_numbers=jnp.zeros(4, jnp.uint32))


def port_frame_constants(settings):
    from vulkan_renderer_tpu_torch.render.shading import FrameConstants
    return FrameConstants(
        camera_position=torch.zeros(3), pixel_to_ray=torch.eye(3),
        exposure_factor=float(settings.exposure_factor),
        roughness_factor=float(settings.roughness_factor),
        noise_random_numbers=(0, 0, 0, 0))


def per_pixel_inputs(data, ltc):
    """(JAX ShadingData, JAX LtcCoefficients, port ShadingData, port
    LtcCoefficients) of shading_inputs' dictionaries."""
    from vulkan_renderer_tpu.ops.ltc import LtcCoefficients as JLtc
    return (JShadingData(**{k: jnp.asarray(v) for k, v in data.items()}),
            JLtc(**{k: jnp.asarray(v) for k, v in ltc.items()}),
            ShadingData(**{k: torch.from_numpy(v) for k, v in data.items()}),
            LtcCoefficients(**{k: torch.from_numpy(v)
                               for k, v in ltc.items()}))


def compare_light_shading(settings, specs, seed, light_textures=None,
                          p=480, threshold=0.99, report=None,
                          exact_finite_pattern=True):
    """Shade every light of specs at p seeded pixels with the JAX
    package's evaluate_polygonal_light_shading (vmapped) and the port's;
    every output (base, b, ray_dirs, t_max) must agree at `threshold`
    (agreement above). Returns the port's results."""
    from vulkan_renderer_tpu.render import shading as j_shading
    from vulkan_renderer_tpu_torch.render import shading
    data, ltc, _ = shading_inputs(seed, p)
    jdata, jltc, tdata, tltc = per_pixel_inputs(data, ltc)
    jscene, scene = per_pixel_scenes(specs, light_textures)
    texturing = tuple(s.texturing_technique for s in specs)
    counts = tuple(s.vertex_count for s in specs)
    jstatic = j_shading.SceneStatic(light_count=len(specs),
                                    light_texturing=texturing,
                                    light_vertex_counts=counts)
    static = shading.SceneStatic(light_count=len(specs),
                                 light_texturing=texturing,
                                 light_vertex_counts=counts)
    ppl = j_shading.pairs_per_light(settings)
    port_settings = to_port(settings)
    assert shading.pairs_per_light(port_settings) == ppl
    assert shading.rays_per_light(port_settings) \
        == j_shading.rays_per_light(settings)
    jconst = jax_frame_constants(settings)
    const = port_frame_constants(settings)
    results = []
    for i in range(len(specs)):
        noise = quantized_noise((p, ppl, 2), seed + 10 * i + 1)
        want = jax.vmap(lambda d, l, nz: j_shading
                        .evaluate_polygonal_light_shading(
                            jscene, jstatic, settings, jconst, i, d, l,
                            nz))(jdata, jltc, noise)
        got = shading.evaluate_polygonal_light_shading(
            scene, static, port_settings, const, i, tdata, tltc,
            torch.from_numpy(noise))
        for name in ("base", "b", "ray_dirs", "t_max"):
            g = getattr(got, name).numpy()
            w = np.asarray(getattr(want, name))
            ok = agreement(g, w, f"light {i} {name}", exact_finite_pattern)
            if report is not None:
                report.append((name, i, ok))
            assert ok >= threshold, (name, i, ok)
        results.append(got)
    return results
