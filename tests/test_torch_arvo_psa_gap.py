"""How far the JAX package's two Arvo PSA formulations part on the inputs
of test_torch_per_pixel.py, against how far the port parts from the
JAX reference there: the structure-of-arrays sampler
(vulkan_renderer_tpu/ops/soa_arvo_psa.py, through the plain-XLA fused
shading render/fused.py fused_light_shading_xla), the vmapped one
(ops/sampling_arvo_psa.py, through render/shading.py
evaluate_polygonal_light_shading, the port's reference) and the port's
per-pixel path, DIFFUSE_ONLY, one sample a light, on the same seeded
shading data, lights and UNORM16 noise pairs, by the rule of
_torch_shading_inputs.agreement (a value finite in one formulation only
counts as a disagreement), light by light as that test counts.

Measured, on the quadrilateral light (the hexagon has no flips): the JAX
formulations part on 0.49% / 0.66% / 1.04% of values (b, ray
directions, t_max), the port and the JAX reference on 0.83% / 1.32% /
1.46%, the port and the JAX SoA formulation on 0.49% / 0.83% / 0.62%.
So the port inherits a gap of the JAX package's own kind and size. Its
flips are of the same kind as the JAX package's own: where a
sector starts at a vertex on the horizon, the Newton step's derivative is
the difference of two edges' +-0.5 and comes out 0 or +-1e-7 by rounding;
a tiny nonzero derivative sends the step to the sector's edge, where the
sample lies on the horizon and the z > 1e-5 gate drops it. The roundings
differ because XLA's CPU rsqrt is not 1/sqrt rounded once (36% of
float32 inputs differ) and XLA contracts a * b + c into FMAs; the port
rounds as its CUDA kernels do, with which it must stay bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_shading_inputs import (agreement, jax_frame_constants,
                                   light_specs, per_pixel_inputs,
                                   per_pixel_scenes, port_frame_constants,
                                   quantized_noise, shading_inputs, to_port)
from test_torch_per_pixel import ARVO_PSA_THRESHOLD, VERTEX_COUNTS
from vulkan_renderer_tpu.core.settings import (PolygonSamplingTechnique,
                                               RenderSettings,
                                               SamplingStrategy)
from vulkan_renderer_tpu.render import fused as j_fused
from vulkan_renderer_tpu.render import shading as j_shading
from vulkan_renderer_tpu.scene.lights import (stack_lights,
                                              update_polygonal_light)
from vulkan_renderer_tpu_torch.render import shading

SEED, PIXELS = 23, 480
SETTINGS = RenderSettings(
    sampling_strategy=SamplingStrategy.DIFFUSE_ONLY,
    polygon_sampling_technique=(
        PolygonSamplingTechnique.PROJECTED_SOLID_ANGLE_ARVO))
# The largest share of disagreeing values between the two JAX
# formulations over the outputs and lights (measured 0.0104), pinned
# within this band, so that a change to either JAX sampler shows here.
JAX_GAP_BAND = (0.006, 0.016)


def jax_formulations():
    """{output name: (SoA values, vmapped values)}, lights stacked along
    the sample axis."""
    settings = SETTINGS
    specs = light_specs(VERTEX_COUNTS)
    data, ltc, _ = shading_inputs(SEED, PIXELS)
    jdata, jltc, _, _ = per_pixel_inputs(data, ltc)
    jscene, _ = per_pixel_scenes(specs)
    counts = tuple(s.vertex_count for s in specs)
    jstatic = j_shading.SceneStatic(light_count=len(specs),
                                    light_texturing=(0,) * len(specs),
                                    light_vertex_counts=counts)
    ppl = j_shading.pairs_per_light(settings)
    constants = jax_frame_constants(settings)
    noises = [quantized_noise((PIXELS, ppl, 2), SEED + 10 * i + 1)
              for i in range(len(specs))]
    vmapped = {"b": [], "ray_dirs": [], "t_max": []}
    for i, noise in enumerate(noises):
        out = jax.vmap(lambda d, l, nz: j_shading
                       .evaluate_polygonal_light_shading(
                           jscene, jstatic, settings, constants, i, d, l,
                           nz))(jdata, jltc, noise)
        for name in vmapped:
            vmapped[name].append(np.asarray(getattr(out, name)))
    lights = stack_lights([update_polygonal_light(s) for s in specs])
    _, b, dirs, t_max = j_fused.fused_light_shading_xla(
        jdata, jltc, jnp.ones(PIXELS, bool),
        jnp.asarray(np.concatenate(noises, axis=1)),
        j_fused._pack_light_scalars(lights, len(specs)),
        jnp.float32(settings.mis_visibility_estimate), jstatic, settings)
    soa = {"b": b, "ray_dirs": dirs, "t_max": t_max}
    return {name: (np.asarray(soa[name]),
                   np.concatenate(vmapped[name], axis=1))
            for name in soa}


def port_values():
    """{output name: the port's per-pixel values}, as jax_formulations."""
    specs = light_specs(VERTEX_COUNTS)
    data, ltc, _ = shading_inputs(SEED, PIXELS)
    _, _, tdata, tltc = per_pixel_inputs(data, ltc)
    _, scene = per_pixel_scenes(specs)
    counts = tuple(s.vertex_count for s in specs)
    static = shading.SceneStatic(light_count=len(specs),
                                 light_texturing=(0,) * len(specs),
                                 light_vertex_counts=counts)
    settings = to_port(SETTINGS)
    out = {"b": [], "ray_dirs": [], "t_max": []}
    for i in range(len(specs)):
        noise = quantized_noise((PIXELS, shading.pairs_per_light(settings),
                                 2), SEED + 10 * i + 1)
        r = shading.evaluate_polygonal_light_shading(
            scene, static, settings, port_frame_constants(SETTINGS), i,
            tdata, tltc, torch.from_numpy(noise))
        for name in out:
            out[name].append(getattr(r, name).numpy())
    return {name: np.concatenate(v, axis=1) for name, v in out.items()}


def test_port_parts_from_jax_as_the_jax_formulations_do():
    forms, port = jax_formulations(), port_values()
    jax_gap, port_gap = {}, {}
    for name, (soa, vmapped) in forms.items():
        for i in range(len(VERTEX_COUNTS)):
            key = f"{name} light {i}"
            jax_gap[key] = 1.0 - agreement(soa[:, i], vmapped[:, i], key,
                                           exact_finite_pattern=False)
            port_gap[key] = 1.0 - agreement(port[name][:, i],
                                            vmapped[:, i], key,
                                            exact_finite_pattern=False)
    print(f"share of values that disagree with the JAX reference: JAX SoA "
          f"{jax_gap}, port {port_gap}")
    low, high = JAX_GAP_BAND
    assert low <= max(jax_gap.values()) <= high, jax_gap
    # The port parts from the reference by less than twice the JAX
    # package's own gap, and within test_torch_per_pixel.py's threshold.
    assert max(port_gap.values()) <= 2.0 * max(jax_gap.values()), port_gap
    assert max(port_gap.values()) <= 1.0 - ARVO_PSA_THRESHOLD, port_gap
