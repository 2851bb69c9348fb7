"""The per-pixel path's own formulation against the JAX package's
per-pixel functions, function by function: clip_polygon, solve_cubic,
the solid angle and projected solid angle (unbiased and biased)
preparations, samplers and error estimate, Urena's rectangles, Arvo's
solid angle, Hart's bilinear and biquadratic warps, Arvo's PSA and Turk's
area sampling (render/shading.py::_sample_area_polygon_turk). The JAX
side runs jax.vmap over the same numpy inputs on the CPU.

Inputs, one set each: seeded polygons of 3, 5 and 7 vertices facing the
origin, some below or across the horizon (clipping makes 3-8 vertices;
central and decentral PSA cases both occur), and 4,096 pixel-light pairs
of the tiny city's 64x32 frame under the bench lights (1,024 hit pixels
x 4 quads; tests/_torch_trace_inputs.py::city_frame), each light in the
pixel's shading frame as the shading path transforms it. Random numbers
are UNORM16-quantized pairs from a seed.

Tolerance: the per-pixel tests' (test_torch_per_pixel.py::tolerance):
for each compared array the finite pattern matches exactly and >= 99.5%
of finite values lie within 1e-4 of the array's largest |value| + 1e-3
relative (_torch_shading_inputs.agreement); Arvo's PSA at 98%, a value
finite in one package only counting as a disagreement. Both packages
write the same formulas, but XLA contracts multiply-adds into FMAs and
its rsqrt, cos and sin round apart from torch's, so a sample at a fan or
sector boundary may land in the neighbour. Fully clipped polygons (count
0, which the shading gates) are left out. The error estimates are
compared at the JAX samples rotated about z (0.01 rad for PSA, 0.03 for
Arvo's PSA), where they are residuals of a few percent of the projected
solid angle, not rounding (as tests/test_torch_sampling_ops.py does).

The last test holds that the per-pixel modules import none of the
structure-of-arrays library that K4's plain version runs."""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_shading_inputs import (agreement, light_specs, quantized_noise,
                                   to_jax, to_port)
from test_torch_per_pixel import ARVO_PSA_THRESHOLD
from test_torch_sampling_ops import jax_clip, padded, polygons, rotated
from vulkan_renderer_tpu.ops import cubic as j_cubic
from vulkan_renderer_tpu.ops import sampling as j_sampling
from vulkan_renderer_tpu.ops import sampling_arvo_psa as j_arvo
from vulkan_renderer_tpu.ops import sampling_related as j_related
from vulkan_renderer_tpu.render import shading as j_shading
from vulkan_renderer_tpu.scene.lights import (stack_lights,
                                              update_polygonal_light)
from vulkan_renderer_tpu_torch.ops import clipping, cubic, sampling
from vulkan_renderer_tpu_torch.ops import sampling_arvo_psa as arvo
from vulkan_renderer_tpu_torch.ops import sampling_related as related
from vulkan_renderer_tpu_torch.render import fused, shading
from vulkan_renderer_tpu_torch.scene.scene import lights_from_specs
from vulkan_renderer_tpu_torch.tools import bench_frame as bench

THRESHOLD = 0.995
P = 4096
CITY_PIXELS = 1024
SETS = ["n3", "n5", "n7", "city"]
PORT = pathlib.Path(__file__).resolve().parents[1] / \
    "vulkan_renderer_tpu_torch"
OWN_FORMULATION = ["render/shading.py", "render/line_shading.py",
                   "ops/sampling.py", "ops/sampling_related.py",
                   "ops/sampling_arvo_psa.py", "ops/clipping.py",
                   "ops/cubic.py"]
SOA_MODULES = {"soa", "soa_techniques", "soa_arvo_psa"}


def t(a, dtype=torch.float32):
    """A numpy array as a tensor; floats as `dtype`."""
    out = torch.from_numpy(np.ascontiguousarray(a))
    return out.to(dtype) if out.is_floating_point() else out


def _numpy(a, rows):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a if rows is None else a[rows]


def check(got, want, name, threshold=THRESHOLD, rows=None, oracle=None):
    """got (torch or numpy) against want (JAX or numpy) at the per-pixel
    tolerance on the pixels `rows`. With an oracle (the port's float64
    values), each float32 evaluation is held against it instead: the JAX
    values agree with it on no fewer values than the port's own, less
    1 - threshold."""
    got, want = _numpy(got, rows), _numpy(want, rows)
    if oracle is None:
        share = agreement(got, want, name,
                          exact_finite_pattern=threshold == THRESHOLD)
        assert share >= threshold, (name, share)
        return
    oracle = _numpy(oracle, rows)
    port = agreement(got, oracle, name, exact_finite_pattern=False)
    jax_share = agreement(want, oracle, name, exact_finite_pattern=False)
    assert jax_share >= port - (1.0 - threshold), (name, jax_share, port)


def compare(got, want, oracle=None, threshold=THRESHOLD, rows=None):
    """check every entry of the dictionaries got (port float32) and want
    (JAX), with oracle (port float64) entries if given."""
    for name, value in got.items():
        check(value, want[name], name, threshold, rows,
              None if oracle is None else oracle[name])


def evaluate(inputs, port, unstable=False):
    """port(tensor maker) -> {name: tensor} at float32, and where the
    function is unstable in float32 on the city set, at float64."""
    got = port(t)
    if inputs["name"] != "city" or not unstable:
        return got, None
    return got, port(functools.partial(t, dtype=torch.float64))


def _city_pairs():
    """(positions (P, 3), world vertices (P, 4, 3), shading-frame
    polygons (P, 4, 3) unflipped and flipped as the PSA family flips
    them, light ids (P,)) for CITY_PIXELS hit pixels x 4 lights,
    light-major."""
    import tempfile

    from _torch_trace_inputs import city_frame
    _, scene, captured = city_frame(tempfile.mkdtemp())
    planes = captured["fused_shading"][0]
    planes = planes[:, bench.hit_mask(planes) > 0.5][:, :CITY_PIXELS]
    planes = planes.numpy().astype(np.float32)
    assert planes.shape[1] == CITY_PIXELS
    rows = [fused.BASE_PLANES.index(f"w2s{i}{j}")
            for i in range(3) for j in range(4)]
    pos = planes[[fused.BASE_PLANES.index(f"pos{c}") for c in range(3)]].T
    w2s = planes[rows].T.reshape(-1, 3, 4)
    lights = scene.lights
    verts = lights.vertices_world_space[:, :4].numpy()
    plane = lights.plane.numpy()
    out = {k: [] for k in ("pos", "world", "shading", "flipped", "light")}
    for i in range(4):
        side = pos @ plane[i, :3] + plane[i, 3]
        flip = np.where(side < 0.0, np.float32(-1.0), np.float32(1.0))
        local = np.einsum("pij,kj->pki", w2s[:, :, :3], verts[i]) \
            + w2s[:, None, :, 3]
        flipped = local.copy()
        flipped[..., 1] *= flip[:, None]
        for key, value in (("pos", pos), ("world", np.repeat(
                verts[i][None], CITY_PIXELS, 0)), ("shading", local),
                ("flipped", flipped),
                ("light", np.full(CITY_PIXELS, i))):
            out[key].append(value)
    return {k: np.concatenate(v).astype(np.float32 if k != "light"
                                        else np.int64)
            for k, v in out.items()}


@pytest.fixture(scope="module", params=SETS)
def inputs(request):
    """{world (P, n, 3) about pos (P, 3), shading (P, n, 3) about the
    origin, n, rnd (P, 2)} of one input set."""
    name = request.param
    if name == "city":
        pairs = _city_pairs()
        d = dict(world=pairs["world"], pos=pairs["pos"],
                 shading=pairs["flipped"], n=4)
    else:
        n = int(name[1:])
        rng = np.random.default_rng(n)
        d = dict(world=polygons(n, seed=100 + n, p=P, below=False),
                 pos=(rng.normal(size=(P, 3)) * 0.1).astype(np.float32),
                 shading=polygons(n, seed=200 + n, p=P), n=n)
    d["name"] = name
    d["rnd"] = quantized_noise((d["world"].shape[0], 2),
                               300 + SETS.index(name))
    clipped, count = jax_clip(d["shading"], d["n"])
    d["clipped"], d["count"] = clipped, count
    d["live"] = count > 0
    return d


def test_clip_polygon(inputs):
    n, clipped, count = inputs["n"], inputs["clipped"], inputs["count"]
    got, got_count = clipping.clip_polygon(t(inputs["shading"]), n)
    np.testing.assert_array_equal(got_count.numpy(), count)
    assert got.shape[1] == n + 1
    check(got, clipped[:, :n + 1], "clipped vertices")
    if inputs["name"] != "city":
        # Fully clipped, unclipped and horizon-crossing polygons occur.
        assert (count == 0).any() and (count == n).any() \
            and ((count > 0) & (count != n)).any()


def test_solve_cubic():
    rng = np.random.default_rng(3)
    coeffs = rng.normal(size=(4 * P, 4)).astype(np.float32)
    want_roots, want_three = j_cubic.solve_cubic(jnp.asarray(coeffs))
    roots, three = cubic.solve_cubic(t(coeffs))
    np.testing.assert_array_equal(three.numpy(), np.asarray(want_three))
    assert 0.2 < three.float().mean() < 0.8
    check(roots[:, 0], np.asarray(want_roots)[:, 0], "root 0")
    check(roots[three], np.asarray(want_roots)[np.asarray(want_three)],
          "three roots")


def test_solid_angle(inputs):
    """About per-pixel positions (SOLID_ANGLE), and the clipped polygons
    about the origin (CLIPPED_SOLID_ANGLE)."""
    rnd, live = inputs["rnd"], inputs["live"]
    world = inputs["world"]
    clipped = inputs["clipped"][:, :inputs["n"] + 1]
    c3 = np.maximum(inputs["count"], 3).astype(np.int32)
    zeros = np.zeros_like(inputs["pos"])
    for label, verts, count, pos, rows in (
            ("world", world, world.shape[1], inputs["pos"], None),
            ("clipped", clipped, c3, zeros, live)):
        n = verts.shape[1]
        jp = jax.vmap(lambda v, c, x: j_sampling
                      .prepare_solid_angle_polygon_sampling(v, c, x))(
            padded(verts), jnp.broadcast_to(jnp.asarray(count),
                                            (verts.shape[0],)), pos)
        jd = jax.vmap(j_sampling.sample_solid_angle_polygon)(jp, rnd)
        want = dict(solid_angle=jp.solid_angle,
                    fan=np.asarray(jp.fan_solid_angles)[:, :n - 2],
                    samples=jd)

        def port(x):
            tp = sampling.prepare_solid_angle_polygon_sampling(
                x(verts), count if isinstance(count, int)
                else t(count), x(pos))
            return dict(solid_angle=tp.solid_angle, fan=tp.fan_solid_angles,
                        samples=sampling.sample_solid_angle_polygon(
                            tp, x(rnd)))

        got, oracle = evaluate(inputs, port)
        compare(got, want, oracle, rows=rows)


@pytest.mark.parametrize("biased", [False, True], ids=["psa", "biased"])
def test_projected_solid_angle(inputs, biased):
    n, live, rnd = inputs["n"], inputs["live"], inputs["rnd"]
    clipped, count = inputs["clipped"], inputs["count"]
    m = n + 1
    jp = jax.vmap(lambda v, c: j_sampling
                  .prepare_projected_solid_angle_polygon_sampling(
                      v, jnp.maximum(c, 3), biased=biased))(clipped, count)
    jd = jax.vmap(lambda q, r: j_sampling.sample_projected_solid_angle_polygon(
        q, r, biased=biased))(jp, rnd)
    off = rotated(np.asarray(jd), 0.01)
    want = dict(psa=jp.projected_solid_angle,
                sector_psa=np.asarray(jp.sector_psa)[:, :m],
                vertices=np.asarray(jp.vertices)[:, :m],
                inner_ellipse_0=jp.inner_ellipse_0, samples=jd)
    if not biased:
        want["errors"] = jax.vmap(
            j_sampling.compute_projected_solid_angle_polygon_sampling_error)(
                jp, rnd, off)

    def port(x):
        tp = sampling.prepare_projected_solid_angle_polygon_sampling(
            x(clipped[:, :m]), t(count), biased)
        out = dict(psa=tp.projected_solid_angle, sector_psa=tp.sector_psa,
                   vertices=tp.vertices, inner_ellipse_0=tp.inner_ellipse_0,
                   samples=sampling.sample_projected_solid_angle_polygon(
                       tp, x(rnd), biased),
                   central=sampling.is_central_case(tp))
        if not biased:
            out["errors"] = sampling \
                .compute_projected_solid_angle_polygon_sampling_error(
                    tp, x(rnd), x(off))
        return out

    got, _ = evaluate(inputs, port)
    central = got.pop("central").numpy()
    want_central = np.asarray(jp.inner_ellipse_0)[:, 0] > 0.0
    assert (central == want_central)[live].mean() >= THRESHOLD
    if inputs["name"] != "city":
        assert 0 < central[live].mean() < 1, "central and decentral occur"
    compare(got, want, rows=live)


def _urena_frames(inputs):
    """[(corner, side lengths, axes (3, 3), pixel rows)]: the city's four
    quad lights, or one seeded rectangle."""
    if inputs["name"] == "city":
        lights = lights_from_specs(bench.lights(), "cpu")
        count = CITY_PIXELS
        return [(lights.translation[i].numpy(),
                 np.float32(lights.scaling_x[i]),
                 np.float32(lights.scaling_y[i]),
                 lights.rotation[i].numpy(),
                 slice(i * count, (i + 1) * count)) for i in range(4)]
    rng = np.random.default_rng(inputs["n"])
    axes = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    return [(np.array([-0.4, 0.3, 1.2], np.float32), np.float32(0.9),
             np.float32(0.6), axes, slice(None))]


URENA_FIELDS = ("solid_angle", "k", "b0", "b1", "x0", "y0", "z0")


def test_urena(inputs):
    for s, exl, eyl, axes, rows in _urena_frames(inputs):
        pos, rnd = inputs["pos"][rows], inputs["rnd"][rows]
        ax, ay, az = (np.ascontiguousarray(axes[:, c]) for c in range(3))
        jsq = jax.vmap(lambda o: j_related
                       .prepare_solid_angle_rectangle_sampling_urena(
                           s, exl * ax, eyl * ay, exl, eyl, ax, ay, az, o))(
            pos)
        want = {f: getattr(jsq, f) for f in URENA_FIELDS}
        want["samples"] = jax.vmap(
            j_related.sample_solid_angle_rectangle_urena)(jsq, rnd)

        def port(x):
            sq = related.prepare_solid_angle_rectangle_sampling_urena(
                x(s), x(exl), x(eyl), x(ax), x(ay), x(az), x(pos))
            out = {f: getattr(sq, f) for f in URENA_FIELDS}
            out["samples"] = related.sample_solid_angle_rectangle_urena(
                sq, x(rnd))
            return out

        got, oracle = evaluate(inputs, port, unstable=True)
        compare(got, want, oracle)


def test_arvo_solid_angle(inputs):
    rnd, world, pos = inputs["rnd"], inputs["world"], inputs["pos"]
    n = world.shape[1]
    jp = jax.vmap(lambda v, x: j_related
                  .prepare_solid_angle_polygon_sampling_arvo(
                      v, jnp.int32(n), x))(padded(world), pos)
    want = dict(solid_angle=jp.solid_angle,
                fan=np.asarray(jp.fan_solid_angles)[:, :n - 2],
                opposite=np.asarray(jp.opposite_dirs)[:, :n - 2],
                samples=jax.vmap(j_related.sample_solid_angle_polygon_arvo)(
                    jp, rnd))

    def port(x):
        tp = related.prepare_solid_angle_polygon_sampling_arvo(
            x(world), n, x(pos))
        return dict(solid_angle=tp.solid_angle, fan=tp.fan_solid_angles,
                    opposite=tp.opposite_dirs,
                    samples=related.sample_solid_angle_polygon_arvo(
                        tp, x(rnd)))

    got, oracle = evaluate(inputs, port, unstable=True)
    compare(got, want, oracle)


@pytest.mark.parametrize("warp", ["bilinear", "biquadratic"])
def test_hart(inputs, warp):
    n, live, rnd = inputs["n"], inputs["live"], inputs["rnd"]
    c3 = np.maximum(inputs["count"], 3).astype(np.int32)
    clipped = inputs["clipped"]
    name = f"{warp}_cosine_warp_polygon"
    fields = ("density_0", "density_1") + (
        ("density_2",) if warp == "biquadratic" else ())
    jw = jax.vmap(getattr(j_related, f"prepare_{name}_sampling_hart"))(
        clipped, c3)
    jd, jdens = jax.vmap(getattr(j_related, f"sample_{name}_hart"))(jw, rnd)
    want = {f: getattr(jw, f) for f in fields}
    want.update(solid_angle=jw.polygon.solid_angle, samples=jd,
                density=jdens)

    def port(x):
        w = getattr(related, f"prepare_{name}_sampling_hart")(
            x(clipped[:, :n + 1]), t(c3))
        d, dens = getattr(related, f"sample_{name}_hart")(w, x(rnd))
        out = {f: getattr(w, f) for f in fields}
        out.update(solid_angle=w.polygon.solid_angle, samples=d,
                   density=dens)
        return out

    got, oracle = evaluate(inputs, port)
    compare(got, want, oracle, rows=live)


def test_arvo_psa(inputs):
    n, live, rnd = inputs["n"], inputs["live"], inputs["rnd"]
    clipped, count = inputs["clipped"], inputs["count"]
    m = n + 1
    jp = jax.vmap(lambda v, c: j_arvo
                  .prepare_projected_solid_angle_polygon_sampling_arvo(
                      v, jnp.maximum(c, 3)))(clipped, count)
    jd = jax.vmap(functools.partial(
        j_arvo.sample_projected_solid_angle_polygon_arvo,
        iteration_count=3))(jp, rnd)
    off = rotated(np.asarray(jd), 0.03)
    want = dict(
        psa=jp.projected_solid_angle,
        sector_psa=np.asarray(jp.sector_psa)[:, :m],
        azimuths=np.asarray(jp.vertex_azimuths)[:, :m],
        inner_cdf=jp.inner_cdf, samples=jd,
        errors=jax.vmap(
            j_arvo.compute_projected_solid_angle_polygon_sampling_error_arvo)(
                jp, rnd, off))

    def port(x):
        tp = arvo.prepare_projected_solid_angle_polygon_sampling_arvo(
            x(clipped[:, :m]), t(count))
        return dict(
            psa=tp.projected_solid_angle, sector_psa=tp.sector_psa,
            azimuths=tp.vertex_azimuths, inner_cdf=tp.inner_cdf,
            samples=arvo.sample_projected_solid_angle_polygon_arvo(
                tp, x(rnd)),
            errors=arvo
            .compute_projected_solid_angle_polygon_sampling_error_arvo(
                tp, x(rnd), x(off)))

    got, oracle = evaluate(inputs, port, unstable=True)
    compare(got, want, oracle, threshold=ARVO_PSA_THRESHOLD, rows=live)


def test_turk(inputs):
    """Uniform area samples of the lights: the city's four quads, or
    seeded regular polygons of 3-7 vertices."""
    if inputs["name"] == "city":
        port_specs = bench.lights()
        specs = to_jax(port_specs)
    else:
        specs = light_specs((3, 4, inputs["n"], 7))
        port_specs = to_port(specs)
    jl = stack_lights([update_polygonal_light(s) for s in specs])
    tl = lights_from_specs(port_specs, "cpu")
    rnd = inputs["rnd"]
    for i, spec in enumerate(specs):
        nv = spec.vertex_count
        verts = jl.vertices_world_space[i]
        jverts = jnp.concatenate(
            [verts, jnp.broadcast_to(verts[0], (8 - verts.shape[0], 3))])
        want = jax.vmap(lambda r: j_shading._sample_area_polygon_turk(
            jnp.int32(nv), jverts, jl.fan_areas[i], r))(rnd)
        got = shading._sample_area_polygon_turk(
            nv, tl.vertices_world_space[i], tl.fan_areas[i], t(rnd))
        check(got, want, f"light {i} ({nv} vertices)")


@pytest.mark.parametrize("path", OWN_FORMULATION)
def test_per_pixel_modules_import_no_soa_library(path):
    """The per-pixel path carries its own formulation: these modules
    import nothing from ops/soa.py, ops/soa_techniques.py or
    ops/soa_arvo_psa.py."""
    tree = ast.parse((PORT / path).read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[-1])
            imported.update(a.name.split(".")[-1] for a in node.names)
        elif isinstance(node, ast.Import):
            imported.update(a.name.split(".")[-1] for a in node.names)
    assert not imported & SOA_MODULES, (path, imported & SOA_MODULES)
