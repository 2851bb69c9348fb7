"""The per-pixel path's ops modules against the JAX package's per-pixel
functions, vmapped: clipping, the cubic solver, MIS, the BRDF and GGX
sampling, solid angle and projected solid angle sampling with their error
estimates, the related-work samplers (Urena, Arvo solid angle, Hart
bilinear and biquadratic) and Arvo's PSA sampler. Inputs are seeded
numpy polygons in shading space (some below or across the horizon),
directions and UNORM16-quantized random numbers, handed to both packages.

Tolerances, stated per check: float32 results agree within a few 1e-6
relative where the two packages differ only in rounding (the port writes
the JAX per-pixel formulas, batched with gathers where the JAX package
selects lanes one-hot; XLA contracts multiply-adds into FMAs and its
rsqrt, cos, sin and atan2 round apart from torch's). Samples agree for
>= 99% of random numbers (a sample at a sector or fan boundary may land
in the neighbour), Arvo's PSA samples for >= 98% (its sector choice
flips with the rounding, test_torch_arvo_psa_gap.py). The
error estimates of the iterative PSA inversion are rounding residuals of
the sampled area at the sampler's own samples: there they agree in size
(within 2^-14 of the projected solid angle), and the forward error's
factor, the norm of the inversion's derivative, agrees by value (1e-3
relative for >= 99%). Handed one set of directions rotated off the samples,
so that the residual is a few percent of the projected solid angle, every
error component agrees by value: PSA within 1e-4 relative, Arvo's PSA for
>= 99% within 5e-3 (its azimuths' atan2 rounds apart)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_shading_inputs import quantized_noise
from vulkan_renderer_tpu import MAX_POLYGON_VERTEX_COUNT as MAXV
from vulkan_renderer_tpu.ops import brdf as j_brdf
from vulkan_renderer_tpu.ops import clipping as j_clipping
from vulkan_renderer_tpu.ops import cubic as j_cubic
from vulkan_renderer_tpu.ops import mis as j_mis
from vulkan_renderer_tpu.ops import sampling as j_sampling
from vulkan_renderer_tpu.ops import sampling_arvo_psa as j_arvo
from vulkan_renderer_tpu.ops import sampling_related as j_related
from vulkan_renderer_tpu_torch.ops import brdf, clipping, cubic, mis
from vulkan_renderer_tpu_torch.ops import sampling
from vulkan_renderer_tpu_torch.ops import sampling_arvo_psa as arvo
from vulkan_renderer_tpu_torch.ops import sampling_related as related
from vulkan_renderer_tpu_torch.render.shading import ShadingData

P = 512


def polygons(n, seed, p=P, below=True):
    """(p, n, 3) convex polygons facing the origin, clockwise as seen
    from it; with below, centers reach under the horizon."""
    rng = np.random.default_rng(seed)
    out = np.empty((p, n, 3), np.float32)
    for i in range(p):
        c = rng.normal(size=3)
        c[2] = rng.uniform(-0.4 if below else 0.2, 1.5)
        c /= np.linalg.norm(c)
        helper = np.array([0.0, 1.0, 0.0]) if abs(c[0]) > 0.9 \
            else np.array([1.0, 0.0, 0.0])
        u = np.cross(helper, c)
        u /= np.linalg.norm(u)
        v = np.cross(c, u)
        angles = (np.arange(n) + rng.uniform(0.2, 0.8, n)) * (2 * np.pi / n)
        dist = rng.uniform(1.0, 3.0)
        out[i] = dist * c + rng.uniform(0.3, 1.2) * (
            np.cos(angles)[:, None] * u + np.sin(angles)[:, None] * v)
    return out


def padded(verts):
    pad = MAXV - verts.shape[1]
    return np.concatenate([verts, np.repeat(verts[:, :1], pad, 1)], axis=1)


def jax_clip(verts, n):
    out, count = jax.vmap(lambda v: j_clipping.clip_polygon(
        jnp.asarray(v), jnp.int32(n)))(padded(verts))
    return np.asarray(out), np.asarray(count)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rotated(dirs, angle):
    """(P, 3) directions rotated by `angle` about the z axis: off the
    sampler's samples, at the same elevation."""
    c, s = np.cos(angle), np.sin(angle)
    out = np.array(dirs, np.float32)
    out[:, 0] = c * dirs[:, 0] - s * dirs[:, 1]
    out[:, 1] = s * dirs[:, 0] + c * dirs[:, 1]
    return out


def close_share(got, want, rtol, atol):
    """Share of entries (rows of the last axis for vectors) within
    atol + rtol |want|; NaN matches NaN."""
    got, want = np.asarray(got), np.asarray(want)
    ok = np.isclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
    if ok.ndim > 1:
        ok = ok.all(axis=-1)
    return float(ok.mean())


@pytest.mark.parametrize("n", [3, 7])
def test_clipping_matches_reference(n):
    verts = polygons(n, seed=n)
    want, want_count = jax_clip(verts, n)
    got, count = clipping.clip_polygon(t(verts), n)
    np.testing.assert_array_equal(count.numpy(), want_count)
    assert 0 < (want_count == 0).sum() and (want_count == n + 1).sum() > 0
    # Lanes 0..n: the polygon, then the first vertex repeated (zeros when
    # fully clipped). The intersection point is one formula in both.
    np.testing.assert_allclose(got.numpy(), want[:, :n + 1], rtol=1e-6,
                               atol=1e-6)


def test_cubic_matches_reference():
    rng = np.random.default_rng(3)
    coeffs = rng.normal(size=(P, 4)).astype(np.float32)
    want_roots, want_three = j_cubic.solve_cubic(jnp.asarray(coeffs))
    roots, three = cubic.solve_cubic(t(coeffs))
    np.testing.assert_array_equal(three.numpy(), np.asarray(want_three))
    assert 0.2 < three.float().mean() < 0.8
    # atan2/cos/sin round apart and the cube root is another float32
    # formula (|x|^(1/3)): 1e-4 relative to the roots' scale.
    scale = np.abs(np.asarray(want_roots)).max(axis=-1, keepdims=True)
    assert np.all(np.abs(roots.numpy() - np.asarray(want_roots))
                  <= 1e-4 * np.maximum(scale, 1.0))


def test_mis_matches_reference():
    rng = np.random.default_rng(4)
    sd, od = rng.uniform(0.01, 3.0, (2, P)).astype(np.float32)
    sw, ow, integrand = rng.uniform(0.0, 2.0, (3, P, 3)).astype(np.float32)
    for h in mis.MisHeuristic:
        jh = j_mis.MisHeuristic(h.value)
        if h in (mis.MisHeuristic.BALANCE, mis.MisHeuristic.POWER):
            np.testing.assert_allclose(
                mis.mis_weight_over_density(h, t(sd), t(od)).numpy(),
                np.asarray(j_mis.mis_weight_over_density(jh, sd, od)),
                rtol=1e-6)
        want = j_mis.mis_estimate(jh, True, integrand, sw, sd[:, None], ow,
                                  od[:, None], 0.5)
        got = mis.mis_estimate(h, t(integrand), t(sw), t(sd), t(ow), t(od),
                               0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=1e-6, err_msg=h.value)


def _shading_data(rng):
    normal = rng.normal(size=(P, 3)).astype(np.float32)
    normal[:, 2] = np.abs(normal[:, 2]) + 0.3
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    out = rng.normal(size=(P, 3)).astype(np.float32) + normal
    out /= np.linalg.norm(out, axis=-1, keepdims=True)
    fields = dict(
        position=rng.normal(size=(P, 3)).astype(np.float32), normal=normal,
        outgoing=out, lambert_outgoing=np.sum(normal * out, axis=-1),
        diffuse_albedo=rng.uniform(0, 1, (P, 3)).astype(np.float32),
        fresnel_0=rng.uniform(0.02, 0.9, (P, 3)).astype(np.float32),
        roughness=rng.uniform(0.01, 1.0, P).astype(np.float32))
    return fields


def test_brdf_and_ggx_sampling_match_reference():
    rng = np.random.default_rng(5)
    fields = _shading_data(rng)
    jdata = j_brdf.ShadingData(**{k: jnp.asarray(v)
                                  for k, v in fields.items()})
    data = ShadingData(**{k: t(v) for k, v in fields.items()})
    incoming = rng.normal(size=(P, 3)).astype(np.float32)
    incoming /= np.linalg.norm(incoming, axis=-1, keepdims=True)
    for diffuse, specular in ((True, True), (True, False), (False, True)):
        got = brdf.evaluate_brdf(data, t(incoming), diffuse, specular)
        want = j_brdf.evaluate_brdf(jdata, incoming, diffuse, specular)
        # Smith's masking + shadowing cancels near grazing incidence,
        # where XLA's contracted FMAs round differently: 99% within
        # 2e-5, all within 1e-2 relative.
        assert close_share(got.numpy(), want, 2e-5, 1e-7) >= 0.99
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2,
                                   atol=1e-7)
    rnd = quantized_noise((P, 2), 6)
    out_shading = fields["outgoing"]
    rough = fields["roughness"]
    jd, jdens = j_brdf.sample_ggx_reflected_direction(out_shading, rough,
                                                      rnd)
    d, dens = brdf.sample_ggx_reflected_direction(t(out_shading), t(rough),
                                                  t(rnd))
    # cos/sin of the azimuth are other float32 formulas: 1e-5.
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=2e-5)
    np.testing.assert_allclose(dens.numpy(), np.asarray(jdens), rtol=1e-3,
                               atol=1e-6)
    jm = j_brdf.sample_ggx_visible_normal(out_shading, np.stack(
        [rough, rough], -1), rnd)
    m = brdf.sample_ggx_visible_normal(t(out_shading), torch.stack(
        [t(rough), t(rough)], -1), t(rnd))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=2e-5)
    want = j_brdf.ggx_reflected_direction_density(
        fields["lambert_outgoing"], fields["outgoing"], incoming,
        fields["normal"], rough)
    got = brdf.ggx_reflected_direction_density(
        data.lambert_outgoing, data.outgoing, t(incoming), data.normal,
        data.roughness)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("n", [4, 7])
def test_sampling_matches_reference(n):
    """Solid angle about per-pixel shading positions; PSA (unbiased and
    biased) of the clipped polygons, their samples and error estimates."""
    verts = polygons(n, seed=10 + n)
    rnd = quantized_noise((P, 2), 7 + n)
    rng = np.random.default_rng(n)
    pos = (rng.normal(size=(P, 3)) * 0.1).astype(np.float32)

    jpoly = jax.vmap(lambda v, x: j_sampling
                     .prepare_solid_angle_polygon_sampling(
                         jnp.asarray(v), jnp.int32(n), x))(padded(verts), pos)
    poly = sampling.prepare_solid_angle_polygon_sampling(t(verts), n, t(pos))
    np.testing.assert_allclose(poly.solid_angle.numpy(),
                               np.asarray(jpoly.solid_angle), rtol=1e-5)
    jd = jax.vmap(j_sampling.sample_solid_angle_polygon)(jpoly, rnd)
    d = sampling.sample_solid_angle_polygon(poly, t(rnd))
    assert close_share(d.numpy(), jd, 1e-4, 1e-4) >= 0.99

    clipped, count = jax_clip(verts, n)
    live = count > 0
    for biased in (False, True):
        jpsa = jax.vmap(lambda v, c: j_sampling
                        .prepare_projected_solid_angle_polygon_sampling(
                            v, jnp.maximum(c, 3), biased=biased))(
            clipped, count)
        psa = sampling.prepare_projected_solid_angle_polygon_sampling(
            t(clipped[:, :n + 1]), t(count), biased)
        want_psa = np.asarray(jpsa.projected_solid_angle)
        np.testing.assert_allclose(
            psa.projected_solid_angle.numpy()[live], want_psa[live],
            rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(
            sampling.is_central_case(psa).numpy()[live],
            (np.asarray(jpsa.inner_ellipse_0)[:, 0] > 0.0)[live])
        jdir = jax.vmap(lambda q, r: j_sampling
                        .sample_projected_solid_angle_polygon(
                            q, r, biased=biased))(jpsa, rnd)
        dirs = sampling.sample_projected_solid_angle_polygon(psa, t(rnd),
                                                             biased)
        assert close_share(dirs.numpy()[live], np.asarray(jdir)[live],
                           1e-3, 1e-4) >= 0.99
        if biased:
            continue
        jerr = np.asarray(jax.vmap(
            j_sampling.compute_projected_solid_angle_polygon_sampling_error)(
                jpsa, rnd, jdir))
        err = sampling.compute_projected_solid_angle_polygon_sampling_error(
            psa, t(rnd), dirs).numpy()
        central = sampling.is_central_case(psa).numpy()
        assert np.all(err[central] == 0.0)
        assert np.all(jerr[central & live] == 0.0)
        # Backward errors: rounding residuals of the sampled area; the
        # same share of them (>= 98%) within 2^-14 of the projected solid
        # angle in both packages.
        dec = live & ~central & (rnd[:, 0] > 1e-3) & (rnd[:, 0] < 1 - 1e-3)
        assert dec.sum() > 50
        for e in (err, jerr):
            assert (np.abs(e[dec, 1]) <= 2.0 ** -14 * want_psa[dec]).mean() \
                >= 0.98
        np.testing.assert_allclose(err[dec, 0] * want_psa[dec],
                                   err[dec, 1], rtol=1e-5, atol=1e-12)
        # The forward error is |d direction / d area| times the scaled
        # backward error; that norm depends only on the sample, so it
        # agrees by value (1e-3 relative for >= 99%: the two samples
        # differ in rounding).
        nz = dec & (err[:, 1] != 0.0) & (jerr[:, 1] != 0.0)
        assert nz.sum() > 0.75 * dec.sum()
        assert close_share(err[nz, 2] / err[nz, 1], jerr[nz, 2] / jerr[nz, 1],
                           1e-3, 0.0) >= 0.99
        # Off the samples (rotated by 0.01 rad: residuals ~1.5% of the
        # PSA), all three components agree by value within 1e-4.
        off = rotated(np.asarray(jdir), 0.01)
        jerr = np.asarray(jax.vmap(
            j_sampling.compute_projected_solid_angle_polygon_sampling_error)(
                jpsa, rnd, off))
        err = sampling.compute_projected_solid_angle_polygon_sampling_error(
            psa, t(rnd), t(off)).numpy()
        assert np.median(np.abs(jerr[dec, 1]) / want_psa[dec]) > 1e-3
        np.testing.assert_allclose(err[dec], jerr[dec], rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("n", [4, 6])
def test_related_sampling_matches_reference(n):
    """Urena's rectangles (n == 4 lights), Arvo's solid angle, Hart's
    bilinear and biquadratic warps of clipped polygons."""
    rnd = quantized_noise((P, 2), 20 + n)
    rng = np.random.default_rng(30 + n)
    verts = polygons(n, seed=40 + n, below=False)
    pos = (rng.normal(size=(P, 3)) * 0.1).astype(np.float32)

    japoly = jax.vmap(lambda v, x: j_related
                      .prepare_solid_angle_polygon_sampling_arvo(
                          jnp.asarray(v), jnp.int32(n), x))(padded(verts), pos)
    apoly = related.prepare_solid_angle_polygon_sampling_arvo(t(verts), n,
                                                              t(pos))
    np.testing.assert_allclose(apoly.solid_angle.numpy(),
                               np.asarray(japoly.solid_angle), rtol=1e-5)
    jd = jax.vmap(j_related.sample_solid_angle_polygon_arvo)(japoly, rnd)
    d = related.sample_solid_angle_polygon_arvo(apoly, t(rnd))
    assert close_share(d.numpy(), jd, 1e-3, 1e-4) >= 0.99

    clipped, count = jax_clip(polygons(n, seed=50 + n), n)
    live = count > 0
    c3 = np.maximum(count, 3)
    for name in ("bilinear", "biquadratic"):
        jprep = getattr(j_related, f"prepare_{name}_cosine_warp_polygon_"
                                   "sampling_hart")
        jsample = getattr(j_related, f"sample_{name}_cosine_warp_polygon_"
                                     "hart")
        prep = getattr(related, f"prepare_{name}_cosine_warp_polygon_"
                                "sampling_hart")
        sample = getattr(related, f"sample_{name}_cosine_warp_polygon_hart")
        jw = jax.vmap(jprep)(clipped, c3)
        w = prep(t(clipped[:, :n + 1]), t(c3))
        np.testing.assert_allclose(
            w.polygon.solid_angle.numpy()[live],
            np.asarray(jw.polygon.solid_angle)[live], rtol=1e-5)
        jdir, jdens = jax.vmap(jsample)(jw, rnd)
        dirs, dens = sample(w, t(rnd))
        assert close_share(dirs.numpy()[live], np.asarray(jdir)[live],
                           1e-3, 1e-4) >= 0.99, name
        assert close_share(dens.numpy()[live], np.asarray(jdens)[live],
                           1e-3, 1e-6) >= 0.99, name

    # Urena: a rectangle with corner s and sides along two axes.
    axes = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    s = np.array([-0.4, 0.3, 1.2], np.float32)
    exl, eyl = np.float32(0.9), np.float32(0.6)
    jsq = jax.vmap(lambda o: j_related
                   .prepare_solid_angle_rectangle_sampling_urena(
                       s, exl * axes[:, 0], eyl * axes[:, 1], exl, eyl,
                       axes[:, 0], axes[:, 1], axes[:, 2], o))(pos)
    sq = related.prepare_solid_angle_rectangle_sampling_urena(
        t(s), torch.tensor(exl), torch.tensor(eyl), t(axes[:, 0].copy()),
        t(axes[:, 1].copy()), t(axes[:, 2].copy()), t(pos))
    np.testing.assert_allclose(sq.solid_angle.numpy(),
                               np.asarray(jsq.solid_angle), rtol=1e-5)
    jd = jax.vmap(j_related.sample_solid_angle_rectangle_urena)(jsq, rnd)
    d = related.sample_solid_angle_rectangle_urena(sq, t(rnd))
    assert close_share(d.numpy(), jd, 1e-3, 1e-4) >= 0.99


@pytest.mark.parametrize("n", [4, 7])
def test_arvo_psa_matches_reference(n):
    clipped, count = jax_clip(polygons(n, seed=60 + n), n)
    live = count > 0
    rnd = quantized_noise((P, 2), 61 + n)
    jpoly = jax.vmap(lambda v, c: j_arvo
                     .prepare_projected_solid_angle_polygon_sampling_arvo(
                         v, jnp.maximum(c, 3)))(clipped, count)
    poly = arvo.prepare_projected_solid_angle_polygon_sampling_arvo(
        t(clipped[:, :n + 1]), t(count))
    want_psa = np.asarray(jpoly.projected_solid_angle)
    # The azimuths' atan2 rounds apart (torch's, XLA's): 98% within 1e-4.
    assert close_share(poly.projected_solid_angle.numpy()[live],
                       want_psa[live], 1e-4, 1e-7) >= 0.98
    jd = jax.vmap(functools.partial(
        j_arvo.sample_projected_solid_angle_polygon_arvo,
        iteration_count=3))(jpoly, rnd)
    d = arvo.sample_projected_solid_angle_polygon_arvo(poly, t(rnd))
    assert close_share(d.numpy()[live], np.asarray(jd)[live], 1e-3,
                       1e-4) >= 0.98
    jerr = np.asarray(jax.vmap(
        j_arvo.compute_projected_solid_angle_polygon_sampling_error_arvo)(
            jpoly, rnd, jd))
    err = arvo.compute_projected_solid_angle_polygon_sampling_error_arvo(
        poly, t(rnd), d).numpy()
    central = arvo.is_central_case_arvo(poly).numpy()
    assert np.all(err[central] == 0.0)
    dec = live & ~central
    assert dec.sum() > 50
    # Arvo's Newton iteration converges to a few 1e-4 of the PSA at most;
    # the two packages' residuals are of that size.
    for e in (err, jerr):
        finite = dec & np.isfinite(e[:, 1])
        assert finite.mean() / dec.mean() >= 0.98
        assert np.quantile(np.abs(e[finite, 1]) / want_psa[finite],
                           0.95) <= 1e-3
    np.testing.assert_allclose(
        err[dec, 0] * poly.projected_solid_angle.numpy()[dec], err[dec, 1],
        rtol=1e-5, atol=1e-12)
    # Off the samples (rotated by 0.03 rad: residuals ~5% of the PSA),
    # both components agree by value: >= 99% within 5e-3 relative, all
    # within 5e-2 (the azimuths' atan2 roundings differ by ~1e-4 of the
    # PSA).
    off = rotated(np.asarray(jd), 0.03)
    jerr = np.asarray(jax.vmap(
        j_arvo.compute_projected_solid_angle_polygon_sampling_error_arvo)(
            jpoly, rnd, off))
    err = arvo.compute_projected_solid_angle_polygon_sampling_error_arvo(
        poly, t(rnd), t(off)).numpy()
    assert np.median(np.abs(jerr[dec, 1]) / want_psa[dec]) > 1e-2
    for k in range(2):
        assert close_share(err[dec, k], jerr[dec, k], 5e-3, 0.0) >= 0.99, k
        np.testing.assert_allclose(err[dec, k], jerr[dec, k], rtol=5e-2,
                                   atol=0.0)
