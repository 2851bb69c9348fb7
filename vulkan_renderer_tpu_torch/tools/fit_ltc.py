"""LTC table fitting: the GGX specular lobe as linearly transformed cosines.

Counterpart of vulkan_renderer_tpu/tools/fit_ltc.py. The reference ships
precomputed fit<i>.dat tables (ltc_table.c); this fits equivalent ones
from scratch, every (fresnel, inclination, roughness) texel at once: one
parameter tensor (..., 4) and a hand-written Adam update over the summed
per-texel losses, whose gradients are independent per texel.

Model: the forward LTC transform M = [[m00, 0, m02], [0, m11, 0],
[m20, 0, 1]] (the file format's four parameters, plus the albedo); the
fitted density is evaluated through M's analytic inverse, as the renderer
evaluates it. The BRDF is ops/brdf.py's. Nothing is random: the
evaluation directions are a Fibonacci hemisphere and VNDF samples at
fixed low-discrepancy numbers.

Output: fit<i>.dat files that assets/ltc_table.py load_ltc_table_files
reads (save_ltc_table_files). Accuracy only affects MIS variance, never
bias.

    python -m vulkan_renderer_tpu_torch.tools.fit_ltc \
        [--output data/ltc_fits] [--device cuda]
"""

from __future__ import annotations

import argparse
import types

import numpy as np
import torch
import torch.nn.functional as F

from ..assets.ltc_table import save_ltc_table_files
from ..core.device import get_device
from ..ops.brdf import evaluate_brdf, sample_ggx_reflected_direction
from ..ops.math_utils import M_HALF_PI, M_PI

MIN_ROUGHNESS = 0.0064


def inv_softplus(y):
    return torch.log(torch.expm1(torch.clamp(y, min=1e-4)))


def fibonacci_hemisphere(count: int) -> np.ndarray:
    """Deterministic, roughly uniform hemisphere directions (z >= 0)."""
    i = np.arange(count) + 0.5
    z = i / count                       # uniform in z: uniform solid angle
    phi = i * (np.pi * (3.0 - np.sqrt(5.0)))
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], -1) \
        .astype(np.float32)


def texel_parameters(resolution: int = 32, fresnel_count: int = 8):
    """(f0, roughness, inclination), each (fresnel_count, resolution,
    resolution) float32: texel centers inverted through the texture
    coordinate transforms (ltc_table.c:184-192), axes (fresnel,
    inclination, sqrt-roughness) as the fit files lay them out."""
    tex = (np.arange(resolution) + 0.5) / resolution
    rough_factor = (resolution - 1) / resolution
    rough_summand = 0.5 / resolution
    sqrt_rough = np.clip((tex - rough_summand) / rough_factor, 0.0, 1.0)
    roughness = (sqrt_rough ** 2).astype(np.float32)
    incl_factor = (resolution - 1) / (M_HALF_PI * resolution)
    incl_summand = 0.5 / resolution
    inclination = ((tex - incl_summand) / incl_factor).astype(np.float32)
    f0 = np.linspace(0.0, 1.0, fresnel_count).astype(np.float32)
    grid = np.meshgrid(f0, inclination, roughness, indexing="ij")
    return grid[0], grid[2], grid[1]


def brdf_cos(f0, roughness, inclination, directions):
    """Specular BRDF times the clamped cosine at `directions` (..., S, 3)
    for texels (...,) in shading space (normal +z, outgoing in xz)."""
    outgoing = torch.stack([torch.sin(inclination), 0.0 * inclination,
                            torch.cos(inclination)], dim=-1)[..., None, :]
    normal = torch.zeros_like(outgoing)
    normal[..., 2] = 1.0
    data = types.SimpleNamespace(
        normal=normal,
        outgoing=outgoing,
        lambert_outgoing=torch.cos(inclination)[..., None],
        diffuse_albedo=torch.zeros_like(outgoing),
        fresnel_0=torch.stack([f0, f0, f0], dim=-1)[..., None, :],
        roughness=torch.clamp(roughness, min=MIN_ROUGHNESS)[..., None])
    values = evaluate_brdf(data, directions, diffuse=False,
                           specular=True)[..., 0]
    return values * torch.clamp(directions[..., 2], min=0.0)


def ltc_density(params, directions):
    """(LTC density at directions (..., S, 3), m00 - m02 m20 (...,)) of
    parameters (..., 4) = (raw m00, m02, raw m11, m20)."""
    m00 = F.softplus(params[..., 0]) + 1e-4
    m02 = params[..., 1]
    m11 = F.softplus(params[..., 2]) + 1e-4
    m20 = params[..., 3]
    # Analytic inverse of [[m00, 0, m02], [0, m11, 0], [m20, 0, 1]]; det2
    # is clamped positive, the loss's barrier keeps it away from 0.
    det2 = torch.clamp(m00 - m02 * m20, min=1e-5)
    zero, one = torch.zeros_like(m00), torch.ones_like(m00)
    inv = torch.stack([
        torch.stack([one, zero, -m02], dim=-1),
        torch.stack([zero, det2 / m11, zero], dim=-1),
        torch.stack([-m20, zero, m00], dim=-1)], dim=-2) \
        / det2[..., None, None]
    dc = directions @ inv.transpose(-1, -2)
    len_sq = torch.sum(dc * dc, dim=-1)
    det_inv = torch.abs(torch.linalg.det(inv))[..., None]
    density = torch.clamp(dc[..., 2], min=0.0) * det_inv / (len_sq * len_sq)
    return torch.clamp(density * (1.0 / M_PI), min=0.0), m00 - m02 * m20


def fit_loss(params, directions, target):
    """Per-texel loss (...,): L2 between square roots (the peak
    compressed so the wings count) plus a barrier against det <= 0."""
    model, det2_raw = ltc_density(params, directions)
    fit = torch.mean((torch.sqrt(model + 1e-6)
                      - torch.sqrt(target + 1e-6)) ** 2, dim=-1)
    barrier = torch.clamp(0.05 - det2_raw, min=0.0) ** 2 * 100.0
    return fit + barrier


def fit_problem(f0, roughness, inclination, sample_count: int):
    """(evaluation directions (..., 2 S, 3), target (..., 2 S), albedo
    (...,), initial parameters (..., 4)) of texels (...,)."""
    shape = f0.shape
    device = f0.device
    i = torch.arange(sample_count, dtype=torch.float64, device=device) + 0.5
    vndf_rnd = torch.stack([i / sample_count,
                            (i * 0.6180339887498949) % 1.0], dim=-1) \
        .to(torch.float32)
    alpha_s = torch.clamp(roughness, MIN_ROUGHNESS, 1.0)
    outgoing = torch.stack([torch.sin(inclination), 0.0 * inclination,
                            torch.cos(inclination)], dim=-1)
    # Albedo and lobe-concentrated evaluation points by VNDF importance
    # sampling: resolves sharp lobes that a uniform grid cannot.
    vndf_dirs, vndf_pdf = sample_ggx_reflected_direction(
        outgoing[..., None, :].expand(*shape, sample_count, 3),
        alpha_s[..., None].expand(*shape, sample_count),
        vndf_rnd.expand(*shape, sample_count, 2))
    vndf_vals = brdf_cos(f0, roughness, inclination, vndf_dirs)
    good = (vndf_dirs[..., 2] > 0.0) & (vndf_pdf > 1e-8)
    albedo = torch.mean(torch.where(
        good, vndf_vals / torch.clamp(vndf_pdf, min=1e-8), 0.0), dim=-1)
    albedo = torch.clamp(albedo, 1e-4, 1.0)
    hemisphere = torch.from_numpy(fibonacci_hemisphere(sample_count)).to(
        device)
    directions = torch.cat([hemisphere.expand(*shape, sample_count, 3),
                            vndf_dirs], dim=-2)
    target = brdf_cos(f0, roughness, inclination, directions) \
        / albedo[..., None]
    # Start: isotropic scale ~ alpha, lobe tilted to the reflection.
    alpha = torch.clamp(roughness, min=MIN_ROUGHNESS)
    tilt = torch.tan(torch.clamp(inclination, max=1.4))
    params = torch.stack([inv_softplus(alpha), alpha * tilt,
                          inv_softplus(alpha), 0.0 * alpha], dim=-1)
    return directions, target, albedo, params


def fit_texels(f0, roughness, inclination, sample_count: int = 512,
               steps: int = 600, learning_rate: float = 0.02):
    """Records (..., 5) = (m00, m02, m11, m20, albedo) of texels (...,)
    (float32 tensors on one device), each fitted by `steps` Adam steps
    (the JAX tool's update: beta 0.9 / 0.999, eps 1e-8)."""
    with torch.no_grad():
        directions, target, albedo, params = fit_problem(
            f0, roughness, inclination, sample_count)
    m = torch.zeros_like(params)
    v = torch.zeros_like(params)
    for t in range(1, steps + 1):
        params.requires_grad_(True)
        loss = fit_loss(params, directions, target).sum()
        (g,) = torch.autograd.grad(loss, params)
        with torch.no_grad():
            params = params.detach()
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            m_hat = m / (1.0 - 0.9 ** t)
            v_hat = v / (1.0 - 0.999 ** t)
            params = params - learning_rate * m_hat / (torch.sqrt(v_hat)
                                                       + 1e-8)
    params = params.detach()
    return torch.stack([F.softplus(params[..., 0]) + 1e-4, params[..., 1],
                        F.softplus(params[..., 2]) + 1e-4, params[..., 3],
                        albedo], dim=-1)


def records_loss(records, f0, roughness, inclination,
                 sample_count: int = 512):
    """Per-texel loss (...,) of records (..., 5), as fit_texels minimizes
    it: the parameters are recovered from (m00, m02, m11, m20)."""
    directions, target, _, _ = fit_problem(f0, roughness, inclination,
                                           sample_count)
    params = torch.stack([inv_softplus(records[..., 0] - 1e-4),
                          records[..., 1],
                          inv_softplus(records[..., 2] - 1e-4),
                          records[..., 3]], dim=-1)
    return fit_loss(params, directions, target)


def fit_ltc_tables(resolution: int = 32, fresnel_count: int = 8,
                   sample_count: int = 512, steps: int = 600,
                   learning_rate: float = 0.02,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """Records (fresnel_count, resolution, resolution, 5) float32, laid
    out as the fit files: texel (y, x) with x the sqrt-roughness axis and
    y the inclination axis."""
    device = get_device(device)
    f0, roughness, inclination = (torch.from_numpy(a).to(device)
                                  for a in texel_parameters(resolution,
                                                            fresnel_count))
    records = fit_texels(f0, roughness, inclination, sample_count, steps,
                         learning_rate)
    return records.cpu().numpy().astype(np.float32)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--output", default="data/ltc_fits")
    parser.add_argument("--resolution", type=int, default=32)
    parser.add_argument("--fresnel-count", type=int, default=8)
    parser.add_argument("--samples", type=int, default=512)
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card) or cpu")
    args = parser.parse_args(argv)
    records = fit_ltc_tables(args.resolution, args.fresnel_count,
                             args.samples, args.steps, device=args.device)
    save_ltc_table_files(args.output, records)
    print(f"wrote LTC fits ({records.shape[0]} x {records.shape[1]} x "
          f"{records.shape[2]} texels) to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
