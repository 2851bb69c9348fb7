"""Blinn's numerically stable cubic solver for the per-pixel path.

Counterpart of vulkan_renderer_tpu/ops/cubic.py (reference
cubic_solver.glsl:29-76; Blinn 2007, "How to solve a cubic equation, part
5") as the JAX package writes it: both the three-real-root and the
one-real-root paths are evaluated and selected. The cube root is
sign(x) |x|^(1/3) (torch has no cbrt). K4's plain version runs its own
copy (ops/soa_techniques.py solve_cubic_soa).

Precision: the float type is the input's; the float64 evaluation takes
the other path only where the discriminant is within rounding of 0.
"""

from __future__ import annotations

import math

import torch


def _cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def solve_cubic(coeffs):
    """coeffs: (..., 4) with polynomial c0 + c1 x + c2 x^2 + c3 x^3.
    Returns (roots (..., 3), three_real (...,) bool); without three real
    roots only roots[..., 0] is meaningful (the others repeat it)."""
    c3 = coeffs[..., 3]
    c0 = coeffs[..., 0] / c3
    c1 = coeffs[..., 1] / (3.0 * c3)
    c2 = coeffs[..., 2] / (3.0 * c3)

    delta0 = -c2 * c2 + c1
    delta1 = -c1 * c2 + c0
    delta2 = c2 * c0 - c1 * c1
    discriminant = 4.0 * delta0 * delta2 - delta1 * delta1
    sqrt_abs_disc = torch.sqrt(torch.abs(discriminant))
    depressed0 = -2.0 * c2 * delta0 + delta1
    depressed1 = delta0

    # --- three real roots ----------------------------------------------------
    theta = torch.atan2(sqrt_abs_disc, -depressed0) * (1.0 / 3.0)
    cr_cos = torch.cos(theta)
    cr_sin = torch.sin(theta)
    sqrt_075 = math.sqrt(0.75)
    r1 = -sqrt_075 * cr_sin - 0.5 * cr_cos
    r2 = sqrt_075 * cr_sin - 0.5 * cr_cos
    scale = (2.0 * torch.sqrt(torch.clamp(-depressed1, min=0.0)))[..., None]
    roots3 = torch.stack([cr_cos, r1, r2], dim=-1) * scale - c2[..., None]

    # --- one real root -------------------------------------------------------
    signed_sqrt = torch.where(depressed0 < 0.0, sqrt_abs_disc, -sqrt_abs_disc)
    quadratic_root = 0.5 * (signed_sqrt - depressed0)
    cube0 = _cbrt(quadratic_root)
    nonzero = cube0 != 0.0
    cube1 = torch.where(nonzero,
                        -depressed1 / torch.where(nonzero, cube0, 1.0), 0.0)
    root1 = (cube0 + cube1 - c2)[..., None].expand(roots3.shape)

    three_real = discriminant >= 0.0
    roots = torch.where(three_real[..., None], roots3, root1)
    return roots, three_real
