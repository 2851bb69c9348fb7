"""Blinn's numerically stable cubic solver for the per-pixel path.

Counterpart of vulkan_renderer_tpu/ops/cubic.py (reference
cubic_solver.glsl:29-76): the same branchless formula, on a batch of
polynomials, through the structure-of-arrays solver that K4's plain
version runs (ops/soa_techniques.py solve_cubic_soa).
"""

from __future__ import annotations

import torch

from .soa_techniques import solve_cubic_soa


def solve_cubic(coeffs):
    """coeffs: (..., 4) with polynomial c0 + c1 x + c2 x^2 + c3 x^3.
    Returns (roots (..., 3), three_real (...,) bool); without three real
    roots only roots[..., 0] is meaningful (the others repeat it)."""
    r0, r1, r2, three_real = solve_cubic_soa(
        coeffs[..., 0], coeffs[..., 1], coeffs[..., 2], coeffs[..., 3])
    return torch.stack([r0, r1, r2], dim=-1), three_real
