"""Holding a kernel's output against its plain version's, on any device.

Used by chip_smoke.py and tests/test_torch_gpu.py on the card: the
kernels and their plain PyTorch versions run the same float32 operations
in the same order (the kernels are built with --fmad=false), so most
values agree bit for bit; where a transcendental or rsqrt instruction
differs by an ulp, a sample can cross a sector or fan boundary and that
one value moves. compare() counts both.
"""

from __future__ import annotations

import torch

from ..render.fused import rays_per_light, vertex_groups


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Agreement of got with the reference want: exact share of finite
    reference values, share outside 1e-4 x (the row's largest |value|) +
    1e-3 x |value| (rows: the first axis), max |difference| and the
    count of values whose finiteness differs."""
    fin = torch.isfinite(want)
    nonfinite = int((fin != torch.isfinite(got)).sum())
    scale = torch.where(fin, want.abs(), 0.0).amax(
        dim=tuple(range(1, want.dim())) or None, keepdim=want.dim() > 1)
    diff = torch.where(fin, (got - want).abs(), 0.0)
    diff = torch.where(torch.isnan(diff), float("inf"), diff)
    outside = fin & (diff > 1e-4 * scale + 1e-3 * want.abs())
    count = max(int(fin.sum()), 1)
    return {"values": int(fin.sum()),
            "exact": float(((got == want) & fin).sum()) / count,
            "outside": float(outside.sum()) / count,
            "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
            "nonfinite_mismatch": nonfinite}


def k4_resolved(out: torch.Tensor, static, settings) -> torch.Tensor:
    """K4's (3 + 7 S, P) output resolved with visibility 1: K4's base plus,
    in K5's order, per light (0 + b_0 + b_1 + ...), lights in vertex-count
    groups, groups added in turn. Under DIFFUSE_ONLY the base is zero and
    this is K5's sum operation for operation; under DIFFUSE_SPECULAR_MIS
    K5 adds each light's base before its slots, so the two differ in the
    last bits. Returns (P, 3)."""
    ppl = rays_per_light(settings)
    p = out.shape[1]
    b = out[3:].reshape(static.light_count, ppl, 7, p)[:, :, 0:3]
    total = None
    for _, ids in vertex_groups(static):
        group = torch.zeros((3, p), device=out.device)
        for i in ids:
            bsum = torch.zeros((3, p), device=out.device)
            for q in range(ppl):
                bsum = bsum + b[i, q]
            group = group + bsum
        total = group if total is None else total + group
    return (out[0:3] + total).T
