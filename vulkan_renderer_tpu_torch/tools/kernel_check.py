"""Holding a kernel's output against its plain version's, on any device.

Used by chip_smoke.py and tests/test_torch_gpu.py on the card: the
kernels and their plain PyTorch versions run the same float32 operations
in the same order (the kernels are built with --fmad=false), so most
values agree bit for bit; where a transcendental or rsqrt instruction
differs by an ulp, a sample can cross a sector or fan boundary and that
one value moves. compare() counts both; compare_planes() holds K6's
planes value by value.
"""

from __future__ import annotations

import torch

from ..render.fused import BASE_PLANES, rays_per_light, vertex_groups


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


def bit_mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """The values whose NaN-ness differs, or that are NaN in neither and
    differ in any bit (+0 and -0 differ)."""
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    bits_off = (got.view(torch.int32) != want.view(torch.int32)) \
        & ~nan_got & ~nan_want
    return int(((nan_got != nan_want) | bits_off).sum())


def compare_planes(got: torch.Tensor, want: torch.Tensor) -> dict:
    """K6's (62, P) planes against its plain version's: the values whose
    NaN-ness differs, the values NaN in neither that differ in any bit,
    and per plane (BASE_PLANES names) the values either way off and the
    largest distance in ulps between values finite in both."""
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    nan_off = nan_got != nan_want
    bits_got = got.view(torch.int32).to(torch.int64)
    bits_want = want.view(torch.int32).to(torch.int64)
    bits_off = (bits_got != bits_want) & ~nan_got & ~nan_want
    finite = torch.isfinite(got) & torch.isfinite(want)
    # Within one sign the bit patterns count ulps; across signs, add both
    # distances from zero.
    ulps = torch.where(
        (bits_got < 0) == (bits_want < 0), (bits_got - bits_want).abs(),
        (bits_got & 0x7FFFFFFF) + (bits_want & 0x7FFFFFFF))
    ulps = torch.where(finite, ulps, 0)
    off = (nan_off | bits_off).sum(dim=1).tolist()
    worst = ulps.amax(dim=1).tolist() if ulps.numel() else [0] * len(off)
    return {"values": got.numel(), "nan_mismatch": int(nan_off.sum()),
            "bit_mismatch": int(bits_off.sum()),
            "planes": {BASE_PLANES[k]: {"off": n, "max_ulps": worst[k]}
                       for k, n in enumerate(off) if n}}


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
