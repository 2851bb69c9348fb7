"""Holding a kernel's output against its plain version's, on any device.

Used by the gpu-marked tests (tests/test_torch_gpu*.py) on the card: the
kernels and their plain PyTorch versions run the same float32 operations
in the same order (the kernels are built with --fmad=false), so most
values agree bit for bit; where a transcendental or rsqrt instruction
differs by an ulp, a sample can cross a sector or fan boundary and that
one value moves. compare() counts both; compare_planes() holds K6's
planes value by value; compare_closest() holds K2's primitive ids and hit
distances; hold_slot_entry() holds K1's slot entry on a pixel subset.
"""

from __future__ import annotations

import torch

from ..render import fused
from ..render import trace_kernel as tk
from ..render.fused import BASE_PLANES, rays_per_light, vertex_groups

# The pixels of a larger frame on which K1's slot entry (whose plain
# version walks the ray list, ~0.9 s on the card at 4,096 pixels), K4 and
# K5 (whose plain versions loop over the lights in PyTorch) are held.
PIXEL_SUBSET = 4096
# The share of an Arvo technique's K4 and K5 values that may be inexact
# (ROADMAP Queue 3); every other technique is held bit for bit.
ARVO_INEXACT = 5e-3
# The shadow rays of a frame on which K1's ray list is held: the plain
# any-hit walks every triangle of each cluster whose box passes.
RAY_SUBSET = 131072


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


def compare_closest(args) -> dict:
    """K2 against its plain version on the same rays (clusters, origins,
    dirs, t_max): rays, hits kernel/plain, primitive mismatches, t bit
    mismatches and max |dt| where both hit."""
    prim_k, t_k = tk.trace_closest(*args)
    prim_p, t_p = tk.trace_closest_plain(*args)
    both = (prim_k >= 0) & (prim_p >= 0)
    t_err = (t_k - t_p).abs()[both]
    return {"rays": args[2].shape[0],
            "hits": f"{int((prim_k >= 0).sum())}/{int((prim_p >= 0).sum())}",
            "prim_mismatches": int((prim_k != prim_p).sum()),
            "t_bit_mismatches": int((t_k.view(torch.int32)
                                     != t_p.view(torch.int32)).sum()),
            "max_abs_dt": float(t_err.max()) if t_err.numel() else 0.0}


def subset_indices(count: int, available: int, device) -> torch.Tensor:
    """`count` evenly spaced indices into range(available) (all of them
    where there are no more)."""
    count = min(count, available)
    return torch.linspace(0, available - 1, count, device=device).long()


def subset_args(args, idx):
    """K4's or K5's arguments (planes, noise, lights, static, settings) at
    plane columns idx."""
    planes, noise, ls, st, s = args
    return (planes[:, idx].contiguous(), noise.subset(idx), ls, st, s)


def pixel_subset(args, count: int = PIXEL_SUBSET):
    """K4's or K5's arguments cut to `count` evenly spaced pixels, where
    the frame has more."""
    p = args[0].shape[1]
    if p <= count:
        return args
    return subset_args(args, subset_indices(count, p, args[0].device))


def ray_subset(origins, dirs, t_max, count: int = RAY_SUBSET):
    """All rays where there are at most `count`, else `count` evenly
    spaced live ones (t_max >= 0)."""
    if t_max.numel() <= count:
        return origins, dirs, t_max
    live = torch.nonzero(t_max >= 0.0)[:, 0]
    idx = live[subset_indices(count, live.numel(), t_max.device)]
    return tuple(a[idx].contiguous() for a in (origins, dirs, t_max))


def diffuse_only_faults(args) -> dict:
    """K5 and K4 under DIFFUSE_ONLY on K5's arguments against their plain
    versions (bit for bit; the Arvo techniques, whose azimuth sectors can
    flip where an ulp of the card's transcendentals differs, on all but
    ARVO_INEXACT of their values), K4's slots resolved with visibility 1
    against K5 (bit for bit), and K5's plain output not all zero: the
    compare() rows that fail, by name."""
    static, settings = args[3], args[4]
    limit = ARVO_INEXACT if settings.polygon_sampling_technique.name in (
        "SOLID_ANGLE_ARVO", "PROJECTED_SOLID_ANGLE_ARVO") else 0.0
    got5 = fused.fused_light_shading_resolved(*args)
    want5 = fused.fused_light_shading_resolved_plain(*args)
    got4 = fused.fused_light_shading(*args)
    rows = {"K5": (compare(got5.T, want5.T), limit),
            "K4": (compare(got4, fused.fused_light_shading_plain(*args)),
                   limit),
            "K4 resolved vs K5": (compare(
                k4_resolved(got4, static, settings).T, got5.T), 0.0)}
    faults = {name: r for name, (r, inexact) in rows.items()
              if 1.0 - r["exact"] > inexact or r["nonfinite_mismatch"]}
    if not float(want5.abs().max()) > 0:
        faults["K5 plain all zero"] = rows["K5"][0]
    return faults


def slot_args_subset(args, idx):
    """K1's slot-entry arguments (clusters, out, slots, hit, position,
    cam, base0) for the pixels idx."""
    clusters, out, slots, hit, position, cam, base0 = args
    return (clusters, out[:, idx].contiguous(), slots, hit[idx].contiguous(),
            position.T[:, idx].contiguous().T, cam, base0[idx].contiguous())


def hold_slot_entry(captured):
    """K1's slot entry on PIXEL_SUBSET evenly spaced pixels of a captured
    frame (tools/bench_frame.py recording_kernels) against its plain
    version: (compare()'s row with the bit mismatches, the pixels'
    arguments)."""
    args = captured["trace_anyhit_slots"][:7]
    sub = slot_args_subset(args, subset_indices(
        PIXEL_SUBSET, args[1].shape[1], args[1].device))
    got = tk.trace_anyhit_slots(*sub)
    want = tk.trace_anyhit_slots_plain(*sub)
    row = compare(got, want)
    row["bit_mismatches"] = bit_mismatches(got, want)
    return row, sub
