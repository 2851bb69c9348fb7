"""Slot planes in K4's (3 + 7 S, P) layout, drawn from a seed, for K1's
slot entry (render/trace_kernel.py trace_anyhit_slots): on the CPU in
tests/test_torch_shadow_slots.py, on the card in tests/test_torch_gpu.py.
Imports only the port (no JAX)."""

import torch

from vulkan_renderer_tpu_torch.render import trace_kernel as tk


def scene_box(clusters):
    """(lo, hi) (3,) of the clusters' boxes; NaN padding boxes drop out."""
    lo = torch.where(torch.isnan(clusters.aabb_lo), float("inf"),
                     clusters.aabb_lo).amin(dim=0)
    hi = torch.where(torch.isnan(clusters.aabb_hi), float("-inf"),
                     clusters.aabb_hi).amax(dim=0)
    return lo.cpu(), hi.cpu()


def slot_inputs(clusters, slots: int, pixels: int, seed: int):
    """K1's slot-entry arguments after the clusters (out, slots, hit,
    position, cam, base0), on the clusters' device: shading points inside
    the scene's box, 80% of the pixels hit (the others start at cam), rays
    in random directions with t_max up to the box's diagonal, a fifth of
    the slots dead (b = 0 in all three channels; their direction and
    t_max stay drawn) and a fifth of the live ones lit in one channel
    only. position is the (P, 3) view of (3, P) rows, as K6's planes hold
    it."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = scene_box(clusters)
    extent = hi - lo
    rows = lo[:, None] + torch.rand((3, pixels), generator=g) \
        * extent[:, None]
    hit = torch.rand(pixels, generator=g) < 0.8
    cam = lo + extent * torch.tensor([0.5, 0.5, 0.9])
    out = torch.rand((3 + 7 * slots, pixels), generator=g)
    rest = out[3:].view(slots, 7, pixels)
    rest[:, 3:6] = torch.randn((slots, 3, pixels), generator=g)
    rest[:, 6] = torch.rand((slots, pixels), generator=g) \
        * float(extent.norm())
    one_channel = torch.rand((slots, pixels), generator=g) < 0.2
    rest[:, 1:3] = torch.where(one_channel[:, None], 0.0, rest[:, 1:3])
    dead = torch.rand((slots, pixels), generator=g) < 0.2
    rest[:, 0:3] = torch.where(dead[:, None], 0.0, rest[:, 0:3])
    base0 = torch.rand((pixels, 3), generator=g)
    device = clusters.planes.device
    return (out.to(device), slots, hit.to(device), rows.to(device).T,
            cam.to(device), base0.to(device))


def slot_rays(out, slots: int, hit, position, cam):
    """The shadow rays of out (origins, directions, t_max), built slot by
    slot apart from the shadow megabatch, in its order: every pixel's ray
    of slot 0, then of slot 1, ...; a ray starts at its shading point on a
    hit pixel and at cam on a miss, and is dead (t_max = -1) where its b
    is zero in all three channels."""
    start = torch.where(hit[:, None], position, cam)
    origins, dirs, t_max = [], [], []
    for s in range(slots):
        row = 3 + 7 * s
        origins.append(start)
        dirs.append(out[row + 3:row + 6].T)
        lit = (out[row:row + 3] != 0.0).any(dim=0)
        t_max.append(torch.where(lit, out[row + 6], -1.0))
    return (torch.cat(origins), torch.cat(dirs).contiguous(),
            torch.cat(t_max))


def summed_route(clusters, out, slots, hit, position, cam, base0):
    """The ray-list route with the combine before slot groups: slot_rays,
    the plain tracer, then base0 + base + one torch.sum of b V over the
    slots. (colors (P, 3), the float64 sum of the terms' magnitudes (P,
    3), occluded (S P,))."""
    p = out.shape[1]
    occluded = tk.trace_anyhit_plain(
        clusters, *slot_rays(out, slots, hit, position, cam))
    b = out[3:].reshape(slots, 7, p)[:, 0:3]                 # (S, 3, P)
    visibility = torch.where(occluded, 0.0, 1.0).reshape(slots, 1, p)
    colors = base0 + out[0:3].T + torch.sum(b * visibility, dim=0).T
    magnitude = base0.double().abs() + out[0:3].T.double().abs() \
        + (b.double().abs() * visibility.double()).sum(dim=0).T
    return colors, magnitude, occluded


def assert_sums_agree(got, want, magnitude, slots: int):
    """got and want, two float32 sums of the same S + 2 terms in other
    orders: NaN and infinite at the same values, and elsewhere within
    twice gamma(S + 1) = (S + 1) u / (1 - (S + 1) u), u = 2^-24, of the sum
    of the terms' magnitudes: gamma(S + 1) bounds how far any order of
    summing S + 2 float32 terms lies from their exact sum."""
    for test in (torch.isnan, torch.isinf):
        assert torch.equal(test(got), test(want))
    finite = torch.isfinite(got) & torch.isfinite(want)
    gamma = (slots + 1) * 2.0**-24 / (1.0 - (slots + 1) * 2.0**-24)
    bound = 2.0 * gamma * magnitude
    off = (got.double() - want.double()).abs() > bound
    assert not bool((off & finite).any()), \
        f"{int((off & finite).sum())} values past the bound"


def occluded_slot(clusters, out, slots, hit, position, cam):
    """(slot, pixel) of the first live ray that the plain tracer finds
    occluded."""
    rays = slot_rays(out, slots, hit, position, cam)
    occluded = tk.trace_anyhit_plain(clusters, *rays)
    r = int(torch.nonzero(occluded & (rays[2] >= 0.0))[0, 0])
    return divmod(r, out.shape[1])
