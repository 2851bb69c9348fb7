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


# The cases K1's slot entry is held on at each packet width
# (render/trace_kernel.py PACKET_WIDTHS): slot planes drawn from a seed
# with S slots (groups of 1, 2 and 17 slots, none a multiple of a width
# above 2, and S = 1); whole packets dead; packets whose rays part at
# their first triangle; packets whose rays part at the tree's root.
PACKET_CASES = ("slots_1", "slots_7", "slots_13", "slots_130",
                "dead_packets", "first_triangle", "opposite_lights")
# Slots of the built cases: 8 slot groups of 8, so a group fills a packet
# of every width.
CASE_SLOTS = 64
CASE_PIXELS = 250


def _triangles(clusters):
    """(v0, e1, e2), (T, 3) each on the CPU, of the clusters' triangles
    whose edges span an area (padding triangles have zero edges)."""
    c = clusters.cluster_size
    tab = clusters.planes.cpu().reshape(-1, 9, c).permute(0, 2, 1)
    tab = tab.reshape(-1, 9)
    v0, e1, e2 = tab[:, 0:3], tab[:, 3:6], tab[:, 6:9]
    keep = torch.linalg.cross(e1, e2).norm(dim=1) > 1e-6
    return v0[keep], e1[keep], e2[keep]


def _built_case(clusters, b, dirs, t_max, origins):
    """Slot-entry arguments of rays from origins (P, 3), every pixel a hit
    pixel: b and dirs (S, 3, P), t_max (S, P)."""
    slots, _, pixels = b.shape
    out = torch.full((3 + 7 * slots, pixels), 0.25)
    rest = out[3:].view(slots, 7, pixels)
    rest[:, 0:3] = b
    rest[:, 3:6] = dirs
    rest[:, 6] = t_max
    lo, hi = scene_box(clusters)
    device = clusters.planes.device
    return (out.to(device), slots, torch.ones(pixels, dtype=torch.bool,
                                              device=device),
            origins.T.contiguous().to(device).T, ((lo + hi) / 2).to(device),
            torch.full((pixels, 3), 0.125, device=device))


def packet_case(clusters, case: str, seed: int):
    """K1's slot-entry arguments after the clusters (out, slots, hit,
    position, cam, base0) of one of PACKET_CASES, on the clusters' device:
    - slots_S: slot_inputs with S slots (1,000 pixels; 250 for S = 130);
    - dead_packets: slot_inputs with CASE_SLOTS slots, every slot of a
      third of the pixels dead and the first group's slots of another
      third;
    - first_triangle: each pixel 1 cm above the centroid of a triangle of
      the clusters, its even slots straight down onto it (occluded at
      t = 1 cm) and its odd slots straight up, both ending at 2 cm;
    - opposite_lights: pixels near the ground of the scene's box, their
      even slots toward a square light past its -x side and their odd
      slots toward one past its +x side, above the roofs, each ray ending
      at its point on the light."""
    g = torch.Generator().manual_seed(seed)
    if case.startswith("slots_"):
        slots = int(case.split("_")[1])
        return slot_inputs(clusters, slots, 250 if slots > 100 else 1000,
                           seed)
    if case == "dead_packets":
        args = slot_inputs(clusters, CASE_SLOTS, CASE_PIXELS, seed)
        rest = args[0][3:].view(CASE_SLOTS, 7, CASE_PIXELS)
        pixel = torch.arange(CASE_PIXELS, device=rest.device)
        rest[:, 0:3, pixel % 3 == 0] = 0.0
        rest[:CASE_SLOTS // 8, 0:3, pixel % 3 == 1] = 0.0
        return args
    b = 0.5 + torch.rand((CASE_SLOTS, 3, CASE_PIXELS), generator=g)
    even = (torch.arange(CASE_SLOTS) % 2 == 0)[:, None, None]
    if case == "first_triangle":
        v0, e1, e2 = _triangles(clusters)
        pick = torch.randint(v0.shape[0], (CASE_PIXELS,), generator=g)
        normal = torch.linalg.cross(e1[pick], e2[pick])
        normal = normal / normal.norm(dim=1, keepdim=True)
        origins = v0[pick] + (e1[pick] + e2[pick]) / 3.0 + 0.01 * normal
        up = normal.T[None].expand(CASE_SLOTS, 3, CASE_PIXELS)
        dirs = torch.where(even, -up, up)
        t_max = torch.full((CASE_SLOTS, CASE_PIXELS), 0.02)
        return _built_case(clusters, b, dirs, t_max, origins)
    assert case == "opposite_lights", case
    lo, hi = scene_box(clusters)
    extent = hi - lo
    origins = lo + torch.rand((CASE_PIXELS, 3), generator=g) \
        * extent * torch.tensor([1.0, 1.0, 0.2])
    centre = (lo + hi) / 2
    lights = torch.stack([
        torch.stack([lo[0] - 0.1 * extent[0], centre[1], hi[2] + 2.0]),
        torch.stack([hi[0] + 0.1 * extent[0], centre[1], hi[2] + 2.0])])
    on_light = lights[(~even[:, 0, 0]).long()][:, :, None] \
        + (torch.rand((CASE_SLOTS, 3, CASE_PIXELS), generator=g) - 0.5) \
        * torch.tensor([3.0, 3.0, 0.0])[:, None]
    to_light = on_light - origins.T[None]
    t_max = to_light.norm(dim=1)
    return _built_case(clusters, b, to_light / t_max[:, None], t_max,
                       origins)
