"""Scalar math shared by the port: host-side (numpy) codecs and hashes,
device-side (torch) float helpers.

Counterparts of vulkan_renderer_tpu/ops/math_utils.py. The numpy encoders
are the same arithmetic as the reference's Blender exporter; the torch
helpers reproduce the JAX package's float32 formulas operation by
operation (the Cephes atan, the biased-PSA polynomial atan and the
Veltkamp two_product), so the plain versions and the CUDA kernels can be
held against the reference with tight tolerances.

The lane helpers (cumsum_lanes, first_true_lane, pick_lane) are the JAX
package's, on a leading pixel axis P: a lane axis is dim 1 of a (P, m,
...) tensor. The float helpers take their type from their inputs:

- atan is the Cephes polynomial at float32 (the JAX package's atan_f32,
  which exists there because jnp.arctan has no Mosaic lowering; every
  float32 path of both packages evaluates it) and torch.atan at any wider
  type, whose rounding the float32 coefficients would otherwise set;
- two_product splits at 2^12 + 1 in float32 and 2^27 + 1 in float64
  (Veltkamp's split at half the significand, so p + e == a*b stays
  exact in both).
"""

from __future__ import annotations

import numpy as np
import torch

M_PI = 3.14159265358979323846
M_HALF_PI = 0.5 * M_PI

# ---------------------------------------------------------------------------
# Host-side codecs (numpy)
# ---------------------------------------------------------------------------


def wang_hash_np(seed: np.ndarray) -> np.ndarray:
    """uint32 Wang hash (reference math_utilities.h:50-57), bit-exact."""
    seed = np.asarray(seed, np.uint32)
    with np.errstate(over="ignore"):
        seed = (seed ^ np.uint32(61)) ^ (seed >> np.uint32(16))
        seed = seed * np.uint32(9)
        seed = seed ^ (seed >> np.uint32(4))
        seed = seed * np.uint32(0x27D4EB2D)
        seed = seed ^ (seed >> np.uint32(15))
    return seed


def encode_normal_octahedral_32bit_np(normals: np.ndarray) -> np.ndarray:
    """Unit normals -> 2x16-bit UNORM octahedral codes (Blender exporter
    io_export_vulkan_blender28.py:24-46)."""
    n = np.asarray(normals, np.float32)
    n = n / np.maximum(1e-30, np.abs(n[..., 0:1]) + np.abs(n[..., 1:2])
                       + np.abs(n[..., 2:3]))
    below = n[..., 2] < 0.0
    abs_yx = np.abs(n[..., [1, 0]])
    signs = np.where(n[..., :2] >= 0.0, 1.0, -1.0)
    xy = np.where(below[..., None], (1.0 - abs_yx) * signs, n[..., :2])
    # Inverse of the decoder's zero-preserving affine map.
    factor = 2.0 * (65534.0 / 65535.0)
    summand = -(32768.0 / 65535.0) * factor
    unorm = (xy - summand) / factor
    return np.clip(np.round(unorm * 65535.0), 0, 65535).astype(np.uint16)


def decode_normal_octahedral_32bit_np(codes: np.ndarray) -> np.ndarray:
    """(..., 2) uint16 octahedral codes -> (..., 3) float32 unit normals
    (mesh_quantization.glsl:19-33), in float32 like the shader."""
    unorm = np.asarray(codes, np.float32) / np.float32(65535.0)
    factor = np.float32(2.0 * (65534.0 / 65535.0))
    summand = np.float32(-(32768.0 / 65535.0) * (2.0 * (65534.0 / 65535.0)))
    o = unorm * factor + summand
    ox, oy = o[..., 0], o[..., 1]
    nz = np.float32(1.0) - np.abs(ox) - np.abs(oy)
    sign_x = np.where(ox >= 0.0, np.float32(1.0), np.float32(-1.0))
    sign_y = np.where(oy >= 0.0, np.float32(1.0), np.float32(-1.0))
    below = nz < 0.0
    nx = np.where(below, (np.float32(1.0) - np.abs(oy)) * sign_x, ox)
    ny = np.where(below, (np.float32(1.0) - np.abs(ox)) * sign_y, oy)
    n = np.stack([nx, ny, nz], axis=-1).astype(np.float32)
    length = np.sqrt(np.sum(n * n, axis=-1, keepdims=True))
    return (n / length).astype(np.float32)


def encode_position_64bit_np(positions, box_min, box_max):
    """Quantize positions to 3x21 bits packed in 2x uint32 (Blender
    exporter io_export_vulkan_blender28.py:476-487).

    Returns (packed (..., 2) uint32, dequantization_factor (3,),
    dequantization_summand (3,))."""
    positions = np.asarray(positions, np.float64)
    box_min = np.asarray(box_min, np.float64)
    box_max = np.asarray(box_max, np.float64)
    max_code = float((1 << 21) - 1)
    extent = np.maximum(box_max - box_min, 1e-30)
    factor = (extent / max_code).astype(np.float32)
    summand = box_min.astype(np.float32)
    q = np.clip(np.round((positions - box_min) / extent * max_code), 0,
                max_code).astype(np.uint64)
    combined = q[..., 0] | (q[..., 1] << 21) | (q[..., 2] << 42)
    lo = (combined & 0xFFFFFFFF).astype(np.uint32)
    hi = (combined >> 32).astype(np.uint32)
    return np.stack([lo, hi], axis=-1), factor, summand


def decode_position_64bit_np(packed: np.ndarray, factor: np.ndarray,
                             summand: np.ndarray) -> np.ndarray:
    """(N, 2) uint32 -> (N, 3) float32 (mesh_quantization.glsl:38-45)."""
    q = np.asarray(packed).astype(np.uint64)
    combined = q[:, 0] | (q[:, 1] << np.uint64(32))
    pos = np.stack([combined & np.uint64(0x1FFFFF),
                    (combined >> np.uint64(21)) & np.uint64(0x1FFFFF),
                    (combined >> np.uint64(42)) & np.uint64(0x1FFFFF)],
                   axis=-1).astype(np.float32)
    return pos * np.asarray(factor, np.float32) \
        + np.asarray(summand, np.float32)


# ---------------------------------------------------------------------------
# Device-side float helpers (torch)
# ---------------------------------------------------------------------------


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of size 3, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v| over the last axis (no epsilon: zero vectors give NaN, as
    in the reference)."""
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


# Veltkamp's split constant, 2^ceil(significand bits / 2) + 1.
_SPLIT = {torch.float32: 4097.0, torch.float64: 134217729.0}


def two_product(a: torch.Tensor, b: torch.Tensor):
    """(p, e) with p = fl(a*b) and p + e == a*b exactly, in float32 or
    float64, wherever the split's products neither overflow nor lose
    bits below the smallest normal."""
    split = _SPLIT[a.dtype]
    p = a * b
    a_hi = a * split
    a_hi = a_hi - (a_hi - a)
    a_lo = a - a_hi
    b_hi = b * split
    b_hi = b_hi - (b_hi - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def atan_f32(x: torch.Tensor) -> torch.Tensor:
    """Cephes single-precision atan, the same branchless polynomial as the
    JAX package's atan_f32 / atan_soa (so every path shares one formula)."""
    ax = torch.abs(x)
    big = ax > 2.414213562373095
    mid = (ax > 0.4142135623730950) & ~big
    one = torch.ones_like(ax)
    safe_ax = torch.where(ax > 0.0, ax, one)
    r = torch.where(big, -1.0 / torch.where(big, safe_ax, one),
                    torch.where(mid, (ax - 1.0) / (ax + 1.0), ax))
    offset = torch.where(big, torch.full_like(ax, M_HALF_PI),
                         torch.where(mid, torch.full_like(ax, 0.25 * M_PI),
                                     torch.zeros_like(ax)))
    z = r * r
    p = z * 8.05374449538e-2 - 1.38776856032e-1
    p = z * p + 1.99777106478e-1
    p = z * p - 3.33329491539e-1
    y = offset + (z * p * r + r)
    return torch.where(x < 0.0, -y, y)


def fast_positive_atan(y: torch.Tensor) -> torch.Tensor:
    """Piecewise-polynomial positive atan of the biased PSA variant
    (polygon_sampling.glsl:83-97), max abs error 1.16e-5."""
    ay = torch.abs(y)
    rx = torch.where(ay > 1.0, 1.0 / ay, ay)
    ry = rx * rx
    rz = ry * 0.02083509974181652 + (-0.08513300120830536)
    rz = ry * rz + 0.18014100193977356
    rz = ry * rz + (-0.3302994966506958)
    ry = ry * rz + 0.9998660087585449
    rz = -2.0 * ry * rx + M_HALF_PI
    rz = torch.where(ay > 1.0, rz, torch.zeros_like(rz))
    rx = rx * ry + rz
    return torch.where(y < 0.0, M_PI - rx, rx)


def atan(x: torch.Tensor) -> torch.Tensor:
    """arctan at the input's precision: atan_f32 for float32 (the JAX
    package's formula), torch.atan for wider types."""
    return atan_f32(x) if x.dtype == torch.float32 else torch.atan(x)


def constant_like(value: float, like: torch.Tensor):
    """value for torch.where beside `like`: the Python float at float32
    (where two Python floats give a float32 tensor), a tensor of like's
    type otherwise, so that a float64 run adds pi, not float32(pi)."""
    if like.dtype == torch.float32:
        return value
    return torch.full_like(like, value)


def positive_atan(tangent: torch.Tensor) -> torch.Tensor:
    """atan offset into [0, pi]: the angle whose tangent is `tangent`."""
    return atan(tangent) + torch.where(tangent < 0.0,
                                       constant_like(M_PI, tangent), 0.0)


def kahan(a, b, c, d):
    """a*b - c*d with ~1.5 ulp error (polygon_sampling.glsl:261-268),
    through the error-free two_product."""
    p1, e1 = two_product(a, b)
    p2, e2 = two_product(c, d)
    return (p1 - p2) + (e1 - e2)


def cross_stable(lhs, rhs):
    """Cross product over the last axis with per-entry <= 1.5 ulp error
    (polygon_sampling.glsl:273-279)."""
    return torch.stack([
        kahan(lhs[..., 1], rhs[..., 2], lhs[..., 2], rhs[..., 1]),
        kahan(lhs[..., 2], rhs[..., 0], lhs[..., 0], rhs[..., 2]),
        kahan(lhs[..., 0], rhs[..., 1], lhs[..., 1], rhs[..., 0])], dim=-1)


def mix_fma(x, y, a):
    """Stable lerp (polygon_sampling.glsl:183-185)."""
    return a * y + (x - a * x)


def dot2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of size 2."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def rotate_90(v: torch.Tensor) -> torch.Tensor:
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


# ---------------------------------------------------------------------------
# Lane helpers: (P, m, ...) tensors, lanes on dim 1
# ---------------------------------------------------------------------------


def cumsum_lanes(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over dim 1 by log2(m) shift-adds, the JAX
    package's cumsum_lanes (its order of additions)."""
    m = x.shape[1]
    offset = 1
    while offset < m:
        shifted = torch.cat([torch.zeros_like(x[:, :offset]),
                             x[:, :m - offset]], dim=1)
        x = x + shifted
        offset *= 2
    return x


def first_true_lane(mask: torch.Tensor, fallback: torch.Tensor):
    """Index (P,) of the first True lane of mask (P, m), else fallback."""
    m = mask.shape[1]
    lanes = torch.arange(m, device=mask.device, dtype=torch.int32)
    idx = torch.min(torch.where(mask, lanes, m), dim=1).values
    return torch.where(idx < m, idx, fallback.to(torch.int32))


def pick_lane(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr (P, m, ...) at lane idx (P,): (P, ...), zeros (False) where
    idx is outside [0, m), as the JAX package's one-hot pick_lane."""
    m = arr.shape[1]
    inside = (idx >= 0) & (idx < m)
    safe = torch.clamp(idx, 0, m - 1).long()
    tail = arr.shape[2:]
    index = safe.view((-1, 1) + (1,) * len(tail)).expand(
        (arr.shape[0], 1) + tail)
    got = torch.gather(arr, 1, index).squeeze(1)
    inside = inside.view((-1,) + (1,) * len(tail))
    if arr.dtype == torch.bool:
        return got & inside
    return torch.where(inside, got, 0)


def gather_lanes(arr: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """arr (P, m, ...) permuted along dim 1 by order (P, m) int, plus 0:
    the JAX package's one-hot masked sums, which turn -0.0 into +0.0."""
    tail = arr.shape[2:]
    index = order.long().view(order.shape + (1,) * len(tail)).expand(
        order.shape + tail)
    return torch.gather(arr, 1, index) + 0.0
