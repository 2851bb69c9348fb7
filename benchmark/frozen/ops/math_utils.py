"""Host-side (numpy) codecs and hashes the scene and noise writers use:
the octahedral normal and 21-bit position encoders of the reference's
Blender exporter, and the Wang hash of its white noise."""

from __future__ import annotations

import numpy as np


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
