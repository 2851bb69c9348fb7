"""Screenshot writers: PNG and Radiance HDR (reference: main.c:1536-1770).

The port's own copy of what the harness calls of
vulkan_renderer_tpu/render/screenshot.py; the same image gives the same
file bytes. The reference uses stb_image_write; these writers need no
dependency.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3|4) uint8 or float [0,1] image as PNG (no deps)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data \
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", header))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def write_hdr(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) float32 as Radiance .hdr (RGBE, uncompressed
    scanlines), the format stbi_write_hdr produces (main.c:1757)."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    max_c = img.max(axis=-1)
    nonzero = max_c >= 1e-32
    f, e = np.frexp(np.where(nonzero, max_c, 1.0))
    mantissa_scale = np.where(nonzero, f * 256.0 / np.where(nonzero, max_c, 1.0),
                              0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * mantissa_scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nonzero, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as fo:
        fo.write(b"#?RADIANCE\n")
        fo.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        fo.write(f"-Y {h} +X {w}\n".encode())
        fo.write(rgbe.tobytes())


def take_screenshot(path: str, image: np.ndarray,
                    output_linear_rgb: bool = False) -> None:
    """Dispatch on extension like the reference (png / jpg->png / hdr)."""
    if path.endswith(".hdr"):
        write_hdr(path, image)
    else:
        write_png(path if path.endswith(".png") else path + ".png", image)
