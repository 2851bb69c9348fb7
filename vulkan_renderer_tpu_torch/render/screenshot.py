"""Screenshots: PNG and Radiance HDR writers and readers, and the
two-frame HDR recombination (reference: main.c:1536-1770).

The port's own copy of vulkan_renderer_tpu/render/screenshot.py, in
numpy: the same image gives the same file bytes and the same bytes read
back the same array. The reference uses stb_image; these need no
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


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for our own writer's output (8-bit, no filters
    beyond per-row filter bytes)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = b""
    width = height = channels = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            width, height, depth, color_type = struct.unpack(
                ">IIBB", payload[:10])
            if depth != 8:
                raise ValueError(f"{path}: {depth}-bit PNG, expected 8")
            channels = {0: 1, 2: 3, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = width * channels
    rows = []
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        filt = raw[y * (stride + 1)]
        row = np.frombuffer(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)],
                            np.uint8).copy()
        if filt == 1:  # Sub
            for i in range(channels, stride):
                row[i] = (int(row[i]) + int(row[i - channels])) & 0xFF
        elif filt == 2:  # Up
            row = (row.astype(np.int32) + prev).astype(np.uint8)
        elif filt != 0:
            raise ValueError(f"unsupported PNG filter {filt}")
        rows.append(row)
        prev = row
    return np.stack(rows).reshape(height, width, channels)


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


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file (flat or RLE scanlines) to (H, W, 3) f32."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"\n\n") + 2
    dims_end = data.index(b"\n", end)
    dims = data[end:dims_end].decode().split()
    h, w = int(dims[1]), int(dims[3])
    payload = data[dims_end + 1:]
    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if len(payload) - pos >= 4 and payload[pos] == 2 and payload[pos + 1] == 2:
            # RLE scanline.
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = payload[pos]
                    pos += 1
                    if count > 128:
                        rgbe[y, x:x + count - 128, c] = payload[pos]
                        pos += 1
                        x += count - 128
                    else:
                        rgbe[y, x:x + count, c] = np.frombuffer(
                            payload[pos:pos + count], np.uint8)
                        pos += count
                        x += count
        else:
            row = np.frombuffer(payload[pos:pos + 4 * w], np.uint8)
            rgbe[y] = row.reshape(w, 4)
            pos += 4 * w
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def combine_ldr_screenshots_into_hdr(low: np.ndarray, high: np.ndarray
                                     ) -> np.ndarray:
    """Recombine the two frame_bits LDR captures into fp32
    (main.c:1700-1710)."""
    lo = np.round(np.asarray(low) * 255.0).astype(np.uint16)
    hi = np.round(np.asarray(high) * 255.0).astype(np.uint16)
    return (lo | (hi << 8)).view(np.float16).astype(np.float32)


def take_screenshot(path: str, image: np.ndarray,
                    output_linear_rgb: bool = False) -> None:
    """Dispatch on extension like the reference (png / jpg->png / hdr)."""
    if path.endswith(".hdr"):
        write_hdr(path, image)
    else:
        write_png(path if path.endswith(".png") else path + ".png", image)
