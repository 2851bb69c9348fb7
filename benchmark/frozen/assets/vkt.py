""".vkt texture files: parser/writer, BC1/BC5 block codec, Gaussian mips.

Counterpart of vulkan_renderer_tpu/assets/vkt.py (byte-identical file
format, textures.c:112-169 / tools/texture_conversion/main.c:263-291),
written in numpy only so that scenes can be built and loaded on a machine
without JAX. Textures are decoded to float32 at load time; the frame
filters them with explicit gathers (render/texture.py).

  u32 marker 0xbc1bc1 | u32 version 1
  u32 mipmap_count | u32 width | u32 height | u32 VkFormat | u64 payload_size
  per mip: u32 w | u32 h | u64 size | u64 offset (into payload)
  payload bytes | u32 eof 0xE0FE0F
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..ops.srgb import linear_to_srgb_np, srgb_to_linear_np

MARKER = 0xBC1BC1
EOF_MARKER = 0xE0FE0F
VERSION = 1

VK_FORMAT_R16G16B16_SFLOAT = 90
VK_FORMAT_R16G16B16A16_SFLOAT = 97
VK_FORMAT_R32G32B32_SFLOAT = 106
VK_FORMAT_R32G32B32A32_SFLOAT = 109
VK_FORMAT_BC1_RGB_UNORM_BLOCK = 131
VK_FORMAT_BC1_RGB_SRGB_BLOCK = 132
VK_FORMAT_BC5_UNORM_BLOCK = 141


# The float formats decode_to_float reads: (element type, channels).
_FLOAT_FORMATS = {
    VK_FORMAT_R16G16B16_SFLOAT: (np.float16, 3),
    VK_FORMAT_R16G16B16A16_SFLOAT: (np.float16, 4),
    VK_FORMAT_R32G32B32_SFLOAT: (np.float32, 3),
    VK_FORMAT_R32G32B32A32_SFLOAT: (np.float32, 4),
}


@dataclasses.dataclass
class Texture2d:
    format: int
    mips: list[np.ndarray]  # raw bytes per mip (uint8) in file layout
    width: int = 0
    height: int = 0

    def mip_resolution(self, level: int):
        return max(self.width >> level, 1), max(self.height >> level, 1)

    def decode_to_float(self, level: int | None = None) -> list[np.ndarray]:
        """Decode mips to (H, W, C) float32 linear-color arrays."""
        levels = range(len(self.mips)) if level is None else [level]
        out = []
        for lv in levels:
            w, h = self.mip_resolution(lv)
            raw = self.mips[lv]
            if self.format in (VK_FORMAT_BC1_RGB_UNORM_BLOCK,
                               VK_FORMAT_BC1_RGB_SRGB_BLOCK):
                img = decode_bc1(raw, w, h)
                if self.format == VK_FORMAT_BC1_RGB_SRGB_BLOCK:
                    img = srgb_to_linear_np(img)
            elif self.format == VK_FORMAT_BC5_UNORM_BLOCK:
                img = decode_bc5(raw, w, h)
            elif self.format in _FLOAT_FORMATS:
                # Light textures (probes, IES profiles) in half or single
                # precision, 3 or 4 channels.
                dtype, channels = _FLOAT_FORMATS[self.format]
                img = raw.view(dtype).reshape(h, w, channels) \
                    .astype(np.float32)
            else:
                raise ValueError(f"unsupported VkFormat {self.format}")
            out.append(img)
        return out


def load_vkt(path: str) -> Texture2d:
    with open(path, "rb") as f:
        marker, version = struct.unpack("<II", f.read(8))
        if marker != MARKER or version != VERSION:
            raise ValueError(f"{path}: bad marker 0x{marker:x} / v{version}")
        mip_count, width, height, fmt = struct.unpack("<IIII", f.read(16))
        (payload_size,) = struct.unpack("<Q", f.read(8))
        mip_headers = []
        for _ in range(mip_count):
            w, h = struct.unpack("<II", f.read(8))
            size, offset = struct.unpack("<QQ", f.read(16))
            mip_headers.append((w, h, size, offset))
        payload = f.read(payload_size)
        (eof,) = struct.unpack("<I", f.read(4))
        if eof != EOF_MARKER:
            raise ValueError(f"{path}: missing EOF marker")
    mips = [np.frombuffer(payload[off:off + size], np.uint8).copy()
            for (_, _, size, off) in mip_headers]
    return Texture2d(format=fmt, mips=mips, width=width, height=height)


def save_vkt(path: str, texture: Texture2d) -> None:
    offsets = []
    off = 0
    for m in texture.mips:
        offsets.append(off)
        off += len(m)
    with open(path, "wb") as f:
        f.write(struct.pack("<II", MARKER, VERSION))
        f.write(struct.pack("<IIII", len(texture.mips), texture.width,
                            texture.height, texture.format))
        f.write(struct.pack("<Q", off))
        for lv, m in enumerate(texture.mips):
            w, h = texture.mip_resolution(lv)
            f.write(struct.pack("<IIQQ", w, h, len(m), offsets[lv]))
        for m in texture.mips:
            f.write(m.tobytes())
        f.write(struct.pack("<I", EOF_MARKER))


# ---------------------------------------------------------------------------
# BC1 (DXT1)
# ---------------------------------------------------------------------------

def _expand_565(c):
    r = ((c >> 11) & 0x1F).astype(np.float32) / 31.0
    g = ((c >> 5) & 0x3F).astype(np.float32) / 63.0
    b = (c & 0x1F).astype(np.float32) / 31.0
    return np.stack([r, g, b], axis=-1)


def decode_bc1(raw: np.ndarray, width: int, height: int) -> np.ndarray:
    """BC1 blocks -> (H, W, 3) float32 (UNORM color space)."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    blocks = raw.view("<u4").reshape(bh * bw, 2)
    colors = blocks[:, 0]
    c0 = (colors & 0xFFFF).astype(np.uint32)
    c1 = (colors >> 16).astype(np.uint32)
    p0 = _expand_565(c0)
    p1 = _expand_565(c1)
    four_color = c0 > c1
    pal = np.empty((len(c0), 4, 3), np.float32)
    pal[:, 0] = p0
    pal[:, 1] = p1
    pal[:, 2] = np.where(four_color[:, None],
                         (2 * p0 + p1) / 3.0, (p0 + p1) * 0.5)
    pal[:, 3] = np.where(four_color[:, None], (p0 + 2 * p1) / 3.0, 0.0)
    indices = blocks[:, 1]
    shifts = np.arange(16, dtype=np.uint32) * 2
    idx = ((indices[:, None] >> shifts[None, :]) & 3).astype(np.int64)
    texels = np.take_along_axis(pal, idx[:, :, None], axis=1)  # (B, 16, 3)
    img = texels.reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4) \
        .reshape(bh * 4, bw * 4, 3)
    return img[:height, :width]


def encode_bc1(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) floats in [0,1] -> BC1 bytes (min/max endpoints)."""
    h, w = img.shape[:2]
    bh, bw = (h + 3) // 4, (w + 3) // 4
    padded = np.zeros((bh * 4, bw * 4, 3), np.float32)
    padded[:h, :w] = np.clip(img[..., :3], 0.0, 1.0)
    if h < bh * 4:
        padded[h:, :w] = padded[h - 1:h, :w]
    if w < bw * 4:
        padded[:, w:] = padded[:, w - 1:w]
    blocks = padded.reshape(bh, 4, bw, 4, 3).transpose(0, 2, 1, 3, 4) \
        .reshape(bh * bw, 16, 3)
    mins = blocks.min(axis=1)
    maxs = blocks.max(axis=1)

    def quant565(c):
        r = np.round(c[..., 0] * 31).astype(np.uint32)
        g = np.round(c[..., 1] * 63).astype(np.uint32)
        b = np.round(c[..., 2] * 31).astype(np.uint32)
        return (r << 11) | (g << 5) | b

    e0 = quant565(maxs)
    e1 = quant565(mins)
    # Four-color mode needs e0 > e1: swap; equal endpoints take index 0.
    swap = e0 < e1
    e0s = np.where(swap, e1, e0)
    e1s = np.where(swap, e0, e1)
    equal = e0s == e1s
    p0 = _expand_565(e0s)
    p1 = _expand_565(e1s)
    pal = np.stack([p0, p1, (2 * p0 + p1) / 3.0, (p0 + 2 * p1) / 3.0], axis=1)
    dists = np.sum((blocks[:, :, None, :] - pal[:, None, :, :]) ** 2, axis=-1)
    idx = np.argmin(dists, axis=-1).astype(np.uint32)
    idx = np.where(equal[:, None], 0, idx)
    shifts = np.arange(16, dtype=np.uint32) * 2
    index_bits = np.bitwise_or.reduce(idx << shifts[None, :], axis=1)
    colors = e0s.astype(np.uint32) | (e1s.astype(np.uint32) << 16)
    out = np.empty((bh * bw, 2), "<u4")
    out[:, 0] = colors
    out[:, 1] = index_bits
    return out.reshape(-1).view(np.uint8).copy()


# ---------------------------------------------------------------------------
# BC5 (two BC4 channels)
# ---------------------------------------------------------------------------

def _decode_bc4_channel(lo, hi, bits):
    """lo, hi: (B,) uint; bits: (B, 16) 3-bit indices -> (B, 16) float."""
    lo_f = lo.astype(np.float32) / 255.0
    hi_f = hi.astype(np.float32) / 255.0
    pal = np.empty((len(lo), 8), np.float32)
    pal[:, 0] = lo_f
    pal[:, 1] = hi_f
    six = lo_f > hi_f
    for i in range(2, 8):
        interp6 = ((8 - i) * lo_f + (i - 1) * hi_f) / 7.0
        if i < 6:
            interp4 = ((6 - i) * lo_f + (i - 1) * hi_f) / 5.0
        elif i == 6:
            interp4 = np.zeros_like(lo_f)
        else:
            interp4 = np.ones_like(lo_f)
        pal[:, i] = np.where(six, interp6, interp4)
    return np.take_along_axis(pal, bits.astype(np.int64), axis=1)


def _unpack_bc4_indices(raw6: np.ndarray) -> np.ndarray:
    """(B, 6) uint8 -> (B, 16) 3-bit indices."""
    b = raw6.astype(np.uint64)
    packed = (b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
              | (b[:, 3] << 24) | (b[:, 4] << 32) | (b[:, 5] << 40))
    shifts = np.arange(16, dtype=np.uint64) * 3
    return ((packed[:, None] >> shifts[None, :]) & 7).astype(np.uint8)


def decode_bc5(raw: np.ndarray, width: int, height: int) -> np.ndarray:
    """BC5 blocks -> (H, W, 2) float32."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    blocks = raw.reshape(bh * bw, 16)
    channels = []
    for c in range(2):
        sub = blocks[:, c * 8:(c + 1) * 8]
        bits = _unpack_bc4_indices(sub[:, 2:8])
        channels.append(_decode_bc4_channel(sub[:, 0], sub[:, 1], bits))
    texels = np.stack(channels, axis=-1)  # (B, 16, 2)
    img = texels.reshape(bh, bw, 4, 4, 2).transpose(0, 2, 1, 3, 4) \
        .reshape(bh * 4, bw * 4, 2)
    return img[:height, :width]


def encode_bc5(img: np.ndarray) -> np.ndarray:
    """(H, W, >=2) floats in [0,1] -> BC5 bytes."""
    h, w = img.shape[:2]
    bh, bw = (h + 3) // 4, (w + 3) // 4
    padded = np.zeros((bh * 4, bw * 4, 2), np.float32)
    padded[:h, :w] = np.clip(img[..., :2], 0.0, 1.0)
    if h < bh * 4:
        padded[h:, :w] = padded[h - 1:h, :w]
    if w < bw * 4:
        padded[:, w:] = padded[:, w - 1:w]
    blocks = padded.reshape(bh, 4, bw, 4, 2).transpose(0, 2, 1, 3, 4) \
        .reshape(bh * bw, 16, 2)
    out = np.empty((bh * bw, 16), np.uint8)
    for c in range(2):
        vals = blocks[:, :, c]
        lo = np.round(vals.max(axis=1) * 255).astype(np.uint8)  # six-mode
        hi = np.round(vals.min(axis=1) * 255).astype(np.uint8)
        degenerate = lo <= hi
        lo = np.where(degenerate, np.minimum(hi + 1, 255), lo)
        pal = np.empty((len(lo), 8), np.float32)
        lo_f = lo.astype(np.float32) / 255.0
        hi_f = hi.astype(np.float32) / 255.0
        pal[:, 0] = lo_f
        pal[:, 1] = hi_f
        for i in range(2, 8):
            pal[:, i] = ((8 - i) * lo_f + (i - 1) * hi_f) / 7.0
        idx = np.argmin(np.abs(vals[:, :, None] - pal[:, None, :]), axis=-1)
        packed = np.zeros(len(lo), np.uint64)
        for t in range(16):
            packed |= idx[:, t].astype(np.uint64) << np.uint64(3 * t)
        out[:, c * 8 + 0] = lo
        out[:, c * 8 + 1] = hi
        for b in range(6):
            out[:, c * 8 + 2 + b] = ((packed >> np.uint64(8 * b))
                                     & np.uint64(0xFF)).astype(np.uint8)
    return out.reshape(-1).copy()


# ---------------------------------------------------------------------------
# Gaussian mip pyramid (tools/texture_conversion/main.c:295-345)
# ---------------------------------------------------------------------------

def gaussian_mip_pyramid(image: np.ndarray) -> list[np.ndarray]:
    """Full mip chain, sigma = 0.4 * 2^level, 3-sigma support, wrap."""
    h, w = image.shape[:2]
    if (h & (h - 1)) or (w & (w - 1)):
        raise ValueError("resolution must be a power of two")
    mips = [np.asarray(image, np.float32)]
    level_count = max(w, h).bit_length()
    for level in range(1, level_count):
        mw, mh = max(w >> level, 1), max(h >> level, 1)
        sigma = 0.4 * (1 << level)
        support = int(np.ceil(3.0 * sigma))
        offsets = np.arange(-support, support + 1)
        weights = np.exp(-0.5 * (offsets / sigma) ** 2)
        weights /= weights.sum()
        base = mips[0]
        tmp = np.zeros_like(base)
        for o, wt in zip(offsets, weights):
            tmp += wt * np.roll(base, -o, axis=0)
        blurred = np.zeros_like(base)
        for o, wt in zip(offsets, weights):
            blurred += wt * np.roll(tmp, -o, axis=1)
        step = 1 << level
        mips.append(blurred[step // 2::step, step // 2::step][:mh, :mw])
    return mips


def encode_texture(image: np.ndarray, fmt: int) -> Texture2d:
    """Full .vkt texture (mips + block compression) from a linear image."""
    mips = []
    for m in gaussian_mip_pyramid(image):
        if fmt == VK_FORMAT_BC1_RGB_SRGB_BLOCK:
            mips.append(encode_bc1(linear_to_srgb_np(m[..., :3])))
        elif fmt == VK_FORMAT_BC1_RGB_UNORM_BLOCK:
            mips.append(encode_bc1(m[..., :3]))
        elif fmt == VK_FORMAT_BC5_UNORM_BLOCK:
            mips.append(encode_bc5(m))
        elif fmt == VK_FORMAT_R16G16B16A16_SFLOAT:
            rgba = np.ones(m.shape[:2] + (4,), np.float16)
            rgba[..., :m.shape[-1]] = m.astype(np.float16)
            mips.append(rgba.reshape(-1).view(np.uint8).copy())
        else:
            raise ValueError(f"unsupported encode format {fmt}")
    return Texture2d(format=fmt, mips=mips,
                     width=image.shape[1], height=image.shape[0])
