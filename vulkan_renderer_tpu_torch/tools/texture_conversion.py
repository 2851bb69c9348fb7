"""Texture conversion CLI: image -> .vkt with mips and block compression.

Counterpart of vulkan_renderer_tpu/tools/texture_conversion.py
(reference: tools/texture_conversion/main.c, CLI `texture_compression
<vk_format> <input> <output>`): the same VkFormat codes, the same .vkt
output, the same power-of-two requirement and Gaussian mip pyramid
(assets/vkt.py). Inputs: .png and .hdr (render/screenshot.py readers) or
.npy float arrays. Host numpy; PNG colors are decoded from sRGB with
ops/srgb.py.

    python -m vulkan_renderer_tpu_torch.tools.texture_conversion \
        132 in.png out.vkt
"""

from __future__ import annotations

import sys

import numpy as np

from ..assets import vkt
from ..ops.srgb import srgb_to_linear_np
from ..render.screenshot import read_hdr, read_png

KNOWN_FORMATS = (
    vkt.VK_FORMAT_R16G16B16_SFLOAT,
    vkt.VK_FORMAT_R16G16B16A16_SFLOAT,
    vkt.VK_FORMAT_R32G32B32_SFLOAT,
    vkt.VK_FORMAT_R32G32B32A32_SFLOAT,
    vkt.VK_FORMAT_BC1_RGB_UNORM_BLOCK,
    vkt.VK_FORMAT_BC1_RGB_SRGB_BLOCK,
    vkt.VK_FORMAT_BC5_UNORM_BLOCK,
)


def load_image(path: str) -> np.ndarray:
    """The image as float32: PNG colors decoded from sRGB to linear (alpha
    kept), HDR and .npy as stored."""
    if path.endswith(".png"):
        img = read_png(path).astype(np.float32) / 255.0
        rgb = srgb_to_linear_np(img[..., :3])
        if img.shape[-1] == 4:
            return np.concatenate([rgb, img[..., 3:]], axis=-1)
        return rgb
    if path.endswith(".hdr"):
        return read_hdr(path)
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    raise ValueError(f"unsupported input image format: {path}")


def convert(format_code: int, input_path: str, output_path: str) -> None:
    if format_code not in KNOWN_FORMATS:
        raise ValueError(f"unknown VkFormat {format_code}")
    image = load_image(input_path)
    h, w = image.shape[:2]
    if (h & (h - 1)) or (w & (w - 1)):
        raise ValueError(
            f"input resolution {w}x{h} must be a power of two "
            "(tools/texture_conversion/main.c:229-237)")
    texture = vkt.encode_texture(image, format_code)
    vkt.save_vkt(output_path, texture)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print("Usage: texture_conversion <vk_format> <input> <output.vkt>")
        print("vk_format codes: 90, 97, 106, 109 (float), "
              "131/132 (BC1 UNORM/sRGB), 141 (BC5)")
        return 1
    convert(int(argv[0]), argv[1], argv[2])
    print(f"wrote {argv[2]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
