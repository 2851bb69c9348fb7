"""The frame's noise image (reference: noise_utility.glsl:21-117).

Counterpart of vulkan_renderer_tpu/ops/noise.py::get_noise_image. The
reference scrambles per FRAME, not per pixel: a fetch reads
table[layer, (y + off_y) & mask_y, (x + off_x) & mask_x] with offsets and
layer shared by every pixel. Those three uint32 scalars per fetch are
computed on the host in numpy (torch lacks uint32 shifts); the image is
then one wrapped gather of a table layer per fetch, bit-identical to the
JAX package's get_noise_pairs.
"""

from __future__ import annotations

import numpy as np
import torch


def fetch_scalars(sample_index: int, texture_index_mask: int,
                  noise_random_numbers) -> tuple[int, int, int]:
    """(off_x, off_y, texture_index) of fetch `sample_index`
    (noise_utility.glsl:62-73), as Python ints."""
    rn = np.asarray(noise_random_numbers, np.uint32)
    if sample_index & 2:
        rn = rn[[2, 3, 0, 1]]
    if sample_index & 1:
        rx, ry, rz = rn[1], rn[2], rn[3]
    else:
        rx, ry, rz = rn[0], rn[1], rn[2]
    shift = np.uint32((sample_index & 124) >> 2)
    with np.errstate(over="ignore"):
        texture_index = (rz + np.uint32(sample_index)) \
            & np.uint32(texture_index_mask)
    return int(rx >> shift), int(ry >> shift), int(texture_index)


def get_noise_image(table: torch.Tensor, width: int, height: int,
                    pair_count: int, texture_index_mask: int,
                    noise_random_numbers) -> torch.Tensor:
    """table: (layers, H, W, 4) int32 holding UNORM16 values.

    Returns (2 * pair_count, height * width) float32 in [0, 1]: plane
    2 j + c holds component c of pair j (pairs in the order the shader
    consumes them) for every pixel, pixels row-major. This is the layout of
    K4's noise planes and, viewed as (lights, 2 * pairs per light, P), of
    K5's light-major noise, so neither kernel's input needs a copy."""
    th, tw = table.shape[1], table.shape[2]
    ys = torch.arange(height, device=table.device)
    xs = torch.arange(width, device=table.device)
    planes = torch.empty((2 * pair_count, height, width), dtype=torch.float32,
                         device=table.device)
    for i in range((pair_count + 1) // 2):
        off_x, off_y, layer = fetch_scalars(i, texture_index_mask,
                                            noise_random_numbers)
        channels = min(4, 2 * pair_count - 4 * i)
        values = table[layer, :, :, :channels].permute(2, 0, 1) \
            .to(torch.float32) * (1.0 / 65535.0)
        # value[y, x] = layer[(y + off_y) & mask_y, (x + off_x) & mask_x]:
        # the table sides are powers of two.
        planes[4 * i:4 * i + channels] = values[
            :, ((ys + off_y) & (th - 1))[:, None],
            ((xs + off_x) & (tw - 1))[None, :]]
    return planes.reshape(2 * pair_count, height * width)
