"""The frame's noise (reference: noise_utility.glsl:21-117).

Counterpart of vulkan_renderer_tpu/ops/noise.py::get_noise_image. The
reference scrambles per FRAME, not per pixel: a fetch reads
table[layer, (y + off_y) & mask_y, (x + off_x) & mask_x] with offsets and
layer shared by every pixel. Those three uint32 scalars per fetch are
computed on the host in numpy (torch lacks uint32 shifts). Kernels K4 and
K5 read the table themselves at each pixel (FrameNoise, csrc/
techniques.cuh Noise); the plain versions build the noise image, one
wrapped gather of a table layer per fetch, bit-identical to the JAX
package's get_noise_pairs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import to_device_async


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
    consumes them) for every pixel, pixels row-major. The plain versions
    of K4 and K5 read it; the kernels read the table (FrameNoise)."""
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


@dataclasses.dataclass(frozen=True)
class FrameNoise:
    """One frame's noise as kernels K4 and K5 read it.

    table: (layers, H, W, 4) int32 UNORM16 values, H and W powers of two;
    fetches: (F, 3) int32 on the table's device, fetch i's (off_x mod W,
    off_y mod H, layer), so that pair j of a pixel is channels 2 (j & 1)
    and 2 (j & 1) + 1 of fetch j >> 1; width, height: the frame;
    pair_count, texture_index_mask, random_numbers: get_noise_image's
    arguments, from which image() builds the plain versions' noise;
    pixels: (P,) int32, the frame pixel (row-major index) of each plane
    column, or None for the whole frame in row-major order."""
    table: torch.Tensor
    fetches: torch.Tensor
    width: int
    height: int
    pair_count: int
    texture_index_mask: int
    random_numbers: tuple
    pixels: torch.Tensor | None = None

    @property
    def column_count(self) -> int:
        return self.width * self.height if self.pixels is None \
            else self.pixels.shape[0]

    def image(self) -> torch.Tensor:
        """(2 pair_count, P) float32: get_noise_image at the columns'
        pixels."""
        planes = get_noise_image(self.table, self.width, self.height,
                                 self.pair_count, self.texture_index_mask,
                                 self.random_numbers)
        return planes if self.pixels is None \
            else planes[:, self.pixels.long()]

    def subset(self, columns: torch.Tensor) -> "FrameNoise":
        """The noise of plane columns `columns` (int indices)."""
        pixels = columns if self.pixels is None else self.pixels[columns]
        return dataclasses.replace(
            self, pixels=pixels.to(device=self.table.device,
                                   dtype=torch.int32).contiguous())


def frame_noise(table: torch.Tensor, width: int, height: int,
                pair_count: int, texture_index_mask: int,
                noise_random_numbers) -> FrameNoise:
    """The FrameNoise of a width x height frame reading pair_count pairs;
    the fetch scalars are fetch_scalars', the offsets reduced modulo the
    table's sides ((y + off_y) & (H - 1) is unchanged by that)."""
    th, tw = table.shape[1], table.shape[2]
    rows = []
    for i in range((pair_count + 1) // 2):
        off_x, off_y, layer = fetch_scalars(i, texture_index_mask,
                                            noise_random_numbers)
        rows.append((off_x & (tw - 1), off_y & (th - 1), layer))
    fetches = torch.tensor(rows, dtype=torch.int32).reshape(-1, 3)
    return FrameNoise(
        table=table, fetches=to_device_async(fetches, table.device),
        width=width, height=height, pair_count=pair_count,
        texture_index_mask=texture_index_mask,
        random_numbers=tuple(int(v) for v in
                             np.asarray(noise_random_numbers, np.uint32)))


def noise_pairs(noise: FrameNoise, start: int, stop: int) -> torch.Tensor:
    """(stop - start, pair_count, 2) float32: the noise pairs of frame
    pixels start..stop-1 (row-major), the per-pixel shading path's noise.
    Pair j component c equals plane 2 j + c of get_noise_image at those
    pixels, bit for bit; only these pixels' texels are gathered."""
    if noise.pixels is not None:
        raise ValueError("noise_pairs reads whole-frame FrameNoise")
    table = noise.table
    th, tw = table.shape[1], table.shape[2]
    idx = torch.arange(start, stop, device=table.device)
    ys, xs = idx // noise.width, idx % noise.width
    values = torch.empty((stop - start, 2 * noise.pair_count),
                         dtype=torch.float32, device=table.device)
    for i in range((noise.pair_count + 1) // 2):
        off_x, off_y, layer = fetch_scalars(i, noise.texture_index_mask,
                                            noise.random_numbers)
        channels = min(4, 2 * noise.pair_count - 4 * i)
        values[:, 4 * i:4 * i + channels] = table[
            layer, (ys + off_y) & (th - 1), (xs + off_x) & (tw - 1),
            :channels].to(torch.float32) * (1.0 / 65535.0)
    return values.reshape(stop - start, noise.pair_count, 2)
