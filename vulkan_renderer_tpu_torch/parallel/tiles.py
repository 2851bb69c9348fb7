"""Image-row bands: one frame rendered as bands of rows over devices.

Counterpart of vulkan_renderer_tpu/parallel/tiles.py
(render_frame_shardmap): each device renders height / n rows of the frame
through the whole single-device pipeline, kernels included, with the
scene copied to it, and reads global pixel rows (render/pipeline.py
render_frame_constants row_offset), so that rays and noise fetches, and
with them the concatenated image, equal the whole frame's bit for bit.
PyTorch queues each band on its device's stream without waiting, so the
devices work at once; the bands are then gathered on the first device.
A device may be named more than once (bands in turn on one card).

    image = render_frame_bands(["cuda:0", "cuda:1"], scene, static,
                               camera, settings, 1920, 1080)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import get_device
from ..core.settings import RenderSettings
from ..render.pipeline import make_frame_constants, render_frame_constants
from ..render.shading import SceneStatic
from ..scene.camera import FirstPersonCamera


def to_device(tree, device: torch.device):
    """A copy of a dataclass tree (the Scene and the tables it holds) with
    every tensor on `device`; other fields are kept."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _indexed(device: torch.device) -> torch.device:
    """cuda -> cuda:<current>, so that equal devices compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def render_frame_bands(devices, scene, static: SceneStatic,
                       camera: FirstPersonCamera, settings: RenderSettings,
                       width: int, height: int, noise_random_numbers=None
                       ) -> torch.Tensor:
    """The (height, width, 3) frame as len(devices) bands of rows, band i
    on devices[i], returned on devices[0]."""
    devices = [_indexed(get_device(d)) for d in devices]
    n = len(devices)
    if height % n:
        raise ValueError(f"height {height} is not divisible by {n} bands")
    if noise_random_numbers is None:
        noise_random_numbers = (np.arange(4) * 0x123456).astype(np.uint32)
    band = height // n
    scenes, constants = {}, {}
    for device in devices:
        if device not in scenes:
            scenes[device] = scene if device == _indexed(scene.device) \
                else to_device(scene, device)
            constants[device] = make_frame_constants(
                camera, width, height, settings, noise_random_numbers,
                device)
    with torch.no_grad():
        bands = [render_frame_constants(
            scenes[device], static, settings, constants[device], width,
            band, row_offset=i * band)
            for i, device in enumerate(devices)]
    return torch.cat([b.to(devices[0]) for b in bands], dim=0)
