"""The per-pixel preamble: kernel K6 (csrc/preamble.cu) and its plain
PyTorch version.

Both take K3's (ATTR_PLANES, P) attribute planes, the closest hit (prim
(P,) int32, t_hit (P,)) and the (P, 3) rays of a frame, and give its (62, P)
float32 planes of render/fused.py BASE_PLANES: each pixel's position,
shading data, hit flag and LTC coefficients (the JAX package's
render/pipeline.py _pixel_preamble less the light display). K4 and K5 read
the planes; fused.plane_views gives the per-pixel path, the light display
and K1's slot entry (the shading points) their (P, ...) views.

K6 replaces no Pallas kernel: the JAX package leaves this preamble to XLA's
fusion of its jnp code (csrc/preamble.cu says why the port has it and what
bounds it).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import trace
from ..kernels import build
from ..ops.ltc import get_ltc_coefficients
from .fused import BASE_PLANES, pack_planes
from .shading import INVALID_PRIMITIVE, FrameConstants, finish_shading_data
from .trace_kernel import ATTR_PLANES

# k6_preamble's arguments.
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p,   # attrs, prim
             ctypes.c_void_p, ctypes.c_void_p,   # t_hit, ray directions
             ctypes.c_int, ctypes.c_void_p,      # P, camera position
             ctypes.c_float,                     # roughness factor
             ctypes.c_void_p,                    # atlas texels
             ctypes.c_void_p, ctypes.c_void_p,   # mip offsets, widths
             ctypes.c_void_p, ctypes.c_void_p,   # mip heights, counts
             ctypes.c_int,                       # mip levels per texture
             ctypes.c_void_p, ctypes.c_int,      # LTC table, its layers
             ctypes.c_int, ctypes.c_int,         # its height and width
             ctypes.c_void_p,                    # its constants
             ctypes.c_void_p, ctypes.c_void_p]   # out, stream


def shading_planes_plain(scene, constants: FrameConstants, attrs, prim,
                         t_hit, ray_dirs) -> torch.Tensor:
    """Plain version of K6: the (62, P) planes, by the texture fetch and
    material decode (render/shading.py finish_shading_data), the LTC
    coefficients (ops/ltc.py) and render/fused.py pack_planes."""
    hit = prim != INVALID_PRIMITIVE
    t_safe = torch.where(hit & torch.isfinite(t_hit), t_hit, 0.0)
    position = constants.camera_position + t_safe[:, None] * ray_dirs
    data = finish_shading_data(scene, constants, attrs, position)
    f0 = data.fresnel_0
    fresnel_luminance = f0[:, 0] * 0.2126 + f0[:, 1] * 0.7152 \
        + f0[:, 2] * 0.0722
    with trace.span("preamble.ltc"):
        ltc = get_ltc_coefficients(scene.ltc, fresnel_luminance,
                                   data.roughness, data.position,
                                   data.normal, data.outgoing)
    return pack_planes(data, ltc, hit)


def shading_planes(scene, constants: FrameConstants, attrs, prim, t_hit,
                   ray_dirs) -> torch.Tensor:
    """The frame's (62, P) planes of BASE_PLANES. CPU tensors take
    shading_planes_plain; CUDA tensors launch K6, which adds one to the
    counter "K6.launches" (core/trace.py)."""
    if ray_dirs.device.type == "cpu":
        return shading_planes_plain(scene, constants, attrs, prim, t_hit,
                                    ray_dirs)
    atlas, ltc = scene.material_atlas, scene.ltc
    camera = constants.camera_position
    build.require_cuda(attrs, prim, t_hit, ray_dirs, camera, atlas.texels,
                       atlas.mip_offset, atlas.mip_width, atlas.mip_height,
                       atlas.mip_count, ltc.table, ltc.constants)
    p = ray_dirs.shape[0]
    build.check_tensor(attrs, "attrs", torch.float32, (ATTR_PLANES, p))
    build.check_tensor(prim, "prim", torch.int32, (p,))
    build.check_tensor(t_hit, "t_hit", torch.float32, (p,))
    build.check_tensor(ray_dirs, "ray_dirs", torch.float32, (p, 3))
    build.check_tensor(camera, "camera_position", torch.float32, (3,))
    textures, levels = atlas.mip_offset.shape
    build.check_tensor(atlas.texels, "texels", torch.int32,
                       (atlas.texels.shape[0], 8))
    for name in ("mip_offset", "mip_width", "mip_height"):
        build.check_tensor(getattr(atlas, name), name, torch.int64,
                           (textures, levels))
    build.check_tensor(atlas.mip_count, "mip_count", torch.int64,
                       (textures,))
    build.check_tensor(ltc.table, "ltc table", torch.float32,
                       (*ltc.table.shape[:3], 6))
    build.check_tensor(ltc.constants, "ltc constants", torch.float32, (6,))
    out = torch.empty((len(BASE_PLANES), p), dtype=torch.float32,
                      device=ray_dirs.device)
    if p == 0:
        return out
    lib = build.load_library("preamble", {"k6_preamble": _ARGTYPES})
    layers, height, width = ltc.table.shape[:3]
    with torch.cuda.device(ray_dirs.device):
        err = lib.k6_preamble(
            build.ptr(attrs), build.ptr(prim), build.ptr(t_hit),
            build.ptr(ray_dirs), p, build.ptr(camera),
            float(constants.roughness_factor), build.ptr(atlas.texels),
            build.ptr(atlas.mip_offset), build.ptr(atlas.mip_width),
            build.ptr(atlas.mip_height), build.ptr(atlas.mip_count), levels,
            build.ptr(ltc.table), layers, height, width,
            build.ptr(ltc.constants), build.ptr(out),
            build.stream(ray_dirs.device))
    build.check_launch(err, "k6_preamble")
    trace.count("K6.launches")
    return out
