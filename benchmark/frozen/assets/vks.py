""".vks scene file parser/writer.

The port's own copy of vulkan_renderer_tpu/assets/vks.py, byte-identical
with the reference format (scene.c:409-483 for the reader,
tools/io_export_vulkan_blender28.py:470-531 for the writer). Decoding the
quantized positions and normals is scene/scene.py::mesh_triangles.

  u32 marker 0xabcabc | u32 version 1
  u64 material_count | u64 triangle_count
  f32[3] dequantization_factor | f32[3] dequantization_summand
  per material: u64 name_length | name_length+1 bytes (NUL included)
  positions:  u32 x 2 per vertex, 3 vertices per triangle (21-bit packed)
  normals/uv: u16 x 4 per vertex (octahedral normal x2, uv x2 scaled by 8)
  material index: u8 per triangle
  u32 eof 0xE0FE0F
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

MARKER = 0xABCABC
EOF_MARKER = 0xE0FE0F
VERSION = 1


@dataclasses.dataclass
class SceneMesh:
    """Parsed mesh in the exact GPU-facing layout of the reference."""
    material_names: list[str]
    dequantization_factor: np.ndarray   # (3,) f32
    dequantization_summand: np.ndarray  # (3,) f32
    quantized_positions: np.ndarray     # (3*T, 2) u32
    normals_and_tex_coords: np.ndarray  # (3*T, 4) u16
    material_indices: np.ndarray        # (T,) u8

    @property
    def triangle_count(self) -> int:
        return int(self.material_indices.shape[0])


def load_vks(path: str) -> SceneMesh:
    with open(path, "rb") as f:
        marker, version = struct.unpack("<II", f.read(8))
        if marker != MARKER or version != VERSION:
            raise ValueError(f"{path}: bad marker 0x{marker:x} / version {version}")
        material_count, triangle_count = struct.unpack("<QQ", f.read(16))
        factor = np.frombuffer(f.read(12), np.float32).copy()
        summand = np.frombuffer(f.read(12), np.float32).copy()
        names = []
        for _ in range(material_count):
            (name_length,) = struct.unpack("<Q", f.read(8))
            raw = f.read(name_length + 1)
            names.append(raw[:name_length].decode("utf-8", "replace"))
        vert_count = 3 * triangle_count
        positions = np.frombuffer(f.read(8 * vert_count), np.uint32) \
            .reshape(vert_count, 2).copy()
        normals_uv = np.frombuffer(f.read(8 * vert_count), np.uint16) \
            .reshape(vert_count, 4).copy()
        material_indices = np.frombuffer(f.read(triangle_count), np.uint8).copy()
        (eof,) = struct.unpack("<I", f.read(4))
        if eof != EOF_MARKER:
            raise ValueError(f"{path}: missing EOF marker (got 0x{eof:x})")
    return SceneMesh(names, factor, summand, positions, normals_uv,
                     material_indices)


def save_vks(path: str, mesh: SceneMesh) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<II", MARKER, VERSION))
        f.write(struct.pack("<QQ", len(mesh.material_names),
                            mesh.triangle_count))
        f.write(np.asarray(mesh.dequantization_factor, np.float32).tobytes())
        f.write(np.asarray(mesh.dequantization_summand, np.float32).tobytes())
        for name in mesh.material_names:
            encoded = name.encode("utf-8")
            f.write(struct.pack("<Q", len(encoded)))
            f.write(encoded + b"\x00")
        f.write(np.ascontiguousarray(mesh.quantized_positions, np.uint32).tobytes())
        f.write(np.ascontiguousarray(mesh.normals_and_tex_coords, np.uint16).tobytes())
        f.write(np.ascontiguousarray(mesh.material_indices, np.uint8).tobytes())
        f.write(struct.pack("<I", EOF_MARKER))
