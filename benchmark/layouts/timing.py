"""The roughness-planes timing layouts (the port's experiments/setups.py::
timing_lights, frozen; experiment_list.c:364-409): regular n-gons on a
grid 8 m wide, central ones 4 m above the lit region facing down,
decentral ones to the side at a grazing offset."""

import numpy as np


def regular_polygon(vertex_count: int) -> np.ndarray:
    """Plane-space vertices of a regular n-gon inscribed in the unit
    circle (setups._regular_polygon)."""
    a = 2.0 * np.pi * (np.arange(vertex_count) + 0.5) / vertex_count
    return np.stack([np.cos(a), np.sin(a)], axis=-1).astype(np.float32)


def lights(vertex_count: int, central: bool, light_count: int
           ) -> list[dict]:
    out = []
    grid = int(np.ceil(np.sqrt(light_count)))
    verts = regular_polygon(vertex_count)
    for i in range(light_count):
        gx, gy = i % grid, i // grid
        span = 8.0
        x = -span / 2 + (gx + 0.5) * span / grid
        y = -span / 2 + (gy + 0.5) * span / grid
        if central:
            translation = np.array([x, y, 4.0], np.float32)
        else:
            translation = np.array([x + 9.0, y, 1.2], np.float32)
        out.append(dict(
            translation=translation,
            rotation_angles=np.array([np.pi, 0.0, 0.0], np.float32),
            scaling_x=2.5 / grid, scaling_y=2.5 / grid,
            radiant_flux=np.array([25.0, 24.0, 22.0], np.float32)
            / light_count,
            vertices_plane_space=verts))
    return out
