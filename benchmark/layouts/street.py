"""Quad lights in a row facing down: the bench frame's four street lights
(the port's tools/bench_frame.py::lights, frozen) at count 4, x0 -30,
dx 20, height 8, scale 1.5."""

import numpy as np


def lights(count: int, x0: float, dx: float, height: float, scale: float,
           flux: list) -> list[dict]:
    return [dict(
        translation=np.array([x0 + dx * i, 0.0, height], np.float32),
        rotation_angles=np.array([np.pi, 0.0, 0.0], np.float32),
        scaling_x=scale, scaling_y=scale,
        radiant_flux=np.array(flux, np.float32),
        vertices_plane_space=np.array(
            [[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32))
        for i in range(count)]
