"""Minimal interactive viewer (reference: the GLFW window + ImGui panel,
user_interface.cpp / control_camera, camera.c:86-131).

Counterpart of vulkan_renderer_tpu/tools/viewer.py over the port's
Application. A matplotlib-window front end: first-person
camera controls with the reference's key bindings and movement math, and
setting toggles whose combinations pass through legalize_settings — the
same masking the reference GUI performs — so no key press can produce an
illegal configuration.

Keys (camera.c:116-131 bindings; rotation on arrows instead of the mouse):
    w/s     forward/back          a/d    strafe left/right
    q/e     down/up               arrows rotate (x: up/down, z: left/right)
    t/T     next/prev sampling technique
    y       cycle sampling strategy        u    cycle MIS heuristic
    r       toggle shadow rays             p    screenshot
Headless environments (no display) can use run_orbit() instead, which
renders a deterministic camera orbit to PNG files — the same code path,
testable without a window, and without matplotlib, which only run()
imports.

    python -m vulkan_renderer_tpu_torch.tools.viewer [--scene cornell_box] \
        [--device cuda] [--orbit]
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..core.settings import (MisHeuristic, PolygonSamplingTechnique,
                             SamplingStrategy, legalize_settings)
from ..scene.camera import FirstPersonCamera

_STEP_RADIANS = np.pi / 36.0


def move_camera(camera: FirstPersonCamera, forward: float = 0.0,
                right: float = 0.0, vertical: float = 0.0,
                rotate_x: float = 0.0, rotate_z: float = 0.0
                ) -> FirstPersonCamera:
    """The reference's movement math (camera.c:124-131) + the GUI's
    rotation_x clamp to [0, pi] (camera.c:102-103)."""
    cos_z, sin_z = np.cos(camera.rotation_z), np.sin(camera.rotation_z)
    position = np.asarray(camera.position_world_space, np.float32).copy()
    position[0] -= sin_z * forward + cos_z * right
    position[1] -= cos_z * forward - sin_z * right
    position[2] += vertical
    rotation_x = float(np.clip(camera.rotation_x + rotate_x, 0.0, np.pi))
    return dataclasses.replace(
        camera, position_world_space=position, rotation_x=rotation_x,
        rotation_z=camera.rotation_z + rotate_z)


def _cycle(enum_cls, value, delta: int):
    members = list(enum_cls)
    return members[(members.index(value) + delta) % len(members)]


class InteractiveViewer:
    """Drives an Application at a reduced preview resolution."""

    def __init__(self, app, width: int = 480, height: int = 270,
                 speed: float = 0.5):
        self.app = app
        app.width, app.height = width, height
        self.speed = speed
        self.frame_count = 0

    def handle_key(self, key: str) -> bool:
        """Apply one key press; returns True when a re-render is needed."""
        app = self.app
        cam = app.scene_spec.camera
        s = self.speed
        moves = {"w": dict(forward=s), "s": dict(forward=-s),
                 "d": dict(right=s), "a": dict(right=-s),
                 "e": dict(vertical=s), "q": dict(vertical=-s),
                 "up": dict(rotate_x=-_STEP_RADIANS),
                 "down": dict(rotate_x=_STEP_RADIANS),
                 "left": dict(rotate_z=-_STEP_RADIANS),
                 "right": dict(rotate_z=_STEP_RADIANS)}
        if key in moves:
            app.scene_spec.camera = move_camera(cam, **moves[key])
            return True
        settings = app.settings
        if key in ("t", "T"):
            app.settings = legalize_settings(
                settings, polygon_sampling_technique=_cycle(
                    PolygonSamplingTechnique,
                    settings.polygon_sampling_technique,
                    1 if key == "t" else -1))
            return True
        if key == "y":
            app.settings = legalize_settings(
                settings, sampling_strategy=_cycle(
                    SamplingStrategy, settings.sampling_strategy, 1))
            return True
        if key == "u":
            app.settings = legalize_settings(
                settings, mis_heuristic=_cycle(
                    MisHeuristic, settings.mis_heuristic, 1))
            return True
        if key == "r":
            app.settings = legalize_settings(
                settings, trace_shadow_rays=not settings.trace_shadow_rays)
            return True
        if key == "p":
            from ..render.screenshot import take_screenshot
            take_screenshot(f"viewer_{self.frame_count:05d}.png",
                            self.render())
            return False
        return False

    def render(self) -> np.ndarray:
        """The app's next frame as a host (H, W, 3) array."""
        self.frame_count += 1
        return self.app.render_frame_sync().detach().cpu().numpy()

    def run(self):
        """Open the matplotlib window loop (needs a display)."""
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(num="vulkan_renderer_tpu_torch viewer")
        image = ax.imshow(np.clip(self.render(), 0.0, 1.0))
        ax.set_axis_off()

        def on_key(event):
            if event.key == "escape":
                plt.close(fig)
                return
            if self.handle_key(event.key or ""):
                image.set_data(np.clip(self.render(), 0.0, 1.0))
                fig.canvas.draw_idle()

        fig.canvas.mpl_connect("key_press_event", on_key)
        title = (f"{self.app.settings.polygon_sampling_technique.value} / "
                 f"{self.app.settings.sampling_strategy.value}")
        ax.set_title(title, fontsize=8)
        plt.show()


def run_orbit(app, frames: int = 8, output_dir: str = "viewer_orbit",
              width: int = 160, height: int = 90) -> list:
    """Headless stand-in for the window loop: render `frames` steps of a
    camera orbit through the SAME key-handling path. Returns PNG paths."""
    from ..render.screenshot import take_screenshot
    viewer = InteractiveViewer(app, width, height)
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for i in range(frames):
        viewer.handle_key("right")
        viewer.handle_key("w" if i % 2 == 0 else "s")
        img = viewer.render()
        path = os.path.join(output_dir, f"orbit_{i:03d}.png")
        take_screenshot(path, img)
        paths.append(path)
    return paths


def main(argv=None) -> int:
    import argparse

    from ..core.app import Application, SceneSpecification
    from ..experiments.registry import resolve_scene
    from ..experiments.setups import (_scene_default_camera,
                                      _scene_default_lights)

    parser = argparse.ArgumentParser(description="Interactive viewer")
    parser.add_argument("--scene", default="cornell_box")
    parser.add_argument("--width", type=int, default=480)
    parser.add_argument("--height", type=int, default=270)
    parser.add_argument("--orbit", action="store_true",
                        help="headless orbit capture instead of a window")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card) or cpu (plain versions)")
    parser.add_argument("--data-directory", default="data")
    parser.add_argument("--output-dir", default="viewer_orbit")
    args = parser.parse_args(argv)

    entry = resolve_scene(args.scene, args.data_directory)
    app = Application(SceneSpecification(
        name=args.scene, vks_path=entry.vks_path,
        texture_dir=entry.texture_dir,
        camera=_scene_default_camera(args.scene),
        lights=_scene_default_lights(args.scene)),
        width=args.width, height=args.height,
        data_directory=args.data_directory, device=args.device)
    if args.orbit:
        for p in run_orbit(app, output_dir=args.output_dir,
                           width=args.width, height=args.height):
            print(p)
        return 0
    InteractiveViewer(app, args.width, args.height).run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
