"""Application orchestration: the dependency-tracked rebuild engine and the
pipelined frame loop.

Counterpart of vulkan_renderer_tpu/core/app.py (reference main.c's
application layer):
- ApplicationUpdates + Application.update() reproduce the flag-propagation
  rebuild engine (main.c:1804-1886): each raised flag rebuilds the
  dependent host-side resources (scene, noise table). Resolution and
  shading changes need no flag: the kernels for a configuration are built
  at its first frame (kernels/build.py).
- The frame loop keeps N frames in flight (main.h:359-390 fence ring):
  PyTorch launches asynchronously, so after each frame a CUDA event is
  recorded, and the event of the frame N frames old is waited on before
  the frame timer is stamped. Each dispatched frame gets an index, which
  its spans carry (core/trace.py: frame.dispatch, frame.constants and
  frame.retire here, the stages in render/pipeline.py).

The JAX Application's autotune_exactness and its frame_stats
(uncertain/overflow counters) have no counterpart: the CUDA tracers are
exact by construction, and the harness's CSV writes those columns as 0.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import torch

from ..assets.noise import (INITIAL_RANDOM_SEED,
                            advance_noise_random_numbers,
                            noise_table_for_settings)
from ..assets.quicksave import Quicksave, load_quicksave, save_quicksave
from ..render.pipeline import make_frame_constants, render_frame_constants
from ..render.shading import SceneStatic
from ..scene.camera import FirstPersonCamera
from ..scene.scene import load_scene
from . import trace
from .device import get_device
from .settings import RenderSettings
from .timer import FrameTimer


@dataclasses.dataclass
class ApplicationUpdates:
    """application_updates_t (main.h:430-454)."""
    startup: bool = False
    reload_scene: bool = False
    update_light_count: bool = False
    update_light_textures: bool = False
    regenerate_noise: bool = False
    quick_load: bool = False
    quick_save: bool = False


@dataclasses.dataclass
class SceneSpecification:
    """scene_specification_t: file paths, camera, polygonal lights and
    linear (line segment) lights, the HPG 2021 branch's light type
    (line_sampling.glsl), rendered beside the polygonal ones."""
    name: str = "cornell_box"
    vks_path: str = ""
    texture_dir: str = ""
    quicksave_path: str = ""
    camera: FirstPersonCamera = dataclasses.field(
        default_factory=FirstPersonCamera)
    lights: list = dataclasses.field(default_factory=list)
    linear_lights: list = dataclasses.field(default_factory=list)


class Application:
    """Headless application on one device: owns the scene, the settings
    and the frame loop."""

    def __init__(self, scene_spec: SceneSpecification,
                 settings: RenderSettings | None = None,
                 width: int = 1920, height: int = 1080,
                 frames_in_flight: int = 3, data_directory: str = "data",
                 device: str | torch.device = "cuda"):
        self.scene_spec = scene_spec
        self.settings = settings or RenderSettings()
        self.width = width
        self.height = height
        self.frames_in_flight = frames_in_flight
        self.data_directory = data_directory
        self.device = get_device(device)
        self.timer = FrameTimer()
        self.noise_seed = INITIAL_RANDOM_SEED
        self.scene = None
        self.static: SceneStatic | None = None
        self.frame_index = 0  # the index of the next frame dispatched
        self._in_flight: deque = deque()
        self.update(ApplicationUpdates(startup=True))

    # -- update engine (main.c:1804-1886) ---------------------------------

    def update(self, updates: ApplicationUpdates) -> None:
        if updates.startup:
            updates.reload_scene = True
            updates.regenerate_noise = True
        if updates.quick_load and self.scene_spec.quicksave_path:
            save = load_quicksave(self.scene_spec.quicksave_path)
            self.scene_spec.camera = save.camera
            # The frame reads the scene's baked lights: any quick-load
            # rebuilds the scene.
            updates.update_light_count = True
            self.scene_spec.lights = save.lights
        if updates.quick_save and self.scene_spec.quicksave_path:
            save_quicksave(self.scene_spec.quicksave_path, Quicksave(
                camera=self.scene_spec.camera,
                lights=self.scene_spec.lights))
        rebuilt = updates.reload_scene or updates.update_light_count \
            or updates.update_light_textures
        if rebuilt:
            # A rebuilt scene loads the settings' noise table with it.
            self._rebuild_scene()
        if updates.regenerate_noise:
            self.noise_seed = INITIAL_RANDOM_SEED
            if not rebuilt:
                self._rebuild_scene_noise()

    def _rebuild_scene(self) -> None:
        self.scene = load_scene(
            self.scene_spec.vks_path, self.scene_spec.texture_dir,
            self.scene_spec.lights, self.device,
            noise_type=self.settings.noise_type,
            data_directory=self.data_directory,
            linear_light_specs=self.scene_spec.linear_lights)
        self.static = SceneStatic.for_scene(self.scene)

    def _rebuild_scene_noise(self) -> None:
        if self.scene is None:
            return
        table = noise_table_for_settings(self.settings.noise_type,
                                         self.data_directory)
        self.scene.noise_table = torch.from_numpy(
            table.table.astype("int32")).to(self.device)
        self.scene.noise_texture_index_mask = table.texture_index_mask

    # -- frame loop --------------------------------------------------------

    def _dispatch(self):
        index = self.frame_index
        self.frame_index += 1
        with trace.span("frame.dispatch", frame=index, device=self.device):
            with trace.span("frame.constants"):
                self.noise_seed, randoms = advance_noise_random_numbers(
                    self.noise_seed, self.settings.animate_noise
                    and self.settings.frame_bits == 0)
                constants = make_frame_constants(
                    self.scene_spec.camera, self.width, self.height,
                    self.settings, randoms, self.device)
            # Called through this module's name, which a measuring harness
            # may wrap.
            with torch.no_grad():
                frame = render_frame_constants(self.scene, self.static,
                                               self.settings, constants,
                                               self.width, self.height)
            event = None
            if self.device.type == "cuda":
                event = trace.frame_end_event(index)
                event.record(torch.cuda.current_stream(self.device))
        self._in_flight.append((index, frame, event))

    def _retire(self):
        index, frame, event = self._in_flight.popleft()
        with trace.span("frame.retire", frame=index):
            if event is not None:
                event.synchronize()
        trace.frame_retired(index)
        return frame

    def render_frame_async(self):
        """Dispatch one frame; wait on the frame `frames_in_flight` old like
        the reference's per-image fences (main.c:2208-2225), stamp the
        timer and return that frame (None while the queue fills)."""
        self._dispatch()
        if len(self._in_flight) > self.frames_in_flight:
            oldest = self._retire()
            self.timer.record()
            return oldest
        return None

    def render_frame_sync(self):
        """Render one frame and wait for it and every frame before it;
        stamps the timer once and returns the frame on the device."""
        self._dispatch()
        frame = None
        while self._in_flight:
            frame = self._retire()
        self.timer.record()
        return frame
