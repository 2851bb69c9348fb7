"""Image-row bands (parallel/tiles.py render_frame_bands) on the CPU: a
frame rendered as 2 and 4 bands of rows equals the whole frame bit for
bit, on the kernels' plain versions with shadows (K4 + K1) and without
(K5) and on the per-pixel path; and the banded frame agrees with the JAX
package's whole frame at the frame tolerance of test_torch_frame.py
(mean |sRGB difference| <= 1e-3, >= 99% of pixels within 1e-2)."""

import numpy as np
import pytest

from _torch_shading_inputs import to_port
from test_torch_hdr import HEIGHT, WIDTH, cornell  # noqa: F401 (fixture)
from vulkan_renderer_tpu.core.settings import (RenderSettings,
                                               SamplingStrategy)
from vulkan_renderer_tpu.render.pipeline import render_frame as j_render
from vulkan_renderer_tpu.render.shading import SceneStatic as JSceneStatic
from vulkan_renderer_tpu_torch.parallel.tiles import render_frame_bands
from vulkan_renderer_tpu_torch.render.pipeline import render_frame
from vulkan_renderer_tpu_torch.render.shading import SceneStatic
from vulkan_renderer_tpu_torch.scene.scene import (scene_from_numpy,
                                                   tree_leaves)

CASES = {
    "k4_shadows": (RenderSettings(trace_shadow_rays=True), "auto"),
    "k5": (RenderSettings(trace_shadow_rays=False), "auto"),
    "per_pixel": (RenderSettings(
        sampling_strategy=SamplingStrategy.DIFFUSE_SPECULAR_SEPARATELY,
        trace_shadow_rays=True), "off"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bands_equal_the_whole_frame(cornell, case):  # noqa: F811
    jscene, camera = cornell
    settings, fused = CASES[case]
    scene = scene_from_numpy(tree_leaves(jscene), "cpu")
    static = SceneStatic.for_scene(scene, fused=fused)
    whole = render_frame(scene, static, to_port(camera), to_port(settings),
                         WIDTH, HEIGHT).numpy()
    for n in (2, 4):
        banded = render_frame_bands(["cpu"] * n, scene, static,
                                    to_port(camera), to_port(settings),
                                    WIDTH, HEIGHT).numpy()
        np.testing.assert_array_equal(banded, whole, err_msg=f"{n} bands")
    jstatic = JSceneStatic(light_count=1, light_texturing=(0,),
                           traversal="bruteforce")
    want = np.asarray(j_render(jscene, jstatic, camera, settings, WIDTH,
                               HEIGHT))
    diff = np.abs(banded - want)
    assert diff.mean() <= 1e-3, diff.mean()
    assert (diff.max(axis=-1) <= 1e-2).mean() >= 0.99
    assert 0.05 < banded.mean() < 0.95


def test_bands_must_divide_the_height(cornell):  # noqa: F811
    jscene, camera = cornell
    scene = scene_from_numpy(tree_leaves(jscene), "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        render_frame_bands(["cpu"] * 3, scene, SceneStatic.for_scene(scene),
                           to_port(camera), to_port(RenderSettings()), WIDTH,
                           HEIGHT)


def test_to_device_moves_every_tensor(cornell):  # noqa: F811
    """The scene copy a band on another device renders from: every tensor
    of the tree on the target device (the meta device here), the other
    fields kept."""
    import dataclasses

    import torch

    from vulkan_renderer_tpu_torch.parallel.tiles import to_device
    jscene, _ = cornell
    scene = scene_from_numpy(tree_leaves(jscene), "cpu")
    moved = to_device(scene, torch.device("meta"))

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        if dataclasses.is_dataclass(tree):
            return [x for f in dataclasses.fields(tree)
                    for x in leaves(getattr(tree, f.name))]
        return []

    assert len(leaves(moved)) == len(leaves(scene)) > 20
    assert all(t.device.type == "meta" for t in leaves(moved))
    assert moved.noise_texture_index_mask == scene.noise_texture_index_mask
    assert moved.clusters.cluster_count == scene.clusters.cluster_count
