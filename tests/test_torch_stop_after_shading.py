"""stop_after, the port's stage cut-off, against the JAX package's: the
stages from the shading on, on the per-pixel paths ("shade",
"shadowrays", "shadow", and "shadow" without shadows, which cuts after
the shading in both packages).

The port's frame takes SceneStatic.fused="off" and the JAX frame its
CPU's per-pixel path (fused="auto", traversal="bruteforce"): the same
formulation, whose exits mean the same: after the shading, after the
shadow megabatch, after the shadow trace. The scene, frame, exit
readings and tolerances are test_torch_stop_after.py's: base, b,
directions and t_max within SUM_RTOL of their sum of |x| over the
values a frame uses, visibility exactly, and the port's image the stub
of its exit tensors.
"""

import dataclasses

import pytest

from test_torch_stop_after import (assert_exit_matches_jax,  # noqa: F401
                                   assert_stub, hit, jax_exit, port_exit,
                                   scenes)


@pytest.mark.parametrize("stage, shadows", [
    ("shade", True), ("shadowrays", True), ("shadow", True),
    ("shadow", False)])
def test_stage_matches_jax_stub(scenes, hit, stage, shadows):  # noqa: F811
    jscene, scene, static = scenes
    cut = port_exit(scene, dataclasses.replace(static, fused="off"), stage,
                    shadows)
    assert_stub(cut)
    assert_exit_matches_jax(stage, cut,
                            jax_exit(jscene, stage, shadows, fused="auto"),
                            hit, shadows)
