"""stop_after, the port's stage cut-off, against the JAX package's: the
stages from the shading on, on the fused path (K4 with shadows, K5
without), against the JAX package's fused path, its Pallas kernels
interpreted on the CPU (fused="on", traversal="bruteforce").

"shade" with shadows holds K4's planes (base, b, and the live slots'
directions and t_max), "shadow" K1's visibility of K4's shadow rays, and
"shade" without shadows K5's colors. The megabatch between them is the
per-pixel path's (test_torch_stop_after_shading.py). The scene, frame, exit readings and
tolerances are test_torch_stop_after.py's. Each JAX exit compiles the
interpreted kernel anew (~20 s).
"""

import pytest

from test_torch_stop_after import (assert_exit_matches_jax,  # noqa: F401
                                   assert_stub, hit, jax_exit, port_exit,
                                   scenes)


@pytest.mark.parametrize("stage, shadows", [
    ("shade", True), ("shadow", True), ("shade", False)])
def test_fused_stage_matches_jax_stub(scenes, hit, stage,  # noqa: F811
                                      shadows):
    jscene, scene, static = scenes
    cut = port_exit(scene, static, stage, shadows)
    assert_stub(cut)
    assert_exit_matches_jax(stage, cut,
                            jax_exit(jscene, stage, shadows, fused="on"),
                            hit, shadows)
