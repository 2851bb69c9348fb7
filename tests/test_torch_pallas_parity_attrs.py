"""K3's plain version (render/trace_kernel.py::closest_attrs_plain)
against the JAX Pallas K3 itself, trace_closest_attrs run in interpret
mode, on the primary rays of the tiny city's 64x32 bench-camera frame
(test_torch_pallas_parity_closest.py holds K2 on them).

trace_closest_attrs's 18 attribute planes (its `stale` flag,
:1396-1400, is false on every ray of these inputs, and its prim equals
the port's), against closest_attrs_plain on the port's prim: within 1e-6 of each plane's largest |value|, ten times tighter than
the finalize test's 1e-5 (the same float32 operations; XLA's rsqrt, sqrt
and any fused multiply-add round an ulp apart: 99.4% of the values are
equal, the largest difference 1.7e-7 of its plane's largest |value|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_trace_inputs import city_frame, jax_prim
from vulkan_renderer_tpu.render import trace_kernel as j_trace
from vulkan_renderer_tpu_torch.render import trace_kernel as tk


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    return city_frame(str(tmp_path_factory.mktemp("city")))


def test_attrs_match_pallas_on_frame_primary_rays(frame):
    jax_cl, _, captured = frame
    clusters, _, o, d, dcam = captured["closest_attrs"]
    o, d, dcam = o.numpy(), d.numpy(), dcam.numpy()
    prim, _ = (a.numpy() for a in tk.trace_closest_plain(
        clusters, torch.from_numpy(o), torch.from_numpy(d),
        torch.full((d.shape[0],), float("inf"))))
    got = tk.closest_attrs_plain(clusters, torch.from_numpy(prim).int(),
                                 torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(dcam)).numpy().T
    j_prim, _, uncertain, want, stale = j_trace.trace_closest_attrs(
        jax_cl, jnp.asarray(o), jnp.asarray(d), jnp.asarray(dcam),
        chunk_rows=2, m_budget=64, interpret=True)
    assert int(uncertain) == 0 and not np.asarray(stale).any()
    np.testing.assert_array_equal(jax_prim(j_prim), prim)
    want = np.asarray(want)
    assert got.shape == want.shape and got.shape[1] == tk.ATTR_PLANES
    assert (prim >= 0).sum() > 500
    scale = np.abs(want).max(axis=0)
    assert (np.abs(got - want) <= 1e-6 * scale).all()
