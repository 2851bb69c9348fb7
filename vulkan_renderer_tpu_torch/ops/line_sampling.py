"""Linear (line segment) light sampling: the HPG 2021 companion paper's
capability ("BRDF Importance Sampling for Linear Lights"; the reference
keeps it on a branch with line_sampling.glsl).

Counterpart of vulkan_renderer_tpu/ops/line_sampling.py, batched over a
leading pixel axis P. A thin Lambertian cylinder of radius r -> 0
collapses to a segment [A, B]; the line point P(t) contributes
f_r * cos(theta_x) * L_eff * sin(alpha) / d^2 * len dt to the shading
point x, alpha being the angle between the line and the direction to
P(t), L_eff = Phi / (pi^2 * len) the linear radiance.

Techniques: uniform (t ~ U[0, 1]), distance (t ~ 1/d^2, the exact
inverse CDF of the perpendicular-foot atan parametrization) and
resampled importance sampling (RIS) toward a diffuse or LTC target over
distance-sampled candidates.
"""

from __future__ import annotations

import dataclasses

import torch

from .math_utils import dot


@dataclasses.dataclass
class LineSampling:
    """Per-(shading point, segment) intermediates; (P,) or (P, 3) fields
    (start, axis and length are the segment's own)."""
    start: torch.Tensor      # (3,) segment start A
    axis: torch.Tensor       # (3,) unit direction (B - A) / len
    length: torch.Tensor     # ()
    foot_s: torch.Tensor     # (P,) arc parameter of the perpendicular foot
    perp: torch.Tensor       # (P, 3) offset from x to the foot
    h: torch.Tensor          # (P,) perpendicular distance (>= 1e-6)
    theta0: torch.Tensor     # (P,) atan2(0 - foot_s, h)
    theta1: torch.Tensor     # (P,) atan2(len - foot_s, h)
    norm_1_d2: torch.Tensor  # (P,) integral of 1/d^2 dl


def prepare_line_sampling(a, b, shading_position) -> LineSampling:
    """a, b: (3,) segment ends; shading_position: (P, 3)."""
    delta = b - a
    length = torch.sqrt(dot(delta, delta))
    axis = delta / torch.clamp(length, min=1e-20)
    to_a = a - shading_position
    foot_s = -dot(to_a, axis)
    perp = -(to_a + foot_s[:, None] * axis)
    h = torch.clamp(torch.sqrt(dot(perp, perp)), min=1e-6)
    theta0 = torch.atan2(0.0 - foot_s, h)
    theta1 = torch.atan2(length - foot_s, h)
    return LineSampling(start=a, axis=axis, length=length, foot_s=foot_s,
                        perp=perp, h=h, theta0=theta0, theta1=theta1,
                        norm_1_d2=(theta1 - theta0) / h)


def line_point(prep: LineSampling, t):
    return prep.start + (t * prep.length)[..., None] * prep.axis


def line_geometry(prep: LineSampling, t, shading_position):
    """(omega (P, 3), dist (P,), sin_alpha (P,)) toward parameter t."""
    offset = line_point(prep, t) - shading_position
    dist = torch.clamp(torch.sqrt(dot(offset, offset)), min=1e-8)
    omega = offset / dist[:, None]
    cos_alpha = torch.clamp(dot(omega, prep.axis), -1.0, 1.0)
    sin_alpha = torch.sqrt(torch.clamp(1.0 - cos_alpha * cos_alpha,
                                       min=0.0))
    return omega, dist, sin_alpha


def sample_line_uniform(prep: LineSampling, u):
    """t ~ U[0, 1]; density per unit length 1 / len."""
    return u, (1.0 / torch.clamp(prep.length, min=1e-20)).expand_as(u)


def sample_line_distance(prep: LineSampling, u):
    """t ~ 1/d^2 (exact): s = foot + h tan(lerp(theta0, theta1, u)).
    Returns (t in [0, 1], density per unit length)."""
    theta = prep.theta0 + u * (prep.theta1 - prep.theta0)
    s = prep.foot_s + prep.h * torch.tan(theta)
    t = torch.clamp(s / torch.clamp(prep.length, min=1e-20), 0.0, 1.0)
    d_sq = prep.h * prep.h + (s - prep.foot_s) ** 2
    return t, 1.0 / (d_sq * prep.norm_1_d2)


def sample_line_ris(prep: LineSampling, shading_position, target_fn,
                    random_numbers, ris_candidates: int = 4):
    """Resampled importance sampling toward target_fn(t, omega, dist,
    sin_alpha) -> (P,) >= 0. random_numbers: (P, ris_candidates + 1, 2):
    [:, i, 0] draws candidate i, [:, -1, 1] selects one. Returns (t,
    omega, dist, sin_alpha, weight): the unbiased estimate is
    f(t) * weight, weight = mean_i(target_i / source_i) / target(t)."""
    ts, weights, targets, geo = [], [], [], []
    for i in range(ris_candidates):
        t_i, src_density = sample_line_distance(prep,
                                                random_numbers[:, i, 0])
        omega, dist, sin_alpha = line_geometry(prep, t_i, shading_position)
        tgt = target_fn(t_i, omega, dist, sin_alpha)
        ts.append(t_i)
        weights.append(tgt / torch.clamp(src_density, min=1e-20))
        targets.append(tgt)
        geo.append((omega, dist, sin_alpha))
    cum = []
    total = None
    for w in weights:
        total = w if total is None else total + w
        cum.append(total)
    pick = random_numbers[:, -1, 1] * total
    # The first candidate whose cumulative weight exceeds the pick;
    # candidate 0 when none does or the total is not positive.
    sel = torch.zeros_like(pick, dtype=torch.int64)
    found = torch.zeros_like(pick, dtype=torch.bool)
    for i, c in enumerate(cum):
        hit = (pick < c) & ~found
        sel = torch.where(hit, i, sel)
        found = found | hit
    sel = torch.where(total > 0.0, sel, 0)

    def pick_lane(values):
        out = values[0]
        for i in range(1, ris_candidates):
            mask = sel == i
            out = torch.where(mask[:, None] if out.dim() == 2 else mask,
                              values[i], out)
        return out

    t = pick_lane(ts)
    omega = pick_lane([g[0] for g in geo])
    dist = pick_lane([g[1] for g in geo])
    sin_alpha = pick_lane([g[2] for g in geo])
    target_sel = pick_lane(targets)
    ris_weight = total / ris_candidates
    inv_target = torch.where(target_sel > 0.0,
                             1.0 / torch.clamp(target_sel, min=1e-30), 0.0)
    return t, omega, dist, sin_alpha, ris_weight * inv_target
