// Device code shared by kernels K4 (fused_shading.cu) and K5
// (fused_resolved.cu): the per-pixel shading math of one polygonal light.
//
// Every function is the scalar form of the plain PyTorch version
// (vulkan_renderer_tpu_torch/ops/soa.py, ops/soa_techniques.py,
// ops/soa_arvo_psa.py, render/fused.py), which in turn follows the JAX
// package's SoA code (vulkan_renderer_tpu/ops/soa*.py, render/fused.py
// :156-467) operation by operation and in the same order. The kernels are
// built with --fmad=false, so no product is fused behind our back, and a
// scalar divided by a tensor is written (1 / x) * c, as PyTorch computes
// it. Per-lane selects are unrolled compare/select chains over
// compile-time lane indices, so every polygon lane stays in registers
// (or spills to L1-resident local memory) instead of dynamic indexing.
//
// Compile-time configuration (one library per combination, kernels/
// build.py):
//   VR_TECHNIQUE  PolygonSamplingTechnique, in render/fused.py TECHNIQUE_IDS
//                 order (the order of the enum);
//   VR_MIS        1 for DIFFUSE_SPECULAR_MIS (PSA pair only), 0 for
//                 DIFFUSE_ONLY;
//   VR_HEURISTIC  MIS heuristic (render/fused.py HEURISTIC_IDS), read only
//                 under VR_MIS;
//   VR_COUNT_OPS  1 in the counting build, whose f32 counts every float
//                 operation executed (count_ops.cuh); f32 is float
//                 otherwise.
#pragma once

#include "common.cuh"
#include "count_ops.cuh"

#ifndef VR_TECHNIQUE
#error "VR_TECHNIQUE must be defined (render/fused.py TECHNIQUE_IDS)"
#endif
#ifndef VR_MIS
#error "VR_MIS must be defined (0 DIFFUSE_ONLY, 1 DIFFUSE_SPECULAR_MIS)"
#endif
#ifndef VR_HEURISTIC
#error "VR_HEURISTIC must be defined (0 balance, 1 power, 2 weighted, 3 optimal_clamped, 4 optimal)"
#endif

namespace shade {

using vrt::f32;
using vrt::raw;

enum : int {
  kBaseline = 0,
  kAreaTurk = 1,
  kUrena = 2,
  kSolidAngleArvo = 3,
  kSolidAngle = 4,
  kClippedSolidAngle = 5,
  kBilinearHart = 6,
  kBilinearClippingHart = 7,
  kBiquadraticHart = 8,
  kBiquadraticClippingHart = 9,
  kPsaArvo = 10,
  kPsa = 11,
  kPsaBiased = 12,
};

constexpr int kTechnique = VR_TECHNIQUE;
constexpr bool kMis = VR_MIS != 0;
constexpr int kHeuristic = VR_HEURISTIC;
constexpr bool kBiased = kTechnique == kPsaBiased;
static_assert(kTechnique >= 0 && kTechnique <= 12, "unknown technique");
static_assert(!kMis || kTechnique == kPsa || kTechnique == kPsaBiased,
              "DIFFUSE_SPECULAR_MIS is fused for the PSA pair only");

// Constants rounded from double exactly as the plain version's Python
// scalars are.
constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = (float)kPiD;
constexpr float kTwoPi = (float)(2.0 * kPiD);
constexpr float kHalfPi = (float)(0.5 * kPiD);
constexpr float kQuarterPi = (float)(0.25 * kPiD);
constexpr float kInvPi = (float)(1.0 / kPiD);
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kTwoThirds = (float)(2.0 / 3.0);

// Light record layout (render/fused.py LS_*).
constexpr int kLightScalars = 58;
constexpr int kLsPlane = 24;
constexpr int kLsRadiance = 28;
constexpr int kLsRotation = 31;
constexpr int kLsTranslation = 40;
constexpr int kLsScaling = 43;
constexpr int kLsArea = 45;
constexpr int kLsFan = 46;
constexpr int kBasePlanes = 62;

struct V2 {
  f32 x, y;
};
struct V3 {
  f32 x, y, z;
};

K_INLINE bool signbit_f(f32 x) { return (__float_as_uint(raw(x)) >> 31) != 0; }
K_INLINE f32 dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
K_INLINE V3 sub3(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
K_INLINE V3 scale3(f32 s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
K_INLINE V3 add3(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
K_INLINE V3 normalize3(V3 a) { return scale3(rsqrtf(dot3(a, a)), a); }
K_INLINE V3 select3(bool c, V3 a, V3 b) { return c ? a : b; }
// mix_fma(x, y, a) = a * y + (x - a * x), ops/soa.py mix_fma.
K_INLINE f32 mix_fma(f32 x, f32 y, f32 a) { return a * y + (x - a * x); }
// A Python scalar c divided by a tensor x: PyTorch computes
// x.reciprocal() * c.
K_INLINE f32 rdiv(f32 c, f32 x) { return (1.0f / x) * c; }
K_INLINE f32 clip01(f32 x) { return vrt::jclip(x, 0.0f, 1.0f); }

// --- error-free products (ops/math_utils.py two_product / kahan) -----------

// p = a * b rounded and its exact error e = a * b - p, with the bits of
// the plain version's Dekker split (ops/math_utils.py two_product). One
// fused multiply-add rounds a * b - p once, and that difference is exactly
// representable, so it is Dekker's float wherever Dekker's split is exact:
// |a|, |b| < 2^115 (a * 4097 finite), |a * b| < 2^127, and a * b zero or
// at least 2^-102 in magnitude (tests/test_torch_two_product.py). kFma
// takes the FMA, which the caller may ask for only where fma_exact holds
// for every operand; otherwise two_product runs Dekker's split itself, in
// the plain version's order (the kernels are built with --fmad=false, so
// no step of it is fused). The callers test a polygon's coordinates once
// and take one of two instantiations: a test per product measured K4
// +40% and K5 PSA +57% on the H100 (PERF.md section 6). The FMA is the
// only one the kernels issue.
K_INLINE f32 dekker_error(f32 a, f32 b, f32 p) {
  f32 a_hi = a * 4097.0f;
  a_hi = a_hi - (a_hi - a);
  const f32 a_lo = a - a_hi;
  f32 b_hi = b * 4097.0f;
  b_hi = b_hi - (b_hi - b);
  const f32 b_lo = b - b_hi;
  return ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo;
}

// c is 0 or 2^-50 <= |c| < 2^63, read off its exponent field: the
// product of two such values is 0 or between 2^-100 and 2^126, inside the
// range where the FMA's error term is Dekker's. Shading-frame coordinates
// from 1e-15 m to 9e18 m pass.
K_INLINE bool fma_exact(f32 c) {
  const unsigned u = __float_as_uint(raw(c)) & 0x7fffffffu;
  return u == 0u || (u >> 23) - 77u < 190u - 77u;
}

K_INLINE bool fma_exact(V3 v) {
  return fma_exact(v.x) & fma_exact(v.y) & fma_exact(v.z);
}

template <bool kFma>
K_INLINE void two_product(f32 a, f32 b, f32& p, f32& e) {
  p = a * b;
  if constexpr (kFma) {
    e = vrt::fma_rn(a, b, -p);
  } else {
    e = dekker_error(a, b, p);
  }
}

template <bool kFma>
K_INLINE f32 kahan(f32 a, f32 b, f32 c, f32 d) {
  f32 p1, e1, p2, e2;
  two_product<kFma>(a, b, p1, e1);
  two_product<kFma>(c, d, p2, e2);
  return (p1 - p2) + (e1 - e2);
}

template <bool kFma>
K_INLINE V3 cross3(V3 a, V3 b) {
  return {kahan<kFma>(a.y, b.z, a.z, b.y), kahan<kFma>(a.z, b.x, a.x, b.z),
          kahan<kFma>(a.x, b.y, a.y, b.x)};
}

K_INLINE V3 cross3_fast(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// --- atan family (ops/math_utils.py, ops/soa.py) ---------------------------

K_INLINE f32 atan_f32(f32 x) {
  const f32 ax = fabsf(x);
  const bool big = ax > (float)2.414213562373095;
  const bool mid = (ax > (float)0.4142135623730950) && !big;
  const f32 safe_ax = ax > 0.0f ? ax : 1.0f;
  const f32 r = big ? -1.0f / (big ? safe_ax : 1.0f)
                      : (mid ? (ax - 1.0f) / (ax + 1.0f) : ax);
  const f32 offset = big ? kHalfPi : (mid ? kQuarterPi : 0.0f);
  const f32 z = r * r;
  f32 p = z * (float)8.05374449538e-2 - (float)1.38776856032e-1;
  p = z * p + (float)1.99777106478e-1;
  p = z * p - (float)3.33329491539e-1;
  const f32 y = offset + (z * p * r + r);
  return x < 0.0f ? -y : y;
}

K_INLINE f32 fast_positive_atan(f32 y) {
  const f32 ay = fabsf(y);
  f32 rx = ay > 1.0f ? 1.0f / ay : ay;
  f32 ry = rx * rx;
  f32 rz = ry * (float)0.02083509974181652 + (float)(-0.08513300120830536);
  rz = ry * rz + (float)0.18014100193977356;
  rz = ry * rz + (float)(-0.3302994966506958);
  ry = ry * rz + (float)0.9998660087585449;
  rz = -2.0f * ry * rx + kHalfPi;
  rz = ay > 1.0f ? rz : 0.0f;
  rx = rx * ry + rz;
  return y < 0.0f ? kPi - rx : rx;
}

K_INLINE f32 positive_atan_unbiased(f32 t) {
  return atan_f32(t) + (t < 0.0f ? kPi : 0.0f);
}

// The PSA samplers' atan: the polynomial one for PSA-biased.
K_INLINE f32 positive_atan(f32 t) {
  if (kBiased) return fast_positive_atan(t);
  return positive_atan_unbiased(t);
}

K_INLINE f32 atan2_soa(f32 y, f32 x) {
  const f32 base = atan_f32(y / (x != 0.0f ? x : 1.0f));
  const bool neg_y = (y < 0.0f) || (signbit_f(y) && y == 0.0f);
  const f32 shifted = base + (neg_y ? -kPi : kPi);
  const f32 res = x > 0.0f ? base : shifted;
  const f32 on_axis =
      y == 0.0f ? (x >= 0.0f ? 0.0f : (neg_y ? -kPi : kPi))
                : (y > 0.0f ? kHalfPi : -kHalfPi);
  return x == 0.0f ? (y == 0.0f ? 0.0f : on_axis)
                   : (y == 0.0f ? on_axis : res);
}

K_INLINE f32 acos_soa(f32 x) {
  return atan2_soa(sqrtf(vrt::jmax(1.0f - x * x, 0.0f)), x);
}

// --- the pixel and the light -------------------------------------------------

struct Pixel {
  V3 position, normal, outgoing, albedo, fresnel_0;
  f32 lambert_out, roughness, ltc_albedo, ltc_det;
  bool hit;
  f32 w2s[12], w2c[12], s2c[9], c2s[9];
};

// The 62 base planes of pixel p (render/fused.py BASE_PLANES).
K_INLINE Pixel load_pixel(const float* __restrict__ planes, size_t P, int p) {
  auto in = [&](int k) { return planes[(size_t)k * P + p]; };
  Pixel px;
  px.position = {in(0), in(1), in(2)};
  px.normal = {in(3), in(4), in(5)};
  px.outgoing = {in(6), in(7), in(8)};
  px.lambert_out = in(9);
  px.albedo = {in(10), in(11), in(12)};
  px.fresnel_0 = {in(13), in(14), in(15)};
  px.roughness = in(16);
  px.hit = in(17) > 0.5f;
  px.ltc_albedo = in(18);
  px.ltc_det = in(19);
#pragma unroll
  for (int k = 0; k < 12; ++k) px.w2s[k] = in(20 + k);
#pragma unroll
  for (int k = 0; k < 12; ++k) px.w2c[k] = in(32 + k);
#pragma unroll
  for (int k = 0; k < 9; ++k) px.s2c[k] = in(44 + k);
#pragma unroll
  for (int k = 0; k < 9; ++k) px.c2s[k] = in(53 + k);
  return px;
}

// --- the noise, read from the table (ops/noise.py) ---------------------------
//
// Pair j of the pixel at (x, y) is channels 2 (j & 1) and 2 (j & 1) + 1 of
// fetch j >> 1: table[layer, (y + off_y) & (H - 1), (x + off_x) & (W - 1),
// c] / 65535 with (off_x, off_y, layer) = fetches[j >> 1], the offsets
// reduced modulo the table's sides on the host (ops/noise.py
// FrameNoise). Planes 2 j and 2 j + 1 of get_noise_image hold the same
// values; no noise image is stored.
constexpr float kNoiseScale = (float)(1.0 / 65535.0);

struct Noise {
  const int* __restrict__ table;    // (layers, H, W, 4) UNORM16 values
  const int* __restrict__ fetches;  // (F, 3): off_x, off_y, layer
  int height, width;                // the table's sides, powers of two
  int x, y;                         // the pixel in the frame
  K_INLINE void pair(int j, f32& r0, f32& r1) const {
    const int* f = fetches + 3 * (j >> 1);
    const int off_x = __ldg(f), off_y = __ldg(f + 1), layer = __ldg(f + 2);
    const size_t texel =
        ((size_t)layer * height + ((y + off_y) & (height - 1))) * width +
        ((x + off_x) & (width - 1));
    const int2 v =
        __ldg(reinterpret_cast<const int2*>(table + 4 * texel) + (j & 1));
    r0 = f32((float)v.x) * kNoiseScale;
    r1 = f32((float)v.y) * kNoiseScale;
  }
};

K_INLINE V3 light_vert(const float* ls, int k) {
  return {ls[3 * k], ls[3 * k + 1], ls[3 * k + 2]};
}
K_INLINE V3 light_rot_col(const float* ls, int k) {
  return {ls[kLsRotation + 3 * k], ls[kLsRotation + 3 * k + 1],
          ls[kLsRotation + 3 * k + 2]};
}

// Rows of a 3x4 world->space matrix applied to a point, and the transposed
// rotation applied to a direction (render/fused.py _affine, _rot_t_apply).
K_INLINE V3 affine(const f32 (&w)[12], V3 v) {
  return {(w[0] * v.x + w[1] * v.y + w[2] * v.z) + w[3],
          (w[4] * v.x + w[5] * v.y + w[6] * v.z) + w[7],
          (w[8] * v.x + w[9] * v.y + w[10] * v.z) + w[11]};
}
K_INLINE V3 rot_t_apply(const f32 (&w)[12], V3 d) {
  return {d.x * w[0] + d.y * w[4] + d.z * w[8],
          d.x * w[1] + d.y * w[5] + d.z * w[9],
          d.x * w[2] + d.y * w[6] + d.z * w[10]};
}

// The winding flip of the PSA samplers: row 1 of the matrix negated when
// the shading point is behind the light plane (glsl:444-452).
K_INLINE void flipped_rows(const Pixel& px, const float* ls,
                           const f32 (&w)[12], f32 (&out)[12]) {
  const f32 side = (px.position.x * ls[kLsPlane] +
                      px.position.y * ls[kLsPlane + 1] +
                      px.position.z * ls[kLsPlane + 2]) + ls[kLsPlane + 3];
  const f32 flip = side < 0.0f ? -1.0f : 1.0f;
#pragma unroll
  for (int k = 0; k < 12; ++k) out[k] = (k >= 4 && k < 8) ? flip * w[k] : w[k];
}

// --- clipping to z >= 0 (ops/soa.py clip_soa) ------------------------------

template <int N>
K_INLINE int clip(const V3 (&v)[N], V3 (&out)[N + 1]) {
  bool above[N], emit[N];
  V3 isect[N];
#pragma unroll
  for (int k = 0; k < N; ++k) above[k] = v[k].z > 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const V3 v0 = v[k], v1 = v[(k + 1) % N];
    const bool crosses = above[k] != above[(k + 1) % N];
    emit[k] = crosses;
    const f32 t = v0.z / (crosses ? v0.z - v1.z : 1.0f);
    isect[k] = {t * v1.x + (v0.x - t * v0.x), t * v1.y + (v0.y - t * v0.y),
                0.0f};
  }
  int offsets[N];
  int running = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    offsets[k] = running;
    running = running + (int)above[k] + (int)emit[k];
  }
#pragma unroll
  for (int j = 0; j < N + 1; ++j) {
    V3 acc = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const bool sc = above[k] && offsets[k] == j;
      acc.x = acc.x + (sc ? v[k].x : 0.0f);
      acc.y = acc.y + (sc ? v[k].y : 0.0f);
      acc.z = acc.z + (sc ? v[k].z : 0.0f);
      const bool si = emit[k] && offsets[k] + (int)above[k] == j;
      acc.x = acc.x + (si ? isect[k].x : 0.0f);
      acc.y = acc.y + (si ? isect[k].y : 0.0f);
      acc.z = acc.z + (si ? isect[k].z : 0.0f);
    }
    out[j] = acc;
  }
  const int count = running >= 3 ? running : 0;
#pragma unroll
  for (int j = 1; j < N + 1; ++j)
    if (count <= j) out[j] = out[0];
  return count;
}

// First sector whose cumulative value exceeds target, else the last valid
// one (ops/soa.py _select_sector_soa); -1 when no lane is selected.
template <int M>
K_INLINE int select_sector(const f32 (&sector_psa)[M], f32 target,
                           int num_sectors, f32& remaining) {
  f32 running = 0.0f;
  f32 prev[M];
  bool sel[M];
  bool any_before = false;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    prev[k] = running;
    running = running + sector_psa[k];
    const bool reached = (target < running) && (num_sectors > k);
    sel[k] = reached && !any_before;
    any_before = any_before || reached;
  }
  int chosen = -1;
  remaining = 0.0f;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const bool s =
        (any_before && sel[k]) || (!any_before && num_sectors - 1 == k);
    remaining = remaining + (s ? target - prev[k] : 0.0f);
    if (s) chosen = k;
  }
  return chosen;
}

// --- BRDF and the radiance of one sample direction ---------------------------

K_INLINE f32 schlick(f32 f0, f32 f90, f32 c) {
  const f32 flipped = 1.0f - c;
  const f32 fsq = flipped * flipped;
  return f0 + (f90 - f0) * (fsq * flipped * fsq);
}

K_INLINE V3 evaluate_brdf(const Pixel& px, V3 incoming) {
  const V3 h = {incoming.x + px.outgoing.x, incoming.y + px.outgoing.y,
                incoming.z + px.outgoing.z};
  const f32 rl = rsqrtf(dot3(h, h));
  const V3 half = {rl * h.x, rl * h.y, rl * h.z};
  const f32 lambert_in = dot3(px.normal, incoming);
  const f32 out_dot_half = dot3(px.outgoing, half);
  const f32 rough = px.roughness;

  const f32 f90 = out_dot_half * out_dot_half * (2.0f * rough) + 0.5f;
  const f32 ff = schlick(1.0f, f90, px.lambert_out) *
                   schlick(1.0f, f90, lambert_in);
  V3 brdf = {0.0f + ff * px.albedo.x, 0.0f + ff * px.albedo.y,
             0.0f + ff * px.albedo.z};

  const f32 ndh = dot3(px.normal, half);
  const f32 r_sq = rough * rough;
  f32 ggx = (ndh * r_sq - ndh) * ndh + 1.0f;
  ggx = r_sq / (ggx * ggx);
  const f32 lo = px.lambert_out;
  const f32 masking = lambert_in * sqrtf((-lo * r_sq + lo) * lo + r_sq);
  const f32 shadowing =
      lo * sqrtf((-lambert_in * r_sq + lambert_in) * lambert_in + r_sq);
  const f32 gs = ggx * (0.5f / (masking + shadowing));
  const f32 codh = vrt::jclip(out_dot_half, 0.0f, 1.0f);
  brdf.x = brdf.x + gs * schlick(px.fresnel_0.x, 1.0f, codh);
  brdf.y = brdf.y + gs * schlick(px.fresnel_0.y, 1.0f, codh);
  brdf.z = brdf.z + gs * schlick(px.fresnel_0.z, 1.0f, codh);
  return {kInvPi * brdf.x, kInvPi * brdf.y, kInvPi * brdf.z};
}

// radiance x BRDF assuming visibility, the geometric lambert gate and the
// shadow ray's t_max (render/fused.py _rad_brdf).
struct Radiance {
  f32 value[3];
  f32 lambert;
  f32 t_max;
};

K_INLINE Radiance rad_brdf(const Pixel& px, const float* ls, V3 d) {
  Radiance r;
  const f32 pl0 = ls[kLsPlane], pl1 = ls[kLsPlane + 1],
              pl2 = ls[kLsPlane + 2], pl3 = ls[kLsPlane + 3];
  r.lambert = dot3(px.normal, d);
  const bool geo = r.lambert > 0.0f;
  const f32 denom = d.x * pl0 + d.y * pl1 + d.z * pl2;
  const f32 dist = (px.position.x * pl0 + px.position.y * pl1 +
                      px.position.z * pl2) + pl3;
  const f32 t_max = -dist / (denom != 0.0f ? denom : 1.0f);
  const V3 brdf = evaluate_brdf(px, d);
  r.value[0] = geo ? ls[kLsRadiance] * brdf.x : 0.0f;
  r.value[1] = geo ? ls[kLsRadiance + 1] * brdf.y : 0.0f;
  r.value[2] = geo ? ls[kLsRadiance + 2] * brdf.z : 0.0f;
  r.t_max = geo ? t_max : 0.0f;
  return r;
}

// --- LTC density and MIS (ops/soa.py) ---------------------------------------

K_INLINE f32 ltc_density(const f32 (&s2c)[9], f32 det, V3 d,
                           f32 rcp_psa) {
  const f32 dx = s2c[0] * d.x + s2c[1] * d.y + s2c[2] * d.z;
  const f32 dy = s2c[3] * d.x + s2c[4] * d.y + s2c[5] * d.z;
  const f32 dz = s2c[6] * d.x + s2c[7] * d.y + s2c[8] * d.z;
  const f32 len_sq = dx * dx + dy * dy + dz * dz;
  const f32 density = vrt::jmax(dz, 0.0f) * det / (len_sq * len_sq);
  return density * rcp_psa;
}

// One channel of mis_estimate_soa for the compile-time heuristic.
K_INLINE f32 mis_estimate(f32 integrand, f32 sampled_weight,
                            f32 sampled_density, f32 other_weight,
                            f32 other_density, f32 vis) {
  if (kHeuristic == 0) {  // balance
    return (1.0f / (sampled_density + other_density)) * integrand;
  } else if (kHeuristic == 1) {  // power
    const f32 wod =
        sampled_density / (sampled_density * sampled_density +
                           other_density * other_density);
    return wod * integrand;
  }
  const f32 wsum =
      sampled_density * sampled_weight + other_density * other_weight;
  if (kHeuristic == 2) {  // weighted
    return sampled_weight * integrand / wsum;
  }
  const f32 balance = 1.0f / (sampled_density + other_density);
  if (kHeuristic == 3) {  // optimal_clamped
    f32 mixed = -vis * balance + balance;
    mixed = vis * (sampled_weight / wsum) + mixed;
    return mixed * integrand;
  }
  // optimal
  return vis * sampled_weight + balance * (integrand - vis * wsum);
}

// --- ellipse helpers (ops/soa.py) ------------------------------------------

template <bool kFma>
K_INLINE V2 ellipse_from_edge(V3 v0, V3 v1) {
  const V3 n = cross3<kFma>(v0, v1);
  const bool nz_ok = n.z != 0.0f;
  f32 scaling = 1.0f / (nz_ok ? n.z : 1.0f);
  scaling = signbit_f(n.x) ? -scaling : scaling;
  return {nz_ok ? n.x * scaling : INFINITY, n.y * scaling};
}

K_INLINE V2 ellipse_transform(V2 e, V2 p) {
  const f32 d = e.x * p.x + e.y * p.y;
  return {d * e.x + p.x, d * e.y + p.y};
}

K_INLINE f32 ellipse_det(V2 e) { return e.x * e.x + e.y * e.y + 1.0f; }

K_INLINE f32 ellipse_dir_factor_rsq(V2 e, V2 d) {
  const f32 ed = e.x * d.x + e.y * d.y;
  return ed * ed + d.x * d.x + d.y * d.y;
}

K_INLINE f32 ellipse_normalized_dir_factor(V2 e, V2 d) {
  const f32 ed = e.x * d.x + e.y * d.y;
  return rsqrtf(ed * ed + 1.0f);
}

K_INLINE f32 area_between_from_tangents(f32 inner_rsd, f32 inner_tan,
                                          f32 outer_rsd, f32 outer_tan) {
  const f32 inner_area = inner_rsd * positive_atan(inner_tan);
  const f32 result = outer_rsd * positive_atan(outer_tan) - inner_area;
  return result > 0.0f ? 0.5f * result : 0.0f;
}

K_INLINE f32 area_between_ellipses_in_sector(V2 inner_e, f32 inner_rsd,
                                               V2 outer_e, f32 outer_rsd,
                                               V2 d0, V2 d1) {
  const f32 det_dirs = vrt::jmax(d1.x * (-d0.y) + d1.y * d0.x, 0.0f);
  const V2 it = ellipse_transform(inner_e, d1);
  const V2 ot = ellipse_transform(outer_e, d1);
  const f32 inner_dot = inner_rsd * (d0.x * it.x + d0.y * it.y);
  const f32 outer_dot = outer_rsd * (d0.x * ot.x + d0.y * ot.y);
  return area_between_from_tangents(inner_rsd, det_dirs / inner_dot,
                                    outer_rsd, det_dirs / outer_dot);
}

K_INLINE f32 ellipse_area_in_sector(V2 e, V2 d0, V2 d1) {
  const f32 rsd = rsqrtf(ellipse_det(e));
  const f32 det_dirs = vrt::jmax(d1.x * (-d0.y) + d1.y * d0.x, 0.0f);
  const V2 et = ellipse_transform(e, d1);
  const f32 e_dot = rsd * (d0.x * et.x + d0.y * et.y);
  const f32 area = 0.5f * rsd * positive_atan(det_dirs / e_dot);
  return rsd > 0.0f ? area : 0.0f;
}

// --- PSA prepare (ops/soa.py prepare_psa_soa) ------------------------------

template <int M>
struct PsaPoly {
  V2 vertices[M];
  V2 ellipses[M];
  V2 sector_inner[M];
  V2 sector_outer[M];
  f32 sector_psa[M];
  f32 psa;
  int count;
  bool central;
};

template <int M>
K_INLINE void prepare_psa(const V3 (&v)[M], int count_in, PsaPoly<M>& poly) {
  const int count = max(count_in, 3);
  // fma_exact on every lane, in fewer instructions: clip leaves z >= +0
  // (0 on the horizon, where z - 1 wraps to the top), and an exact 0 in x
  // or y sends the polygon to Dekker's split (rare, and exact); a polygon
  // clipped away is all zeros (hi == 0), whose products are exact either
  // way. A NaN coordinate passes (fmaxf and fminf drop it); the FMA and
  // the split then both give NaN.
  float hi = 0.0f, lo_xy = INFINITY;
  unsigned lo_z = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float x = fabsf(raw(v[k].x)), y = fabsf(raw(v[k].y));
    hi = fmaxf(hi, fmaxf(x, fmaxf(y, raw(v[k].z))));
    lo_xy = fminf(lo_xy, fminf(x, y));
    lo_z = min(lo_z, __float_as_uint(raw(v[k].z)) - 1u);
  }
  const bool exact = (hi == 0.0f) |
                     ((hi < 0x1p63f) & (lo_xy >= 0x1p-50f) &
                      (lo_z >= __float_as_uint(0x1p-50f) - 1u));
  V2 raw[M];
  bool raw_inner[M];
  if (exact) {
#pragma unroll
    for (int k = 0; k < M; ++k)
      raw[k] = ellipse_from_edge<true>(v[k], v[(k + 1) % M]);
  } else {
#pragma unroll
    for (int k = 0; k < M; ++k)
      raw[k] = ellipse_from_edge<false>(v[k], v[(k + 1) % M]);
  }
#pragma unroll
  for (int k = 0; k < M; ++k) raw_inner[k] = signbit_f(raw[k].x);
  // Lane k's previous edge: lane count-1 for k == 0, else k-1.
  V2 last_raw = {0.0f, 0.0f};
  bool last_inner = false;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const bool is_last = count - 1 == k;
    if (is_last) last_raw = raw[k];
    last_inner = (is_last && raw_inner[k]) || (!is_last && last_inner);
  }
  V2 ellipses[M];
  V2 picked = {0.0f, 0.0f};
  bool seen = false;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const V2 prev_raw = k == 0 ? last_raw : raw[k - 1];
    const bool prev_inner = k == 0 ? last_inner : raw_inner[k - 1];
    ellipses[k] = raw_inner[k] ? prev_raw : raw[k];
    // The first inner->outer transition records the dropped inner ellipse.
    const bool trans = (count > k) && prev_inner && !raw_inner[k];
    if (trans && !seen) picked = prev_raw;
    seen = seen || trans;
  }
  const V2 inner0 = seen ? picked : V2{1.0f, 0.0f};
  const bool central = inner0.x > 0.0f;
  poly.central = central;
  poly.count = count;

  if (central) {
    f32 psa = 0.0f;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const V2 vk = {v[k].x, v[k].y};
      const V2 vn = {v[(k + 1) % M].x, v[(k + 1) % M].y};
      const f32 s =
          (count > k) ? ellipse_area_in_sector(ellipses[k], vk, vn) : 0.0f;
      poly.sector_psa[k] = s;
      psa = k == 0 ? s : psa + s;
      poly.vertices[k] = vk;
      poly.ellipses[k] = ellipses[k];
    }
    poly.psa = psa;
  } else {
    // CCW sort by a tie-preserving pseudo-angle, then the sector walk.
    f32 crs[M], keys[M];
    if (exact) {
#pragma unroll
      for (int k = 0; k < M; ++k)
        crs[k] = kahan<true>(v[0].x, v[k].y, v[0].y, v[k].x);
    } else {
#pragma unroll
      for (int k = 0; k < M; ++k)
        crs[k] = kahan<false>(v[0].x, v[k].y, v[0].y, v[k].x);
    }
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const f32 cr = crs[k];
      const f32 dt = v[0].x * v[k].x + v[0].y * v[k].y;
      const f32 p = dt / (fabsf(dt) + fabsf(cr) + 1e-37f);
      const f32 key = cr >= 0.0f ? 1.0f - p : p - 1.0f;
      keys[k] = (count > k) ? key : 4.0f;
    }
    int rank[M];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      int r = 0;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        if (j < k) r += (int)((keys[j] < keys[k]) || (keys[j] == keys[k]));
        if (j > k) r += (int)(keys[j] < keys[k]);
      }
      rank[k] = r;
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      V2 av = {0.0f, 0.0f}, ae = {0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < M; ++k) {
        if (rank[k] == j) {
          av = {v[k].x, v[k].y};
          ae = ellipses[k];
        }
      }
      poly.vertices[j] = av;
      // "+ 0.0f" canonicalizes -0.0 like the reference's masked sum.
      poly.ellipses[j] = {ae.x + 0.0f, ae.y + 0.0f};
    }
    V2 inner_e = inner0;
    V2 outer_e = poly.ellipses[0];
#pragma unroll
    for (int i = 0; i < M - 1; ++i) {
      if (i > 0) {
        if (signbit_f(poly.ellipses[i].x))
          inner_e = poly.ellipses[i];
        else
          outer_e = poly.ellipses[i];
      }
      poly.sector_inner[i] = inner_e;
      poly.sector_outer[i] = outer_e;
    }
    poly.sector_inner[M - 1] = poly.sector_inner[M - 2];
    poly.sector_outer[M - 1] = poly.sector_outer[M - 2];
    f32 psa = 0.0f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      f32 s = 0.0f;
      if (i < M - 1 && count - 1 > i) {
        s = area_between_ellipses_in_sector(
            poly.sector_inner[i], rsqrtf(ellipse_det(poly.sector_inner[i])),
            poly.sector_outer[i], rsqrtf(ellipse_det(poly.sector_outer[i])),
            poly.vertices[i], poly.vertices[i + 1]);
      }
      poly.sector_psa[i] = s;
      psa = i == 0 ? s : psa + s;
    }
    poly.psa = psa;
  }
}

// --- PSA sampling (ops/soa.py sample_psa_soa) -------------------------------

K_INLINE V2 solve_homogeneous_quadratic(f32 q00, f32 q01, f32 q10,
                                        f32 q11) {
  const f32 coeff_xy = 0.5f * (q01 + q10);
  const f32 sqrt_disc =
      sqrtf(vrt::jmax(coeff_xy * coeff_xy - q00 * q11, 0.0f));
  const f32 scaled_root = fabsf(coeff_xy) + sqrt_disc;
  const bool pos = coeff_xy >= 0.0f;
  return {pos ? scaled_root : q11, pos ? -q00 : scaled_root};
}

K_INLINE V2 sample_sector_between_ellipses(f32 r0, f32 r1,
                                           f32 target_area, V2 inner_e,
                                           V2 outer_e, V2 dir_0, V2 dir_1) {
  f32 rl = rsqrtf(dir_0.x * dir_0.x + dir_0.y * dir_0.y);
  const V2 q0 = {dir_0.x * rl, dir_0.y * rl};
  rl = rsqrtf(dir_1.x * dir_1.x + dir_1.y * dir_1.y);
  V2 q2 = {dir_1.x * rl, dir_1.y * rl};
  const V2 q1 = {q0.x + q2.x, q0.y + q2.y};

  const f32 nf00 = ellipse_normalized_dir_factor(inner_e, q0);
  const f32 nf01 = rsqrtf(ellipse_dir_factor_rsq(inner_e, q1));
  f32 nf02 = ellipse_normalized_dir_factor(inner_e, q2);
  const f32 nf10 = ellipse_normalized_dir_factor(outer_e, q0);
  const f32 nf11 = rsqrtf(ellipse_dir_factor_rsq(outer_e, q1));
  f32 nf12 = ellipse_normalized_dir_factor(outer_e, q2);
  const f32 area0 = nf10 * nf11 - nf00 * nf01;
  const f32 area1 = nf11 * nf12 - nf01 * nf02;

  f32 target_quad_area = mix_fma(-area0, area1, r0);
  const bool first_half = target_quad_area <= 0.0f;
  if (first_half) {
    q2 = q0;
    nf02 = nf00;
    nf12 = nf10;
  }
  target_quad_area = target_quad_area + (first_half ? area0 : -area1);
  target_quad_area = target_quad_area * fabsf(q1.x * q2.y - q1.y * q2.x);

  const V2 quad_normal_inner = ellipse_transform(
      inner_e, {q1.x * nf01 + q2.x * nf02, q1.y * nf01 + q2.y * nf02});
  const V2 quad_normal_outer = ellipse_transform(
      outer_e, {q1.x * nf11 + q2.x * nf12, q1.y * nf11 + q2.y * nf12});
  const f32 quad_offset_inner =
      (quad_normal_inner.x * q1.x + quad_normal_inner.y * q1.y) * nf01;
  const f32 quad_offset_outer =
      (quad_normal_outer.x * q1.x + quad_normal_outer.y * q1.y) * nf11;

  const V2 r90q2 = {-q2.y, q2.x};
  const f32 sa = quad_offset_outer * nf12;
  const V2 a = {sa * r90q2.x, sa * r90q2.y};
  const f32 sb = quad_offset_inner * nf02;
  const V2 b = {sb * r90q2.x + target_quad_area * quad_normal_inner.x,
                sb * r90q2.y + target_quad_area * quad_normal_inner.y};
  // outer2(a, b) = (a.x b.x, a.y b.x, a.x b.y, a.y b.y)
  V2 current = solve_homogeneous_quadratic(
      a.x * quad_normal_inner.x - b.x * quad_normal_outer.x,
      a.y * quad_normal_inner.x - b.y * quad_normal_outer.x,
      a.x * quad_normal_inner.y - b.x * quad_normal_outer.y,
      a.y * quad_normal_inner.y - b.y * quad_normal_outer.y);

  if (!kBiased) {
    const bool stable = fabsf(r0 - 0.5f) <= 0.5f - 1.0e-5f;
    const f32 inner_rsd = rsqrtf(ellipse_det(inner_e));
    const f32 outer_rsd = rsqrtf(ellipse_det(outer_e));
    const V2 r90q0 = {-q0.y, q0.x};
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      f32 scaling = 1.0f / (fabsf(current.x) + fabsf(current.y));
      scaling = (current.x * q1.x + current.y * q1.y >= 0.0f) ? scaling
                                                             : -scaling;
      const V2 new_dir = {scaling * current.x, scaling * current.y};
      const V2 inner_dir = ellipse_transform(inner_e, new_dir);
      const V2 outer_dir = ellipse_transform(outer_e, new_dir);
      const f32 det_dirs =
          vrt::jmax(new_dir.x * r90q0.x + new_dir.y * r90q0.y, 0.0f);
      const f32 error =
          target_area -
          area_between_from_tangents(
              inner_rsd,
              det_dirs / (inner_rsd * (q0.x * inner_dir.x + q0.y * inner_dir.y)),
              outer_rsd,
              det_dirs / (outer_rsd * (q0.x * outer_dir.x + q0.y * outer_dir.y)));
      const V2 ad = {inner_dir.x - outer_dir.x, inner_dir.y - outer_dir.y};
      const V2 rn = {-new_dir.y, new_dir.x};
      const f32 e2 = 2.0f * error;
      const V2 bd = {e2 * inner_dir.x, e2 * inner_dir.y};
      const V2 stepped = solve_homogeneous_quadratic(
          ad.x * rn.x - bd.x * outer_dir.x, ad.y * rn.x - bd.y * outer_dir.x,
          ad.x * rn.y - bd.x * outer_dir.y, ad.y * rn.y - bd.y * outer_dir.y);
      if (stable) current = stepped;
    }
  }
  if (!((current.x * q1.x + current.y * q1.y) >= 0.0f))
    current = {-current.x, -current.y};
  const f32 inner_factor = 1.0f / ellipse_dir_factor_rsq(inner_e, current);
  const f32 outer_factor = 1.0f / ellipse_dir_factor_rsq(outer_e, current);
  const f32 radius = sqrtf(mix_fma(inner_factor, outer_factor, r1));
  return {radius * current.x, radius * current.y};
}

template <int M>
K_INLINE V3 sample_psa(const PsaPoly<M>& poly, f32 r0, f32 r1) {
  const f32 target = r0 * poly.psa;
  V2 dir;
  if (poly.central) {
    f32 rem;
    const int s = select_sector<M>(poly.sector_psa, target, poly.count, rem);
    V2 outer = {0.0f, 0.0f}, dir0 = {0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < M; ++k)
      if (s == k) {
        outer = poly.ellipses[k];
        dir0 = poly.vertices[k];
      }
    const f32 sqrt_det = sqrtf(ellipse_det(outer));
    const f32 angle = 2.0f * rem * sqrt_det;
    const V2 t0 = ellipse_transform(outer, dir0);
    const V2 r90 = {-t0.y, t0.x};
    const f32 ca = cosf(angle) * sqrt_det;
    const f32 sa = sinf(angle);
    dir = {ca * dir0.x + sa * r90.x, ca * dir0.y + sa * r90.y};
    const f32 scale = sqrtf(r1 / ellipse_dir_factor_rsq(outer, dir));
    dir = {scale * dir.x, scale * dir.y};
  } else {
    f32 rem;
    const int s =
        select_sector<M>(poly.sector_psa, target, poly.count - 1, rem);
    V2 inner = {0.0f, 0.0f}, outer = {0.0f, 0.0f}, dir0 = {0.0f, 0.0f},
       dir1 = {0.0f, 0.0f};
    f32 sector = 0.0f;
#pragma unroll
    for (int k = 0; k < M; ++k)
      if (s == k) {
        inner = poly.sector_inner[k];
        outer = poly.sector_outer[k];
        dir0 = poly.vertices[k];
        dir1 = poly.vertices[(k + 1) % M];
        sector = poly.sector_psa[k];
      }
    const f32 rr0 = rem / (sector > 0.0f ? sector : 1.0f);
    dir = sample_sector_between_ellipses(rr0, r1, rem, inner, outer, dir0,
                                         dir1);
  }
  return {dir.x, dir.y,
          sqrtf(vrt::jmax(1.0f - dir.x * dir.x - dir.y * dir.y, 0.0f))};
}

// --- solid-angle triangle fans (ops/soa_techniques.py) ----------------------
//
// One struct for ours (prm = simplex volume, dot_0_2 + dot_1_2,
// 1 + dot_0_1) and Arvo's (prm = cos, sin of the opposite angle). count is
// max(vertex count, 3); a fan triangle i is active while i + 2 < count. A
// static vertex count passes count = M: every triangle is active, which is
// what the reference's "count None" case computes.

template <int M>
struct SaFan {
  V3 dirs[M];
  f32 prm[3][M - 2];
  f32 fan[M - 2];
  int count;
  f32 solid_angle;
};

template <int M>
K_INLINE void prepare_sa(const V3 (&dirs)[M], int count, SaFan<M>& f) {
  f.count = max(count, 3);
#pragma unroll
  for (int k = 0; k < M; ++k) f.dirs[k] = dirs[k];
  const V3 d0 = dirs[0];
  const f32 hh_sign = d0.x > 0.0f ? -1.0f : 1.0f;
  const f32 rcp = 1.0f / (fabsf(d0.x) + 1.0f);
  const f32 hy = d0.y * rcp;
  const f32 hz = d0.z * rcp;
  f32 cum = 0.0f;
#pragma unroll
  for (int i = 0; i < M - 2; ++i) {
    const V3 v0 = dirs[i + 1], v2 = dirs[i + 2];
    const f32 dot01 = dot3(v0, d0);
    const f32 dot02 = dot3(v0, v2);
    const f32 dot12 = dot3(d0, v2);
    const f32 dh0 = -hh_sign * v0.x + dot01;
    const f32 dh2 = -hh_sign * v2.x + dot12;
    const f32 col00 = -dh0 * hy + v0.y;
    const f32 col01 = -dh0 * hz + v0.z;
    const f32 col10 = -dh2 * hy + v2.y;
    const f32 col11 = -dh2 * hz + v2.z;
    const f32 simplex = fabsf(col00 * col11 - col01 * col10);
    const f32 d02p12 = dot02 + dot12;
    const f32 opd01 = 1.0f + dot01;
    const f32 tangent = simplex / (opd01 + d02p12);
    f32 sa_i = 2.0f * positive_atan_unbiased(tangent);
    sa_i = (i + 2 < f.count) ? sa_i : 0.0f;
    cum = i == 0 ? sa_i : cum + sa_i;
    f.fan[i] = cum;
    f.prm[0][i] = simplex;
    f.prm[1][i] = d02p12;
    f.prm[2][i] = opd01;
  }
  f.solid_angle = cum;
}

template <int M>
K_INLINE void prepare_sa_arvo(const V3 (&dirs)[M], int count, SaFan<M>& f) {
  f.count = max(count, 3);
#pragma unroll
  for (int k = 0; k < M; ++k) f.dirs[k] = dirs[k];
  const V3 v0 = dirs[0];
  f32 cum = 0.0f;
#pragma unroll
  for (int i = 0; i < M - 2; ++i) {
    const V3 v1 = dirs[i + 1], v2 = dirs[i + 2];
    const V3 e10 = sub3(v1, v0), e21 = sub3(v2, v1);
    V3 c0, c1, c2;
    if (fma_exact(e10) & fma_exact(e21) & fma_exact(v0) & fma_exact(v1) &
        fma_exact(v2)) {
      c0 = cross3<true>(e10, v0);
      c1 = cross3<true>(e21, v1);
      c2 = cross3<true>(v1, v2);
    } else {
      c0 = cross3<false>(e10, v0);
      c1 = cross3<false>(e21, v1);
      c2 = cross3<false>(v1, v2);
    }
    const V3 en0 = normalize3(c0);
    const V3 en1 = normalize3(c1);
    const f32 cos_op = -dot3(en0, en1);
    const f32 sin_op = sqrtf(vrt::jmax(-cos_op * cos_op + 1.0f, 0.0f));
    const f32 simplex = dot3(v0, c2);
    const f32 tangent = fabsf(simplex) / (((1.0f + dot3(v0, v1)) +
                                             dot3(v0, v2)) + dot3(v1, v2));
    f32 sa_i = 2.0f * positive_atan_unbiased(tangent);
    sa_i = (i + 2 < f.count) ? sa_i : 0.0f;
    cum = i == 0 ? sa_i : cum + sa_i;
    f.fan[i] = cum;
    f.prm[0][i] = cos_op;
    f.prm[1][i] = sin_op;
    f.prm[2][i] = 0.0f;
  }
  f.solid_angle = cum;
}

// First fan triangle whose cumulative angle reaches target, else the last
// active one (ops/soa_techniques.py _select_fan).
template <int M>
K_INLINE void select_fan(const SaFan<M>& f, f32 target, f32 (&sel)[3],
                         f32& sel_prev, V3& sel_v0, V3& sel_v2) {
  constexpr int nt = M - 2;
#pragma unroll
  for (int c = 0; c < 3; ++c) sel[c] = f.prm[c][nt - 1];
  sel_prev = nt >= 2 ? f.fan[nt >= 2 ? nt - 2 : 0] : 0.0f;
  sel_v0 = f.dirs[nt];
  sel_v2 = f.dirs[nt + 1];
#pragma unroll
  for (int i = nt - 2; i >= 0; --i) {
    if (f.fan[i] >= target && i + 2 < f.count) {
#pragma unroll
      for (int c = 0; c < 3; ++c) sel[c] = f.prm[c][i];
      sel_prev = i >= 1 ? f.fan[i >= 1 ? i - 1 : 0] : 0.0f;
      sel_v0 = f.dirs[i + 1];
      sel_v2 = f.dirs[i + 2];
    }
  }
  f32 last[3] = {f.prm[0][0], f.prm[1][0], f.prm[2][0]};
  f32 last_prev = 0.0f;
  V3 last_v0 = f.dirs[1], last_v2 = f.dirs[2];
#pragma unroll
  for (int i = 1; i < nt; ++i) {
    if (i + 2 < f.count) {
#pragma unroll
      for (int c = 0; c < 3; ++c) last[c] = f.prm[c][i];
      last_prev = f.fan[i - 1];
      last_v0 = f.dirs[i + 1];
      last_v2 = f.dirs[i + 2];
    }
  }
  bool any_reach = false;
#pragma unroll
  for (int i = 0; i < nt; ++i)
    any_reach = any_reach || (f.fan[i] >= target && i + 2 < f.count);
  if (!any_reach) {
#pragma unroll
    for (int c = 0; c < 3; ++c) sel[c] = last[c];
    sel_prev = last_prev;
    sel_v0 = last_v0;
    sel_v2 = last_v2;
  }
}

// polygon_sampling.glsl:194-224 (ops/soa_techniques.py sample_sa_soa).
template <int M>
K_INLINE V3 sample_sa(const SaFan<M>& f, f32 r0, f32 r1) {
  const f32 target = f.solid_angle * r0;
  f32 prm[3], prev;
  V3 v0, v2;
  select_fan<M>(f, target, prm, prev, v0, v2);
  const V3 v1 = f.dirs[0];
  const f32 sub = target - prev;
  const f32 cos_h = cosf(0.5f * sub);
  const f32 sin_h = sinf(0.5f * sub);
  const f32 s0 = prm[0] * cos_h - prm[1] * sin_h;
  const f32 s2 = prm[2] * sin_h;
  const V3 offset = add3(scale3(s0, v0), scale3(s2, v2));
  const f32 off_sq = dot3(offset, offset);
  const f32 scale =
      2.0f * dot3(v0, offset) / (off_sq != 0.0f ? off_sq : 1.0f);
  const V3 new_v2 = sub3(scale3(scale, offset), v0);
  const f32 s2d = dot3(v1, new_v2);
  const f32 s = mix_fma(1.0f, s2d, r1);
  const f32 denom = -s2d * s2d + 1.0f;
  f32 t_normed = sqrtf(vrt::jmax(-s * s + 1.0f, 0.0f) /
                         (denom > 0.0f ? denom : 1.0f));
  t_normed = denom > 0.0f ? t_normed : r1;
  return add3(scale3(-t_normed * s2d + s, v1), scale3(t_normed, new_v2));
}

// polygon_sampling_related_work.glsl:262-293 (sample_sa_arvo_soa).
template <int M>
K_INLINE V3 sample_sa_arvo(const SaFan<M>& f, f32 r0, f32 r1) {
  const f32 target = f.solid_angle * r0;
  f32 prm[3], sel_prev;
  V3 tv0, tv2;
  select_fan<M>(f, target, prm, sel_prev, tv0, tv2);
  const f32 cos_op = prm[0], sin_op = prm[1];
  const V3 tv1 = f.dirs[0];
  const f32 sub = target - sel_prev;
  const f32 ssa_cos = cosf(sub);
  const f32 ssa_sin = sinf(sub);
  const f32 p = ssa_sin * cos_op - ssa_cos * sin_op;
  const f32 q = ssa_sin * sin_op + ssa_cos * cos_op;
  const f32 u = q - cos_op;
  const f32 v = p + sin_op * dot3(tv0, tv1);
  const f32 s_div = (v * p + u * q) * sin_op;
  const f32 s = ((v * q - u * p) * cos_op - v) /
                  (s_div != 0.0f ? s_div : 1.0f);
  const V3 edge20 = normalize3(sub3(tv2, scale3(dot3(tv0, tv2), tv0)));
  const V3 vertex2 =
      add3(scale3(s, tv0), scale3(sqrtf(clip01(-s * s + 1.0f)), edge20));
  const f32 z = 1.0f - r1 * (1.0f - dot3(vertex2, tv1));
  const V3 edge21 =
      normalize3(sub3(vertex2, scale3(dot3(tv1, vertex2), tv1)));
  return add3(scale3(z, tv1), scale3(sqrtf(clip01(-z * z + 1.0f)), edge21));
}

// --- Urena spherical rectangles (prepare_urena_soa / sample_urena_soa) -------

struct Urena {
  V3 x_axis, y_axis, z_axis;
  f32 z0, z0sq, x0, y0, y0sq, x1, y1, y1sq, b0, b1, b0sq, k, solid_angle;
};

K_INLINE void prepare_urena(const float* ls, V3 o, Urena& q) {
  const V3 s = {ls[kLsTranslation], ls[kLsTranslation + 1],
                ls[kLsTranslation + 2]};
  const V3 ax = light_rot_col(ls, 0), ay = light_rot_col(ls, 1),
           az = light_rot_col(ls, 2);
  const V3 d = sub3(s, o);
  const f32 z0_raw = dot3(d, az);
  const bool neg = z0_raw > 0.0f;
  q.z_axis = {neg ? -az.x + 0.0f : az.x + 0.0f,
              neg ? -az.y + 0.0f : az.y + 0.0f,
              neg ? -az.z + 0.0f : az.z + 0.0f};
  q.x_axis = ax;
  q.y_axis = ay;
  const f32 z0 = -fabsf(z0_raw);
  const f32 x0 = dot3(d, ax);
  const f32 y0 = dot3(d, ay);
  const f32 x1 = x0 + ls[kLsScaling];
  const f32 y1 = y0 + ls[kLsScaling + 1];
  const V3 v00 = {x0, y0, z0}, v01 = {x0, y1, z0}, v10 = {x1, y0, z0},
           v11 = {x1, y1, z0};
  V3 c[4];
  if (fma_exact(v00) & fma_exact(v11)) {  // v01 and v10 mix their values
    c[0] = cross3<true>(v00, v10);
    c[1] = cross3<true>(v10, v11);
    c[2] = cross3<true>(v11, v01);
    c[3] = cross3<true>(v01, v00);
  } else {
    c[0] = cross3<false>(v00, v10);
    c[1] = cross3<false>(v10, v11);
    c[2] = cross3<false>(v11, v01);
    c[3] = cross3<false>(v01, v00);
  }
  const V3 n0 = normalize3(c[0]);
  const V3 n1 = normalize3(c[1]);
  const V3 n2 = normalize3(c[2]);
  const V3 n3 = normalize3(c[3]);
  const f32 g0 = acos_soa(vrt::jclip(-dot3(n0, n1), -1.0f, 1.0f));
  const f32 g1 = acos_soa(vrt::jclip(-dot3(n1, n2), -1.0f, 1.0f));
  const f32 g2 = acos_soa(vrt::jclip(-dot3(n2, n3), -1.0f, 1.0f));
  const f32 g3 = acos_soa(vrt::jclip(-dot3(n3, n0), -1.0f, 1.0f));
  q.z0 = z0;
  q.z0sq = z0 * z0;
  q.x0 = x0;
  q.y0 = y0;
  q.y0sq = y0 * y0;
  q.x1 = x1;
  q.y1 = y1;
  q.y1sq = y1 * y1;
  q.b0 = n0.z;
  q.b1 = n2.z;
  q.b0sq = n0.z * n0.z;
  q.k = kTwoPi - g2 - g3;
  q.solid_angle = g0 + g1 - q.k;
}

K_INLINE V3 sample_urena(const Urena& q, f32 u, f32 v) {
  const f32 au = u * q.solid_angle + q.k;
  const f32 sin_au = sinf(au);
  const f32 fu = (cosf(au) * q.b0 - q.b1) / (sin_au != 0.0f ? sin_au : 1.0f);
  f32 cu = 1.0f / sqrtf(fu * fu + q.b0sq);
  cu = fu > 0.0f ? cu : -cu;
  cu = vrt::jclip(cu, -1.0f, 1.0f);
  f32 xu = -(cu * q.z0) / sqrtf(vrt::jmax(1.0f - cu * cu, 1e-20f));
  xu = vrt::jmin(vrt::jmax(xu, q.x0), q.x1);
  const f32 d = sqrtf(xu * xu + q.z0sq);
  const f32 h0 = q.y0 / sqrtf(d * d + q.y0sq);
  const f32 h1 = q.y1 / sqrtf(d * d + q.y1sq);
  const f32 hv = h0 + v * (h1 - h0);
  const f32 mhv2_1 = -hv * hv + 1.0f;
  const f32 yv = mhv2_1 >= 0.0f
                       ? (hv * d) / sqrtf(vrt::jmax(mhv2_1, 1e-20f))
                       : q.y1;
  const V3 out = {
      xu * (q.x_axis.x + 0.0f) + yv * (q.y_axis.x + 0.0f) + q.z0 * q.z_axis.x,
      xu * (q.x_axis.y + 0.0f) + yv * (q.y_axis.y + 0.0f) + q.z0 * q.z_axis.y,
      xu * (q.x_axis.z + 0.0f) + yv * (q.y_axis.z + 0.0f) + q.z0 * q.z_axis.z};
  return normalize3(out);
}

// --- Turk uniform area sampling (sample_area_turk_soa) -----------------------

template <int NV>
K_INLINE V3 sample_area_turk(const float* ls, f32 r0, f32 r1) {
  constexpr int nt = NV - 2;
  auto tri = [&](int i) { return ls[kLsFan + 2 * i]; };
  auto cum = [&](int i) { return ls[kLsFan + 2 * i + 1]; };
  const f32 target = cum(nt - 1) * r0;
  f32 sel_prev = nt >= 2 ? cum(nt >= 2 ? nt - 2 : 0) : 0.0f;
  f32 sel_area = tri(nt - 1);
  V3 sel_v0 = light_vert(ls, nt), sel_v2 = light_vert(ls, nt + 1);
#pragma unroll
  for (int i = nt - 2; i >= 0; --i) {
    if (cum(i) >= target) {
      sel_prev = i >= 1 ? cum(i >= 1 ? i - 1 : 0) : 0.0f;
      sel_area = tri(i);
      sel_v0 = light_vert(ls, i + 1);
      sel_v2 = light_vert(ls, i + 2);
    }
  }
  const f32 sub = target - sel_prev;
  const f32 r0t = sub / (sel_area != 0.0f ? sel_area : 1.0f);
  const f32 sqrt_r0 = sqrtf(vrt::jmax(r0t, 0.0f));
  const f32 b0 = 1.0f - sqrt_r0;
  const f32 b1 = sqrt_r0 * r1;
  const f32 b2 = -sqrt_r0 * r1 + sqrt_r0;
  const V3 v1 = light_vert(ls, 0);
  return {b0 * sel_v0.x + b1 * v1.x + b2 * sel_v2.x,
          b0 * sel_v0.y + b1 * v1.y + b2 * sel_v2.y,
          b0 * sel_v0.z + b1 * v1.z + b2 * sel_v2.z};
}

// --- Hart et al. cosine warps (ops/soa_techniques.py) ------------------------

// The vertex at index count - 1, clipped to [2, M - 1].
template <int M>
K_INLINE V3 last_active_dir(const V3 (&dirs)[M], int count) {
  V3 v = dirs[2];
#pragma unroll
  for (int i = 3; i < M; ++i)
    if (count - 1 >= i) v = dirs[i];
  return v;
}

K_INLINE f32 linear_warp(f32 r, f32 density_0, f32 density_1) {
  const f32 lerped_sq =
      mix_fma(density_0 * density_0, density_1 * density_1, r);
  const f32 divisor = density_0 + sqrtf(vrt::jmax(lerped_sq, 0.0f));
  return r * (density_0 + density_1) / (divisor != 0.0f ? divisor : 1.0f);
}

template <int M>
struct HartBilinear {
  SaFan<M> poly;
  f32 density_0, density_1a, density_1b;
};

template <int M>
K_INLINE void prepare_hart_bilinear(const V3 (&dirs)[M], int count,
                                    HartBilinear<M>& w) {
  prepare_sa<M>(dirs, count, w.poly);
  const f32 d0 = vrt::jmax(dirs[0].z, 0.0f);
  const f32 d1a = vrt::jmax(dirs[1].z, 0.0f);
  const f32 d1b = vrt::jmax(last_active_dir<M>(dirs, count).z, 0.0f);
  const f32 dsum = 2.0f * d0 + d1a + d1b;
  const f32 sa = w.poly.solid_angle;
  const f32 norm = rdiv(4.0f, sa * dsum);
  const f32 inv_sa = 1.0f / sa;
  const bool degen = dsum <= 0.0f;
  w.density_0 = degen ? inv_sa : d0 * norm;
  w.density_1a = degen ? inv_sa : d1a * norm;
  w.density_1b = degen ? inv_sa : d1b * norm;
}

template <int M>
K_INLINE V3 sample_hart_bilinear(const HartBilinear<M>& w, f32 r0, f32 r1,
                                 f32& density) {
  const f32 r1w =
      linear_warp(r1, 2.0f * w.density_0, w.density_1a + w.density_1b);
  const f32 d0 = mix_fma(w.density_0, w.density_1a, r1w);
  const f32 d1 = mix_fma(w.density_0, w.density_1b, r1w);
  const f32 r0w = linear_warp(r0, d0, d1);
  density = mix_fma(d0, d1, r0w);
  return sample_sa<M>(w.poly, r0w, r1w);
}

// Blinn's cubic solver (solve_cubic_soa); returns whether three roots are
// real.
K_INLINE bool solve_cubic(f32 c0, f32 c1, f32 c2, f32 c3, f32& r0,
                          f32& r1, f32& r2) {
  const f32 n0 = c0 / c3;
  const f32 n1 = c1 / (3.0f * c3);
  const f32 n2 = c2 / (3.0f * c3);
  const f32 delta0 = -n2 * n2 + n1;
  const f32 delta1 = -n1 * n2 + n0;
  const f32 delta2 = n2 * n0 - n1 * n1;
  const f32 disc = 4.0f * delta0 * delta2 - delta1 * delta1;
  const f32 sqrt_abs = sqrtf(fabsf(disc));
  const f32 dep0 = -2.0f * n2 * delta0 + delta1;
  const f32 dep1 = delta0;
  const f32 theta = atan2_soa(sqrt_abs, -dep0) * kThird;
  const f32 cr_cos = cosf(theta);
  const f32 cr_sin = sinf(theta);
  const f32 sqrt_075 = (float)0.8660254037844386;
  const f32 scale = 2.0f * sqrtf(vrt::jmax(-dep1, 0.0f));
  const f32 t0 = cr_cos * scale - n2;
  const f32 t1 = (-sqrt_075 * cr_sin - 0.5f * cr_cos) * scale - n2;
  const f32 t2 = (sqrt_075 * cr_sin - 0.5f * cr_cos) * scale - n2;
  const f32 signed_sqrt = dep0 < 0.0f ? sqrt_abs : -sqrt_abs;
  const f32 quad_root = 0.5f * (signed_sqrt - dep0);
  const f32 abs_qr = fabsf(quad_root);
  const f32 cube0_mag = expf(logf(abs_qr > 0.0f ? abs_qr : 1.0f) * kThird);
  const f32 cube0 =
      abs_qr > 0.0f ? (quad_root < 0.0f ? -cube0_mag : cube0_mag) : 0.0f;
  f32 cube1 = -dep1 / (cube0 != 0.0f ? cube0 : 1.0f);
  cube1 = cube0 != 0.0f ? cube1 : 0.0f;
  const f32 root1 = cube0 + cube1 - n2;
  const bool three = disc >= 0.0f;
  r0 = three ? t0 : root1;
  r1 = three ? t1 : root1;
  r2 = three ? t2 : root1;
  return three;
}

K_INLINE f32 quadratic_warp(f32 r, f32 d0, f32 d1, f32 d2) {
  const f32 q0 = d0;
  const f32 q1 = 2.0f * (d1 - d0);
  const f32 q2 = d0 - 2.0f * d1 + d2;
  const f32 c1 = q0;
  const f32 c2 = 0.5f * q1;
  const f32 c3 = kThird * q2;
  const f32 scaled = r * (c1 + c2 + c3);
  f32 r0, r1, r2;
  const bool three = solve_cubic(-scaled, c1, c2, c3, r0, r1, r2);
  f32 out = r0;
  out = (three && r1 >= 0.0f && r1 <= 1.0f) ? r1 : out;
  out = (three && r2 >= 0.0f && r2 <= 1.0f) ? r2 : out;
  return out;
}

K_INLINE f32 quadratic_bezier(f32 b0, f32 b1, f32 b2, f32 x) {
  return mix_fma(mix_fma(b0, b1, x), mix_fma(b1, b2, x), x);
}

template <int M>
struct HartBiquadratic {
  SaFan<M> poly;
  f32 density_0;
  f32 density_1[3];
  f32 density_2[3];
};

template <int M>
K_INLINE void prepare_hart_biquadratic(const V3 (&dirs)[M], int count,
                                       HartBiquadratic<M>& w) {
  prepare_sa<M>(dirs, count, w.poly);
  const V3 v0 = dirs[0];
  const V3 last = last_active_dir<M>(dirs, count);
  const f32 d0 = vrt::jmax(v0.z, 0.0f);
  const f32 d2_0 = vrt::jmax(dirs[1].z, 0.0f);
  const f32 d2_2 = vrt::jmax(last.z, 0.0f);
  const V3 sample_2_1 = sample_sa<M>(w.poly, 0.5f, 1.0f);
  const f32 d2_1 = vrt::jmax(sample_2_1.z, 0.0f);
  // Middle row: the tail of SA sampling at r1 = 0.5 toward the three far
  // directions (column 0 warps toward vertex 0 itself, glsl:430-443).
  const V3 fars[3] = {v0, sample_2_1, last};
  f32 d1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const V3 far = fars[i];
    const f32 s2 = dot3(v0, far);
    const f32 s = 0.5f * s2 + 0.5f;
    const f32 t = sqrtf(vrt::jmax(-s * s + 1.0f, 0.0f));
    const f32 t_axis_z = -s2 * v0.z + far.z;
    const f32 norm_t =
        1.0f / sqrtf(vrt::jmax(2.0f * (-s2 * s2 + 1.0f), 1e-20f));
    d1[i] = vrt::jmax(s * v0.z + t * norm_t * t_axis_z, 0.0f);
  }
  const f32 dsum = 3.0f * d0 + d1[0] + d1[1] + d1[2] + d2_0 + d2_1 + d2_2;
  const f32 sa = w.poly.solid_angle;
  const f32 norm = rdiv(9.0f, sa * dsum);
  const f32 inv_sa = 1.0f / sa;
  const bool degen = dsum <= 0.0f;
  w.density_0 = degen ? inv_sa : d0 * norm;
#pragma unroll
  for (int i = 0; i < 3; ++i) w.density_1[i] = degen ? inv_sa : d1[i] * norm;
  w.density_2[0] = degen ? inv_sa : d2_0 * norm;
  w.density_2[1] = degen ? inv_sa : d2_1 * norm;
  w.density_2[2] = degen ? inv_sa : d2_2 * norm;
}

template <int M>
K_INLINE V3 sample_hart_biquadratic(const HartBiquadratic<M>& w, f32 r0,
                                    f32 r1, f32& density) {
  const f32 r1w = quadratic_warp(
      r1, 3.0f * w.density_0,
      w.density_1[0] + w.density_1[1] + w.density_1[2],
      w.density_2[0] + w.density_2[1] + w.density_2[2]);
  const f32 d0 =
      quadratic_bezier(w.density_0, w.density_1[0], w.density_2[0], r1w);
  const f32 d1 =
      quadratic_bezier(w.density_0, w.density_1[1], w.density_2[1], r1w);
  const f32 d2 =
      quadratic_bezier(w.density_0, w.density_1[2], w.density_2[2], r1w);
  const f32 r0w = quadratic_warp(r0, d0, d1, d2);
  density = quadratic_bezier(d0, d1, d2, r0w);
  return sample_sa<M>(w.poly, r0w, r1w);
}

// --- Arvo's projected solid angle (ops/soa_arvo_psa.py) -----------------------

struct ArvoEdge {
  f32 cdf;
  V2 len, elev;
};

K_INLINE V3 normalize3_rl(V3 v) {
  const f32 rl = rsqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
  return {v.x * rl, v.y * rl, v.z * rl};
}

// prepare_edge_arvo (glsl:559-590).
K_INLINE ArvoEdge arvo_prepare_edge(V3 v0, V3 v1) {
  const V3 na = normalize3_rl(cross3_fast(v0, v1));
  ArvoEdge e;
  e.cdf = 0.5f * na.z;
  const bool pos = e.cdf > 0.0f;
  const V3 ccw = pos ? v0 : v1;
  const f32 rl = rsqrtf(ccw.x * ccw.x + ccw.y * ccw.y);
  const f32 ncx = -ccw.y * rl, ncy = ccw.x * rl;
  const f32 cos_beta = -(na.x * ncx + na.y * ncy);
  const f32 sin_beta_sq = -cos_beta * cos_beta + 1.0f;
  const f32 csc_beta =
      1.0f / sqrtf(vrt::jmax(sin_beta_sq, 0.0f) + 1e-30f);
  const f32 csc_c =
      1.0f / sqrtf(vrt::jmax(-ccw.z * ccw.z + 1.0f, 0.0f) + 1e-30f);
  const f32 scale = csc_beta * csc_c;
  e.len = {sin_beta_sq * scale,
           (na.x * (-ncy) + na.y * ncx) * cos_beta * scale};
  const f32 elev1 = ccw.x * na.y - ccw.y * na.x;
  e.elev = {ccw.z, pos ? -elev1 : elev1};
  return e;
}

// glsl:600-612.
K_INLINE f32 arvo_edge_psa_in_sector(f32 cdf, V2 len, f32 ra0,
                                       f32 ra1) {
  const f32 c0 = cosf(ra0), s0 = sinf(ra0);
  const V2 p0 = {len.x * c0 + len.y * s0, s0};
  const f32 c1 = cosf(ra1), s1 = sinf(ra1);
  const V2 p1 = {len.x * c1 + len.y * s1, s1};
  const f32 rx = p0.x * p1.x + p0.y * p1.y;
  const f32 ry = p0.x * p1.y - p0.y * p1.x;
  return cdf * positive_atan_unbiased(fabsf(ry) / rx);
}

// glsl:617-642: psa and d psa / d ra1.
K_INLINE void arvo_edge_psa_and_derivative(f32 cdf, V2 len, f32 ra0,
                                           f32 ra1, f32& psa_out,
                                           f32& d_out) {
  const f32 c0 = cosf(ra0), s0 = sinf(ra0);
  const V2 p0 = {len.x * c0 + len.y * s0, s0};
  const f32 c1 = cosf(ra1), s1 = sinf(ra1);
  const V2 p1 = {len.x * c1 + len.y * s1, s1};
  const f32 rx = p0.x * p1.x + p0.y * p1.y;
  const f32 ry = p0.x * p1.y - p0.y * p1.x;
  const f32 quotient = fabsf(ry) / rx;
  const f32 psa = positive_atan_unbiased(quotient);
  const f32 d1x = -s1, d1y = c1;
  const V2 p1d = {len.x * d1x + len.y * d1y, d1y};
  const f32 rxd = p0.x * p1d.x + p0.y * p1d.y;
  const f32 ryd = p0.x * p1d.y - p0.y * p1d.x;
  f32 qd = (ryd * rx - ry * rxd) / (rx * rx);
  qd = ry < 0.0f ? -qd : qd;
  const f32 psa_d = qd / (quotient * quotient + 1.0f);
  psa_out = cdf * psa;
  d_out = cdf * psa_d;
}

// glsl:648-654.
K_INLINE f32 arvo_edge_elevation(V2 len, V2 elev, f32 ra) {
  const f32 c = cosf(ra), s = sinf(ra);
  const f32 px = len.x * c + len.y * s;
  const f32 rl = rsqrtf(px * px + s * s);
  return (px * elev.x + s * elev.y) * rl;
}

// A sector bound: an edge with its azimuth.
struct ArvoBound {
  ArvoEdge e;
  f32 az;
};

template <int M>
struct ArvoPoly {
  f32 az[M];      // central: lane azimuths; decentral: sorted azimuths
  ArvoEdge edge[M]; // central: lane edges; decentral: sorted edges
  ArvoBound inner[M], outer[M];  // decentral sector bounds
  f32 sector_psa[M];
  f32 psa;
  int count;
  bool central;
};

// prepare_arvo_psa_soa (glsl:743-820). Only the branch that the final
// central/decentral select keeps is computed.
template <int M>
K_INLINE void prepare_arvo_psa(const V3 (&verts)[M], int count_in,
                               ArvoPoly<M>& poly) {
  const int count = max(count_in, 3);
  poly.count = count;
  V3 v[M];
  f32 az[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    v[k] = normalize3_rl(verts[k]);
    az[k] = atan2_soa(v[k].y, v[k].x);
  }
  const f32 az0 = az[0];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const f32 a = az[k] > az0 + kPi ? az[k] - kTwoPi : az[k];
    az[k] = a < az0 - kPi ? a + kTwoPi : a;
  }
  ArvoEdge raw[M];
  bool raw_inner[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    raw[k] = arvo_prepare_edge(v[k], v[(k + 1) % M]);
    raw_inner[k] = raw[k].cdf < 0.0f;
  }
  ArvoEdge last = {0.0f, {0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int k = 0; k < M; ++k)
    if (count - 1 == k) last = raw[k];
  ArvoEdge edge[M];
  ArvoEdge picked = {0.0f, {0.0f, 0.0f}, {0.0f, 0.0f}};
  bool seen = false;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const ArvoEdge prev = k == 0 ? last : raw[k == 0 ? 0 : k - 1];
    edge[k] = raw_inner[k] ? prev : raw[k];
    // The first inner->outer transition records the dropped inner edge.
    const bool trans = (count > k) && (prev.cdf < 0.0f) && !raw_inner[k];
    if (trans && !seen) picked = prev;
    seen = seen || trans;
  }
  const ArvoEdge inner0 =
      seen ? picked : ArvoEdge{1.0f, {0.0f, 0.0f}, {0.0f, 0.0f}};
  poly.central = inner0.cdf > 0.0f;

  if (poly.central) {
    f32 psa = 0.0f;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const f32 s =
          (count > k) ? arvo_edge_psa_in_sector(edge[k].cdf, edge[k].len,
                                                0.0f, az[(k + 1) % M] - az[k])
                      : 0.0f;
      poly.sector_psa[k] = s;
      psa = k == 0 ? s : psa + s;
      poly.az[k] = az[k];
      poly.edge[k] = edge[k];
    }
    poly.psa = psa;
    return;
  }
  // Decentral: azimuth sort (rank one-hot), then the sector walk.
  f32 keys[M];
#pragma unroll
  for (int k = 0; k < M; ++k) keys[k] = (count > k) ? az[k] : INFINITY;
  int rank[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    int r = 0;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (j < k) r += (int)((keys[j] < keys[k]) || (keys[j] == keys[k]));
      if (j > k) r += (int)(keys[j] < keys[k]);
    }
    rank[k] = r;
  }
#pragma unroll
  for (int j = 0; j < M; ++j) {
    f32 a_az = 0.0f;
    ArvoEdge a_e = {0.0f, {0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int k = 0; k < M; ++k)
      if (rank[k] == j) {
        a_az = az[k];
        a_e = edge[k];
      }
    poly.az[j] = a_az;
    poly.edge[j] = a_e;
  }
  ArvoBound in_b = {inner0, poly.az[0]};
  ArvoBound out_b = {poly.edge[0], poly.az[0]};
#pragma unroll
  for (int i = 0; i < M - 1; ++i) {
    if (i > 0) {
      if (poly.edge[i].cdf >= 0.0f)
        out_b = {poly.edge[i], poly.az[i]};
      else
        in_b = {poly.edge[i], poly.az[i]};
    }
    poly.inner[i] = in_b;
    poly.outer[i] = out_b;
  }
  poly.inner[M - 1] = poly.inner[M - 2];
  poly.outer[M - 1] = poly.outer[M - 2];
  f32 psa = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    f32 s = 0.0f;
    if (i < M - 1 && i < count - 1) {
      const ArvoBound& o = poly.outer[i];
      const ArvoBound& n = poly.inner[i];
      const int i1 = i < M - 1 ? i + 1 : i;
      s = arvo_edge_psa_in_sector(o.e.cdf, o.e.len, poly.az[i] - o.az,
                                  poly.az[i1] - o.az) +
          arvo_edge_psa_in_sector(n.e.cdf, n.e.len, poly.az[i] - n.az,
                                  poly.az[i1] - n.az);
    }
    poly.sector_psa[i] = s;
    psa = i == 0 ? s : psa + s;
  }
  poly.psa = psa;
}

// Newton divided differences through 4 points (glsl:826-839).
K_INLINE f32 arvo_cubic_interpolation(f32 x, const f32 (&xs)[4],
                                        const f32 (&ys)[4]) {
  const f32 y01 = (ys[0] - ys[1]) / (xs[0] - xs[1]);
  const f32 y12 = (ys[1] - ys[2]) / (xs[1] - xs[2]);
  const f32 y23 = (ys[2] - ys[3]) / (xs[2] - xs[3]);
  const f32 y012 = (y01 - y12) / (xs[0] - xs[2]);
  const f32 y123 = (y12 - y23) / (xs[1] - xs[3]);
  const f32 y0123 = (y012 - y123) / (xs[0] - xs[3]);
  return (x - xs[0]) * ((x - xs[1]) * ((x - xs[2]) * y0123 + y012) + y01) +
         ys[0];
}

// sample_sector_within_edge / between_edges (glsl:845-929): the outer
// bound alone (central) or between inner and outer.
template <bool kInner>
K_INLINE V3 arvo_sample_sector(f32 target, f32 r1, const ArvoBound& in,
                               const ArvoBound& out, f32 azimuth_0,
                               f32 azimuth_1) {
  const f32 azs[4] = {azimuth_0, mix_fma(azimuth_0, azimuth_1, kThird),
                        mix_fma(azimuth_0, azimuth_1, kTwoThirds),
                        azimuth_1};
  f32 psas[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    psas[i] = arvo_edge_psa_in_sector(out.e.cdf, out.e.len,
                                      azimuth_0 - out.az, azs[i] - out.az);
    if (kInner)
      psas[i] = psas[i] + arvo_edge_psa_in_sector(in.e.cdf, in.e.len,
                                                  azimuth_0 - in.az,
                                                  azs[i] - in.az);
  }
  f32 sampled = arvo_cubic_interpolation(target, psas, azs);
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    f32 out_psa, out_d;
    arvo_edge_psa_and_derivative(out.e.cdf, out.e.len, azimuth_0 - out.az,
                                 sampled - out.az, out_psa, out_d);
    f32 error, derivative;
    if (kInner) {
      f32 in_psa, in_d;
      arvo_edge_psa_and_derivative(in.e.cdf, in.e.len, azimuth_0 - in.az,
                                   sampled - in.az, in_psa, in_d);
      error = in_psa + out_psa - target;
      derivative = in_d + out_d;
    } else {
      error = out_psa - target;
      derivative = out_d;
    }
    const f32 step = error / (derivative != 0.0f ? derivative : 1.0f);
    sampled = vrt::jmin(vrt::jmax(sampled - step, azimuth_0), azimuth_1);
  }
  const f32 cos_az = cosf(sampled);
  const f32 sin_az = sinf(sampled);
  const f32 out_z = arvo_edge_elevation(out.e.len, out.e.elev,
                                          sampled - out.az);
  f32 z_sq;
  if (kInner) {
    const f32 in_z = arvo_edge_elevation(in.e.len, in.e.elev,
                                           sampled - in.az);
    z_sq = mix_fma(in_z * in_z, out_z * out_z, r1);
  } else {
    z_sq = mix_fma(1.0f, out_z * out_z, r1);
  }
  const f32 z = sqrtf(vrt::jmax(z_sq, 0.0f));
  const f32 r_xy = sqrtf(vrt::jmax(-z * z + 1.0f, 0.0f));
  return {cos_az * r_xy, sin_az * r_xy, z};
}

// sample_projected_solid_angle_polygon_arvo (glsl:931-992), 3 Newton steps.
template <int M>
K_INLINE V3 sample_arvo_psa(const ArvoPoly<M>& poly, f32 r0, f32 r1) {
  const f32 target = r0 * poly.psa;
  f32 rem;
  if (poly.central) {
    const int s = select_sector<M>(poly.sector_psa, target, poly.count, rem);
    ArvoBound out = {{0.0f, {0.0f, 0.0f}, {0.0f, 0.0f}}, 0.0f};
    f32 az1 = 0.0f;
#pragma unroll
    for (int k = 0; k < M; ++k)
      if (s == k) {
        out = {poly.edge[k], poly.az[k]};
        az1 = poly.count == k + 1 ? poly.az[0] : poly.az[(k + 1) % M];
      }
    az1 = az1 < out.az ? az1 + kTwoPi : az1;
    return arvo_sample_sector<false>(rem, r1, out, out, out.az, az1);
  }
  const int s = select_sector<M>(poly.sector_psa, target, poly.count - 1, rem);
  ArvoBound in = {{0.0f, {0.0f, 0.0f}, {0.0f, 0.0f}}, 0.0f};
  ArvoBound out = in;
  f32 az0 = 0.0f, az1 = 0.0f;
#pragma unroll
  for (int k = 0; k < M; ++k)
    if (s == k) {
      in = poly.inner[k];
      out = poly.outer[k];
      az0 = poly.az[k];
      az1 = poly.az[(k + 1) % M];
    }
  return arvo_sample_sector<true>(rem, r1, in, out, az0, az1);
}

// --- DIFFUSE_ONLY samplers, one per technique (render/fused.py
// _shade_one_light_diffuse, _shade_one_light_arvo_psa, _shade_one_light_psa)
//
// prepare() runs once per (pixel, light); sample() maps one noise pair to a
// world direction and its density and returns the per-sample gate (only
// Arvo PSA has one). `ok` is the per-light gate.

template <int NV>
struct BaselineSampler {
  V3 corner, col0, col1;
  bool ok;
  K_INLINE void prepare(const Pixel& px, const float* ls) {
    corner = {ls[kLsTranslation] - px.position.x,
              ls[kLsTranslation + 1] - px.position.y,
              ls[kLsTranslation + 2] - px.position.z};
    col0 = light_rot_col(ls, 0);
    col1 = light_rot_col(ls, 1);
    ok = true;
  }
  K_INLINE bool sample(const Pixel&, const float*, f32 r0, f32 r1, V3& d,
                       f32& density) const {
    d = normalize3({corner.x + r0 * col0.x + r1 * col1.x,
                    corner.y + r0 * col0.y + r1 * col1.y,
                    corner.z + r0 * col0.z + r1 * col1.z});
    density = 1.0f;
    return true;
  }
};

template <int NV>
struct AreaTurkSampler {
  bool ok;
  K_INLINE void prepare(const Pixel&, const float*) { ok = true; }
  K_INLINE bool sample(const Pixel& px, const float* ls, f32 r0, f32 r1,
                       V3& d, f32& density) const {
    const V3 pos = sample_area_turk<NV>(ls, r0, r1);
    const V3 offset = sub3(pos, px.position);
    const f32 dist_sq = dot3(offset, offset);
    const f32 rcp = 1.0f / sqrtf(dist_sq);
    d = {offset.x * rcp, offset.y * rcp, offset.z * rcp};
    const f32 projected =
        fabsf(d.x * ls[kLsPlane] + d.y * ls[kLsPlane + 1] +
              d.z * ls[kLsPlane + 2]) * ls[kLsArea];
    density = dist_sq / (projected > 0.0f ? projected : 1.0f);
    density = projected > 0.0f ? density : 0.0f;
    return true;
  }
};

// Solid angle of the unclipped world-space polygon, ours or Arvo's.
template <int NV, bool kArvo>
struct SolidAngleSampler {
  SaFan<NV> fan;
  f32 density;
  bool ok;
  K_INLINE void prepare(const Pixel& px, const float* ls) {
    V3 dirs[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k)
      dirs[k] = normalize3(sub3(light_vert(ls, k), px.position));
    if (kArvo)
      prepare_sa_arvo<NV>(dirs, NV, fan);
    else
      prepare_sa<NV>(dirs, NV, fan);
    ok = fan.solid_angle > 0.0f;
    density = 1.0f / (ok ? fan.solid_angle : 1.0f);
  }
  K_INLINE bool sample(const Pixel&, const float*, f32 r0, f32 r1, V3& d,
                       f32& dens) const {
    d = kArvo ? sample_sa_arvo<NV>(fan, r0, r1) : sample_sa<NV>(fan, r0, r1);
    dens = density;
    return true;
  }
};

template <int NV>
struct UrenaSampler {
  Urena q;
  f32 density;
  bool ok;
  K_INLINE void prepare(const Pixel& px, const float* ls) {
    prepare_urena(ls, px.position, q);
    ok = q.solid_angle > 0.0f;
    density = 1.0f / (ok ? q.solid_angle : 1.0f);
  }
  K_INLINE bool sample(const Pixel&, const float*, f32 r0, f32 r1, V3& d,
                       f32& dens) const {
    d = sample_urena(q, r0, r1);
    dens = density;
    return true;
  }
};

// The shading-space family (render/shading.py:501-556): the polygon in the
// pixel's shading frame, clipped to the upper hemisphere or not, no
// winding flip. M lanes: NV + 1 when clipped.
template <int NV, bool kClip>
struct ShadingSpace {
  static constexpr int M = kClip ? NV + 1 : NV;
  static K_INLINE bool directions(const Pixel& px, const float* ls,
                                  V3 (&dirs)[M], int& count) {
    V3 vs[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) vs[k] = affine(px.w2s, light_vert(ls, k));
    bool clip_ok = true;
    if constexpr (kClip) {
      V3 clipped[M];
      count = clip<NV>(vs, clipped);
      clip_ok = count > 0;
#pragma unroll
      for (int k = 0; k < M; ++k) dirs[k] = normalize3(clipped[k]);
    } else {
      count = NV;
#pragma unroll
      for (int k = 0; k < M; ++k) dirs[k] = normalize3(vs[k]);
    }
    return clip_ok;
  }
};

template <int NV>
struct ClippedSolidAngleSampler {
  static constexpr int M = NV + 1;
  SaFan<M> fan;
  f32 density;
  bool ok;
  K_INLINE void prepare(const Pixel& px, const float* ls) {
    V3 dirs[M];
    int count;
    const bool clip_ok = ShadingSpace<NV, true>::directions(px, ls, dirs,
                                                            count);
    prepare_sa<M>(dirs, max(count, 3), fan);
    ok = (fan.solid_angle > 0.0f) && clip_ok;
    density = 1.0f / (fan.solid_angle > 0.0f ? fan.solid_angle : 1.0f);
  }
  K_INLINE bool sample(const Pixel& px, const float*, f32 r0, f32 r1,
                       V3& d, f32& dens) const {
    d = rot_t_apply(px.w2s, sample_sa<M>(fan, r0, r1));
    dens = density;
    return true;
  }
};

template <int NV, bool kClip>
struct HartBilinearSampler {
  static constexpr int M = ShadingSpace<NV, kClip>::M;
  HartBilinear<M> w;
  bool ok;
  K_INLINE void prepare(const Pixel& px, const float* ls) {
    V3 dirs[M];
    int count;
    const bool clip_ok = ShadingSpace<NV, kClip>::directions(px, ls, dirs,
                                                             count);
    prepare_hart_bilinear<M>(dirs, max(count, 3), w);
    ok = (w.poly.solid_angle > 0.0f) && clip_ok;
  }
  K_INLINE bool sample(const Pixel& px, const float*, f32 r0, f32 r1,
                       V3& d, f32& density) const {
    d = rot_t_apply(px.w2s, sample_hart_bilinear<M>(w, r0, r1, density));
    return true;
  }
};

template <int NV, bool kClip>
struct HartBiquadraticSampler {
  static constexpr int M = ShadingSpace<NV, kClip>::M;
  HartBiquadratic<M> w;
  bool ok;
  K_INLINE void prepare(const Pixel& px, const float* ls) {
    V3 dirs[M];
    int count;
    const bool clip_ok = ShadingSpace<NV, kClip>::directions(px, ls, dirs,
                                                             count);
    prepare_hart_biquadratic<M>(dirs, max(count, 3), w);
    ok = (w.poly.solid_angle > 0.0f) && clip_ok;
  }
  K_INLINE bool sample(const Pixel& px, const float*, f32 r0, f32 r1,
                       V3& d, f32& density) const {
    d = rot_t_apply(px.w2s, sample_hart_biquadratic<M>(w, r0, r1, density));
    return true;
  }
};

// PSA / PSA-biased: winding flip, clip, prepare (render/fused.py
// _shade_one_light_psa, DIFFUSE_ONLY branch).
template <int NV>
struct PsaSampler {
  static constexpr int M = NV + 1;
  f32 rows[12];
  PsaPoly<M> poly;
  f32 rcp_psa;
  bool ok;
  K_INLINE void prepare(const Pixel& px, const float* ls) {
    flipped_rows(px, ls, px.w2s, rows);
    V3 vs[NV], clipped[M];
#pragma unroll
    for (int k = 0; k < NV; ++k) vs[k] = affine(rows, light_vert(ls, k));
    const int count = clip<NV>(vs, clipped);
    prepare_psa<M>(clipped, count, poly);
    ok = (count > 0) && (poly.psa > 0.0f);
    rcp_psa = 1.0f / (poly.psa > 0.0f ? poly.psa : 1.0f);
  }
  K_INLINE bool sample(const Pixel&, const float*, f32 r0, f32 r1, V3& d,
                       f32& density) const {
    const V3 d_sh = sample_psa<M>(poly, r0, r1);
    density = d_sh.z * rcp_psa;
    d = rot_t_apply(rows, d_sh);
    return true;
  }
};

// Arvo PSA; horizon samples (z <= 1e-5) are dropped like the reference
// package's vmapped path (render/shading.py one_sample_arvo).
template <int NV>
struct ArvoPsaSampler {
  static constexpr int M = NV + 1;
  f32 rows[12];
  ArvoPoly<M> poly;
  f32 rcp_psa;
  bool ok;
  K_INLINE void prepare(const Pixel& px, const float* ls) {
    flipped_rows(px, ls, px.w2s, rows);
    V3 vs[NV], clipped[M];
#pragma unroll
    for (int k = 0; k < NV; ++k) vs[k] = affine(rows, light_vert(ls, k));
    const int count = clip<NV>(vs, clipped);
    prepare_arvo_psa<M>(clipped, count, poly);
    ok = (count > 0) && (poly.psa > 0.0f);
    rcp_psa = 1.0f / (poly.psa > 0.0f ? poly.psa : 1.0f);
  }
  K_INLINE bool sample(const Pixel&, const float*, f32 r0, f32 r1, V3& d,
                       f32& density) const {
    const V3 d_sh = sample_arvo_psa<M>(poly, r0, r1);
    density = d_sh.z * rcp_psa;
    d = rot_t_apply(rows, d_sh);
    return d_sh.z > 1e-5f;
  }
};

template <int T, int NV> struct SamplerFor;
template <int NV> struct SamplerFor<kBaseline, NV> { using type = BaselineSampler<NV>; };
template <int NV> struct SamplerFor<kAreaTurk, NV> { using type = AreaTurkSampler<NV>; };
template <int NV> struct SamplerFor<kUrena, NV> { using type = UrenaSampler<NV>; };
template <int NV> struct SamplerFor<kSolidAngleArvo, NV> { using type = SolidAngleSampler<NV, true>; };
template <int NV> struct SamplerFor<kSolidAngle, NV> { using type = SolidAngleSampler<NV, false>; };
template <int NV> struct SamplerFor<kClippedSolidAngle, NV> { using type = ClippedSolidAngleSampler<NV>; };
template <int NV> struct SamplerFor<kBilinearHart, NV> { using type = HartBilinearSampler<NV, false>; };
template <int NV> struct SamplerFor<kBilinearClippingHart, NV> { using type = HartBilinearSampler<NV, true>; };
template <int NV> struct SamplerFor<kBiquadraticHart, NV> { using type = HartBiquadraticSampler<NV, false>; };
template <int NV> struct SamplerFor<kBiquadraticClippingHart, NV> { using type = HartBiquadraticSampler<NV, true>; };
template <int NV> struct SamplerFor<kPsaArvo, NV> { using type = ArvoPsaSampler<NV>; };
template <int NV> struct SamplerFor<kPsa, NV> { using type = PsaSampler<NV>; };
template <int NV> struct SamplerFor<kPsaBiased, NV> { using type = PsaSampler<NV>; };

// 1 / n rounded from double, as the plain version's Python scalar is.
K_INLINE f32 inverse_count(int n) { return (float)(1.0 / (double)n); }

// --- one light, DIFFUSE_ONLY -------------------------------------------------
//
// The light's noise pairs are j0, j0 + 1, ... (j0 = light * rays per
// light). emit(q, b[3], d_world, t_max) receives ray slot q = s (one per
// sample), b already scaled by 1/n. The light's base is zero in this mode.
template <int NV, typename Emit>
K_INLINE void shade_light_diffuse(const Pixel& px, const float* ls,
                                  const Noise& noise, int j0, int n,
                                  Emit&& emit) {
  const f32 inv_n = inverse_count(n);
  typename SamplerFor<kTechnique, NV>::type smp;
  vrt::set_op_stage(vrt::kStagePrepare);
  smp.prepare(px, ls);
  vrt::set_op_stage(vrt::kStageSample);
  for (int s = 0; s < n; ++s) {
    f32 r0, r1;
    noise.pair(j0 + s, r0, r1);
    V3 d;
    f32 density;
    const bool sample_ok = smp.sample(px, ls, r0, r1, d, density);
    const Radiance r = rad_brdf(px, ls, d);
    const f32 scale =
        density > 0.0f ? r.lambert / (density > 0.0f ? density : 1.0f) : 0.0f;
    const bool gate = smp.ok && px.hit && sample_ok;
    f32 b[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      b[c] = inv_n * (gate ? scale * r.value[c] : 0.0f);
    emit(s, b, d, r.t_max);
  }
  vrt::set_op_stage(vrt::kStagePixel);
}

// --- one light, PSA + DIFFUSE_SPECULAR_MIS (render/fused.py:392-462) ---------
//
// Two ray slots per sample (q = 2 s + j: j = 0 diffuse, 1 specular), noise
// pairs j0 + 2 s and j0 + 2 s + 1. Writes the light's base, already scaled
// by 1/n.
template <int NV, typename Emit>
K_INLINE void shade_light_mis(const Pixel& px, const float* ls,
                              const Noise& noise, int j0, int n, f32 vis,
                              f32 (&base_out)[3], Emit&& emit) {
  constexpr int M = NV + 1;
  vrt::set_op_stage(vrt::kStagePrepare);
  const f32 scale = inverse_count(n);
  const f32 rad[3] = {ls[kLsRadiance], ls[kLsRadiance + 1],
                        ls[kLsRadiance + 2]};
  f32 w2s[12], w2c[12];
  flipped_rows(px, ls, px.w2s, w2s);
  flipped_rows(px, ls, px.w2c, w2c);
  V3 vs[NV], vc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const V3 v = light_vert(ls, k);
    vs[k] = affine(w2s, v);
    vc[k] = affine(w2c, v);
  }
  V3 clipped[M];
  PsaPoly<M> poly_d, poly_s;
  const int ccount = clip<NV>(vs, clipped);
  prepare_psa<M>(clipped, ccount, poly_d);
  const int ccount_c = clip<NV>(vc, clipped);
  prepare_psa<M>(clipped, ccount_c, poly_s);

  const f32 psa_d = poly_d.psa;
  const bool diffuse_ok = (ccount > 0) && (psa_d > 0.0f);
  const f32 rcp_psa_d = 1.0f / (psa_d > 0.0f ? psa_d : 1.0f);
  const f32 psa_s = ccount_c > 0 ? poly_s.psa : 0.0f;
  const bool specular_ok = psa_s > 0.0f;
  const f32 rcp_psa_s = 1.0f / (psa_s > 0.0f ? psa_s : 1.0f);
  const f32 specular_weight = px.ltc_albedo * psa_s;
  f32 diffuse_weight[3] = {vrt::jmax(px.albedo.x, 0.01f) * psa_d,
                             vrt::jmax(px.albedo.y, 0.01f) * psa_d,
                             vrt::jmax(px.albedo.z, 0.01f) * psa_d};
  f32 specular_weight3[3] = {specular_weight, specular_weight,
                               specular_weight};
  if (kHeuristic == 4) {  // optimal weights carry radiance / pi
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const f32 rop = rad[c] * kInvPi;
      diffuse_weight[c] = diffuse_weight[c] * rop;
      specular_weight3[c] = specular_weight3[c] * rop;
    }
  }

  f32 lbase[3] = {0.0f, 0.0f, 0.0f};
  vrt::set_op_stage(vrt::kStageSample);
  for (int s = 0; s < n; ++s) {
    f32 r0, r1, r2, r3;
    noise.pair(j0 + 2 * s, r0, r1);
    noise.pair(j0 + 2 * s + 1, r2, r3);
    const V3 d_diffuse = sample_psa<M>(poly_d, r0, r1);
    const V3 d_spec_c = sample_psa<M>(poly_s, r2, r3);
    V3 d_specular = {
        px.c2s[0] * d_spec_c.x + px.c2s[1] * d_spec_c.y +
            px.c2s[2] * d_spec_c.z,
        px.c2s[3] * d_spec_c.x + px.c2s[4] * d_spec_c.y +
            px.c2s[5] * d_spec_c.z,
        px.c2s[6] * d_spec_c.x + px.c2s[7] * d_spec_c.y +
            px.c2s[8] * d_spec_c.z};
    d_specular = normalize3(d_specular);
    for (int j = 0; j < 2; ++j) {
      const V3 d_sh = j == 0 ? d_diffuse : d_specular;
      const bool in_upper = d_sh.z > 0.0f;
      const f32 diffuse_density = d_sh.z * rcp_psa_d;
      const f32 specular_density =
          ltc_density(px.s2c, px.ltc_det, d_sh, rcp_psa_s);
      const V3 d_world = rot_t_apply(w2s, d_sh);
      const Radiance r = rad_brdf(px, ls, d_world);
      const bool gate =
          (j == 0 ? (in_upper && diffuse_ok)
                  : (in_upper && diffuse_ok && specular_ok)) && px.hit;
      const f32 dd_safe = diffuse_density > 0.0f ? diffuse_density : 1.0f;
      f32 b[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const f32 integrand1 = d_sh.z * r.value[c];
        const f32 sw = j == 0 ? diffuse_weight[c] : specular_weight3[c];
        const f32 sd = j == 0 ? diffuse_density : specular_density;
        const f32 ow = j == 0 ? specular_weight3[c] : diffuse_weight[c];
        const f32 od = j == 0 ? specular_density : diffuse_density;
        const f32 est0 = mis_estimate(0.0f, sw, sd, ow, od, vis);
        const f32 est1 = mis_estimate(integrand1, sw, sd, ow, od, vis);
        const f32 est_delta = est1 - est0;
        f32 a_term, b_term;
        if (j == 0) {
          a_term = specular_ok ? est0 : 0.0f;
          b_term = specular_ok ? est_delta : (1.0f / dd_safe) * integrand1;
        } else {
          a_term = est0;
          b_term = est_delta;
        }
        lbase[c] = lbase[c] + (gate ? a_term : 0.0f);
        b[c] = scale * (gate ? b_term : 0.0f);
      }
      emit(2 * s + j, b, d_world, r.t_max);
    }
  }
  vrt::set_op_stage(vrt::kStagePixel);
#pragma unroll
  for (int c = 0; c < 3; ++c) base_out[c] = scale * lbase[c];
}

// One light in the compile-time strategy; its noise pairs start at j0.
template <int NV, typename Emit>
K_INLINE void shade_light(const Pixel& px, const float* ls,
                          const Noise& noise, int j0, int n, f32 vis,
                          f32 (&base_out)[3], Emit&& emit) {
  if constexpr (kMis) {
    shade_light_mis<NV>(px, ls, noise, j0, n, vis, base_out, emit);
  } else {
    shade_light_diffuse<NV>(px, ls, noise, j0, n, emit);
#pragma unroll
    for (int c = 0; c < 3; ++c) base_out[c] = 0.0f;
  }
}

// Rays per light per pixel (render/fused.py rays_per_light).
K_INLINE int rays_per_light(int n) { return kMis ? 2 * n : n; }

// Vertex counts compiled into a library: bit nv of VR_NV_MASK (default all
// of 3-8).
#ifndef VR_NV_MASK
#define VR_NV_MASK 0x1f8
#endif

}  // namespace shade
