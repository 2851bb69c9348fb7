// K6: the per-pixel preamble, one thread per pixel: K3's attribute planes,
// the closest hit and the ray to the (62, P) shading planes of
// render/fused.py BASE_PLANES that K4 and K5 read.
//
// K6 replaces no Pallas kernel: the JAX package leaves this preamble
// (render/pipeline.py _pixel_preamble) to XLA's fusion of its jnp code. It
// was added because the port's PyTorch version of it, ~350 launches of
// gathers and elementwise passes with every intermediate in device memory,
// took ~20 ms of a 1920x1080 frame on the H100 (PERF.md section 5).
//
// What bounds it: its plane traffic, ~340 B a pixel (in: 18 attribute
// planes, prim, t_hit and the ray direction, 92 B; out: 62 planes, 248 B),
// 0.21 ms at 3.35 TB/s for 1920x1080. Texel and LTC-table reads are
// gathers into small tables that stay in L2. The design: everything
// between the loads and the stores is in registers; each thread writes its
// pixel's column of every plane, so a warp's stores are coalesced.
//
// Each step is render/preamble.py shading_planes_plain's PyTorch operation
// in the same order, every product and sum rounded on its own (--fmad=
// false), so K6 equals its plain version bit for bit on the card:
//   1. hit, t_safe and position (render/pipeline.py);
//   2. the isotropic trilinear textureGrad fetch with repeat addressing
//      (render/texture.py sample_texture_grad);
//   3. the Falcor decode, normal mapping and hemisphere clip
//      (render/shading.py finish_shading_data);
//   4. the Fresnel luminance;
//   5. the clamp-to-edge bilinear LTC fetch, the shading frame and the
//      matrices (ops/ltc.py get_ltc_coefficients).
// Where PyTorch's operation differs from the plain C one, the helpers
// below say how:
//   - torch.clamp, minimum and maximum propagate NaN (fminf and fmaxf drop
//     it); a miss pixel's planes are NaN exactly where the plain version's
//     are;
//   - torch.remainder on int64 takes the divisor's sign (repeat addressing
//     of negative uv);
//   - a Python float operand acts as a float32 scalar, the double's
//     rounding, written (float)1e-3;
//   - torch.sum over the 3 components of a (P, 3) tensor (normalize) adds
//     them in an order set by the tensor's memory layout: contiguous rows
//     reduce across two threads, (x + z) + y; a transposed layout, one
//     output a thread, (x + y) + z (ATen's ReduceConfig).
// acosf, log2f and sqrtf are the CUDA math library's, as in PyTorch's own
// kernels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K_INLINE __device__ __forceinline__

namespace {

constexpr int kThreads = 256;

// K3's attribute planes (render/trace_kernel.py ATTR_*).
constexpr int kAttrNormal = 0, kAttrUv = 3, kAttrDuvdx = 5, kAttrDuvdy = 7;
constexpr int kAttrTangent = 9, kAttrBitangent = 12, kAttrMtl = 15;
constexpr int kAttrMaterial = 16;

// The output planes (render/fused.py BASE_PLANES).
constexpr int kPos = 0, kNrm = 3, kOut = 6, kLambert = 9, kAlb = 10;
constexpr int kF0 = 13, kRough = 16, kHit = 17, kLtcAlbedo = 18;
constexpr int kLtcDet = 19, kW2s = 20, kW2c = 32, kS2c = 44, kC2s = 53;

// torch.clamp(v, lo, hi), clamp(v, min=lo), maximum and minimum.
K_INLINE float t_clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
K_INLINE float t_clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
K_INLINE float t_maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
K_INLINE float t_minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
// torch.remainder on int64.
K_INLINE long long t_remainder(long long a, long long b) {
  long long r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
// torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0).long().
K_INLINE long long finite_or_zero_long(float x) {
  return isfinite(x) ? (long long)x : 0LL;
}
// torch.nan_to_num(x, nan=0.0).long() for x that is finite or NaN.
K_INLINE long long nan_zero_long(float x) {
  return isnan(x) ? 0LL : (long long)x;
}

struct V3 {
  float x, y, z;
};
// ops/math_utils.py dot: left to right.
K_INLINE float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
K_INLINE V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
K_INLINE V3 div3(V3 v, float d) { return {v.x / d, v.y / d, v.z / d}; }
// ops/math_utils.py normalize of a contiguous (P, 3) tensor: the sum of
// squares as ATen's reduction adds them, (x + z) + y.
K_INLINE V3 normalize_rows(V3 v) {
  const float xx = v.x * v.x, yy = v.y * v.y, zz = v.z * v.z;
  return div3(v, sqrtf((xx + zz) + yy));
}
// The same for a (P, 3) tensor laid out as (3, P): (x + y) + z.
K_INLINE V3 normalize_columns(V3 v) {
  const float xx = v.x * v.x, yy = v.y * v.y, zz = v.z * v.z;
  return div3(v, sqrtf((xx + yy) + zz));
}

struct Atlas {
  const int4* texels;          // (N, 8) int32 UNORM16 values, as 2 int4
  const long long* offset;     // (T, levels) first texel of each mip
  const long long* width;      // (T, levels)
  const long long* height;     // (T, levels)
  const long long* count;      // (T,) mips of each texture
  int levels;
};

// One texel of 8 channels, times 1 / 65535 (render/texture.py fetch).
K_INLINE void fetch_texel(const Atlas& a, long long index, float out[8]) {
  const int4 lo = __ldg(a.texels + 2 * index);
  const int4 hi = __ldg(a.texels + 2 * index + 1);
  const float s = (float)(1.0 / 65535.0);
  out[0] = (float)lo.x * s; out[1] = (float)lo.y * s;
  out[2] = (float)lo.z * s; out[3] = (float)lo.w * s;
  out[4] = (float)hi.x * s; out[5] = (float)hi.y * s;
  out[6] = (float)hi.z * s; out[7] = (float)hi.w * s;
}

// render/texture.py _bilinear_wrap at one mip level.
K_INLINE void bilinear_wrap(const Atlas& a, long long tex, long long level,
                            float u, float v, float out[8]) {
  const long long k = tex * a.levels + level;
  const long long w = __ldg(a.width + k), h = __ldg(a.height + k);
  const long long offset = __ldg(a.offset + k);
  const float x = u * (float)w - 0.5f;
  const float y = v * (float)h - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const long long x0i = finite_or_zero_long(x0);
  const long long y0i = finite_or_zero_long(y0);
  const long long row0 = offset + t_remainder(y0i, h) * w;
  const long long row1 = offset + t_remainder(y0i + 1, h) * w;
  const long long col0 = t_remainder(x0i, w), col1 = t_remainder(x0i + 1, w);
  float t00[8], t10[8], t01[8], t11[8];
  fetch_texel(a, row0 + col0, t00);
  fetch_texel(a, row0 + col1, t10);
  fetch_texel(a, row1 + col0, t01);
  fetch_texel(a, row1 + col1, t11);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float top = t00[c] + fx * (t10[c] - t00[c]);
    const float bottom = t01[c] + fx * (t11[c] - t01[c]);
    out[c] = top + fy * (bottom - top);
  }
}

// render/texture.py sample_texture_grad: isotropic trilinear textureGrad.
K_INLINE void sample_texture_grad(const Atlas& a, long long tex, float u,
                                  float v, float dudx, float dvdx, float dudy,
                                  float dvdy, float out[8]) {
  const float w0 = (float)__ldg(a.width + tex * a.levels);
  const float h0 = (float)__ldg(a.height + tex * a.levels);
  const float dx0 = dudx * w0, dx1 = dvdx * h0;
  const float dy0 = dudy * w0, dy1 = dvdy * h0;
  const float rho_x = sqrtf(dx0 * dx0 + dx1 * dx1);
  const float rho_y = sqrtf(dy0 * dy0 + dy1 * dy1);
  const float rho_max = t_clamp_min(t_maximum(rho_x, rho_y), (float)1e-12);
  const long long mips = __ldg(a.count + tex);
  const float max_level = (float)(mips - 1);
  const float lod =
      t_minimum(t_clamp_min(log2f(rho_max), 0.0f), max_level);
  // render/texture.py _trilinear.
  const long long l0 = nan_zero_long(floorf(lod));
  const long long l1 = l0 + 1 < mips - 1 ? l0 + 1 : mips - 1;
  const float frac = lod - (float)l0;
  float c1[8];
  bilinear_wrap(a, tex, l0, u, v, out);
  bilinear_wrap(a, tex, l1, u, v, c1);
#pragma unroll
  for (int c = 0; c < 8; ++c) out[c] = out[c] + frac * (c1[c] - out[c]);
}

// ops/ltc.py _bilinear_fetch: clamp-to-edge bilinear in the (layers, H, W,
// 6) table.
K_INLINE void ltc_fetch(const float* __restrict__ table, int layers,
                        int height, int width, float tex_x, float tex_y,
                        float layer, float out[6]) {
  const float x = t_clamp(tex_x * (float)width - 0.5f, 0.0f,
                          (float)width - 1.0f);
  const float y = t_clamp(tex_y * (float)height - 0.5f, 0.0f,
                          (float)height - 1.0f);
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x - x0f, fy = y - y0f;
  const long long x0 = nan_zero_long(x0f), y0 = nan_zero_long(y0f);
  long long li = nan_zero_long(rintf(layer));
  li = li < 0 ? 0 : (li > layers - 1 ? layers - 1 : li);
  const long long x1 = x0 + 1 < width - 1 ? x0 + 1 : width - 1;
  const long long y1 = y0 + 1 < height - 1 ? y0 + 1 : height - 1;
  const long long row0 = (li * height + y0) * width;
  const long long row1 = (li * height + y1) * width;
  const float2* t = reinterpret_cast<const float2*>(table);
  float t00[6], t01[6], t10[6], t11[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float2 a = __ldg(t + 3 * (row0 + x0) + k);
    const float2 b = __ldg(t + 3 * (row0 + x1) + k);
    const float2 c = __ldg(t + 3 * (row1 + x0) + k);
    const float2 d = __ldg(t + 3 * (row1 + x1) + k);
    t00[2 * k] = a.x; t00[2 * k + 1] = a.y;
    t01[2 * k] = b.x; t01[2 * k + 1] = b.y;
    t10[2 * k] = c.x; t10[2 * k + 1] = c.y;
    t11[2 * k] = d.x; t11[2 * k + 1] = d.y;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float top = t00[c] + fx * (t01[c] - t00[c]);
    const float bottom = t10[c] + fx * (t11[c] - t10[c]);
    out[c] = top + fy * (bottom - top);
  }
}

__global__ void __launch_bounds__(kThreads)
preamble_kernel(const float* __restrict__ attrs, const int* __restrict__ prim,
                const float* __restrict__ t_hit,
                const float* __restrict__ dirs, int pixel_count,
                const float* __restrict__ camera, float roughness_factor,
                Atlas atlas, const float* __restrict__ ltc_table,
                int ltc_layers, int ltc_height, int ltc_width,
                const float* __restrict__ ltc_constants,
                float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixel_count) return;
  const long long n = pixel_count;
  auto attr = [&](int k) { return __ldg(attrs + k * n + p); };
  auto store = [&](int k, float v) { out[k * n + p] = v; };

  // 1. hit, t_safe and position.
  const V3 cam = {__ldg(camera), __ldg(camera + 1), __ldg(camera + 2)};
  const V3 dir = {__ldg(dirs + 3 * (long long)p),
                  __ldg(dirs + 3 * (long long)p + 1),
                  __ldg(dirs + 3 * (long long)p + 2)};
  const bool hit = __ldg(prim + p) != -1;
  const float t = __ldg(t_hit + p);
  const float t_safe = hit && isfinite(t) ? t : 0.0f;
  const V3 position = {cam.x + t_safe * dir.x, cam.y + t_safe * dir.y,
                       cam.z + t_safe * dir.z};

  // 2. The material texel.
  float texel[8];
  sample_texture_grad(atlas, (long long)attr(kAttrMaterial), attr(kAttrUv),
                      attr(kAttrUv + 1), attr(kAttrDuvdx),
                      attr(kAttrDuvdx + 1), attr(kAttrDuvdy),
                      attr(kAttrDuvdy + 1), texel);

  // 3. Falcor decode, normal mapping, hemisphere clip.
  const float nx = texel[6] * 2.0f - 1.0f, ny = texel[7] * 2.0f - 1.0f;
  const float normal_ts_z = sqrtf(t_clamp_min(1.0f - nx * nx - ny * ny,
                                              0.0f));
  const float metalicity = texel[5];
  V3 base_color = {texel[0], texel[1], texel[2]};
  const V3 diffuse_albedo = {base_color.x - metalicity * base_color.x,
                             base_color.y - metalicity * base_color.y,
                             base_color.z - metalicity * base_color.z};
  const float dielectric = (1.0f - metalicity) * (float)0.02;
  const V3 fresnel_0 = {dielectric + metalicity * base_color.x,
                        dielectric + metalicity * base_color.y,
                        dielectric + metalicity * base_color.z};
  const float linear_roughness = texel[4];
  const float roughness =
      t_clamp(linear_roughness * linear_roughness * roughness_factor,
              (float)0.0064, 1.0f);
  const float nz = normal_ts_z * t_clamp_min(attr(kAttrMtl), (float)1.0e-10);
  const V3 tangent = {attr(kAttrTangent), attr(kAttrTangent + 1),
                      attr(kAttrTangent + 2)};
  const V3 bitangent = {attr(kAttrBitangent), attr(kAttrBitangent + 1),
                        attr(kAttrBitangent + 2)};
  const V3 normal_interp = {attr(kAttrNormal), attr(kAttrNormal + 1),
                            attr(kAttrNormal + 2)};
  // The sum's layout follows the attribute planes': (3, P).
  V3 normal = normalize_columns(
      {nx * tangent.x + ny * bitangent.x + nz * normal_interp.x,
       nx * tangent.y + ny * bitangent.y + nz * normal_interp.y,
       nx * tangent.z + ny * bitangent.z + nz * normal_interp.z});
  const V3 outgoing = normalize_rows(
      {cam.x - position.x, cam.y - position.y, cam.z - position.z});
  const float normal_offset =
      t_clamp_min((float)1.0e-3 - dot3(normal, outgoing), 0.0f);
  normal = normalize_rows({normal_offset * outgoing.x + normal.x,
                           normal_offset * outgoing.y + normal.y,
                           normal_offset * outgoing.z + normal.z});
  const float lambert_outgoing = dot3(normal, outgoing);

  // 4. Fresnel luminance.
  const float fresnel_luminance = fresnel_0.x * (float)0.2126
      + fresnel_0.y * (float)0.7152 + fresnel_0.z * (float)0.0722;

  // 5. LTC coefficients.
  const float c0 = __ldg(ltc_constants), c1 = __ldg(ltc_constants + 1);
  const float c2 = __ldg(ltc_constants + 2), c3 = __ldg(ltc_constants + 3);
  const float c4 = __ldg(ltc_constants + 4), c5 = __ldg(ltc_constants + 5);
  const float normal_dot_outgoing = dot3(normal, outgoing);
  const float inclination = acosf(t_clamp(normal_dot_outgoing, 0.0f, 1.0f));
  const float tex_x = sqrtf(t_clamp(roughness, 0.0f, 1.0f)) * c2 + c3;
  const float tex_y = inclination * c4 + c5;
  const float layer = t_clamp(fresnel_luminance, 0.0f, 1.0f) * c0 + c1;
  float d[6];
  ltc_fetch(ltc_table, ltc_layers, ltc_height, ltc_width, tex_x, tex_y,
            layer, d);
  const float d0x = d[0], d0y = d[1], d0z = d[2], d0w = d[3];
  const float d1x = d[4], d1y = d[5];
  const float det_2x2 = d0x * d1x + d0y * d0w;
  const float determinant = d0z * det_2x2;
  const float inv_det_2x2 = 1.0f / det_2x2;
  const V3 x_axis = normalize_rows(
      {-normal_dot_outgoing * normal.x + outgoing.x,
       -normal_dot_outgoing * normal.y + outgoing.y,
       -normal_dot_outgoing * normal.z + outgoing.z});
  const V3 y_axis = cross3(normal, x_axis);
  const V3 rows[3] = {x_axis, y_axis, normal};
  float w2s[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w2s[i][0] = rows[i].x;
    w2s[i][1] = rows[i].y;
    w2s[i][2] = rows[i].z;
    w2s[i][3] = -dot3(rows[i], position);
  }

  store(kPos, position.x); store(kPos + 1, position.y);
  store(kPos + 2, position.z);
  store(kNrm, normal.x); store(kNrm + 1, normal.y);
  store(kNrm + 2, normal.z);
  store(kOut, outgoing.x); store(kOut + 1, outgoing.y);
  store(kOut + 2, outgoing.z);
  store(kLambert, lambert_outgoing);
  store(kAlb, diffuse_albedo.x); store(kAlb + 1, diffuse_albedo.y);
  store(kAlb + 2, diffuse_albedo.z);
  store(kF0, fresnel_0.x); store(kF0 + 1, fresnel_0.y);
  store(kF0 + 2, fresnel_0.z);
  store(kRough, roughness);
  store(kHit, hit ? 1.0f : 0.0f);
  store(kLtcAlbedo, d1y);
  store(kLtcDet, determinant);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    store(kW2s + j, w2s[0][j]);
    store(kW2s + 4 + j, w2s[1][j]);
    store(kW2s + 8 + j, w2s[2][j]);
    // world_to_cosine = shading_to_cosine @ world_to_shading, rows
    // [d0x 0 d0w], [0 d0z 0], [-d0y 0 d1x].
    store(kW2c + j, d0x * w2s[0][j] + d0w * w2s[2][j]);
    store(kW2c + 4 + j, d0z * w2s[1][j]);
    store(kW2c + 8 + j, -d0y * w2s[0][j] + d1x * w2s[2][j]);
  }
  const float s2c[9] = {d0x, 0.0f, d0w, 0.0f, d0z, 0.0f, -d0y, 0.0f, d1x};
  const float c2s[9] = {d1x * inv_det_2x2, 0.0f, -d0w * inv_det_2x2,
                        0.0f, 1.0f / d0z, 0.0f,
                        d0y * inv_det_2x2, 0.0f, d0x * inv_det_2x2};
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    store(kS2c + k, s2c[k]);
    store(kC2s + k, c2s[k]);
  }
}

}  // namespace

extern "C" int k6_preamble(const float* attrs, const int* prim,
                           const float* t_hit, const float* dirs,
                           int pixel_count, const float* camera,
                           float roughness_factor, const int* texels,
                           const long long* mip_offset,
                           const long long* mip_width,
                           const long long* mip_height,
                           const long long* mip_count, int mip_levels,
                           const float* ltc_table, int ltc_layers,
                           int ltc_height, int ltc_width,
                           const float* ltc_constants, float* out,
                           cudaStream_t stream) {
  const Atlas atlas = {reinterpret_cast<const int4*>(texels), mip_offset,
                       mip_width, mip_height, mip_count, mip_levels};
  const int blocks = (pixel_count + kThreads - 1) / kThreads;
  preamble_kernel<<<blocks, kThreads, 0, stream>>>(
      attrs, prim, t_hit, dirs, pixel_count, camera, roughness_factor, atlas,
      ltc_table, ltc_layers, ltc_height, ltc_width, ltc_constants, out);
  return (int)cudaGetLastError();
}
