// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every helper reproduces the JAX package's float32 semantics operation by
// operation (the kernels are built with --fmad=false, so no product is fused
// into an FMA behind our back):
//   - jmin/jmax propagate NaN like jnp.minimum/jnp.maximum. CUDA's
//     fminf/fmaxf DROP a NaN operand, which would turn a NaN padding box into
//     a phantom slab-test hit; these never do.
//   - the slab test is _ray_slab_scalars of
//     vulkan_renderer_tpu/render/trace_kernel.py:521-538.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K_INLINE __device__ __forceinline__

namespace vrt {

constexpr int kSubGroup = 8;   // triangles per sub-box
constexpr int kStack = 32;     // BVH traversal stack (tree depth <= 31)
constexpr float kU = 1.0f / 16777216.0f;   // 2^-24, float32's unit roundoff
constexpr float kKappaMax = 1048576.0f;    // 2^20 (render/clusters.py)

K_INLINE float jmin(float a, float b) { return (a < b || a != a) ? a : b; }
K_INLINE float jmax(float a, float b) { return (a > b || a != a) ? a : b; }
// jnp.clip(x, lo, hi) == min(max(x, lo), hi), NaN-propagating.
K_INLINE float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}

struct Ray {
  float ox, oy, oz;
  float dx, dy, dz;
  float ix, iy, iz;  // per-axis 1/d, 1e30 where |d| <= 1e-20
  float t_max;
};

K_INLINE float safe_inverse(float d) {
  return fabsf(d) > 1e-20f ? 1.0f / d : 1e30f;
}

K_INLINE Ray load_ray(const float* __restrict__ origins,
                      const float* __restrict__ dirs,
                      const float* __restrict__ t_max, int r) {
  Ray ray;
  ray.ox = origins[3 * r + 0];
  ray.oy = origins[3 * r + 1];
  ray.oz = origins[3 * r + 2];
  ray.dx = dirs[3 * r + 0];
  ray.dy = dirs[3 * r + 1];
  ray.dz = dirs[3 * r + 2];
  ray.ix = safe_inverse(ray.dx);
  ray.iy = safe_inverse(ray.dy);
  ray.iz = safe_inverse(ray.dz);
  ray.t_max = t_max[r];
  return ray;
}

// Slab test of one ray against the box [lo, hi] (3 floats each). NaN box
// coordinates fail every comparison (padding). Writes the entry distance.
K_INLINE bool slab(const float* __restrict__ lo, const float* __restrict__ hi,
                   const Ray& ray, float t_cap, float* t_near_out) {
  float t0 = (lo[0] - ray.ox) * ray.ix;
  float t1 = (hi[0] - ray.ox) * ray.ix;
  float t_near = jmin(t0, t1);
  float t_far = jmax(t0, t1);
  t0 = (lo[1] - ray.oy) * ray.iy;
  t1 = (hi[1] - ray.oy) * ray.iy;
  t_near = jmax(t_near, jmin(t0, t1));
  t_far = jmin(t_far, jmax(t0, t1));
  t0 = (lo[2] - ray.oz) * ray.iz;
  t1 = (hi[2] - ray.oz) * ray.iz;
  t_near = jmax(t_near, jmin(t0, t1));
  t_far = jmin(t_far, jmax(t0, t1));
  *t_near_out = t_near;
  return (t_near <= t_far) && (t_far >= 0.0f) && (t_near <= t_cap) &&
         (t_cap >= 0.0f);
}

// Per ray: (kappa's factor, the constant) of eps = kappa * x + y, the
// distance within which a ray passes a box that holds an axis triangle of
// sliver factor kappa whenever Moeller-Trumbore accepts a hit on it
// (derived in the header of closest.cu), from the scene's box (the union
// of the root's children; NaN children drop out).
K_INLINE float2 floor_scale(const float4* __restrict__ nodes, const Ray& ray) {
  const float4 a = __ldg(nodes), b = __ldg(nodes + 1), c = __ldg(nodes + 2);
  const float lo[3] = {fminf(a.x, b.z), fminf(a.y, b.w), fminf(a.z, c.x)};
  const float hi[3] = {fmaxf(a.w, c.y), fmaxf(b.x, c.z), fmaxf(b.y, c.w)};
  const float o[3] = {ray.ox, ray.oy, ray.oz};
  float far = 0.0f, size = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    far += fmaxf(fabsf(lo[k] - o[k]), fabsf(hi[k] - o[k]));
    size += hi[k] - lo[k];
  }
  return {8.0f * kU * (2.0f * far + size), 8.0f * kU * size};
}

// Triangle t of a cluster's component-major plane row: component j of
// triangle t is at j * C + t (render/clusters.py).
struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

K_INLINE Tri load_tri(const float* __restrict__ row, int t, int c) {
  Tri tri;
  tri.v0x = row[0 * c + t];
  tri.v0y = row[1 * c + t];
  tri.v0z = row[2 * c + t];
  tri.e1x = row[3 * c + t];
  tri.e1y = row[4 * c + t];
  tri.e1z = row[5 * c + t];
  tri.e2x = row[6 * c + t];
  tri.e2y = row[7 * c + t];
  tri.e2z = row[8 * c + t];
  return tri;
}

// Box and triangle tests of one thread, counted only in the libraries that
// chip_smoke.py builds with -DVR_COUNT_TESTS=1 (atomics into a small
// buffer at the end of the thread); compiled out everywhere else.
#ifndef VR_COUNT_TESTS
#define VR_COUNT_TESTS 0
#endif

struct TestCounts {
  unsigned long long boxes = 0;     // slab tests of BVH child boxes
  unsigned long long subboxes = 0;  // slab tests of 8-triangle sub-boxes
  unsigned long long triangles = 0;
};

#if VR_COUNT_TESTS
#define VR_COUNT(counts, field, n) ((counts).field += (n))
#else
#define VR_COUNT(counts, field, n) ((void)0)
#endif

K_INLINE void flush_counts(const TestCounts& counts,
                           unsigned long long* __restrict__ out) {
#if VR_COUNT_TESTS
  if (out != nullptr && counts.boxes != 0) {
    atomicAdd(out + 0, counts.boxes);
    atomicAdd(out + 1, counts.subboxes);
    atomicAdd(out + 2, counts.triangles);
  }
#endif
}

// Depth-first walk of the cluster BVH (render/clusters.py
// build_cluster_bvh_np): each inner node is one 64-byte record holding
// both children's boxes and refs, read as four float4 through the
// read-only path, so one record feeds two slab tests. Both children are
// tested against the ray's [0, t_max]; a child that passes and that
// keep(t_near) accepts is visited, the nearer one first (left on a tie),
// the farther one pushed with its t_near and checked against keep() again
// when it is popped. A leaf ref (< 0) names cluster -1 - ref:
// visit(cluster, kappa) tests its triangles and returns true to end the
// walk; kappa is the cluster's largest sliver factor, from its parent's
// record (words 14-15; +inf for a cluster that holds a triangle that is
// not an axis triangle).
// Refs past the last cluster sit behind NaN boxes that never pass; they
// are skipped all the same. The loop is a while-while walk (Aila and
// Laine, HPG 2009): a thread runs inner nodes until it reaches a leaf, so
// the threads of a warp test their clusters together instead of
// alternating node and leaf bodies (measured against the if-if form in
// PERF.md section 6).
template <class Keep, class Visit>
K_INLINE void walk_bvh(const float4* __restrict__ nodes, const Ray& ray,
                       int cluster_count, Keep keep, Visit visit,
                       TestCounts& counts) {
  int stack_ref[kStack];
  float stack_tnear[kStack], stack_kappa[kStack];
  int sp = 0;
  int ref = 0;  // the root
  float ref_kappa = INFINITY;
  for (;;) {
    while (ref >= 0) {
      const float4* rec = nodes + 4 * ref;
      const float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2),
                   d = __ldg(rec + 3);
      const float lo_l[3] = {a.x, a.y, a.z}, hi_l[3] = {a.w, b.x, b.y};
      const float lo_r[3] = {b.z, b.w, c.x}, hi_r[3] = {c.y, c.z, c.w};
      float t_l, t_r;
      const bool in_l = slab(lo_l, hi_l, ray, ray.t_max, &t_l) && keep(t_l);
      const bool in_r = slab(lo_r, hi_r, ray, ray.t_max, &t_r) && keep(t_r);
      VR_COUNT(counts, boxes, 2);
      const int ref_l = __float_as_int(d.x), ref_r = __float_as_int(d.y);
      if (in_l && in_r) {
        const bool right_first = t_r < t_l;
        stack_ref[sp] = right_first ? ref_l : ref_r;
        stack_tnear[sp] = right_first ? t_l : t_r;
        stack_kappa[sp] = right_first ? d.z : d.w;
        ++sp;
        ref = right_first ? ref_r : ref_l;
        ref_kappa = right_first ? d.w : d.z;
      } else if (in_l || in_r) {
        ref = in_l ? ref_l : ref_r;
        ref_kappa = in_l ? d.z : d.w;
      } else {
        do {
          if (sp == 0) return;
          --sp;
          ref = stack_ref[sp];
          ref_kappa = stack_kappa[sp];
        } while (!keep(stack_tnear[sp]));
      }
    }
    const int k = -1 - ref;
    if (k < cluster_count && visit(k, ref_kappa)) return;
    do {
      if (sp == 0) return;
      --sp;
      ref = stack_ref[sp];
      ref_kappa = stack_kappa[sp];
    } while (!keep(stack_tnear[sp]));
  }
}

}  // namespace vrt
