// K1: shadow any-hit over the cluster BVH, in two entries:
//   - k1_anyhit: a ray list (origins, directions, t_max), one thread per ray;
//   - k1_anyhit_slots: the frame's shadow rays read in place from K4's
//     (3 + 7 S, P) slot planes, with the combine folded in (below).
//
// Replaces the Pallas kernel
// vulkan_renderer_tpu/render/trace_kernel.py::_anyhit_pass_one (kernel at
// :652, pallas_call at :714), which the TPU build drives over (ray chunk,
// cluster) work items from an XLA cull, with supercluster budgets and an
// exactness re-trace. The function is the Pallas kernel's: a ray is
// occluded iff some triangle of a cluster whose box passes the slab test
// against [0, t_max] passes the division-free Moeller-Trumbore of
// trace_kernel.py:676-692 (no backface culling, hit iff adet > 1e-12,
// u, v >= 0, u + v <= adet and t_min * adet <= tt <= t_max * adet). t_max
// < 0 marks a dead ray (zero-weight shadow slot), which returns unoccluded
// at once. trace_anyhit_plain is that function written out: every
// triangle of every passing cluster.
//
// Here every ray walks one binary tree over the clusters (common.cuh
// walk_bvh, nearer child first), then a cluster's 8-triangle sub-boxes,
// then the triangles of each sub-box that passes the gate below, and
// stops at its first hit; no cull, budget or re-trace exists. A cluster
// box that passes implies every ancestor box passes (a parent's box
// contains its children's and the slab arithmetic rounds monotonically),
// so the walk reaches every passing cluster, and the answer does not
// depend on the order of the walk.
//
// The sub-box gate, and why it drops no hit. The Pallas kernel has none
// (":668, sub-box gating was MEASURED SLOWER here"). A bare slab test of
// the sub-box is not conservative: Moeller-Trumbore accepts rays through
// a vertex where the slab test of the vertex's own box finds t_near >
// t_far by an ulp (tools/anyhit_gate_check.py: 46 of 4,484 rays through
// the vertices of a small city), and it accepts points beside its
// triangle on grazing rays. So the gate is a slab test of the sub-box
// grown by eps along every axis, against [0, t_max (1 + eta)], and only
// where eps is a proven bound; elsewhere every triangle of the cluster is
// tested. This is repair (b) of the two that were weighed: (a), no gate,
// is the Pallas kernel's loop, but on the bench city it would test every
// triangle of each cluster a shadow ray reaches (~26 M cluster visits x
// 64 triangles against ~113 M triangle tests with the gate). The bound is
// K2's (closest.cu header): for an axis triangle (e1 and e2 exactly 0 on
// one axis) of sliver factor kappa, every term of det, u, v and tt off
// that axis is an exact zero, and whenever Moeller-Trumbore accepts,
//   (1) the ray's exact distance t* to the triangle's plane is at most
//       tt / adet (1 + (5 + 4 kappa) u), and tt <= t_max adet rounds once
//       more (the division-free test has no reciprocal), so t* <= t_max
//       (1 + (6 + 4 kappa) u + O(u^2));
//   (2) the ray meets the plane within u (kappa (|T| + t*) + |e1| + |e2|)
//       of the box of the triangle's vertices (the lateral errors of u and
//       v, and the edges e = fl(v - v0), which move the corners against
//       the box built from the vertices themselves).
// floor_scale bounds (2) per ray by eps = kappa 8 u (2 F + D) + 8 u D (F,
// D: the scene box's far extent from the origin and side sum), at least 4
// times the term, and eta = (26 + 8 kappa) u is at least 2 times (1). The
// gate works in t along each axis: the entry and exit of the box are
// moved by eps |1/d_a|, so no coordinate is rounded far from the origin;
// the slack between the grown box and (2) covers the slab test's own
// roundings (3 per coordinate: subtraction, reciprocal, product; at most
// 4 u F of the at least 16 u F that eps holds beyond (2)).
// `python -m vulkan_renderer_tpu_torch.tools.anyhit_gate_check --bounds N`
// holds both in float32 numpy: over millions of random axis triangles,
// slivers to kappa 10^4, with rays aimed at vertices, at edges, and 10^-7
// to 10^-2 off the plane, and t_max within 10^-8 to 10^-5 relative of
// t*, no hit that Moeller-Trumbore accepts fails the gate, and the worst
// measured terms stay under half of eps and eta (PERF.md section 6).
// The gate stays off (every triangle of the cluster is tested) where the
// bound is not proven: a cluster holding a triangle that is not an axis
// triangle, or one of kappa > 2^20 (render/clusters.py stores +inf; such
// a triangle's errors grow as 1 / |d . n| with no bound but the det
// gate); eps >= 1e8 (so eps |1/d_a| stays finite for |d_a| <= 1e-20,
// where the slab test takes 1/d_a as 1e30); and t_max > 1e18 eps's
// constant (so such an axis's true motion, |d_a| t_max <= 1e-20 t_max,
// stays within the slack). The bench city and the sweep's planes are axis
// triangles of kappa <= 5.1, where eps is a few millimetres.
//
// What bounds it on the H100: the latency of dependent, divergent loads
// and branches, not DRAM bandwidth or FLOPs. The bench city's tables (about
// 11 MB of triangle planes, 1.8 MB of sub-boxes and a 300 KB tree) sit in
// the 50 MB L2 after the first rays touch them, and a triangle test is
// ~55 operations. The tree limits a ray to the boxes along its path (about
// 2 x depth box tests per cluster it reaches), the sub-box gate skips most
// triangles of a cluster the ray only grazes, and the first hit ends the
// walk; the sample-major ray order makes neighbouring threads shadow
// neighbouring pixels toward the same light, which keeps a warp on the
// same branches of the tree.
//
// The slot entry. Where the frame's rays come from: pixel p's ray of slot
// s starts at its shading point (K6's position rows) on a hit pixel and at
// the camera on a miss, runs along K4's direction of slot s and is dead
// (t_max = -1) where the slot's weight b is zero in all three channels,
// else ends at K4's t_max: the float32 values of the sample-major ray list
// (render/trace_kernel.py shadow_megabatch), never stored. Each ray takes
// the same visit as in the ray list's entry, so its occlusion bit is that
// entry's. The entry then writes colors = (base0 + base) + sum_s b_s V_s,
// V = 0 where the ray is occluded and 1 elsewhere, multiplied and not
// skipped, so a non-finite b still reaches the resolve's pink. A block
// holds 32 consecutive pixels and one warp per slot group (groups of
// group_slots consecutive slots, render/trace_kernel.py slot_groups):
// neighbouring lanes shadow neighbouring pixels toward the same sample,
// the ray list's coherence, and a thread walks only its group's slots, so
// no thread runs all of a pixel's slots while the card idles around the
// last wave. How the sum's order is fixed: each lane adds its group's
// terms in slot order onto 0, then lane p of warp 0 adds the groups'
// partial sums in group order onto 0, through shared memory; the plain
// version (shadow_combine) adds in these groups in this order. With a
// counter, each warp adds its live rays (t_max >= 0) to it with one atomic.

#include "common.cuh"

namespace {

using vrt::Ray;
using vrt::Tri;

__device__ __forceinline__ bool anyhit_triangle(const Tri& p, const Ray& r,
                                                float t_min) {
  const float px = r.dy * p.e2z - r.dz * p.e2y;
  const float py = r.dz * p.e2x - r.dx * p.e2z;
  const float pz = r.dx * p.e2y - r.dy * p.e2x;
  const float det = p.e1x * px + p.e1y * py + p.e1z * pz;
  const float su = det >= 0.0f ? 1.0f : -1.0f;
  const float adet = det * su;
  const float tx = r.ox - p.v0x, ty = r.oy - p.v0y, tz = r.oz - p.v0z;
  const float u = (tx * px + ty * py + tz * pz) * su;
  const float qx = ty * p.e1z - tz * p.e1y;
  const float qy = tz * p.e1x - tx * p.e1z;
  const float qz = tx * p.e1y - ty * p.e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * su;
  const float tt = (p.e2x * qx + p.e2y * qy + p.e2z * qz) * su;
  return (adet > 1e-12f) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= adet) &&
         (tt >= t_min * adet) && (tt <= r.t_max * adet);
}

// The gate: common.cuh slab on the box [lo, hi] with each axis's entry
// and exit moved out by w[a] = eps |1/d_a| (the box grown by eps), against
// [0, t_cap]. NaN boxes (empty groups) fail every comparison.
__device__ __forceinline__ bool grown_slab(const float* lo, const float* hi,
                                           const Ray& ray, const float* w,
                                           float t_cap) {
  const float o[3] = {ray.ox, ray.oy, ray.oz};
  const float inv[3] = {ray.ix, ray.iy, ray.iz};
  float t_near = 0.0f, t_far = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (lo[a] - o[a]) * inv[a];
    const float t1 = (hi[a] - o[a]) * inv[a];
    const float near = vrt::jmin(t0, t1) - w[a];
    const float far = vrt::jmax(t0, t1) + w[a];
    t_near = a == 0 ? near : vrt::jmax(t_near, near);
    t_far = a == 0 ? far : vrt::jmin(t_far, far);
  }
  return (t_near <= t_far) && (t_far >= 0.0f) && (t_near <= t_cap) &&
         (t_cap >= 0.0f);
}

// The tables K1 walks. Each entry builds it from its own __restrict__
// parameters, so the loads through it keep their read-only path.
struct Tables {
  const float4* nodes;
  const float* planes;
  int cluster_count, cluster_size;
  const float* subboxes;
  int subbox_count;
  float t_min;
};

// Whether the live ray (t_max >= 0) is occluded: the BVH walk, each
// reached cluster's gated sub-boxes, then their triangles, up to the first
// hit. scale is floor_scale(nodes, ray), which reads the ray's origin only.
__device__ __forceinline__ bool occluded_ray(const Tables& tab, const Ray& ray,
                                             float2 scale,
                                             vrt::TestCounts& counts) {
  bool hit = false;
  const bool ray_bounded = ray.t_max * 1e-18f <= scale.y;
  auto keep = [](float) { return true; };
  auto visit = [&](int k, float kappa) {
    const float* row = tab.planes + (size_t)k * 9 * tab.cluster_size;
    const float* boxes = tab.subboxes + (size_t)k * 6 * tab.subbox_count;
    const float eps = kappa * scale.x + scale.y;
    const bool gated = ray_bounded & (kappa <= vrt::kKappaMax) &
                       (eps < 1e8f);
    const float w[3] = {eps * fabsf(ray.ix), eps * fabsf(ray.iy),
                        eps * fabsf(ray.iz)};
    const float t_cap =
        ray.t_max * (1.0f + (26.0f + 8.0f * kappa) * vrt::kU);
    for (int g = 0; g < tab.subbox_count; ++g) {
      // Empty groups are NaN boxes and fail either test.
      const float* lo = boxes + 6 * g;
      VR_COUNT(counts, subboxes, 1);
      if (gated ? !grown_slab(lo, lo + 3, ray, w, t_cap) : lo[0] != lo[0])
        continue;
      const int t_end = min((g + 1) * vrt::kSubGroup, tab.cluster_size);
      for (int t = g * vrt::kSubGroup; t < t_end; ++t) {
        VR_COUNT(counts, triangles, 1);
        if (anyhit_triangle(vrt::load_tri(row, t, tab.cluster_size), ray,
                            tab.t_min)) {
          hit = true;
          return true;
        }
      }
    }
    return false;
  };
  vrt::walk_bvh(tab.nodes, ray, tab.cluster_count, keep, visit, counts);
  return hit;
}

__global__ void __launch_bounds__(128)
anyhit_kernel(const float* __restrict__ origins,
              const float* __restrict__ dirs,
              const float* __restrict__ t_max, int ray_count,
              const float4* __restrict__ nodes,
              const float* __restrict__ planes, int cluster_count,
              int cluster_size, const float* __restrict__ subboxes,
              int subbox_count, float t_min, bool* __restrict__ occluded,
              unsigned long long* __restrict__ test_counts) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= ray_count) return;
  const Tables tab = {nodes,    planes,       cluster_count, cluster_size,
                      subboxes, subbox_count, t_min};
  const Ray ray = vrt::load_ray(origins, dirs, t_max, r);
  bool hit = false;
  vrt::TestCounts counts;
  if (ray.t_max >= 0.0f)
    hit = occluded_ray(tab, ray, vrt::floor_scale(tab.nodes, ray), counts);
  occluded[r] = hit;
  vrt::flush_counts(counts, test_counts);
}

// The most slot groups (warps) a block of the slot entry holds.
constexpr int kMaxSlotGroups = 16;

// out (3 + 7 S, P): base RGB, then per slot b RGB, direction, t_max;
// positions (3, P): the shading points; hit_pixel (P,); cam (3,); base0 and
// colors (P, 3). One block per 32 pixels, blockDim.x = 32 x groups.
__global__ void __launch_bounds__(32 * kMaxSlotGroups)
slots_anyhit_kernel(const float* __restrict__ out, int slots, int pixel_count,
                    int group_slots, const bool* __restrict__ hit_pixel,
                    const float* __restrict__ positions,
                    const float* __restrict__ cam,
                    const float* __restrict__ base0,
                    const float4* __restrict__ nodes,
                    const float* __restrict__ planes, int cluster_count,
                    int cluster_size, const float* __restrict__ subboxes,
                    int subbox_count, float t_min,
                    float* __restrict__ colors,
                    int* __restrict__ live_rays) {
  extern __shared__ float partial[];  // (groups, 3, 32)
  const Tables tab = {nodes,    planes,       cluster_count, cluster_size,
                      subboxes, subbox_count, t_min};
  const int lane = threadIdx.x & 31, group = threadIdx.x >> 5;
  const int groups = blockDim.x >> 5;
  const int p = blockIdx.x * 32 + lane;
  const size_t n = (size_t)pixel_count;
  // A lane keeps its group's three sums in its own words of shared memory,
  // and each ray takes floor_scale afresh, as in the ray-list entry: on the
  // arcade frame both ran faster than holding them in registers across the
  // walk (PERF.md section 6).
  float* sum = partial + group * 3 * 32 + lane;
#pragma unroll
  for (int c = 0; c < 3; ++c) sum[32 * c] = 0.0f;
  int live = 0;
  vrt::TestCounts counts;  // counted only by the ray-list entry
  if (p < pixel_count) {
    Ray ray;
    const bool on_surface = hit_pixel[p];
    ray.ox = on_surface ? positions[p] : cam[0];
    ray.oy = on_surface ? positions[n + p] : cam[1];
    ray.oz = on_surface ? positions[2 * n + p] : cam[2];
    const int s_end = min(slots, (group + 1) * group_slots);
    for (int s = group * group_slots; s < s_end; ++s) {
      const float* slot = out + (3 + 7 * (size_t)s) * n + p;
      const float b[3] = {slot[0], slot[n], slot[2 * n]};
      ray.dx = slot[3 * n];
      ray.dy = slot[4 * n];
      ray.dz = slot[5 * n];
      ray.ix = vrt::safe_inverse(ray.dx);
      ray.iy = vrt::safe_inverse(ray.dy);
      ray.iz = vrt::safe_inverse(ray.dz);
      ray.t_max = (b[0] != 0.0f) | (b[1] != 0.0f) | (b[2] != 0.0f)
                      ? slot[6 * n]
                      : -1.0f;
      bool hit = false;
      if (ray.t_max >= 0.0f) {
        ++live;
        hit = occluded_ray(tab, ray, vrt::floor_scale(tab.nodes, ray),
                           counts);
      }
      const float visibility = hit ? 0.0f : 1.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        sum[32 * c] = sum[32 * c] + b[c] * visibility;
    }
  }
  if (live_rays != nullptr) {
    const int warp_live = __reduce_add_sync(0xffffffffu, live);
    if (lane == 0 && warp_live != 0) atomicAdd(live_rays, warp_live);
  }
  __syncthreads();
  if (group == 0 && p < pixel_count) {
    float total[3] = {0.0f, 0.0f, 0.0f};
    for (int g = 0; g < groups; ++g) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        total[c] = total[c] + partial[(g * 3 + c) * 32 + lane];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      colors[3 * p + c] = (base0[3 * p + c] + out[c * n + p]) + total[c];
  }
}

}  // namespace

extern "C" int k1_anyhit(const float* origins, const float* dirs,
                         const float* t_max, int ray_count,
                         const float* nodes, const float* planes,
                         int cluster_count, int cluster_size,
                         const float* subboxes, int subbox_count, float t_min,
                         bool* occluded, unsigned long long* test_counts,
                         cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (ray_count + threads - 1) / threads;
  anyhit_kernel<<<blocks, threads, 0, stream>>>(
      origins, dirs, t_max, ray_count,
      reinterpret_cast<const float4*>(nodes), planes, cluster_count,
      cluster_size, subboxes, subbox_count, t_min, occluded, test_counts);
  return (int)cudaGetLastError();
}

extern "C" int k1_anyhit_slots(const float* out, int slots, int pixel_count,
                               int groups, int group_slots,
                               const bool* hit_pixel, const float* positions,
                               const float* cam, const float* base0,
                               const float* nodes, const float* planes,
                               int cluster_count, int cluster_size,
                               const float* subboxes, int subbox_count,
                               float t_min, float* colors, int* live_rays,
                               cudaStream_t stream) {
  if (groups < 1 || groups > kMaxSlotGroups || group_slots < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (pixel_count + 31) / 32;
  slots_anyhit_kernel<<<blocks, 32 * groups,
                        groups * 3 * 32 * sizeof(float), stream>>>(
      out, slots, pixel_count, group_slots, hit_pixel, positions, cam, base0,
      reinterpret_cast<const float4*>(nodes), planes, cluster_count,
      cluster_size, subboxes, subbox_count, t_min, colors, live_rays);
  return (int)cudaGetLastError();
}
