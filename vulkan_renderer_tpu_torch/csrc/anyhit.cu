// K1: shadow any-hit over the cluster BVH, one thread per ray.
//
// Replaces the Pallas kernel
// vulkan_renderer_tpu/render/trace_kernel.py::_anyhit_pass_one (kernel at
// :652, pallas_call at :714), which the TPU build drives over (ray chunk,
// cluster) work items from an XLA cull, with supercluster budgets and an
// exactness re-trace. Here every ray walks one binary tree over the
// clusters itself (common.cuh walk_bvh, nearer child first), then a
// cluster's 8-triangle sub-boxes, then the triangles of each sub-box that
// passes, and stops at its first hit, so the result is exact by
// construction and no cull, budget or re-trace exists. Every gate is a
// slab test against the ray's [0, t_max], so the answer -- does any
// triangle behind the passing boxes hit? -- does not depend on the order of
// the walk, and equals trace_anyhit_plain's, which gates on the cluster
// boxes and sub-boxes alone (a cluster box that passes implies every
// ancestor box passes: a parent's box contains its children's and the slab
// arithmetic rounds monotonically).
//
// Hit test: the division-free Moeller-Trumbore of trace_kernel.py:676-692,
// unchanged: no backface culling, hit iff adet > 1e-12, u, v >= 0,
// u + v <= adet and t_min * adet <= tt <= t_max * adet. t_max < 0 marks a
// dead ray (zero-weight shadow slot), which returns unoccluded at once.
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
  const Ray ray = vrt::load_ray(origins, dirs, t_max, r);
  bool hit = false;
  vrt::TestCounts counts;
  if (ray.t_max >= 0.0f) {
    auto keep = [](float) { return true; };
    auto visit = [&](int k) {
      const float* row = planes + (size_t)k * 9 * cluster_size;
      const float* boxes = subboxes + (size_t)k * 6 * subbox_count;
      for (int g = 0; g < subbox_count; ++g) {
        // Empty groups are NaN boxes and fail here.
        float t_sub;
        VR_COUNT(counts, subboxes, 1);
        if (!vrt::slab(boxes + 6 * g, boxes + 6 * g + 3, ray, ray.t_max,
                       &t_sub))
          continue;
        const int t_end = min((g + 1) * vrt::kSubGroup, cluster_size);
        for (int t = g * vrt::kSubGroup; t < t_end; ++t) {
          VR_COUNT(counts, triangles, 1);
          if (anyhit_triangle(vrt::load_tri(row, t, cluster_size), ray,
                              t_min)) {
            hit = true;
            return true;
          }
        }
      }
      return false;
    };
    vrt::walk_bvh(nodes, ray, cluster_count, keep, visit, counts);
  }
  occluded[r] = hit;
  vrt::flush_counts(counts, test_counts);
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
