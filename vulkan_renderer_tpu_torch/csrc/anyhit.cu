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
// What bounds it on the H100: issuing the per-ray arithmetic, and the
// latency of dependent, divergent loads and branches; not DRAM bandwidth.
// The bench city's tables (about 11 MB of triangle planes, 1.8 MB of
// sub-boxes and a 300 KB tree) sit in the 50 MB L2 after the first rays
// touch them. A ray's triangle test is ~45 instructions once the origin
// terms are shared (~70 with them and the triangle's 9 loads; --fmad=false
// keeps each product and sum its own instruction). The tree limits a ray
// to the boxes along its path (about 2 x depth box tests per cluster it
// reaches), the sub-box gate skips most triangles of a cluster the ray
// only grazes, and the first hit ends the walk; the sample-major ray
// order makes neighbouring threads shadow neighbouring pixels toward the
// same light, which keeps a warp on the same branches of the tree. On the
// arcade frame (one cluster of 32 triangle slots, no gate, almost no ray
// occluded) every live ray tests every triangle: 8-ray packets took the
// slot entry from 16.4 to 9.7 ms, about two thirds of the issue rate, with
// 3 blocks of 8 warps an SM (PERF.md section 6).
//
// The slot entry. Where the frame's rays come from: pixel p's ray of slot
// s starts at its shading point (K6's position rows) on a hit pixel and at
// the camera on a miss, runs along K4's direction of slot s and is dead
// (t_max = -1) where the slot's weight b is zero in all three channels,
// else ends at K4's t_max: the float32 values of the sample-major ray list
// (render/trace_kernel.py shadow_megabatch), never stored. The entry then
// writes colors = (base0 + base) + sum_s b_s V_s, V = 0 where the ray is
// occluded and 1 elsewhere, multiplied and not skipped, so a non-finite b
// still reaches the resolve's pink. A block holds 32 consecutive pixels
// and one warp per slot group (groups of group_slots consecutive slots,
// render/trace_kernel.py slot_groups): neighbouring lanes shadow
// neighbouring pixels toward the same sample, the ray list's coherence,
// and a thread walks only its group's slots, so no thread runs all of a
// pixel's slots while the card idles around the last wave.
//
// Packets. A lane takes its group's slots R at a time (R a template
// parameter: 1, 2, 4 or 8; render/trace_kernel.py packet_width) as one
// packet of rays from one origin. floor_scale, which reads the origin
// only, is taken once a packet. The packet walks the tree once with an
// R-bit mask: a child is entered with the rays of the mask whose own slab
// test passes and skipped where none does, and the stack holds (ref,
// kappa, mask), so a ray enters a cluster only where its own slab tests
// of every ancestor pass, exactly as its own walk would. At a reached
// cluster each ray takes its own sub-box gate (eps, t_cap and the bound
// test as occluded_ray takes them); a triangle of a sub-box that some ray
// passes is loaded once and its origin terms (o - v0, q = (o - v0) x e1,
// e2 . q) taken once, and each ray of the packet that passed the sub-box
// and is not yet occluded runs the rest of the test (p, det, u, v, tt =
// (e2 . q) su and the compares): the same operations on the same inputs
// as its own test, so the same bits. A ray leaves the mask at its first
// hit, and the walk ends when no live ray is left unoccluded. So each ray
// tests exactly the triangles its own walk could test, stops at its own
// first hit, and its occlusion bit (which does not depend on the order of
// the walk, above) is the ray-list entry's. R = 1 runs occluded_ray
// itself. How the sum's order is fixed: each lane adds its group's terms
// b_s V_s in slot order onto 0, packet after packet, then lane p of warp 0
// adds the groups' partial sums in group order onto 0, through shared
// memory; the plain version (shadow_combine) adds in these groups in this
// order. With counters, each warp adds its live rays (t_max >= 0) and its
// packets that hold one to them with one atomic each.

#include "common.cuh"

namespace {

using vrt::Ray;
using vrt::Tri;

// The terms of the division-free Moeller-Trumbore that read the ray's
// origin and not its direction: t = o - v0, q = t x e1 and e2 . q. The
// slot entry takes them once a triangle for a packet of rays from one
// origin; each is the same operations on the same inputs as where a ray
// takes them alone.
struct OriginTerms {
  float tx, ty, tz, qx, qy, qz, e2q;
};

__device__ __forceinline__ OriginTerms origin_terms(const Tri& p, float ox,
                                                    float oy, float oz) {
  OriginTerms o;
  o.tx = ox - p.v0x;
  o.ty = oy - p.v0y;
  o.tz = oz - p.v0z;
  o.qx = o.ty * p.e1z - o.tz * p.e1y;
  o.qy = o.tz * p.e1x - o.tx * p.e1z;
  o.qz = o.tx * p.e1y - o.ty * p.e1x;
  o.e2q = p.e2x * o.qx + p.e2y * o.qy + p.e2z * o.qz;
  return o;
}

__device__ __forceinline__ bool anyhit_triangle(const Tri& p,
                                                const OriginTerms& o,
                                                const Ray& r, float t_min) {
  const float px = r.dy * p.e2z - r.dz * p.e2y;
  const float py = r.dz * p.e2x - r.dx * p.e2z;
  const float pz = r.dx * p.e2y - r.dy * p.e2x;
  const float det = p.e1x * px + p.e1y * py + p.e1z * pz;
  const float su = det >= 0.0f ? 1.0f : -1.0f;
  const float adet = det * su;
  const float u = (o.tx * px + o.ty * py + o.tz * pz) * su;
  const float v = (r.dx * o.qx + r.dy * o.qy + r.dz * o.qz) * su;
  const float tt = o.e2q * su;
  return (adet > 1e-12f) & (u >= 0.0f) & (v >= 0.0f) & (u + v <= adet) &
         (tt >= t_min * adet) & (tt <= r.t_max * adet);
}

__device__ __forceinline__ bool anyhit_triangle(const Tri& p, const Ray& r,
                                                float t_min) {
  return anyhit_triangle(p, origin_terms(p, r.ox, r.oy, r.oz), r, t_min);
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

// A packet's sub-box gate and triangles in reached cluster k: each ray of
// `mask` takes its own gate of each sub-box, as occluded_ray does; a
// triangle that some ray passes is loaded, and its origin terms taken,
// once. A ray leaves `mask` and `active` at its first hit.
template <int R>
__device__ __forceinline__ void visit_packet(const Tables& tab,
                                             const Ray (&rays)[R], int k,
                                             float kappa, float2 scale,
                                             unsigned bounded, unsigned mask,
                                             unsigned& active) {
  const float* row = tab.planes + (size_t)k * 9 * tab.cluster_size;
  const float* boxes = tab.subboxes + (size_t)k * 6 * tab.subbox_count;
  const float eps = kappa * scale.x + scale.y;
  const unsigned gated =
      (kappa <= vrt::kKappaMax) & (eps < 1e8f) ? bounded : 0u;
  const float grow = 1.0f + (26.0f + 8.0f * kappa) * vrt::kU;
  for (int g = 0; g < tab.subbox_count; ++g) {
    // Empty groups are NaN boxes and fail either test.
    const float* lo = boxes + 6 * g;
    unsigned sub = lo[0] == lo[0] ? mask & ~gated : 0u;
    if (mask & gated) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const Ray& ray = rays[r];
        const float w[3] = {eps * fabsf(ray.ix), eps * fabsf(ray.iy),
                            eps * fabsf(ray.iz)};
        if (((mask & gated) >> r & 1u) &&
            grown_slab(lo, lo + 3, ray, w, ray.t_max * grow))
          sub |= 1u << r;
      }
    }
    if (sub == 0u) continue;
    const int t_end = min((g + 1) * vrt::kSubGroup, tab.cluster_size);
    for (int t = g * vrt::kSubGroup; t < t_end; ++t) {
      const Tri tri = vrt::load_tri(row, t, tab.cluster_size);
      const OriginTerms o = origin_terms(tri, rays[0].ox, rays[0].oy,
                                         rays[0].oz);
      unsigned hits = 0u;
#pragma unroll
      for (int r = 0; r < R; ++r)
        hits |= (anyhit_triangle(tri, o, rays[r], tab.t_min) ? 1u : 0u) << r;
      hits &= sub;
      if (hits != 0u) {
        sub &= ~hits;
        mask &= ~hits;
        active &= ~hits;
        if (sub == 0u) break;
      }
    }
    if (mask == 0u) return;
  }
}

// The packet's walk: the rays of `live` (t_max >= 0), all from one origin,
// down the cluster BVH together (common.cuh walk_bvh's while-while form),
// each child entered with the rays of the mask whose own slab test passes
// and skipped when none does, the nearer child first (by the least entry
// distance of its rays); the stack holds (ref, kappa, mask) and drops the
// rays that are occluded meanwhile. Returns the occluded rays' bits.
// scale is floor_scale(nodes, ray), which reads the origin only. With R =
// 1 this is occluded_ray's walk, visit for visit.
template <int R>
__device__ __forceinline__ unsigned occluded_packet(const Tables& tab,
                                                    const Ray (&rays)[R],
                                                    unsigned live,
                                                    float2 scale) {
  unsigned bounded = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r)
    bounded |= (rays[r].t_max * 1e-18f <= scale.y ? 1u : 0u) << r;
  unsigned active = live;  // live and not yet occluded
  int stack_ref[vrt::kStack];
  float stack_kappa[vrt::kStack];
  unsigned stack_mask[vrt::kStack];
  int sp = 0;
  int ref = 0;  // the root
  float ref_kappa = INFINITY;
  unsigned mask = live;
  for (;;) {
    while (ref >= 0) {
      const float4* rec = tab.nodes + 4 * ref;
      const float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2),
                   d = __ldg(rec + 3);
      const float lo_l[3] = {a.x, a.y, a.z}, hi_l[3] = {a.w, b.x, b.y};
      const float lo_r[3] = {b.z, b.w, c.x}, hi_r[3] = {c.y, c.z, c.w};
      unsigned in_l = 0u, in_r = 0u;
      float near_l = INFINITY, near_r = INFINITY;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool on = mask >> r & 1u;
        float t_l, t_r;
        if (vrt::slab(lo_l, hi_l, rays[r], rays[r].t_max, &t_l) && on) {
          in_l |= 1u << r;
          near_l = t_l < near_l ? t_l : near_l;
        }
        if (vrt::slab(lo_r, hi_r, rays[r], rays[r].t_max, &t_r) && on) {
          in_r |= 1u << r;
          near_r = t_r < near_r ? t_r : near_r;
        }
      }
      const int ref_l = __float_as_int(d.x), ref_r = __float_as_int(d.y);
      // A child is entered where a ray of the mask passes its box. The
      // test reads the least entry distance beside the mask: on the 2-bit
      // masks of R = 2, ptxas of CUDA 12.9 (sm_90a) compiled
      // `in_l != 0u && in_r != 0u` into a wrong predicate that skipped
      // the right child where both rays entered it (its PTX was right),
      // and compiles this form as written (PERF.md section 6).
      const bool go_l = near_l != INFINITY || in_l != 0u;
      const bool go_r = near_r != INFINITY || in_r != 0u;
      if (go_l & go_r) {
        const bool right_first = near_r < near_l;
        stack_ref[sp] = right_first ? ref_l : ref_r;
        stack_kappa[sp] = right_first ? d.z : d.w;
        stack_mask[sp] = right_first ? in_l : in_r;
        ++sp;
        ref = right_first ? ref_r : ref_l;
        ref_kappa = right_first ? d.w : d.z;
        mask = right_first ? in_r : in_l;
      } else if (go_l | go_r) {
        ref = go_l ? ref_l : ref_r;
        ref_kappa = go_l ? d.z : d.w;
        mask = go_l ? in_l : in_r;
      } else {
        do {
          if (sp == 0) return live & ~active;
          --sp;
          ref = stack_ref[sp];
          ref_kappa = stack_kappa[sp];
          mask = stack_mask[sp] & active;
        } while (mask == 0u);
      }
    }
    const int k = -1 - ref;
    if (k < tab.cluster_count) {
      visit_packet<R>(tab, rays, k, ref_kappa, scale, bounded, mask, active);
      if (active == 0u) return live;
    }
    do {
      if (sp == 0) return live & ~active;
      --sp;
      ref = stack_ref[sp];
      ref_kappa = stack_kappa[sp];
      mask = stack_mask[sp] & active;
    } while (mask == 0u);
  }
}

// The most slot groups (warps) a block of the slot entry holds
// (render/trace_kernel.py SLOT_GROUPS).
constexpr int kMaxSlotGroups = 8;

// out (3 + 7 S, P): base RGB, then per slot b RGB, direction, t_max;
// positions (3, P): the shading points; hit_pixel (P,); cam (3,); base0 and
// colors (P, 3). One block per 32 pixels, blockDim.x = 32 x groups; a lane
// takes its group's slots R at a time, as one packet. The launch bounds ask
// for 3 blocks an SM where R > 1 (85 registers, a few hundred bytes
// spilled: faster on the arcade frame than 2 blocks without spills, as
// the R rays' independent tests need warps less than registers), and for
// the 2 blocks (128 registers) of the per-ray walk where R = 1 (PERF.md
// section 6).
template <int R>
__global__ void __launch_bounds__(32 * kMaxSlotGroups, R == 1 ? 2 : 3)
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
                    int* __restrict__ live_rays, int* __restrict__ packets) {
  extern __shared__ float partial[];  // (groups, 3, 32)
  const Tables tab = {nodes,    planes,       cluster_count, cluster_size,
                      subboxes, subbox_count, t_min};
  const int lane = threadIdx.x & 31, group = threadIdx.x >> 5;
  const int groups = blockDim.x >> 5;
  const int p = blockIdx.x * 32 + lane;
  const size_t n = (size_t)pixel_count;
  // A lane keeps its group's three sums in its own words of shared memory:
  // on the arcade frame that ran faster than holding them in registers
  // across the walk (PERF.md section 6).
  float* sum = partial + group * 3 * 32 + lane;
#pragma unroll
  for (int c = 0; c < 3; ++c) sum[32 * c] = 0.0f;
  int live = 0, walked = 0;
  if (p < pixel_count) {
    const bool on_surface = hit_pixel[p];
    const float ox = on_surface ? positions[p] : cam[0];
    const float oy = on_surface ? positions[n + p] : cam[1];
    const float oz = on_surface ? positions[2 * n + p] : cam[2];
    const int s_end = min(slots, (group + 1) * group_slots);
    for (int s0 = group * group_slots; s0 < s_end; s0 += R) {
      Ray rays[R];
      float b[R][3];
      unsigned alive = 0u;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        Ray& ray = rays[r];
        ray.ox = ox;
        ray.oy = oy;
        ray.oz = oz;
        ray.dx = ray.dy = ray.dz = 0.0f;
        ray.ix = ray.iy = ray.iz = 1e30f;
        ray.t_max = -1.0f;
        b[r][0] = b[r][1] = b[r][2] = 0.0f;
        if (s0 + r < s_end) {
          const float* slot = out + (3 + 7 * (size_t)(s0 + r)) * n + p;
          ray.dx = slot[3 * n];
          ray.dy = slot[4 * n];
          ray.dz = slot[5 * n];
          ray.ix = vrt::safe_inverse(ray.dx);
          ray.iy = vrt::safe_inverse(ray.dy);
          ray.iz = vrt::safe_inverse(ray.dz);
          b[r][0] = slot[0];
          b[r][1] = slot[n];
          b[r][2] = slot[2 * n];
          ray.t_max =
              (b[r][0] != 0.0f) | (b[r][1] != 0.0f) | (b[r][2] != 0.0f)
                  ? slot[6 * n]
                  : -1.0f;
        }
        alive |= (ray.t_max >= 0.0f ? 1u : 0u) << r;
      }
      unsigned occluded = 0u;
      if (alive != 0u) {
        live += __popc(alive);
        ++walked;
        const float2 scale = vrt::floor_scale(tab.nodes, rays[0]);
        if constexpr (R == 1) {
          vrt::TestCounts counts;  // counted only by the ray-list entry
          occluded = occluded_ray(tab, rays[0], scale, counts) ? 1u : 0u;
        } else {
          occluded = occluded_packet<R>(tab, rays, alive, scale);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (s0 + r < s_end) {
          const float visibility = occluded >> r & 1u ? 0.0f : 1.0f;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            sum[32 * c] = sum[32 * c] + b[r][c] * visibility;
        }
      }
    }
  }
  if (live_rays != nullptr) {
    const int warp_live = __reduce_add_sync(0xffffffffu, live);
    if (lane == 0 && warp_live != 0) atomicAdd(live_rays, warp_live);
  }
  if (packets != nullptr) {
    const int warp_packets = __reduce_add_sync(0xffffffffu, walked);
    if (lane == 0 && warp_packets != 0) atomicAdd(packets, warp_packets);
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

// packet: R, the slots a lane traces as one packet (1, 2, 4 or 8).
extern "C" int k1_anyhit_slots(const float* out, int slots, int pixel_count,
                               int groups, int group_slots, int packet,
                               const bool* hit_pixel, const float* positions,
                               const float* cam, const float* base0,
                               const float* nodes, const float* planes,
                               int cluster_count, int cluster_size,
                               const float* subboxes, int subbox_count,
                               float t_min, float* colors, int* live_rays,
                               int* packets, cudaStream_t stream) {
  if (groups < 1 || groups > kMaxSlotGroups || group_slots < 0)
    return (int)cudaErrorInvalidValue;
  const auto kernel = packet == 1   ? slots_anyhit_kernel<1>
                      : packet == 2 ? slots_anyhit_kernel<2>
                      : packet == 4 ? slots_anyhit_kernel<4>
                      : packet == 8 ? slots_anyhit_kernel<8>
                                    : nullptr;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int blocks = (pixel_count + 31) / 32;
  kernel<<<blocks, 32 * groups, groups * 3 * 32 * sizeof(float), stream>>>(
      out, slots, pixel_count, group_slots, hit_pixel, positions, cam, base0,
      reinterpret_cast<const float4*>(nodes), planes, cluster_count,
      cluster_size, subboxes, subbox_count, t_min, colors, live_rays,
      packets);
  return (int)cudaGetLastError();
}
