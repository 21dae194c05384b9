// FROZEN: the port's first per-ray traversal, kept unchanged for
// measurement only. It is the loop that traverse_core.cuh replaced: child
// order by an insertion sort over local arrays, a 64-entry stack in local
// memory and no prefetch. traverse_tiles.cu and traverse_rays.cu instantiate
// it beside the redesigned core behind their launchers' `core` argument
// (rt::kBaseline = 256 selects it), so
// that one process can time the two against each other and check that they
// write the same words; the wrappers expose it as core="baseline", which
// only chip_smoke.py and the card tests pass. No render path runs it: any
// hit over leaves of more than one triangle, where every per-lane form of
// the redesigned core lost to it on the card, now runs rt::kAnyHitCore (the
// leaf tests spread over the warp), which beat it at 4 and 8 slots, in both
// orders, at K = 8 and 32 (ops/cuda/traverse.py::launch_plan). Do not edit
// the loop: a change here is no longer the baseline. Its slab tests and its
// Möller–Trumbore test have twins in traverse_core.cuh (Ray::slabs;
// Ray::leaves and mt_hit) that must stay in step with it. The
// one addition is the kOrdered = false form of that any hit
// (trace_rays(ordered=False)): the same loop with the children pushed in
// slot order; kOrdered = true compiles to the frozen loop. It reads the
// records from device memory only (tree_space "hbm" or "vmem").
//
// The per-ray traversal of the supernode records, shared by the primary-ray
// kernels K1a/K1b/K1c/K1d/K1e/K1f (traverse_tiles.cu) and the ray-buffer kernels
// K2a/K2b/K2c (traverse_rays.cu), so the visit order, the culling and the
// stack-drop rule exist once, for records of 4 and of 8 child slots.
//
// It is the per-ray form of raytracer_tpu/ops/pallas/traverse.py::_consume
// (width = 4 or 8) on records with K triangles per leaf (record layout:
// raytracer_tpu_torch/ops/cuda/traverse.py). Every visit is a dependent fetch
// of one record header (8 f32 words per child slot: 128 bytes at 4 slots,
// 256 at 8) through L1 and L2, plus the 12-word triangle records of the leaf
// slots whose slab test passes: that latency, not arithmetic, is what bounds
// a traversal on the card. An 8-wide tree visits fewer records and reads
// twice the header at each; which of the two weighs more is measured, not
// assumed (chip_smoke.py prints both trees side by side).
//
// Exactness: every expression is evaluated in the operation order of the
// plain torch version (ops/cuda/traverse.py::_traverse) and of the TPU
// kernel, built with -fmad=false and IEEE division and square root
// (1.0f / sqrtf, not rsqrtf), so a kernel and its plain version differ only
// where two triangles tie.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt_baseline {

constexpr int kStackMax = 64;           // pushes beyond this are dropped
constexpr float kInf = 1e30f;
constexpr float kMtEps = 1e-7f;
constexpr float kEmptyRef = -268435456.0f;  // -2^28: empty child slot

// A ray's result: zero normal and tri = -1 on a miss, with t = the best t the
// traversal started from (1e30 unless the caller gave a depth bound). Any-hit
// traversal reports t = 0 and the occluder's normal and id. `visits` is
// counted only by a kVisits traversal (0 otherwise).
struct Hit {
  float t, nx, ny, nz;
  int tri;
  int visits;
};

__device__ __forceinline__ float safe_inv(float d) {
  return fabsf(d) > 1e-8f ? 1.0f / d : kInf;
}

// Traverse the records `qn` (rows of `recw` f32 words, kSlots child slots,
// K = leaf_k triangles per leaf) with the ray (o, d). Closest hit: the
// nearest accepted triangle (strict t < best, first in visit order among
// equal t). kAnyHit: stop at the first accepted triangle in visit order.
// kVisits: count the records visited (pops that pass the cull).
// !kOrdered: push the passing children in slot order, with no sort.
//
// `best_init` and `entry` are where the traversal starts: 1e30 and the root
// (record 0) everywhere but in K1d. A finite `best_init` is a depth bound:
// only hits with t < best_init are kept, and every slab and pop cull runs
// against it from the first visit on, so a hit that is found is still the
// nearest one (every node entered below the running best is visited); a ray
// that finds none returns t = best_init. `entry` is pushed with key 0, so it
// is visited whenever best_init > 0; the caller guarantees that no record
// outside its subtree can hold the ray's nearest hit.
template <int kSlots, bool kAnyHit, bool kVisits, bool kOrdered = true>
__device__ __forceinline__ Hit traverse_ray(const float* __restrict__ qn, int recw,
                                            int leaf_k, float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float best_init = kInf, int entry = 0) {
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const int vbase = 8 * kSlots;
  const int ibase = vbase + kSlots * 12 * leaf_k;

  Hit r{kInf, 0.0f, 0.0f, 0.0f, -1, 0};
  float best = best_init;
  int stack_n[kStackMax];
  float stack_d[kStackMax];
  int sp = 0;
  stack_n[0] = entry;
  stack_d[0] = 0.0f;

  while (sp >= 0) {
    const int node = stack_n[sp];
    const float key = stack_d[sp];
    --sp;
    if (!(key < best)) continue;
    if (kVisits) ++r.visits;

    const float* rec = qn + (size_t)node * (size_t)recw;
    // [0:6w] child boxes, [6w:7w] refs, [7w:8w] counts/radii, w = kSlots
    float h[8 * kSlots];
    const float4* hdr = reinterpret_cast<const float4*>(rec);
#pragma unroll
    for (int i = 0; i < 2 * kSlots; ++i) {
      const float4 q = __ldg(hdr + i);
      h[4 * i] = q.x;
      h[4 * i + 1] = q.y;
      h[4 * i + 2] = q.z;
      h[4 * i + 3] = q.w;
    }

    // slab tests of all slots against the best t at the start of the visit
    const float best0 = best;
    float tmin[kSlots];
    bool hit[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const float t1x = (h[6 * k + 0] - ox) * ix, t2x = (h[6 * k + 3] - ox) * ix;
      const float t1y = (h[6 * k + 1] - oy) * iy, t2y = (h[6 * k + 4] - oy) * iy;
      const float t1z = (h[6 * k + 2] - oz) * iz, t2z = (h[6 * k + 5] - oz) * iz;
      const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
      const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
      hit[k] = (tf >= fmaxf(tn, 0.0f)) && (tn < best0);
      tmin[k] = tn;
    }

    // leaf slots: Möller–Trumbore over the inlined [v0, e1, e2, g] records,
    // in slot then triangle order, strict t < best
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const float ref = h[6 * kSlots + k];
      if (!(hit[k] && ref < 0.0f && ref > kEmptyRef)) continue;
      const float cnt = h[7 * kSlots + k];
      const float4* tv = reinterpret_cast<const float4*>(rec + vbase + k * leaf_k * 12);
      for (int j = 0; j < leaf_k && (float)j < cnt; ++j) {
        const float4 a = __ldg(tv + 3 * j);      // v0x v0y v0z e1x
        const float4 b = __ldg(tv + 3 * j + 1);  // e1y e1z e2x e2y
        const float4 c = __ldg(tv + 3 * j + 2);  // e2z gx  gy  gz
        const float e1x = a.w, e1y = b.x, e1z = b.y;
        const float e2x = b.z, e2y = b.w, e2z = c.x;
        const float pxv = dy * e2z - dz * e2y;
        const float pyv = dz * e2x - dx * e2z;
        const float pzv = dx * e2y - dy * e2x;
        const float det = e1x * pxv + e1y * pyv + e1z * pzv;
        const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
        const float sx = ox - a.x, sy = oy - a.y, sz = oz - a.z;
        const float uu = inv_det * (sx * pxv + sy * pyv + sz * pzv);
        const float qcx = sy * e1z - sz * e1y;
        const float qcy = sz * e1x - sx * e1z;
        const float qcz = sx * e1y - sy * e1x;
        const float vv = inv_det * (dx * qcx + dy * qcy + dz * qcz);
        const float tt = inv_det * (e2x * qcx + e2y * qcy + e2z * qcz);
        if (fabsf(det) >= kMtEps && uu >= 0.0f && uu <= 1.0f && vv >= 0.0f &&
            uu + vv <= 1.0f && tt > kMtEps && tt < best) {
          const float g_inv = 1.0f / sqrtf(c.y * c.y + c.z * c.z + c.w * c.w);
          best = tt;
          r.nx = c.y * g_inv;
          r.ny = c.z * g_inv;
          r.nz = c.w * g_inv;
          r.tri = (int)__ldg(rec + ibase + k * leaf_k + j);
          if (kAnyHit) {
            r.t = 0.0f;
            return r;
          }
        }
      }
    }

    if (!kOrdered) {  // slot order, the later slots dropped at the limit
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (hit[k] && h[6 * kSlots + k] >= 0.0f && sp < kStackMax - 1) {
          ++sp;
          stack_n[sp] = (int)h[6 * kSlots + k];
          stack_d[sp] = tmin[k];
        }
      }
      continue;
    }

    // internal slots that passed: push far→near by the slab entry distance
    // (a stable descending insertion sort over up to kSlots candidates, so
    // equal keys keep slot order; the TPU kernel's sorting network orders
    // by the tile-centre ray instead)
    int cand[kSlots];
    float ckey[kSlots];
    int nc = 0;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (hit[k] && h[6 * kSlots + k] >= 0.0f) {
        const int cn = (int)h[6 * kSlots + k];
        const float ck = tmin[k];
        int i = nc - 1;
        while (i >= 0 && ckey[i] < ck) {
          cand[i + 1] = cand[i];
          ckey[i + 1] = ckey[i];
          --i;
        }
        cand[i + 1] = cn;
        ckey[i + 1] = ck;
        ++nc;
      }
    }
    for (int i = 0; i < nc; ++i) {
      if (sp < kStackMax - 1) {
        ++sp;
        stack_n[sp] = cand[i];
        stack_d[sp] = ckey[i];
      }
    }
  }
  r.t = best;
  return r;
}

}  // namespace rt_baseline
