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
// slots whose slab test passes.
//
// What was thought to hold the loop back (the microbenchmarks of
// csrc/microbench.cu: one warp, clock64() cycles on an H100; PERF.md §6):
//  * the child order. The port's first loop sorted the passing children by
//    insertion into `int cand[w]; float ckey[w]` with a data-dependent
//    `while`; the dynamic indexing puts both arrays in local memory. MB3
//    prices that sort alone at 987 cycles against 1,609 for a whole 4-slot
//    visit, and at 3,403 against 2,399 at 8 slots.
//  * the stack. 64 entries of (node, key) in local memory, 512 bytes a thread
//    (ptxas: a 544-byte frame at 4 slots); MB3 prices the pushes and pops of
//    one visit at 669 cycles.
//  * the record fetch. A pop is followed by a dependent load of its header,
//    though the node is known when it is pushed. MB1 prices one warp's
//    dependent 512-byte fetch at 82 cycles from L1, 348 from L2 and 803
//    from device memory; the same walk with the next row's copy in flight
//    (cp.async) costs 456, 0.57× of the dependent one.
// Those are one warp's latencies. With 30-odd warps resident on an SM the
// latencies overlap, and the full kernels are bound by the instructions the
// warps issue and by how many warps fit: an element pays where it removes
// instructions or local-memory operations, and loses where it adds them or
// takes L1 from the records (PERF.md §6).
//
// The design elements, a feature bit each. A core is a mask of them, and the
// launch plans of ops/cuda/traverse.py (launch_plan for K2, tile_plan for
// K1) name every mask the launchers build: kRenderCore at K = 1,
// kAnyHitCore (any hit and closest hit) in K2 over leaves of K > 1, and
// kTileCore in K1 there; each with kUnordered and kSharedTree where K2 takes
// them. The port's first loop, a stack in shared memory and a prefetch of
// the next record were built and timed against these and retired (PERF.md
// §6).
//  * kOrder — child order in registers, in every core. Each passing
//    child k (slab hit, so its key is not NaN, and ref >= 0) goes to its
//    rank in the stable far-to-near order, pos(k) = #{j passing : key_j >
//    key_k} + #{j < k passing : key_j == key_k}, counted over all pairs of
//    slots in a fully unrolled loop (skipped when one child passes), and is
//    written at stack index sp + 1 + pos(k). That is where an insertion
//    sort's pushes land, and a push is dropped exactly when its index would
//    pass 63, as there. No array indexed at run time is left in a visit but
//    the stack, so the sort's local-memory loads and stores are gone; K = 1
//    frames and the K2a waves gain most.
//  * kUnordered — no near-first order (trace_rays(ordered=False)): the
//    passing children are pushed in slot order, each with its slab entry
//    distance (Ray::push).
//  * kSharedTree — not an element of the loop but a placement of the
//    records (trace_rays(tree_space="smem"), the TPU kernel's records in
//    scalar memory): the block copies the whole record array into its
//    dynamic shared memory when it starts (stage_tree) and every record
//    word is then a shared-memory load, where the other cores read the
//    records with __ldg (ld.global.nc, through L1 and L2). The loads go
//    through ld_rec / ld_rec4, which are __ldg without the bit, so a core
//    without it compiles to what it was.
//  * kWarpLeaves — any hit over leaves of K > 1: the leaf tests spread over
//    the warp (Ray::warp_step, warp_leaves). With one lane a ray, a lane
//    tests a whole leaf slot alone, K Möller–Trumbore tests one after
//    another, each three 16-byte loads at a 48-byte stride in its own
//    record, so a warp-wide load touches up to 32 lines and the warp waits
//    for its longest leaf. Here every lane of the warp calls warp_step
//    together: each lane pops and visits its own record (slab tests, the
//    internal children pushed in its core's order) and posts the leaf slots
//    that pass; then the warp serves the posted records one lane after
//    another, the ray broadcast with __shfl_sync, lane j testing triangle j
//    (one K = 32 slot is 12 contiguous 128-byte lines, read by three
//    coalesced loads), and __ballot_sync gives the lowest accepted position:
//    the triangle the sequential loop (Ray::leaves) stops at, so every mask
//    writes that loop's words. Slots of more than 32 triangles are served in
//    runs of 32, in order, up to the first run with a hit. A lane with no
//    ray left only helps test, so the kernels keep every lane of a warp in
//    the loop (traverse_ray_warp; the persistent warps refill as before).
//    Closest hit (warp_nearest) cannot stop at a hit: it serves every run
//    of every posted slot, each against the served ray's running best t,
//    and keeps a run's nearest accepted triangle, lowest position among
//    equal t (__reduce_min_sync over the t bits, then a ballot): the
//    sequential loop's strict t < best, in slot then triangle order.
//  * kPackSlots — with kWarpLeaves: a visit's posted slots as one run of
//    positions k·K + j end to end (their triangles are contiguous in the
//    record), so at K = 8 a 4-slot visit is one run of 32 lanes where one
//    slot at a time fills 8. It pays below K = 32 only, so the launch plans
//    drop it from K = 32 on.
//  * kTileLeaves — with kWarpLeaves, closest hit (the primary rays of K1):
//    a per-step, warp-uniform choice between the warp's leaf tests and each
//    lane's own loop (Ray::tile_step). A warp of K1 is an 8×4 patch of
//    neighbouring pixels whose lanes often post the same leaf at the same
//    step. The lane loop then costs the warp m = Σ over slots k of the max
//    over lanes of slot k's triangle count (the lanes of slot k's loop run
//    in step; when they read the same leaf, each load is one broadcast),
//    while the warp's leaf tests cost w runs of 32, one per posted slot and
//    posting lane (per served lane 9 shuffles, per run a __reduce_min_sync
//    and a ballot): 32 runs where all 32 lanes post one leaf of 32, against
//    32 iterations. Where few lanes post, w is small and m is still a whole
//    leaf. So the warp prices both from its lanes' posted counts and takes
//    the warp's tests where c·w < m (c: the cost of a run in loop
//    iterations, kTileLeafCost, measured on the card; PERF.md §6) and the
//    lanes' own loops otherwise. Both keep the sequential loop's triangle
//    and t, so the choice changes no output bit.
// Two things of the form matter as much: the stack's storage is a variable
// of its own beside the ray's state (in one struct with the dynamically
// indexed array, the ray's scalars live in local memory too), and an any-hit
// traversal leaves its loop before it reads its occluder's normal, so that
// neither that nor the best t is carried around the loop.
//
// Tensor cores and TMA do not apply. The slab and Möller–Trumbore tests are
// per-ray f32 scalar work on data-dependent operands, with no matrix
// product; TMA moves tensor boxes whose addresses are known ahead of time,
// where a traversal learns its next record only at a pop. What Hopper
// offers this loop is its large shared memory, prefetch and asynchronous
// copies, and the block scheduler (traverse_rays.cu's persistent warps).
//
// Exactness: every expression is evaluated in the operation order of the
// plain torch version (ops/cuda/traverse.py::_traverse) and of the TPU
// kernel, built with -fmad=false and IEEE division and square root
// (1.0f / sqrtf, not rsqrtf), so a kernel and its plain version differ only
// where two triangles tie; and every core visits the same records in the
// same order as its plain version and writes the same words.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int kStackMax = 64;           // pushes beyond this are dropped
constexpr float kInf = 1e30f;
constexpr float kMtEps = 1e-7f;
constexpr float kEmptyRef = -268435456.0f;  // -2^28: empty child slot

// The design elements, as bits of a core's feature mask. The bits keep their
// values, so a kernel's template arguments name the same core in every
// profile.
enum : unsigned {
  kOrder = 1u,        // child order by rank in registers
  kUnordered = 8u,    // no near-first order: children pushed in slot order
  kSharedTree = 16u,  // the records in the block's dynamic shared memory
  kWarpLeaves = 32u,  // the warp tests one ray's leaf slots at a time, a triangle a lane
  kPackSlots = 64u,   // with kWarpLeaves: a visit's leaf slots as one run of triangles
  kTileLeaves = 128u,  // with kWarpLeaves: each step picks the warp's or the lanes' leaf tests
};

// The core of the render paths at K = 1 (PERF.md §6).
constexpr unsigned kRenderCore = kOrder;

// The core of K2 over leaves of more than one triangle, where the wrapper's
// launch plan picks it (ops/cuda/traverse.py::launch_plan; any hit, and
// closest hit in its kAnyHit = false form): the render core's order between
// leaves, the leaf tests spread over the warp, the slots packed below
// K = 32 (the plan drops kPackSlots from there).
constexpr unsigned kAnyHitCore = kOrder | kWarpLeaves | kPackSlots;

// The core of K1 over leaves of more than one triangle, where the wrapper's
// tile plan picks it (ops/cuda/traverse.py::tile_plan): kAnyHitCore's
// closest hit with the per-step choice of leaf stage (the plan drops
// kPackSlots from K = 32 on, as for kAnyHitCore).
constexpr unsigned kTileCore = kAnyHitCore | kTileLeaves;

// c of kTileLeaves' rule c·w < m: what one run of the warp's leaf tests
// costs in iterations of a lane's loop, measured on the card (a sweep of
// c = 0, 1, 1.25, 1.5, 2, 3 on K1a; PERF.md §6).
constexpr float kTileLeafCost = 1.5f;

constexpr unsigned kWarpMask = 0xffffffffu;

// The records of a kSharedTree block: the whole (M, recw) array, copied in
// by stage_tree.
extern __shared__ float4 tree_smem[];

// A record word / four record words: __ldg from global memory, or a plain
// load from the block's shared copy under kSharedTree (ld.global.nc on a
// shared-memory address is undefined).
template <unsigned kFeat>
__device__ __forceinline__ float4 ld_rec4(const float4* p) {
  if constexpr ((kFeat & kSharedTree) != 0) {
    return *p;
  } else {
    return __ldg(p);
  }
}

template <unsigned kFeat>
__device__ __forceinline__ float ld_rec(const float* p) {
  if constexpr ((kFeat & kSharedTree) != 0) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// The records a block traverses: `qn` itself, or under kSharedTree the
// block's shared copy of its first `tree_f4` float4s (the whole array),
// made by all threads of the block with 16-byte loads before any of them
// traverses. Call from every thread of the block, before any thread leaves.
template <unsigned kFeat>
__device__ __forceinline__ const float* stage_tree(const float* __restrict__ qn, int tree_f4) {
  if constexpr ((kFeat & kSharedTree) != 0) {
    const float4* src = reinterpret_cast<const float4*>(qn);
    for (int i = threadIdx.x; i < tree_f4; i += blockDim.x) tree_smem[i] = __ldg(src + i);
    __syncthreads();
    return reinterpret_cast<const float*>(tree_smem);
  } else {
    return qn;
  }
}

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

// Möller–Trumbore of the ray (o, d) against one inlined triangle record
// [v0, e1, e2, g] (a, b, c: its three float4s): whether it is accepted, at
// a distance tt with kMtEps < tt < best. The test of the warp's leaf tests.
// Ray::leaves keeps its own copy, in the same operation order, and the two
// must stay in step: with Ray::leaves
// calling this function, 85 of the 151 kernels that do not run the warp's
// leaf tests compiled to other instructions and K1a's framed frame took
// 1.014-1.025x the time on the card (PERF.md §6).
__device__ __forceinline__ bool mt_hit(const float4 a, const float4 b, const float4 c, float ox,
                                       float oy, float oz, float dx, float dy, float dz,
                                       float best, float& tt) {
  const float e1x = a.w, e1y = b.x, e1z = b.y;  // a: v0x v0y v0z e1x
  const float e2x = b.z, e2y = b.w, e2z = c.x;  // b: e1y e1z e2x e2y; c: e2z gx gy gz
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
  tt = inv_det * (e2x * qcx + e2y * qcy + e2z * qcz);
  return fabsf(det) >= kMtEps && uu >= 0.0f && uu <= 1.0f && vv >= 0.0f && uu + vv <= 1.0f &&
         tt > kMtEps && tt < best;
}

// The leaf tests of one ray against the leaf slots `posted` (bit k: slot k)
// of record `rec`, by the whole warp: every lane calls it with the same
// arguments, and each lane tests one triangle position p = k·K + j (slot k,
// triangle j < K, j < the slot's count) of a run of 32 at a time, the runs
// in position order; a ballot gives the lowest accepted position of the
// first run that has one. That is the triangle the sequential loop of
// Ray::leaves stops at (slot then triangle order), so every lane returns
// it, or -1. Each posted slot is its own runs of up to 32 triangles; with
// kPackSlots the runs go over the posted slots' positions end to end
// instead (at K = 8 a 4-slot visit is one run). Both are right at any K;
// the plans take kPackSlots below K = 32 only.
template <int kSlots, unsigned kFeat>
__device__ __forceinline__ int warp_leaves(const float* __restrict__ rec, unsigned posted,
                                           int leaf_k, float ox, float oy, float oz, float dx,
                                           float dy, float dz, float best) {
  const int lane = (int)(threadIdx.x & 31u);
  const float4* tv = reinterpret_cast<const float4*>(rec + 8 * kSlots);
  const float* cnt = rec + 7 * kSlots;
  float tt;
  if constexpr ((kFeat & kPackSlots) != 0) {
    const int end = (32 - __clz(posted)) * leaf_k;  // past the last posted slot
    for (int run = (__ffs(posted) - 1) * leaf_k; run < end; run += 32) {
      const int p = run + lane;
      int k = 0;  // p's slot: p / K with kSlots - 1 compares
#pragma unroll
      for (int s = 1; s < kSlots; ++s) k += p >= s * leaf_k ? 1 : 0;
      const bool ok = p < end && ((posted >> k) & 1u) != 0u &&
                      (float)(p - k * leaf_k) < ld_rec<kFeat>(cnt + k) &&
                      mt_hit(ld_rec4<kFeat>(tv + 3 * p), ld_rec4<kFeat>(tv + 3 * p + 1),
                             ld_rec4<kFeat>(tv + 3 * p + 2), ox, oy, oz, dx, dy, dz, best, tt);
      const unsigned hits = __ballot_sync(kWarpMask, ok);
      if (hits != 0u) return run + __ffs(hits) - 1;
    }
    return -1;
  }
  // unrolled over the slots: a loop over the posted bits spilled less in
  // the 8-slot kernels but took 1.06-1.08x the time of the 4-slot waves on
  // the card (PERF.md §6)
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (((posted >> k) & 1u) == 0u) continue;
    const float n = ld_rec<kFeat>(cnt + k);
    for (int run = 0; run < leaf_k && (float)run < n; run += 32) {
      const int j = run + lane, p = k * leaf_k + j;
      const bool ok = j < leaf_k && (float)j < n &&
                      mt_hit(ld_rec4<kFeat>(tv + 3 * p), ld_rec4<kFeat>(tv + 3 * p + 1),
                             ld_rec4<kFeat>(tv + 3 * p + 2), ox, oy, oz, dx, dy, dz, best, tt);
      const unsigned hits = __ballot_sync(kWarpMask, ok);
      if (hits != 0u) return k * leaf_k + run + __ffs(hits) - 1;
    }
  }
  return -1;
}

// A run's nearest for warp_nearest: each lane's candidate (ok: accepted, at
// tt < best) → the least t over the warp (accepted t lie in (kMtEps, best),
// positive and finite, so their bits order as unsigned), at the lowest lane
// among equal t. Where a lane accepted one, best becomes that t and `at`
// its position run + lane; else both stay. Warp-uniform in and out.
__device__ __forceinline__ void keep_nearest(bool ok, float tt, int run, float& best, int& at) {
  const unsigned m = __reduce_min_sync(kWarpMask, ok ? __float_as_uint(tt) : 0xffffffffu);
  if (m != 0xffffffffu) {
    best = __uint_as_float(m);
    at = run + __ffs(__ballot_sync(kWarpMask, ok && __float_as_uint(tt) == m)) - 1;
  }
}

// The closest-hit leaf tests of one ray against the leaf slots `posted` of
// record `rec`, by the whole warp (every lane calls it with the same
// arguments): the runs of 32 triangle positions of warp_leaves, every one
// of them tested (no early exit), each against the running `best`, which
// it lowers to each accepted run's nearest t. Returns the position k·K + j
// of the nearest accepted triangle, first in position order among equal t
// (-1: none below the best t it was given). That is the triangle and t that
// the sequential loop of Ray::leaves keeps: the nearest t below the start
// value, its first position among ties, since a later run keeps its nearest
// only where it lies strictly below the running best.
template <int kSlots, unsigned kFeat>
__device__ __forceinline__ int warp_nearest(const float* __restrict__ rec, unsigned posted,
                                            int leaf_k, float ox, float oy, float oz, float dx,
                                            float dy, float dz, float& best) {
  const int lane = (int)(threadIdx.x & 31u);
  const float4* tv = reinterpret_cast<const float4*>(rec + 8 * kSlots);
  const float* cnt = rec + 7 * kSlots;
  int at = -1;
  float tt = 0.0f;
  if constexpr ((kFeat & kPackSlots) != 0) {
    const int end = (32 - __clz(posted)) * leaf_k;  // past the last posted slot
    for (int run = (__ffs(posted) - 1) * leaf_k; run < end; run += 32) {
      const int p = run + lane;
      int k = 0;  // p's slot: p / K with kSlots - 1 compares
#pragma unroll
      for (int s = 1; s < kSlots; ++s) k += p >= s * leaf_k ? 1 : 0;
      const bool ok = p < end && ((posted >> k) & 1u) != 0u &&
                      (float)(p - k * leaf_k) < ld_rec<kFeat>(cnt + k) &&
                      mt_hit(ld_rec4<kFeat>(tv + 3 * p), ld_rec4<kFeat>(tv + 3 * p + 1),
                             ld_rec4<kFeat>(tv + 3 * p + 2), ox, oy, oz, dx, dy, dz, best, tt);
      keep_nearest(ok, tt, run, best, at);
    }
    return at;
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (((posted >> k) & 1u) == 0u) continue;
    const float n = ld_rec<kFeat>(cnt + k);
    for (int run = 0; run < leaf_k && (float)run < n; run += 32) {
      const int j = run + lane, p = k * leaf_k + j;
      const bool ok = j < leaf_k && (float)j < n &&
                      mt_hit(ld_rec4<kFeat>(tv + 3 * p), ld_rec4<kFeat>(tv + 3 * p + 1),
                             ld_rec4<kFeat>(tv + 3 * p + 2), ox, oy, oz, dx, dy, dz, best, tt);
      keep_nearest(ok, tt, k * leaf_k + run, best, at);
    }
  }
  return at;
}

// One thread's stack of (node, key bits) entries, in local memory: a
// variable of its own beside the ray's state (in one struct with the
// dynamically indexed array, the ray's scalars would live in local memory
// too).
struct Stack {
  int node[kStackMax];  // two 4-byte planes
  int key[kStackMax];
  __device__ __forceinline__ int2 get(int i) const { return make_int2(node[i], key[i]); }
  __device__ __forceinline__ void put(int i, int2 v) {
    node[i] = v.x;
    key[i] = v.y;
  }
};

// The traversal of one ray by records `qn` (rows of `recw` f32 words,
// kSlots child slots, K = leaf_k triangles per leaf), one stack pop per
// step(), so that a persistent warp can hand an idle lane a new ray between
// two steps (traverse_rays.cu). Closest hit: the nearest accepted triangle
// (strict t < best, first in visit order among equal t). kAnyHit: stop at
// the first accepted triangle in visit order. kVisits: count the records
// visited (pops that pass the cull).
//
// `best_init` and `entry` are where the traversal starts: 1e30 and the root
// (record 0) everywhere but in K1d. A finite `best_init` is a depth bound:
// only hits with t < best_init are kept, and every slab and pop cull runs
// against it from the first visit on, so a hit that is found is still the
// nearest one (every node entered below the running best is visited); a ray
// that finds none returns t = best_init. `entry` is pushed with key 0, so it
// is visited whenever best_init > 0; the caller guarantees that no record
// outside its subtree can hold the ray's nearest hit.
template <int kSlots, bool kAnyHit, bool kVisits, unsigned kFeat>
struct Ray {
  static_assert((kFeat & kOrder) != 0, "every core ranks its children in registers");
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  float best;
  Hit r;
  int sp;  // the top of the stack (-1: empty)

  __device__ __forceinline__ void start(Stack& stack, float ox_, float oy_, float oz_,
                                        float dx_, float dy_, float dz_, float best_init,
                                        int entry) {
    ox = ox_;
    oy = oy_;
    oz = oz_;
    dx = dx_;
    dy = dy_;
    dz = dz_;
    ix = safe_inv(dx);
    iy = safe_inv(dy);
    iz = safe_inv(dz);
    r = Hit{kInf, 0.0f, 0.0f, 0.0f, -1, 0};
    best = best_init;
    sp = 0;
    stack.put(0, make_int2(entry, __float_as_int(0.0f)));
  }

  // Whether an entry is left to pop.
  __device__ __forceinline__ bool pending() const { return sp >= 0; }

  __device__ __forceinline__ Hit result() const {
    Hit out = r;
    out.t = (kAnyHit && r.tri >= 0) ? 0.0f : best;  // an occluded any-hit ray reports 0
    return out;
  }

  // Push the children that passed (hit[k] and ref >= 0) far→near by their
  // slab entry distance, equal keys in slot order; pushes past index 63 are
  // dropped. kUnordered: in slot order instead (the last passing slot is
  // popped first), each with its slab entry distance, which the pop-time
  // cull reads; pushes past index 63 are dropped, the later slots first.
  __device__ __forceinline__ void push(Stack& stack, const float* h, const float* tmin,
                                       const bool* hit) {
    if (kFeat & kUnordered) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (hit[k] && h[6 * kSlots + k] >= 0.0f && sp < kStackMax - 1) {
          ++sp;
          stack.put(sp, make_int2((int)h[6 * kSlots + k], __float_as_int(tmin[k])));
        }
      }
    } else {
      bool pass[kSlots];
      int pos[kSlots];
      int npass = 0;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        pass[k] = hit[k] && h[6 * kSlots + k] >= 0.0f;
        pos[k] = 0;
        npass += pass[k] ? 1 : 0;
      }
      // pos(k) = #{j : key_j > key_k} + #{j < k : key_j == key_k} over
      // passing j; passing keys are never NaN, so for j < k "key_j >= key_k"
      // decides both directions of the pair. One child needs no rank.
      if (npass > 1) {
#pragma unroll
        for (int k = 1; k < kSlots; ++k) {
#pragma unroll
          for (int j = 0; j < k; ++j) {
            const bool ge = tmin[j] >= tmin[k];
            pos[k] += (pass[j] && ge) ? 1 : 0;
            pos[j] += (pass[k] && !ge) ? 1 : 0;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int at = sp + 1 + pos[k];
        if (pass[k] && at < kStackMax) {
          stack.put(at, make_int2((int)h[6 * kSlots + k], __float_as_int(tmin[k])));
        }
      }
      sp = min(sp + npass, kStackMax - 1);
    }
  }

  // Möller–Trumbore over the inlined [v0, e1, e2, g] records of the leaf
  // slots that passed, in slot then triangle order, strict t < best (the
  // test's expression has a twin that must stay in step with it, mt_hit;
  // see mt_hit for why it is not called here). Closest
  // hit keeps the nearest in best and r and returns -1; any hit
  // returns the position k·K + j of the first accepted triangle (or -1) and
  // writes nothing: the caller leaves the loop and takes the triangle's
  // normal and id there (occluder), so that neither they nor best are
  // carried around the loop (best then stays the start value, which the
  // compiler can hold as a constant: 1e30 in K2b).
  __device__ __forceinline__ int leaves(const float* __restrict__ rec, int leaf_k,
                                        const float* h, const bool* hit) {
    const int vbase = 8 * kSlots;
    const int ibase = vbase + kSlots * 12 * leaf_k;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const float ref = h[6 * kSlots + k];
      if (!(hit[k] && ref < 0.0f && ref > kEmptyRef)) continue;
      const float cnt = h[7 * kSlots + k];
      const float4* tv = reinterpret_cast<const float4*>(rec + vbase + k * leaf_k * 12);
      for (int j = 0; j < leaf_k && (float)j < cnt; ++j) {
        const float4 a = ld_rec4<kFeat>(tv + 3 * j);      // v0x v0y v0z e1x
        const float4 b = ld_rec4<kFeat>(tv + 3 * j + 1);  // e1y e1z e2x e2y
        const float4 c = ld_rec4<kFeat>(tv + 3 * j + 2);  // e2z gx  gy  gz
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
          if (kAnyHit) return k * leaf_k + j;
          const float g_inv = 1.0f / sqrtf(c.y * c.y + c.z * c.z + c.w * c.w);
          best = tt;
          r.nx = c.y * g_inv;
          r.ny = c.z * g_inv;
          r.nz = c.w * g_inv;
          r.tri = (int)ld_rec<kFeat>(rec + ibase + k * leaf_k + j);
        }
      }
    }
    return -1;
  }

  // The triangle at position `at` of record `rec` into r: its normal from g,
  // in leaves()' expression, and its id (an any-hit occluder, or a closest
  // hit's new nearest from the warp's leaf tests).
  __device__ __forceinline__ void occluder(const float* __restrict__ rec, int leaf_k, int at) {
    const float4 c =
        ld_rec4<kFeat>(reinterpret_cast<const float4*>(rec + 8 * kSlots) + 3 * at + 2);
    const float g_inv = 1.0f / sqrtf(c.y * c.y + c.z * c.z + c.w * c.w);
    r.nx = c.y * g_inv;
    r.ny = c.z * g_inv;
    r.nz = c.w * g_inv;
    r.tri = (int)ld_rec<kFeat>(rec + 8 * kSlots + kSlots * 12 * leaf_k + at);
  }

  // Take the top entry of the stack.
  __device__ __forceinline__ int2 pop(const Stack& stack) { return stack.get(sp--); }

  // The header of record `rec` into h ([0:6w] child boxes, [6w:7w] refs,
  // [7w:8w] counts/radii, w = kSlots), and the slab tests of all its slots
  // against the best t at the start of the visit: hit[k], and tmin[k] the
  // slab entry distance, for visit() and warp_step.
  __device__ __forceinline__ void slabs(const float* __restrict__ rec, float* h, float* tmin,
                                        bool* hit) const {
    const float4* hdr = reinterpret_cast<const float4*>(rec);
#pragma unroll
    for (int i = 0; i < 2 * kSlots; ++i) {
      const float4 q = ld_rec4<kFeat>(hdr + i);
      h[4 * i] = q.x;
      h[4 * i + 1] = q.y;
      h[4 * i + 2] = q.z;
      h[4 * i + 3] = q.w;
    }
    const float best0 = best;
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
  }

  // Visit record e.x, whose entry passed the cull. Returns the position of
  // the triangle an any-hit traversal accepted (the ray is then done; see
  // leaves), else -1.
  __device__ __forceinline__ int visit(Stack& stack, int2 e, const float* __restrict__ qn,
                                       int recw, int leaf_k) {
    if (kVisits) ++r.visits;
    const float* rec = qn + (size_t)e.x * (size_t)recw;
    float h[8 * kSlots];
    float tmin[kSlots];
    bool hit[kSlots];
    slabs(rec, h, tmin, hit);
    const int at = leaves(rec, leaf_k, h, hit);
    if (at < 0) push(stack, h, tmin, hit);
    return at;
  }

  // One stack pop, visited unless the cull drops it (the persistent warps'
  // unit of work). Returns whether an entry is left to pop; call only while
  // one is.
  __device__ __forceinline__ bool step(Stack& stack, const float* __restrict__ qn, int recw,
                                       int leaf_k) {
    const int2 e = pop(stack);
    if (!(__int_as_float(e.y) < best)) return pending();
    const int at = visit(stack, e, qn, recw, leaf_k);
    if (at >= 0) {  // an any-hit ray ends at its first accepted triangle
      occluder(qn + (size_t)e.x * (size_t)recw, leaf_k, at);
      sp = -1;
      return false;
    }
    return pending();
  }

  // kWarpLeaves: one visit of this lane's ray, then the warp's leaf tests;
  // every lane of the warp calls it together (a lane with no ray left to
  // traverse only helps test). The lane pops until an entry passes the cull,
  // tests the record's slabs and pushes the internal children that pass
  // (before the leaf tests: an any-hit ray that then hits drops its stack;
  // step() pushes a closest-hit ray's after them, but by the slab tests
  // against best0, so the stack is the same); the leaf slots that pass are
  // posted, and the warp tests the posted records one lane after another,
  // with that lane's ray and best t broadcast. Any hit (warp_leaves): a ray
  // with an accepted triangle takes its occluder and is done. Closest hit
  // (warp_nearest): the ray takes the nearest accepted triangle's t, normal
  // and id, and goes on. The same records visited in the same order, and
  // the same words, as step().
  __device__ __forceinline__ void warp_step(Stack& stack, const float* __restrict__ qn,
                                            int recw, int leaf_k) {
    unsigned posted = 0u;
    int node = 0;
    while (pending()) {
      const int2 e = pop(stack);
      if (!(__int_as_float(e.y) < best)) continue;
      if (kVisits) ++r.visits;
      node = e.x;
      float h[8 * kSlots];
      float tmin[kSlots];
      bool hit[kSlots];
      slabs(qn + (size_t)node * (size_t)recw, h, tmin, hit);
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const float ref = h[6 * kSlots + k];
        posted |= (hit[k] && ref < 0.0f && ref > kEmptyRef) ? 1u << k : 0u;
      }
      push(stack, h, tmin, hit);
      break;
    }
    int at = -1;
    for (unsigned lanes = __ballot_sync(kWarpMask, posted != 0u); lanes != 0u;
         lanes &= lanes - 1u) {
      const int src = __ffs(lanes) - 1;
      const int n = __shfl_sync(kWarpMask, node, src);
      if constexpr (kAnyHit) {
        const int found = warp_leaves<kSlots, kFeat>(
            qn + (size_t)n * (size_t)recw, __shfl_sync(kWarpMask, posted, src), leaf_k,
            __shfl_sync(kWarpMask, ox, src), __shfl_sync(kWarpMask, oy, src),
            __shfl_sync(kWarpMask, oz, src), __shfl_sync(kWarpMask, dx, src),
            __shfl_sync(kWarpMask, dy, src), __shfl_sync(kWarpMask, dz, src),
            __shfl_sync(kWarpMask, best, src));
        if ((int)(threadIdx.x & 31u) == src) at = found;
      } else {
        float b = __shfl_sync(kWarpMask, best, src);
        const int found = warp_nearest<kSlots, kFeat>(
            qn + (size_t)n * (size_t)recw, __shfl_sync(kWarpMask, posted, src), leaf_k,
            __shfl_sync(kWarpMask, ox, src), __shfl_sync(kWarpMask, oy, src),
            __shfl_sync(kWarpMask, oz, src), __shfl_sync(kWarpMask, dx, src),
            __shfl_sync(kWarpMask, dy, src), __shfl_sync(kWarpMask, dz, src), b);
        if ((int)(threadIdx.x & 31u) == src) {
          at = found;
          best = b;
        }
      }
    }
    if (at >= 0) {
      occluder(qn + (size_t)node * (size_t)recw, leaf_k, at);
      if (kAnyHit) sp = -1;
    }
  }

  // kTileLeaves: the closest-hit leaf tests of this lane's ray alone
  // against the leaf slots `posted` of record `rec`, in slot then triangle
  // order, strict t < best: Ray::leaves' loop (mt_hit is its expression),
  // lowering best and returning the position k·K + j of the nearest
  // accepted triangle (-1: none), whose normal and id the caller takes.
  __device__ __forceinline__ int lane_nearest(const float* __restrict__ rec, unsigned posted,
                                              int leaf_k) {
    const float4* tv = reinterpret_cast<const float4*>(rec + 8 * kSlots);
    int at = -1;
    float tt = 0.0f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (((posted >> k) & 1u) == 0u) continue;
      const float n = ld_rec<kFeat>(rec + 7 * kSlots + k);
      for (int j = 0; j < leaf_k && (float)j < n; ++j) {
        const int p = k * leaf_k + j;
        if (mt_hit(ld_rec4<kFeat>(tv + 3 * p), ld_rec4<kFeat>(tv + 3 * p + 1),
                   ld_rec4<kFeat>(tv + 3 * p + 2), ox, oy, oz, dx, dy, dz, best, tt)) {
          best = tt;
          at = p;
        }
      }
    }
    return at;
  }

  // kTileLeaves (closest hit): warp_step's visit, then a warp-uniform choice
  // of leaf stage; every lane of the warp calls it together. Each lane pops
  // until an entry passes the cull, tests the record's slabs, pushes the
  // internal children that pass and posts the leaf slots that pass, as in
  // warp_step. Then the warp prices the two leaf stages from the posted
  // slots' triangle counts n (min(count, K)): the lanes' own loops run
  // m = Σ_k max over lanes of n_k iterations (the lanes of one slot's loop
  // run in step), the warp's tests w = Σ over lanes of their runs of 32
  // (per slot ⌈n_k/32⌉; packed, the posted slots' span in runs). Where
  // cost·w < m the warp serves the posting lanes one after another with
  // warp_nearest, else each posting lane runs lane_nearest on its own
  // record. Either way the lane keeps its nearest accepted triangle, first
  // in position among equal t, below its best t: the sequential loop's
  // words, whichever stage ran.
  //
  // What bounds the step (MB1, MB3 on the card; PERF.md §6): the
  // instructions the warp issues, and the dependent fetch of the next
  // record after a pop. The choice goes at the first: the lane loop issues
  // m iterations with loads that are one broadcast where the lanes share a
  // leaf, the warp form w runs of coalesced loads (12 lines a run) plus
  // their reductions, and the warp takes the fewer. It leaves the second as
  // it is: the pricing (kSlots + 1 warp reductions a step) adds nothing to
  // a pop's fetch, and the next pop waits on its record either way.
  __device__ __forceinline__ void tile_step(Stack& stack, const float* __restrict__ qn,
                                            int recw, int leaf_k) {
    static_assert(!kAnyHit && (kFeat & kWarpLeaves) != 0, "closest hit on a warp-leaves core");
    // warp_step's visit, with the posted slots' counts taken from the
    // header while it is in registers: sharing warp_step's visit and reading
    // the counts back from L1 after it lowered render / tile by 2–4% on the
    // card (PERF.md §6)
    unsigned posted = 0u;
    int node = 0;
    int n[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) n[k] = 0;
    while (pending()) {
      const int2 e = pop(stack);
      if (!(__int_as_float(e.y) < best)) continue;
      if (kVisits) ++r.visits;
      node = e.x;
      float h[8 * kSlots];
      float tmin[kSlots];
      bool hit[kSlots];
      slabs(qn + (size_t)node * (size_t)recw, h, tmin, hit);
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const float ref = h[6 * kSlots + k];
        if (hit[k] && ref < 0.0f && ref > kEmptyRef) {
          posted |= 1u << k;
          n[k] = (int)fminf(fmaxf(h[7 * kSlots + k], 0.0f), (float)leaf_k);
        }
      }
      push(stack, h, tmin, hit);
      break;
    }
    int m = 0, runs = 0;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      m += (int)__reduce_max_sync(kWarpMask, (unsigned)n[k]);
      if constexpr ((kFeat & kPackSlots) == 0) runs += (n[k] + 31) >> 5;
    }
    if constexpr ((kFeat & kPackSlots) != 0) {
      runs = posted != 0u ? ((33 - __clz(posted) - __ffs(posted)) * leaf_k + 31) >> 5 : 0;
    }
    if (m == 0) return;  // warp-uniform: no posted slot holds a triangle
    int at = -1;
    if (kTileLeafCost * (float)__reduce_add_sync(kWarpMask, (unsigned)runs) < (float)m) {
      for (unsigned lanes = __ballot_sync(kWarpMask, posted != 0u); lanes != 0u;
           lanes &= lanes - 1u) {
        const int src = __ffs(lanes) - 1;
        const int nd = __shfl_sync(kWarpMask, node, src);
        float b = __shfl_sync(kWarpMask, best, src);
        const int found = warp_nearest<kSlots, kFeat>(
            qn + (size_t)nd * (size_t)recw, __shfl_sync(kWarpMask, posted, src), leaf_k,
            __shfl_sync(kWarpMask, ox, src), __shfl_sync(kWarpMask, oy, src),
            __shfl_sync(kWarpMask, oz, src), __shfl_sync(kWarpMask, dx, src),
            __shfl_sync(kWarpMask, dy, src), __shfl_sync(kWarpMask, dz, src), b);
        if ((int)(threadIdx.x & 31u) == src) {
          at = found;
          best = b;
        }
      }
    } else if (posted != 0u) {
      at = lane_nearest(qn + (size_t)node * (size_t)recw, posted, leaf_k);
    }
    if (at >= 0) occluder(qn + (size_t)node * (size_t)recw, leaf_k, at);
  }
};

// The whole traversal of one ray with core `kFeat` (kSharedTree: `qn` is
// the block's shared copy of the records).
template <int kSlots, bool kAnyHit, bool kVisits, unsigned kFeat>
__device__ __forceinline__ Hit traverse_ray(const float* __restrict__ qn, int recw, int leaf_k,
                                            float ox, float oy, float oz, float dx, float dy,
                                            float dz, float best_init, int entry) {
  using R = Ray<kSlots, kAnyHit, kVisits, kFeat>;
  R ray;
  Stack stack;
  ray.start(stack, ox, oy, oz, dx, dy, dz, best_init, entry);
  while (ray.pending()) {
    const int2 e = ray.pop(stack);
    if (!(__int_as_float(e.y) < ray.best)) continue;
    const int at = ray.visit(stack, e, qn, recw, leaf_k);
    if (at >= 0) {  // an accepted any hit
      ray.occluder(qn + (size_t)e.x * (size_t)recw, leaf_k, at);
      break;
    }
  }
  return ray.result();
}

// The whole traversal of one ray a lane with core `kFeat` (which holds
// kWarpLeaves), any hit or closest hit: every lane of the warp calls it and
// stays until no lane's ray is left, so that the warp tests the leaves
// together; `mine`: whether this lane has a ray (o and d are read only
// then). A lane without one returns the miss values. kVisits: count the
// records visited, as traverse_ray does (K1f). kTileLeaves steps with
// tile_step, the others with warp_step.
template <int kSlots, bool kAnyHit, unsigned kFeat, bool kVisits = false>
__device__ __forceinline__ Hit traverse_ray_warp(const float* __restrict__ qn, int recw,
                                                 int leaf_k, bool mine, float ox, float oy,
                                                 float oz, float dx, float dy, float dz,
                                                 float best_init, int entry) {
  static_assert((kFeat & kWarpLeaves) != 0, "a warp-leaves core");
  using R = Ray<kSlots, kAnyHit, kVisits, kFeat>;
  R ray;
  Stack stack;
  ray.start(stack, ox, oy, oz, dx, dy, dz, best_init, entry);
  if (!mine) ray.sp = -1;
  while (__any_sync(kWarpMask, ray.pending())) {
    if constexpr ((kFeat & kTileLeaves) != 0) {
      ray.tile_step(stack, qn, recw, leaf_k);
    } else {
      ray.warp_step(stack, qn, recw, leaf_k);
    }
  }
  return ray.result();
}

}  // namespace rt
