// K2a / K2b — traversal of an arbitrary ray buffer through the supernode
// records: K2a closest hit (the bounce waves of path tracing), K2b any hit
// (the next-event-estimation shadow rays toward the sun).
// K2c — both on 8-wide records (the BVH8 of collapse_lbvh2_to_bvh8).
// Each also without near-first order (ordered = 0: K2a/K2b/K2c unordered).
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas/traverse.py::
// _raybuf_kernel (loop _traverse_streams, per-visit core _consume, rec_width
// 4 or 8) on records with K triangles per leaf. It computes what
// trace_rays_pallas(qnodes, origins, dirs, any_hit=…, leaf_k=K) computes:
// five (R,) planes t, nx, ny, nz (f32) and tri (int32), with t = 1e30, a zero
// normal and tri = -1 on a miss. Any hit stops at the first accepted
// triangle in visit order and reports t = 0 with that triangle's normal and
// id; its contract is the occlusion mask (tri >= 0) only.
//
// What bounds it on the card: as for K1a, a chain of dependent record
// fetches per ray, but the waves are divergent. Each bounce ray walks its
// own path through the ~390 MB of main-path records, far beyond the 50 MB
// L2, so neighbouring threads rarely share a record line and most visits
// wait on device memory. NEE rays share one direction but start from
// scattered surface points. With one thread per ray (the port's first
// loop), a warp holds its slots until its slowest ray ends while the lanes
// of missed, dead or finished rays idle: the checked rays ran 104× (K2a) and
// 91× (K2b) above their bounds, against 44× for K1a, and at K = 32 most of
// that was one lane testing a whole leaf alone.
//
// What the design does about it:
//  * The per-ray traversal of traverse_core.cuh in its render form
//    rt::kRenderCore (near-first order by the ray's own slab entry
//    distance, ranked in registers; culling at the best t). Over leaves of
//    more than one triangle (every wave of the render paths at SAH K = 32
//    and Morton K = 8) both kinds run rt::kAnyHitCore instead, any hit (the
//    shadow rays) and closest hit (the bounce rays): each lane visits its
//    own ray's records in that order, and the warp tests the leaf slots
//    they reach together, a triangle a lane (kWarpLeaves; any hit stops at
//    the first accepted run, closest hit serves every run and keeps the
//    nearest): one lane testing a whole leaf of 32 triangles alone, on
//    loads that touch a line a lane, was what the per-lane cores spent
//    those waves on. The caller's launch plan
//    (ops/cuda/traverse.py::launch_plan) picks it and its schedule; it beat
//    the port's first loop and the render core on every such wave measured
//    (PERF.md §6), so the render core runs only at K = 1.
//  * Two schedules, chosen by the caller per wave (trace_rays(scattered=)):
//    - one thread per ray in blocks of 128, where the active rays come in
//      runs (the camera's NEE wave and the first bounce: its lanes are the
//      camera's hits). The caller keeps the rays in 32×32 tile-block lane
//      order, so the 32 threads of a warp hold neighbouring rays and whole
//      warps of inactive lanes end at once.
//    - persistent warps with dynamic fetch (Aila & Laine 2009), where the
//      active rays are a scattered minority (the waves that follow a random
//      bounce). The grid is the blocks that fit on the card at once (SMs ×
//      the instantiation's occupancy, queried once), and each
//      warp takes kChunk = 32 ray indices at a time with one atomicAdd on a
//      4-byte counter that the launch zeroes on its own stream (each launch
//      gets its own counter from the caller). A fetched ray whose `active`
//      byte is 0 gets the miss values at once and no traversal lane: the
//      warp fetches again (__ballot_sync) until its lanes hold active rays
//      or the buffer ends, which compacts the wave. When fewer than kRefill
//      = 16 lanes of a warp still traverse, the idle lanes take new rays
//      between two visits (16 beat 0 and 8 on the card). Every result is
//      written at its ray's own index, so lane order and random numbers
//      outside are untouched. On a dense wave the same warps lose to one
//      thread per ray (PERF.md §6), hence the two schedules.
//  * Any hit returns at the first accepted triangle, so an occluded shadow
//    ray frees its lane early.
//  * ordered = 0 (the TPU kernel's static flag `ordered`, traverse.py:919)
//    instantiates every core and schedule above with rt::kUnordered: a
//    visit pushes its passing children in slot order with their slab entry
//    distances, with no ranking and no sort, and the pop-time cull stays.
//    The nearest hit does not depend on the order, so closest-hit planes
//    are those of the ordered kernel; an any-hit ray may stop at another
//    occluder. It trades more visits for cheaper ones, which any hit, with
//    no use for the order, may win.
//  * tree_space (the TPU kernel's placement of the records,
//    trace_rays_pallas(tree_space=…), traverse.py:1197): where the records
//    are read during the traversal. kHbm, the default: in device memory,
//    read through L1 and L2 (every form above). kVmem: the same kernels,
//    with the records pinned in L2 for the call — the persisting carve-out
//    set to their bytes, and the launch given an access-policy window over
//    them (hit ratio 1, persisting; misses streaming) as an attribute of
//    that launch alone, so no stream keeps it — then, after the launch has
//    ended (the launcher waits for it: the carve-out is device-wide and the
//    reset of persisting lines is not stream-ordered), the persisting lines
//    reset and the carve-out put back as it was. kSmem: each block first copies the whole
//    record array into its dynamic shared memory with 16-byte loads
//    (rt::stage_tree) and then traverses from there (rt::kSharedTree), both
//    schedules of the render core and of rt::kAnyHitCore, in blocks of
//    kSmemBlock threads. A block copies the whole tree, so the per-ray
//    schedule copies it once per kSmemBlock rays and the persistent warps
//    once per resident block. The tree must fit
//    one block (232,448 bytes on an H100), as on the TPU it had to fit
//    scalar memory; the caller checks the fit.
//
// The launcher's `core` argument is the core's whole feature mask, as the
// launch plan gives it (RT_RAY_CORES), `persistent` the schedule,
// `tree_space` the placement.
//
// Exactness: the slab and Möller–Trumbore arithmetic of traverse_core.cuh,
// built with -fmad=false, in the operation order of the plain torch version
// (raytracer_tpu_torch/ops/cuda/traverse.py::trace_rays_reference); every
// core and schedule writes the same words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse_core.cuh"

namespace {

constexpr int kRayBlock = 128;  // threads of a block (4 warps)
// Threads of a block that copies the records into shared memory (both
// schedules): each block copies the whole tree, so larger blocks copy it
// fewer times (PERF.md §6); a per-ray block of 1,024 would cap the 8-wide
// core at 64 registers.
constexpr int kSmemBlock = 512;
enum TreeSpace { kHbm = 0, kVmem = 1, kSmem = 2 };

// The launch bound of an instantiation: kRayBlock, or kSmemBlock for the
// shared-tree cores.
__host__ __device__ constexpr int max_block(unsigned core) {
  return (core & rt::kSharedTree) ? kSmemBlock : kRayBlock;
}
constexpr unsigned kFull = 0xffffffffu;
// Ray indices a persistent warp takes from the counter at a time: one a
// lane, so that no warp holds back a long run of rays that it then works
// through alone while the others idle at the end of the wave.
constexpr unsigned kChunk = 32;
// A persistent warp's idle lanes take new rays when fewer than this many of
// its lanes still traverse.
constexpr int kRefill = 16;

__device__ __forceinline__ void store_ray(const rt::Hit& hit, size_t i, float* __restrict__ t_out,
                                          float* __restrict__ nx_out, float* __restrict__ ny_out,
                                          float* __restrict__ nz_out, int* __restrict__ tri_out) {
  t_out[i] = hit.t;
  nx_out[i] = hit.nx;
  ny_out[i] = hit.ny;
  nz_out[i] = hit.nz;
  tri_out[i] = hit.tri;
}

// One thread per ray. `tree_f4`: the records' size in float4s, read only by
// a kSharedTree core.
template <int kSlots, bool kAnyHit, unsigned kCore>
__global__ void __launch_bounds__(max_block(kCore))
trace_rays_kernel(const float* __restrict__ qn, int recw, int leaf_k,
                  const float* __restrict__ orig, const float* __restrict__ dirs,
                  const uint8_t* __restrict__ active, int n,
                  float* __restrict__ t_out, float* __restrict__ nx_out,
                  float* __restrict__ ny_out, float* __restrict__ nz_out,
                  int* __restrict__ tri_out, int tree_f4) {
  const float* tree = rt::stage_tree<kCore>(qn, tree_f4);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr ((kCore & rt::kWarpLeaves) != 0) {
    // the warp tests its rays' leaves together: no lane leaves early (the
    // block holds whole warps)
    const bool mine = i < n && (active == nullptr || active[i] != 0);
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
    if (mine) {
      for (int c = 0; c < 3; ++c) {
        o[c] = orig[3 * (size_t)i + c];
        d[c] = dirs[3 * (size_t)i + c];
      }
    }
    const rt::Hit hit = rt::traverse_ray_warp<kSlots, kAnyHit, kCore>(
        tree, recw, leaf_k, mine, o[0], o[1], o[2], d[0], d[1], d[2], rt::kInf, 0);
    if (i < n) store_ray(hit, (size_t)i, t_out, nx_out, ny_out, nz_out, tri_out);
  } else {
    if (i >= n) return;
    rt::Hit hit{rt::kInf, 0.0f, 0.0f, 0.0f, -1, 0};
    if (active == nullptr || active[i] != 0) {
      const size_t r = 3 * (size_t)i;
      hit = rt::traverse_ray<kSlots, kAnyHit, false, kCore>(
          tree, recw, leaf_k, orig[r], orig[r + 1], orig[r + 2], dirs[r], dirs[r + 1],
          dirs[r + 2], rt::kInf, 0);
    }
    store_ray(hit, (size_t)i, t_out, nx_out, ny_out, nz_out, tri_out);
  }
}

// Persistent warps with dynamic fetch: each warp takes kChunk consecutive
// ray indices at a time from the counter `next` (zeroed before the launch)
// and hands them to its idle lanes, skipping inactive rays, whenever fewer
// than kRefill lanes of the warp traverse. The render core, with or without
// near-first order (kCore = rt::kRenderCore [| rt::kUnordered]
// [| rt::kSharedTree]), and rt::kAnyHitCore for any or closest hit (with
// or without rt::kPackSlots, in the same forms), whose leaf tests take the
// whole warp: there every lane calls warp_step each round, an idle lane
// with an empty stack, and only the lanes that hold a ray store a result.
template <int kSlots, bool kAnyHit, unsigned kCore>
__global__ void __launch_bounds__(max_block(kCore))
trace_rays_persistent_kernel(const float* __restrict__ qn, int recw, int leaf_k,
                             const float* __restrict__ orig, const float* __restrict__ dirs,
                             const uint8_t* __restrict__ active, int n,
                             unsigned* __restrict__ next, float* __restrict__ t_out,
                             float* __restrict__ nx_out, float* __restrict__ ny_out,
                             float* __restrict__ nz_out, int* __restrict__ tri_out,
                             int tree_f4) {
  const float* tree = rt::stage_tree<kCore>(qn, tree_f4);
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  using R = rt::Ray<kSlots, kAnyHit, false, kCore>;
  R ray;
  rt::Stack stack;
  int idx = -1;                // this lane's ray; -1 while the lane is idle
  unsigned qpos = 0, qend = 0;  // the warp's indices taken, [qpos, qend) not handed out
  bool drained = false;        // every index below n has been taken
  if constexpr ((kCore & rt::kWarpLeaves) != 0) {
    ray.sp = -1;  // an idle lane only helps the warp test leaves
  }
  while (true) {
    unsigned busy = __ballot_sync(kFull, idx >= 0);
    if (!drained && (busy == 0u || __popc(busy) < kRefill)) {
      while (busy != kFull && !drained) {
        if (qpos >= qend) {
          unsigned first = 0;
          if (lane == 0) first = atomicAdd(next, kChunk);
          qpos = __shfl_sync(kFull, first, 0);
          qend = qpos + kChunk;
          if (qpos >= (unsigned)n) {
            drained = true;
            break;
          }
        }
        const unsigned idle = ~busy;
        const unsigned rank = __popc(idle & below);
        const unsigned take = min((unsigned)__popc(idle), qend - qpos);
        if (((idle >> lane) & 1u) && rank < take) {
          const unsigned i = qpos + rank;
          if (i < (unsigned)n) {
            if (active == nullptr || active[i] != 0) {
              const size_t r = 3 * (size_t)i;
              ray.start(stack, orig[r], orig[r + 1], orig[r + 2], dirs[r], dirs[r + 1],
                        dirs[r + 2], rt::kInf, 0);
              idx = (int)i;
            } else {
              store_ray(rt::Hit{rt::kInf, 0.0f, 0.0f, 0.0f, -1, 0}, i, t_out, nx_out, ny_out,
                        nz_out, tri_out);
            }
          }
        }
        qpos += take;
        drained = qpos >= (unsigned)n;
        busy = __ballot_sync(kFull, idx >= 0);
      }
    }
    if (busy == 0u) break;  // drained, and no lane traverses
    if constexpr ((kCore & rt::kWarpLeaves) != 0) {
      ray.warp_step(stack, tree, recw, leaf_k);  // every lane: the warp tests the leaves
      if (idx >= 0 && !ray.pending()) {
        store_ray(ray.result(), (size_t)idx, t_out, nx_out, ny_out, nz_out, tri_out);
        idx = -1;
      }
    } else if (idx >= 0 && !ray.step(stack, tree, recw, leaf_k)) {
      store_ray(ray.result(), (size_t)idx, t_out, nx_out, ny_out, nz_out, tri_out);
      idx = -1;
    }
  }
}

// the outputs, as the launch helpers take them
#define RT_RAY_OUTS t, nx, ny, nz, tri

// The records' size in float4s and bytes, as the shared-tree kernels take
// them (the size fits an int: the caller checks it against one block's
// shared memory).
struct Tree {
  int f4;
  size_t bytes;
};

// Launch `kernel` on `s`: with <<<>>>, or, given an access-policy window
// (kVmem), with cudaLaunchKernelEx and the window as the launch's own
// attribute. Returns the launch's error.
template <typename... P, typename... A>
int launch_on(void (*kernel)(P...), int grid, int threads, size_t smem, cudaStream_t s,
              const cudaAccessPolicyWindow* win, A... args) {
  if (win == nullptr) {
    kernel<<<grid, threads, smem, s>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeAccessPolicyWindow;
  attr[0].val.accessPolicyWindow = *win;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// A shared-tree instantiation's dynamic shared memory: allow it the
// records' bytes (beyond the default 48 KB; the launch fails if the card
// has less).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int kSlots, bool kAnyHit, unsigned kCore>
int launch_per_ray(const float* qnodes, int recw, int leaf_k, const float* origins,
                   const float* dirs, const uint8_t* active, int n, float* t, float* nx,
                   float* ny, float* nz, int* tri, cudaStream_t s, Tree tree,
                   const cudaAccessPolicyWindow* win) {
  constexpr bool kShared = (kCore & rt::kSharedTree) != 0;
  const auto kernel = trace_rays_kernel<kSlots, kAnyHit, kCore>;
  const int threads = kShared ? kSmemBlock : kRayBlock;
  const size_t smem = kShared ? tree.bytes : 0;
  if (kShared) {
    const int err = allow_smem(kernel, smem);
    if (err != 0) return err;
  }
  return launch_on(kernel, (n + threads - 1) / threads, threads, smem, s, win, qnodes, recw,
                   leaf_k, origins, dirs, active, n, t, nx, ny, nz, tri, tree.f4);
}

template <int kSlots, bool kAnyHit, unsigned kCore>
int launch_persistent(const float* qnodes, int recw, int leaf_k, const float* origins,
                      const float* dirs, const uint8_t* active, int n, unsigned* next, float* t,
                      float* nx, float* ny, float* nz, int* tri, cudaStream_t s, Tree tree,
                      const cudaAccessPolicyWindow* win) {
  constexpr bool kShared = (kCore & rt::kSharedTree) != 0;
  const auto kernel = trace_rays_persistent_kernel<kSlots, kAnyHit, kCore>;
  const int threads = kShared ? kSmemBlock : kRayBlock;
  const size_t smem = kShared ? tree.bytes : 0;
  // the instantiation's resident blocks per SM: queried at its first launch,
  // or at every launch of a shared-tree core, whose blocks depend on the
  // tree
  int per_sm = 0;
  if (kShared) {
    int err = allow_smem(kernel, smem);
    if (err == 0) {
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    }
    if (err != 0) return err;
  } else {
    // the count, or minus the CUDA error
    static const int fixed = [smem, kernel] {
      int blocks = 0;
      const cudaError_t e =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kRayBlock, smem);
      return e == cudaSuccess ? blocks : -(int)e;
    }();
    if (fixed < 0) return -fixed;
    per_sm = fixed;
  }
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == 0) err = (int)cudaMemsetAsync(next, 0, sizeof(unsigned), s);
  if (err != 0) return err;
  const int wanted = (n + threads - 1) / threads;
  const int grid = per_sm * sms < wanted ? per_sm * sms : wanted;
  return launch_on(kernel, grid, threads, smem, s, win, qnodes, recw, leaf_k, origins, dirs,
                   active, n, next, t, nx, ny, nz, tri, tree.f4);
}

// The records pinned in L2 for one launch (tree_space kVmem): the
// persisting carve-out set to their `bytes`, `launch(&window)` with an
// access-policy window over them; then, after the launch has ended, the
// persisting lines reset and the carve-out as it was. Returns the first
// error (a failed launch's too), having put back the carve-out whatever
// failed.
template <typename Launch>
int launch_pinned(const float* qnodes, size_t bytes, cudaStream_t s, Launch launch) {
  size_t limit = 0;
  int err = (int)cudaDeviceGetLimit(&limit, cudaLimitPersistingL2CacheSize);
  if (err != 0) return err;
  cudaAccessPolicyWindow win = {};
  win.base_ptr = const_cast<float*>(qnodes);
  win.num_bytes = bytes;
  win.hitRatio = 1.0f;
  win.hitProp = cudaAccessPropertyPersisting;
  win.missProp = cudaAccessPropertyStreaming;
  err = (int)cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, bytes);
  if (err == 0) err = launch(&win);
  const int restored[] = {(int)cudaStreamSynchronize(s), (int)cudaCtxResetPersistingL2Cache(),
                          (int)cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, limit)};
  for (const int e : restored) {
    if (err == 0) err = e;
  }
  return err;
}

// The cores rt_trace_rays builds, each at both widths, for both kinds of hit
// and both schedules: what ops/cuda/traverse.py::launch_plan returns. The
// render core (K = 1) and rt::kAnyHitCore (K > 1; the warp's leaf tests,
// any hit or closest hit), the latter without rt::kPackSlots from K = 32 on
// (from there a run holds one slot either way, and the packed loop's slot
// arithmetic cost 7% at K = 32 on the card; in the kernel beside the
// per-slot loop it spilled); each with and without near-first order
// (rt::kUnordered), with the records in device memory and in shared memory
// (rt::kSharedTree).
#define RT_RAY_CORES(X)                                                                     \
  X(rt::kRenderCore) X(rt::kRenderCore | rt::kUnordered) X(rt::kRenderCore | rt::kSharedTree) \
  X(rt::kRenderCore | rt::kUnordered | rt::kSharedTree)                                      \
  X(rt::kAnyHitCore) X(rt::kAnyHitCore | rt::kUnordered) X(rt::kAnyHitCore | rt::kSharedTree) \
  X(rt::kAnyHitCore | rt::kUnordered | rt::kSharedTree)                                      \
  X((rt::kAnyHitCore & ~rt::kPackSlots)) X((rt::kAnyHitCore & ~rt::kPackSlots) | rt::kUnordered) \
  X((rt::kAnyHitCore & ~rt::kPackSlots) | rt::kSharedTree)                                   \
  X((rt::kAnyHitCore & ~rt::kPackSlots) | rt::kUnordered | rt::kSharedTree)

// The launch of everything but the placement: the arguments of
// rt_trace_rays.
int dispatch(const float* qnodes, int recw, int leaf_k, int slots, const float* origins,
             const float* dirs, const uint8_t* active, int n, int any_hit, unsigned core,
             int persistent, Tree tree, const cudaAccessPolicyWindow* win, unsigned* next,
             float* t, float* nx, float* ny, float* nz, int* tri, cudaStream_t s) {
#define RT_RAY_ARGS qnodes, recw, leaf_k, origins, dirs, active, n
#define RT_LAUNCH_TAIL s, tree, win
#define RT_PERSISTENT(S, CORE)                                                             \
  (any_hit ? launch_persistent<S, true, CORE>(RT_RAY_ARGS, next, RT_RAY_OUTS, RT_LAUNCH_TAIL) \
           : launch_persistent<S, false, CORE>(RT_RAY_ARGS, next, RT_RAY_OUTS, RT_LAUNCH_TAIL))
#define RT_PER_RAY(S, CORE)                                                             \
  (any_hit ? launch_per_ray<S, true, CORE>(RT_RAY_ARGS, RT_RAY_OUTS, RT_LAUNCH_TAIL)     \
           : launch_per_ray<S, false, CORE>(RT_RAY_ARGS, RT_RAY_OUTS, RT_LAUNCH_TAIL))
#define RT_CASE(CORE)                                                                 \
  case CORE:                                                                          \
    return persistent ? (slots == 8 ? RT_PERSISTENT(8, CORE) : RT_PERSISTENT(4, CORE)) \
                      : (slots == 8 ? RT_PER_RAY(8, CORE) : RT_PER_RAY(4, CORE));
  switch (core) {
    RT_RAY_CORES(RT_CASE)
    default:
      break;
  }
#undef RT_CASE
#undef RT_PER_RAY
#undef RT_PERSISTENT
#undef RT_LAUNCH_TAIL
#undef RT_RAY_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch K2a (any_hit = 0) or K2b (any_hit != 0) over n rays on `stream`;
// with slots = 8, K2c on 8-wide records. qnodes: (num_nodes, recw) f32,
// 16-byte aligned rows of `slots` (4 or 8) child slots; origins, dirs: (n,
// 3) f32; active: n bytes (0 = inactive) or null for all rays; outputs:
// (n,) planes. `core`: one of the masks of RT_RAY_CORES, as
// ops/cuda/traverse.py::launch_plan gives it, with rt::kSharedTree exactly
// under kSmem. `persistent` != 0 runs persistent warps and needs `next`, 4
// bytes of device memory that this launch alone uses (zeroed here on
// `stream`); otherwise one thread per ray. `tree_space`: kHbm (0), kVmem (1:
// records of at most the card's persisting L2 and window size) or kSmem (2:
// records of at most one block's shared memory). Returns the first CUDA
// error (0 on success, or cudaErrorInvalidValue for an argument outside
// these sets); synchronises nothing but under kVmem, which waits for its
// launch to end.
extern "C" int rt_trace_rays(const float* qnodes, int num_nodes, int recw, int leaf_k, int slots,
                             const float* origins, const float* dirs, const uint8_t* active,
                             int n, int any_hit, int core, int persistent, int tree_space,
                             unsigned* next, float* t, float* nx, float* ny, float* nz, int* tri,
                             void* stream) {
  if (slots != 4 && slots != 8) return (int)cudaErrorInvalidValue;
  if (persistent && next == nullptr) return (int)cudaErrorInvalidValue;
  if (tree_space != kHbm && tree_space != kVmem && tree_space != kSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const bool shared = tree_space == kSmem;
  if (((core & (int)rt::kSharedTree) != 0) != shared) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)num_nodes * (size_t)recw * sizeof(float);
  if (num_nodes <= 0 || (shared && bytes > (size_t)INT32_MAX)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tree tree{(int)(shared ? bytes / sizeof(float4) : 0), bytes};
  auto launch = [&](const cudaAccessPolicyWindow* win) {
    return dispatch(qnodes, recw, leaf_k, slots, origins, dirs, active, n, any_hit,
                    (unsigned)core, persistent, tree, win, next, RT_RAY_OUTS, s);
  };
  if (tree_space == kVmem) return launch_pinned(qnodes, bytes, s, launch);
  return launch(nullptr);
}

// The device limits that decide whether records fit a placement, read from
// the current device: out[0] the shared memory one block may opt in to
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), out[1] the largest persisting
// L2 carve-out (cudaDevAttrMaxPersistingL2CacheSize), out[2] the largest
// access-policy window (cudaDevAttrMaxAccessPolicyWindowSize), in bytes.
// Returns the first CUDA error.
extern "C" int rt_tree_space_limits(long long* out) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  const cudaDeviceAttr attrs[] = {cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  cudaDevAttrMaxPersistingL2CacheSize,
                                  cudaDevAttrMaxAccessPolicyWindowSize};
  for (int i = 0; i < 3 && err == 0; ++i) {
    int v = 0;
    err = (int)cudaDeviceGetAttribute(&v, attrs[i], dev);
    out[i] = v;
  }
  return err;
}

// What a placement leaves behind, read back: out[0] the base address and
// out[1] the bytes of `stream`'s access-policy window (0 when it has none),
// out[2] the device's persisting L2 carve-out. Returns the first CUDA error.
extern "C" int rt_l2_window(void* stream, long long* out) {
  cudaStreamAttrValue win = {};
  size_t limit = 0;
  int err = (int)cudaStreamGetAttribute(static_cast<cudaStream_t>(stream),
                                        cudaStreamAttributeAccessPolicyWindow, &win);
  if (err == 0) err = (int)cudaDeviceGetLimit(&limit, cudaLimitPersistingL2CacheSize);
  out[0] = (long long)(uintptr_t)win.accessPolicyWindow.base_ptr;
  out[1] = (long long)win.accessPolicyWindow.num_bytes;
  out[2] = (long long)limit;
  return err;
}
