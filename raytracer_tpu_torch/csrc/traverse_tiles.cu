// K1a / K1b — closest-hit primary-ray traversal of the supernode records, one
// frame, one ray per pixel; K1b jitters each ray's subpixel position.
// K1c — the same for a batch of F frames (cameras) in one launch.
// K1d — K1a / K1b with a depth bound and an entry node for every 32×32-pixel
// tile of the frame.
// K1e — all of these on 8-wide records (the BVH8 of collapse_lbvh2_to_bvh8).
// K1f — any of these with a sixth output plane: the records each pixel's ray
// visited.
// K1c raw — K1c (or K1e / K1f batches) writing the TPU kernel's own tile
// layout instead of image planes.
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas/traverse.py::
// _persistent_kernel (with its per-visit core _consume, rec_width 4 or 8) on
// the path of K triangles per leaf. K1a computes what trace_tiles_pallas(qnodes, pos, quat, W, H, fov,
// leaf_k=K)[:5] computes; K1b what the same call computes with jitter=True,
// jitter_seed=seed: the fixed pixel-centre offset 0.5 becomes
// subpixel_hash01(px, py, 2·seed) and (…, 2·seed + 1), the hash of
// raytracer_tpu/ops/camera.py. Both write the same five (H, W) planes. Like
// the TPU kernel they can trace a window of a larger frame (raygen_size with
// row/col offsets), which renders one band or crop with the full frame's
// rays. K1c computes what trace_tiles_batch_pallas(qnodes, pos (F,3), quat
// (F,4), W, H, fov, leaf_k=K, jitter=…, jitter_seeds=…)[:5] computes: five
// (F, H, W) planes, frame f from camera row f. K1d computes what the K1a /
// K1b call computes with entries=E, tbounds=B ((⌈H/32⌉, ⌈W/32⌉) int32 and f32):
// pixel (px, py) of the traced window starts with the best t
// B[py / 32, px / 32] and its stack at record E[py / 32, px / 32], where the
// others start at 1e30 and the root. The tile index is taken in the window's
// own pixel coordinates, before the row / column offsets into a larger frame
// are added; 32 is the TPU kernel's tile and part of the function's meaning.
// A pixel keeps only hits nearer than its tile's bound and reports t = the
// bound, tri = −1 and a zero normal when it finds none (the callers in
// render.py re-trace such pixels unbounded). K1e reads rec_layout(K, 8)
// records (a 64-word header) where the others read rec_layout(K, 4). K1f
// computes what stats=True adds there, in this kernel's own terms: the TPU
// kernel shares one stack among the 1,024 rays of a tile and writes the
// tile's visit count to every pixel of it; here each ray has its own stack,
// so the plane holds each pixel's own count of stack pops that passed the
// cull against its best t (as f32). Without it (kVisits false) nothing is
// counted and no sixth plane is written.
//
// K1c raw computes what trace_tiles_batch_pallas(…, raw=True) computes
// (traverse.py:1135): one (F, tiles, 6, 8, 128) f32 array, the layout in
// which the TPU kernel writes its tiles (finish_tile, traverse.py:831-835),
// for frames whose width and height are multiples of 32. Tiles of 32×32
// pixels are row-major over the frame, a tile's pixels row-major in its
// 1,024 words: pixel (px, py) of frame f is word (py % 32)·32 + px % 32 of
// tile (py / 32)·(W / 32) + px / 32. Planes 0–3 are t, nx, ny, nz, plane 4
// tri as f32 (exact: ids stay below 2^24; −1 on a miss). Plane 5 is this
// kernel's own: the TPU kernel writes its tile's packet visit count there,
// over the whole tile; here it is K1f's per-pixel visits with kVisits and
// 0 without. The TPU kernel's raw form saved the transpose of F·6 tile
// planes into images; K1c writes image rows directly, so raw only changes
// where each thread stores its six words (kRaw, the same instantiation
// otherwise): no transpose and no second pass.
//
// What bounds it on the card: every visit is a dependent fetch of one record
// (1,792 f32 words = 7,168 bytes at K = 32) through L1 and L2, and the
// records of the 871,200-triangle main-path scene (54,449 rows, ~390 MB)
// are far larger than the 50 MB L2, so a visit that misses waits on device
// memory before the next node is known. At 8 slots a row is 3,456 words
// (13,824 bytes) and the same scene's records ~753 MB: fewer, larger visits.
// K1c does the same fetches F times over; cameras that see the same part of
// the scene read the same records.
//
// What the design does about it:
//  * One thread per pixel with its own 64-entry stack, in 8×8 blocks: the
//    32 rays of a warp are an 8×4 patch of neighbours that walk nearly the
//    same nodes, so their record loads hit the same L1/L2 lines. 8×16 and
//    16×16 blocks were no faster on the card (PERF.md §6).
//  * The traversal itself (traverse_core.cuh's render core, shared with K2)
//    reads only what a visit needs, orders children near-first by the ray's
//    own slab entry distance, ranked in registers, and culls entries at or
//    beyond the best t. The launchers' `core` argument is the core's mask,
//    as the wrapper's tile plan (ops/cuda/traverse.py::tile_plan) gives it
//    (RT_TILE_CORES).
//  * Over leaves of more than one triangle the leaf tests, not the visits,
//    were half of K1's time (K1a framed 0.4897 ms at SAH K = 1, 1.1131 at
//    K = 32; PERF.md §6): one lane testing a leaf of 32 triangles alone.
//    There the wrapper's tile plan (ops/cuda/traverse.py::tile_plan) runs
//    rt::kTileCore: each lane visits its own ray's records in the render
//    core's order, and at each step the warp picks how the leaf slots its
//    lanes posted are tested (rt::Ray::tile_step): by the whole warp, a
//    triangle a lane, each posting lane in turn (rt::warp_nearest), where
//    few lanes post; by each lane's own loop where many lanes post one leaf
//    (8×4 neighbours often do), so that each load is one broadcast. A
//    warp-leaves core runs the 8×8 block as one dimension of 64 threads
//    (thread_pixel); lanes outside the window stay in the loop and store
//    nothing.
//  * K1d prunes with the ordinary tests: the bound seeds the best t, so the
//    slab test (tn < best) and the pop cull (key < best) drop what lies
//    behind it from the first visit on, and the entry node skips the visits
//    to the top of the tree that every ray of the tile would make. A block
//    of 8×8 pixels lies in one tile, so its threads read one bound and one
//    entry. The kernels without bounds are instantiations of their own
//    (kBounded false) and compile to what they were.
//  * K1c is one launch over a grid of (⌈W/8⌉, ⌈H/8⌉, F) blocks. The TPU
//    kernel's tile queue spans all frames so that no frame's tail idles the
//    chip; here the block scheduler does that: the slow blocks of one frame
//    run beside the blocks of the others, and the F launches' overhead is
//    paid once. Blocks of one frame are adjacent in launch order, so the
//    blocks in flight share the upper levels of the tree in L2. Camera rows
//    are read from a device table of (F, 16) f32 (the TPU kernel's layout),
//    so F is bounded only by the grid (65,535). A progressive sample that a
//    CUDA graph replays traces its jittered camera wave this way, one frame
//    whose row is the sample's uniform block (ops/cuda/traverse.py::
//    trace_tiles_row): the camera and the seed are then read on the device,
//    so one captured launch serves every camera and seed.
//
// The TPU kernel shares one stack among the 1,024 rays of a 32×32 tile and
// orders children by the tile-centre ray; ordering by each ray's own entry
// distance is the per-ray form of that and changes only the visit order.
//
// Exactness: ray generation is raygen.cuh's (the TPU kernel's
// traverse.py:714-736 in the operation order of the plain torch version
// raytracer_tpu_torch/ops/camera.py::primary_dirs). All three kernels
// generate rays with the one function trace_primary, so a K1c frame is
// bit-identical to K1a (K1b with its seed) for its camera, and K1b's rays
// are bit-identical to the directions camera_lanes.cu hands to the sample.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raygen.cuh"
#include "traverse_core.cuh"

// The source builds as two libraries (ops/cuda/traverse.py::TILE_SOURCES),
// their nvcc runs started together: with RT_TILES_WARP the launchers take
// rt::kTileCore's forms, without it the render core; each refuses the
// other's cores (cudaErrorInvalidValue). As one library the source took
// 29.68 s of nvcc on the card's machine against traverse_rays.cu's 23.34 s
// beside it (PERF.md §6).
#ifndef RT_TILES_WARP
#define RT_TILES_WARP 0
#endif

namespace {

constexpr int kBlock = 8;  // threads a side of a block
constexpr int kBlockThreads = kBlock * kBlock;

struct Camera {
  float ox, oy, oz;
  float qx, qy, qz, qw;
  float focal, aspect, fw, fh;
};

// The primary ray of pixel (gx, gy) of the whole frame, traversed from
// record `entry` with the best t `best_init` (the root and 1e30 but in K1d).
// A warp-leaves core (rt::kWarpLeaves) traverses with the whole warp, every
// lane together: `mine` says whether the lane's pixel lies in the window
// (a lane outside only helps test leaves, and returns the miss values).
template <int kSlots, bool kJitter, bool kVisits, unsigned kCore>
__device__ __forceinline__ rt::Hit trace_primary(const float* __restrict__ qn, int recw,
                                                 int leaf_k, const Camera& cam, int seed,
                                                 int gx, int gy, float best_init = rt::kInf,
                                                 int entry = 0, bool mine = true) {
  float jx = 0.5f, jy = 0.5f;
  if (kJitter) {
    jx = rt::subpixel_hash01(gx, gy, seed * 2);
    jy = rt::subpixel_hash01(gx, gy, seed * 2 + 1);
  }
  float dx, dy, dz;
  rt::primary_dir(gx, gy, jx, jy, cam.fw, cam.fh, cam.focal, cam.aspect, cam.qx, cam.qy, cam.qz,
                  cam.qw, dx, dy, dz);
  if constexpr ((kCore & rt::kWarpLeaves) != 0) {
    return rt::traverse_ray_warp<kSlots, false, kCore, kVisits>(
        qn, recw, leaf_k, mine, cam.ox, cam.oy, cam.oz, dx, dy, dz, best_init, entry);
  } else {
    return rt::traverse_ray<kSlots, false, kVisits, kCore>(
        qn, recw, leaf_k, cam.ox, cam.oy, cam.oz, dx, dy, dz, best_init, entry);
  }
}

// The pixel (in the window, or in its frame of a batch) of this thread: a
// render core runs blocks of kBlock × kBlock threads; a warp-leaves core
// runs the same 8×8 patch as one dimension of kBlockThreads threads, row
// after row, because its leaf tests take a lane's index in the warp as
// threadIdx.x & 31 (rt::warp_nearest, the steps' serving lane). A warp is
// the same 8×4 pixels either way.
template <unsigned kCore>
__device__ __forceinline__ int2 thread_pixel() {
  if constexpr ((kCore & rt::kWarpLeaves) != 0) {
    return make_int2(blockIdx.x * kBlock + (int)(threadIdx.x % kBlock),
                     blockIdx.y * kBlock + (int)(threadIdx.x / kBlock));
  } else {
    return make_int2(blockIdx.x * blockDim.x + threadIdx.x, blockIdx.y * blockDim.y + threadIdx.y);
  }
}

// The block a launch of core C runs (thread_pixel).
template <unsigned C>
dim3 block_of() {
  return (C & rt::kWarpLeaves) != 0 ? dim3(kBlockThreads) : dim3(kBlock, kBlock);
}

// Whether the kernel's thread for pixel (px, py) goes on: a pixel in the
// window, or under a warp-leaves core any lane of a warp that has one (the
// warp traverses together; only the window's lanes store).
template <unsigned kCore>
__device__ __forceinline__ bool takes_part(bool mine) {
  if constexpr ((kCore & rt::kWarpLeaves) != 0) {
    return __any_sync(rt::kWarpMask, mine);
  } else {
    return mine;
  }
}

template <bool kVisits>
__device__ __forceinline__ void store_hit(const rt::Hit& hit, size_t p, float* __restrict__ t_out,
                                          float* __restrict__ nx_out,
                                          float* __restrict__ ny_out,
                                          float* __restrict__ nz_out,
                                          int* __restrict__ tri_out,
                                          float* __restrict__ visits_out) {
  t_out[p] = hit.t;
  nx_out[p] = hit.nx;
  ny_out[p] = hit.ny;
  nz_out[p] = hit.nz;
  tri_out[p] = hit.tri;
  if (kVisits) visits_out[p] = (float)hit.visits;
}

constexpr int kTile = 32;  // pixels a side of the tile that shares a bound and an entry

// kBounded (K1d): `tbounds` and `entries` are (⌈height/32⌉, tiles_x) tables of
// the window's tiles; an entry outside [0, num_nodes) is clamped into it.
template <int kSlots, bool kJitter, bool kVisits, bool kBounded, unsigned kCore>
__global__ void __launch_bounds__(kBlockThreads)
trace_tiles_kernel(const float* __restrict__ qn, int recw, int leaf_k, Camera cam,
                   int seed, int width, int height, int row_off, int col_off,
                   const float* __restrict__ tbounds, const int* __restrict__ entries,
                   int tiles_x, int num_nodes, float* __restrict__ t_out,
                   float* __restrict__ nx_out, float* __restrict__ ny_out,
                   float* __restrict__ nz_out, int* __restrict__ tri_out,
                   float* __restrict__ visits_out) {
  const int2 pix = thread_pixel<kCore>();
  const int px = pix.x, py = pix.y;
  const bool mine = px < width && py < height;
  if (!takes_part<kCore>(mine)) return;
  constexpr bool kAll = (kCore & rt::kWarpLeaves) == 0;  // every thread left is in the window
  float best_init = rt::kInf;
  int entry = 0;
  if (kBounded && (kAll || mine)) {
    const int tile = (py / kTile) * tiles_x + px / kTile;
    best_init = __ldg(tbounds + tile);
    entry = min(max(__ldg(entries + tile), 0), num_nodes - 1);
  }
  const rt::Hit hit = trace_primary<kSlots, kJitter, kVisits, kCore>(
      qn, recw, leaf_k, cam, seed, px + col_off, py + row_off, best_init, entry, mine);
  if (kAll || mine) {
    store_hit<kVisits>(hit, (size_t)py * (size_t)width + (size_t)px, t_out, nx_out, ny_out,
                       nz_out, tri_out, visits_out);
  }
}

constexpr int kTileWords = kTile * kTile;  // a tile plane of the raw layout
constexpr int kRawPlanes = 6;

// The frame batch: frame blockIdx.z, its camera from row blockIdx.z of `cams`.
// kRaw: `t_out` is the (F, tiles, 6, 1024) raw layout (width and height
// multiples of 32) and the other outputs are unused.
template <int kSlots, bool kJitter, bool kVisits, bool kRaw, unsigned kCore>
__global__ void __launch_bounds__(kBlockThreads)
trace_tiles_batch_kernel(const float* __restrict__ qn, int recw, int leaf_k,
                         const float* __restrict__ cams, int width, int height,
                         float* __restrict__ t_out, float* __restrict__ nx_out,
                         float* __restrict__ ny_out, float* __restrict__ nz_out,
                         int* __restrict__ tri_out, float* __restrict__ visits_out) {
  const int2 pix = thread_pixel<kCore>();
  const int px = pix.x, py = pix.y;
  const bool mine = px < width && py < height;
  if (!takes_part<kCore>(mine)) return;
  // the row's columns (rt::CamCol)
  const float* row = cams + (size_t)blockIdx.z * rt::kCamCols;
  const Camera cam{row[rt::kOx],     row[rt::kOx + 1], row[rt::kOx + 2], row[rt::kQx],
                   row[rt::kQx + 1], row[rt::kQx + 2], row[rt::kQx + 3], row[rt::kFocal],
                   row[rt::kAspect], row[rt::kFw],     row[rt::kFh]};
  const rt::Hit hit = trace_primary<kSlots, kJitter, kVisits, kCore>(
      qn, recw, leaf_k, cam, (int)row[rt::kSeed], px + (int)row[rt::kColOff],
      py + (int)row[rt::kRowOff], rt::kInf, 0, mine);
  if ((kCore & rt::kWarpLeaves) != 0 && !mine) return;  // a helper lane stores nothing
  if (kRaw) {
    const int tiles_x = width / kTile;
    const size_t tile =
        (size_t)blockIdx.z * (size_t)(tiles_x * (height / kTile)) + (py / kTile) * tiles_x +
        px / kTile;
    float* w = t_out + tile * (kRawPlanes * kTileWords) + (py % kTile) * kTile + px % kTile;
    w[0] = hit.t;
    w[kTileWords] = hit.nx;
    w[2 * kTileWords] = hit.ny;
    w[3 * kTileWords] = hit.nz;
    w[4 * kTileWords] = (float)hit.tri;
    w[5 * kTileWords] = kVisits ? (float)hit.visits : 0.0f;
    return;
  }
  const size_t p = ((size_t)blockIdx.z * (size_t)height + (size_t)py) * (size_t)width + px;
  store_hit<kVisits>(hit, p, t_out, nx_out, ny_out, nz_out, tri_out, visits_out);
}

#define RT_TILE_PARAMS                                                                      \
  dim3 grid, cudaStream_t s, const float *qnodes, int recw, int leaf_k, Camera cam,        \
      int seed, int width, int height, int row_off, int col_off,                \
      const float *tbounds, const int *entries, int tiles_x, int num_nodes, float *t,       \
      float *nx, float *ny, float *nz, int *tri, float *visits
#define RT_TILE_ARGS                                                                        \
  grid, s, qnodes, recw, leaf_k, cam, seed, width, height, row_off, col_off, tbounds, \
      entries, tiles_x, num_nodes, t, nx, ny, nz, tri, visits
#define RT_BATCH_PARAMS                                                                     \
  dim3 grid, cudaStream_t s, const float *qnodes, int recw, int leaf_k, const float *cams, \
      int width, int height, float *t, float *nx, float *ny, float *nz,  \
      int *tri, float *visits
#define RT_BATCH_ARGS \
  grid, s, qnodes, recw, leaf_k, cams, width, height, t, nx, ny, nz, tri, visits

// Launch one instantiation.
template <int S, bool J, bool V, bool B, unsigned C>
int launch_tiles(RT_TILE_PARAMS) {
  const dim3 block = block_of<C>();
  trace_tiles_kernel<S, J, V, B, C><<<grid, block, 0, s>>>(
      qnodes, recw, leaf_k, cam, seed, width, height, row_off, col_off, tbounds, entries,
      tiles_x, num_nodes, t, nx, ny, nz, tri, visits);
  return (int)cudaGetLastError();
}

template <int S, bool J, bool V, unsigned C, bool R = false>
int launch_batch(RT_BATCH_PARAMS) {
  const dim3 block = block_of<C>();
  trace_tiles_batch_kernel<S, J, V, R, C><<<grid, block, 0, s>>>(
      qnodes, recw, leaf_k, cams, width, height, t, nx, ny, nz, tri, visits);
  return (int)cudaGetLastError();
}

// The instantiation that the run-time jitter / visits / bounds name.
template <int S, unsigned C>
int dispatch_tiles(bool jitter, bool with_visits, bool bounded, RT_TILE_PARAMS) {
#define RT_JVB(J, V)                                                             \
  (bounded ? launch_tiles<S, J, V, true, C>(RT_TILE_ARGS)                        \
           : launch_tiles<S, J, V, false, C>(RT_TILE_ARGS))
  if (jitter) return with_visits ? RT_JVB(true, true) : RT_JVB(true, false);
  return with_visits ? RT_JVB(false, true) : RT_JVB(false, false);
#undef RT_JVB
}

template <int S, unsigned C, bool R = false>
int dispatch_batch(bool jitter, bool with_visits, RT_BATCH_PARAMS) {
  if (jitter) {
    return with_visits ? launch_batch<S, true, true, C, R>(RT_BATCH_ARGS)
                       : launch_batch<S, true, false, C, R>(RT_BATCH_ARGS);
  }
  return with_visits ? launch_batch<S, false, true, C, R>(RT_BATCH_ARGS)
                     : launch_batch<S, false, false, C, R>(RT_BATCH_ARGS);
}

// The cores the tile launchers build, each for every variant at both
// widths: what ops/cuda/traverse.py::tile_plan returns. The render core
// (K = 1) and, in the RT_TILES_WARP part, rt::kTileCore (K > 1), without
// rt::kPackSlots from K = 32 on, where the slots' own runs won (as in
// traverse_rays.cu).
#if RT_TILES_WARP
#define RT_TILE_CORES(X) X(rt::kTileCore) X((rt::kTileCore & ~rt::kPackSlots))
#else
#define RT_TILE_CORES(X) X(rt::kRenderCore)
#endif

}  // namespace

// Launch K1a (jitter = 0) or K1b (jitter != 0, subpixel seed `seed`) on
// `stream`; with slots = 8 the same on 8-wide records (K1e); with a `visits`
// plane, K1f; with `tbounds` and `entries`, K1d: both null, or both device
// tables of (⌈height/32⌉, ⌈width/32⌉) f32 / int32, the start values of each
// 32×32-pixel tile of the window. qnodes: (num_nodes, recw) f32, 16-byte
// aligned rows of `slots` (4 or 8) child slots; outputs: (height, width)
// planes of the window at (row_off, col_off) of a rg_width × rg_height frame
// (focal and aspect are the frame's); visits: a sixth f32 plane or null.
// `core`: one of the masks of this part's RT_TILE_CORES, as tile_plan
// gives it. Returns cudaGetLastError() after the launch (0 on success, or
// cudaErrorInvalidValue for another slot count, only one of the two tables,
// or another core); synchronises nothing.
extern "C" int rt_trace_tiles(const float* qnodes, int num_nodes, int recw, int leaf_k,
                              int slots, float ox, float oy, float oz, float qx, float qy,
                              float qz, float qw,
                              float focal, float aspect, int rg_width, int rg_height,
                              int row_off, int col_off, int width, int height, int jitter,
                              int seed, const float* tbounds, const int* entries, int core,
                              float* t, float* nx, float* ny, float* nz, int* tri, float* visits,
                              void* stream) {
  if (slots != 4 && slots != 8) return (int)cudaErrorInvalidValue;
  if ((tbounds == nullptr) != (entries == nullptr)) return (int)cudaErrorInvalidValue;
  const bool bounded = tbounds != nullptr, with_visits = visits != nullptr;
  const Camera cam{ox, oy, oz, qx, qy, qz, qw, focal, aspect,
                   (float)rg_width, (float)rg_height};
  const dim3 grid((width + kBlock - 1) / kBlock, (height + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (width + kTile - 1) / kTile;
  const bool j = jitter != 0;
#define RT_CASE(C)                                                          \
  case C:                                                                   \
    return slots == 8 ? dispatch_tiles<8, C>(j, with_visits, bounded, RT_TILE_ARGS) \
                      : dispatch_tiles<4, C>(j, with_visits, bounded, RT_TILE_ARGS);
  switch ((unsigned)core) {
    RT_TILE_CORES(RT_CASE)
    default:
      break;
  }
#undef RT_CASE
  return (int)cudaErrorInvalidValue;
}

// Launch the frame batch on `stream` (K1c; K1e with slots = 8; K1f with a
// `visits` plane): `num_frames` frames of width × height pixels, frame f
// from row f of `cams` ((num_frames, 16) f32 on the device: origin,
// quaternion xyzw, focal, aspect, raygen W and H, jitter seed, row and column
// offset of the window in that frame, 2 unused), jittered when `jitter` != 0.
// Outputs: (num_frames, height, width) planes; visits: a sixth f32 plane or
// null. `core`: one of the masks of this part's RT_TILE_CORES. Returns
// cudaGetLastError() after the launch (0 on success, or
// cudaErrorInvalidValue for another slot count or core); synchronises
// nothing.
extern "C" int rt_trace_tiles_batch(const float* qnodes, int recw, int leaf_k, int slots,
                                    const float* cams, int num_frames, int width, int height,
                                    int jitter, int core, float* t, float* nx, float* ny,
                                    float* nz, int* tri, float* visits, void* stream) {
  if (slots != 4 && slots != 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((width + kBlock - 1) / kBlock, (height + kBlock - 1) / kBlock, num_frames);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool j = jitter != 0, with_visits = visits != nullptr;
#define RT_CASE(C)                                                      \
  case C:                                                               \
    return slots == 8 ? dispatch_batch<8, C>(j, with_visits, RT_BATCH_ARGS) \
                      : dispatch_batch<4, C>(j, with_visits, RT_BATCH_ARGS);
  switch ((unsigned)core) {
    RT_TILE_CORES(RT_CASE)
    default:
      break;
  }
#undef RT_CASE
  return (int)cudaErrorInvalidValue;
}

// Launch the frame batch in the raw tile layout on `stream` (K1c raw; K1e
// raw with slots = 8; K1f raw with `stats` != 0, whose plane 5 holds the
// visits): `num_frames` frames of width × height pixels, both multiples of
// 32, cameras as for rt_trace_tiles_batch (each frame whole: offsets 0).
// `core`: one of the masks of this part's RT_TILE_CORES.
// out: (num_frames, width/32 · height/32, 6, 1024) f32, every word written.
// Returns cudaGetLastError() after the launch (0 on success, or
// cudaErrorInvalidValue for another slot count, core, or a size that is not
// a multiple of 32); synchronises nothing.
extern "C" int rt_trace_tiles_batch_raw(const float* qnodes, int recw, int leaf_k, int slots,
                                        const float* cams, int num_frames, int width, int height,
                                        int jitter, int stats, int core, float* out,
                                        void* stream) {
  if (slots != 4 && slots != 8) return (int)cudaErrorInvalidValue;
  if (width <= 0 || height <= 0 || width % kTile != 0 || height % kTile != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(width / kBlock, height / kBlock, num_frames);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool j = jitter != 0, with_visits = stats != 0;
  float* t = out;
  float *nx = nullptr, *ny = nullptr, *nz = nullptr, *visits = nullptr;
  int* tri = nullptr;
#define RT_CASE(C)                                                            \
  case C:                                                                     \
    return slots == 8 ? dispatch_batch<8, C, true>(j, with_visits, RT_BATCH_ARGS) \
                      : dispatch_batch<4, C, true>(j, with_visits, RT_BATCH_ARGS);
  switch ((unsigned)core) {
    RT_TILE_CORES(RT_CASE)
    default:
      break;
  }
#undef RT_CASE
  return (int)cudaErrorInvalidValue;
}
