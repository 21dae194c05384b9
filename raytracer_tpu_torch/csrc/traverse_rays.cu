// K2a / K2b — traversal of an arbitrary ray buffer through the supernode
// records: K2a closest hit (the bounce waves of path tracing), K2b any hit
// (the next-event-estimation shadow rays toward the sun).
// K2c — both on 8-wide records (the BVH8 of collapse_lbvh2_to_bvh8).
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
// scattered surface points.
//
// What the design does about it:
//  * One thread per ray in blocks of 128, with the per-ray traversal of
//    traverse_core.cuh (own 64-entry stack, near-first order by the ray's
//    own slab entry distance, culling at the best t, header and triangle
//    loads through __ldg). The caller keeps the rays in 32×32 tile-block
//    lane order, so the 32 threads of a warp come from neighbouring pixels:
//    coherent on the camera and NEE waves, as coherent as the scene allows
//    on bounce waves.
//  * An optional per-ray `active` mask: an inactive thread reads nothing of
//    its ray (which may hold inf or NaN) and writes the miss values. This is
//    the per-thread form of the TPU kernel's lane parking; the packet
//    machinery (streams, pad rays, stream-AABB ordering) exists there
//    because 1,024 lanes share one stack, and has no counterpart here.
//  * Any hit returns at the first accepted triangle, so an occluded shadow
//    ray ends its walk early.
//
// Exactness: the slab and Möller–Trumbore arithmetic of traverse_core.cuh,
// built with -fmad=false, in the operation order of the plain torch version
// (raytracer_tpu_torch/ops/cuda/traverse.py::trace_rays_reference).

#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse_core.cuh"

namespace {

template <int kSlots, bool kAnyHit>
__global__ void __launch_bounds__(128)
trace_rays_kernel(const float* __restrict__ qn, int recw, int leaf_k,
                  const float* __restrict__ orig, const float* __restrict__ dirs,
                  const uint8_t* __restrict__ active, int n,
                  float* __restrict__ t_out, float* __restrict__ nx_out,
                  float* __restrict__ ny_out, float* __restrict__ nz_out,
                  int* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rt::Hit hit{rt::kInf, 0.0f, 0.0f, 0.0f, -1, 0};
  if (active == nullptr || active[i] != 0) {
    const size_t r = 3 * (size_t)i;
    hit = rt::traverse_ray<kSlots, kAnyHit, false>(qn, recw, leaf_k, orig[r], orig[r + 1],
                                                   orig[r + 2], dirs[r], dirs[r + 1],
                                                   dirs[r + 2]);
  }
  t_out[i] = hit.t;
  nx_out[i] = hit.nx;
  ny_out[i] = hit.ny;
  nz_out[i] = hit.nz;
  tri_out[i] = hit.tri;
}

}  // namespace

// Launch K2a (any_hit = 0) or K2b (any_hit != 0) over n rays on `stream`;
// with slots = 8, K2c on 8-wide records. qnodes: (M, recw) f32, 16-byte
// aligned rows of `slots` (4 or 8) child slots; origins, dirs: (n, 3) f32;
// active: n bytes (0 = inactive) or null for all rays; outputs: (n,)
// planes. Returns cudaGetLastError() after the launch (0 on success, or
// cudaErrorInvalidValue for another slot count); synchronises nothing.
extern "C" int rt_trace_rays(const float* qnodes, int recw, int leaf_k, int slots,
                             const float* origins, const float* dirs, const uint8_t* active,
                             int n, int any_hit, float* t, float* nx, float* ny, float* nz,
                             int* tri, void* stream) {
  if (slots != 4 && slots != 8) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_LAUNCH_RAYS(SLOTS, ANY)                                                   \
  trace_rays_kernel<SLOTS, ANY><<<grid, block, 0, s>>>(qnodes, recw, leaf_k, origins, \
                                                       dirs, active, n, t, nx, ny, nz, tri)
  if (slots == 8) {
    if (any_hit) RT_LAUNCH_RAYS(8, true); else RT_LAUNCH_RAYS(8, false);
  } else {
    if (any_hit) RT_LAUNCH_RAYS(4, true); else RT_LAUNCH_RAYS(4, false);
  }
#undef RT_LAUNCH_RAYS
  return (int)cudaGetLastError();
}
