// The camera wave's lanes — the set-up of a progressive sample's first wave
// after K1b, in one launch.
//
// Replaces no TPU kernel. The JAX package's pt_sample_frame
// (raytracer_tpu/render_pt.py) makes the camera wave's jittered rays and puts
// K1b's planes in the 32×32 tile-block lane order with array ops that XLA
// fuses. The port's plain version of that set-up
// (raytracer_tpu_torch/ops/cuda/camera.py::camera_lanes_reference:
// generate_rays_jittered, img_to_lanes of the directions and of the five
// planes, the normals turned to face the rays) is ≈ 290 small torch ops a
// 1920×1080 sample: the hash in masked int64 arithmetic, a scatter for each
// plane where the frame is no multiple of 32, the stacks. Launching
// those ops on the host, not their device time, held the card idle (PERF.md §5). This
// kernel computes the same four outputs, lane l of R = W·H:
//   d[l]   the unit direction of the jittered primary ray of l's pixel, as
//          K1b (traverse_tiles.cu, jitter seed `seed`) traced it;
//   t[l], tri[l]   K1b's t and triangle planes at that pixel;
//   n[l]   K1b's normal at that pixel turned to face d[l]: negated where
//          n·d > 0, left as it is where n·d is 0 (ops/lanes.py::face).
//
// What bounds it on the card: bytes. A lane reads its pixel's five plane
// words (20 B) and writes 32 B: 108 MB at 1920×1080, ≈ 0.03 ms at 3.35 TB/s.
// The hash, the direction and the lane → pixel inverse are a few dozen
// instructions a lane.
//
// What the design does about it: one thread a lane, 1-D blocks of 256
// threads. The thread inverts its lane to its pixel (the inverse of
// ops/lanes.py::lane_of_pixel, partial blocks at the bottom and right edges
// included), so in a full 32×32 block the 32 lanes of a warp are one row of
// 32 pixels: the plane reads are 128-byte coalesced and the lane-major
// writes contiguous.
//
// Exactness: the direction is raygen.cuh's, the function K1b traces with,
// so d is K1b's ray bit for bit, and the plain version's (ops/camera.py
// performs the same IEEE operations in the same order). n·d is summed as
// (nx·dx + nz·dz) + ny·dy, the order ops/lanes.py::face states, so where
// the sum cancels its sign, and the flip, is the plain version's too.
// The source builds with -fmad=false and no fast math (ops/cuda/build.py).
//
// The camera (quaternion, focal, aspect) and the jitter seed are read, when
// the kernel runs, from the sample's camera row on the device (raygen.cuh's
// rt::CamCol; render_pt.py builds it, and K1c traced the planes from it), so
// that a CUDA graph that holds the launch (render_pt.SampleGraphs) serves
// every camera and seed. The seed is the row's f32 converted to int, as K1c
// converts it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"
#include "raygen.cuh"

namespace {

constexpr int kThreads = 256;  // threads a block, one a lane

__global__ void __launch_bounds__(kThreads)
camera_lanes_kernel(const float* __restrict__ row, int width, int height,
                    const float* __restrict__ t_img,
                    const float* __restrict__ nx_img, const float* __restrict__ ny_img,
                    const float* __restrict__ nz_img, const int* __restrict__ tri_img,
                    float* __restrict__ d_out, float* __restrict__ t_out,
                    int* __restrict__ tri_out, float* __restrict__ n_out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= width * height) return;
  const float qx = __ldg(row + rt::kQx), qy = __ldg(row + rt::kQx + 1);
  const float qz = __ldg(row + rt::kQx + 2), qw = __ldg(row + rt::kQx + 3);
  const float focal = __ldg(row + rt::kFocal), aspect = __ldg(row + rt::kAspect);
  const int seed = (int)__ldg(row + rt::kSeed);
  int x, y;
  rt::pixel_of_lane(lane, width, height, x, y);
  const size_t p = (size_t)y * (size_t)width + (size_t)x;

  float dx, dy, dz;
  rt::primary_dir(x, y, rt::subpixel_hash01(x, y, seed * 2),
                  rt::subpixel_hash01(x, y, seed * 2 + 1), (float)width, (float)height, focal,
                  aspect, qx, qy, qz, qw, dx, dy, dz);
  const float nx = __ldg(nx_img + p), ny = __ldg(ny_img + p), nz = __ldg(nz_img + p);
  const float dot = (nx * dx + nz * dz) + ny * dy;
  const float flip = dot > 0.0f ? -1.0f : 1.0f;

  const size_t l = (size_t)lane;
  d_out[3 * l] = dx;
  d_out[3 * l + 1] = dy;
  d_out[3 * l + 2] = dz;
  n_out[3 * l] = nx * flip;
  n_out[3 * l + 1] = ny * flip;
  n_out[3 * l + 2] = nz * flip;
  t_out[l] = __ldg(t_img + p);
  tri_out[l] = __ldg(tri_img + p);
}

}  // namespace

// Launch the camera wave's lanes on `stream`: K1b's (height, width) planes
// t, nx, ny, nz (f32) and tri (int32) of a whole width × height frame traced
// from `row`, a camera row of 16 f32 on the device (rt::CamCol: the
// quaternion, the frame's focal and aspect, the jitter seed) → d (R, 3),
// t_out (R,), tri_out (R,) and n (R, 3) in tile-block lane order,
// R = width · height. Returns cudaGetLastError() after the launch (0 on
// success, or cudaErrorInvalidValue for an empty frame or one of 2^31 lanes
// or more); synchronises nothing.
extern "C" int rt_camera_lanes(const float* row, int width, int height, const float* t,
                               const float* nx, const float* ny, const float* nz, const int* tri,
                               float* d, float* t_out, int* tri_out, float* n, void* stream) {
  if (width <= 0 || height <= 0 || (long long)width * height > 0x7FFFFFFFLL - kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const int lanes = width * height;
  camera_lanes_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      row, width, height, t, nx, ny, nz, tri, d, t_out, tri_out, n);
  return (int)cudaGetLastError();
}
