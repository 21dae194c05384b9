// The progressive sample's wave glue — the per-lane shading between a
// sample's traversal waves, two launches a wave.
//
// Replaces no TPU kernel. The JAX package's pt_sample_frame
// (raytracer_tpu/render_pt.py) shades each wave with array ops that XLA
// fuses. The port's plain version of that shading
// (raytracer_tpu_torch/ops/cuda/wave.py::wave_hit_reference,
// wave_bounce_reference, wave_last_reference) is ≈ 70 small torch ops a
// wave: masks, torch.where updates, the stacks of the normals and of the
// Frisvad basis. Launching those ops on the host, and their round trips
// through device memory, took more of a 1920×1080 sample than K1 and K2
// together (PERF.md §5). Two kernels compute the same numbers, lane l of R:
//
//   wave_hit_kernel, after each closest-hit wave (K1b through camera_lanes,
//   K2a, or the brute-force tracer): the normal n turned to face d (negated
//   where n·d > 0, ops/lanes.py::face), hit = tri ≥ 0 and alive, the
//   radiance plus throughput·env where a live lane missed, the shadow
//   origin p = (o + d·t) + n·eps, ndotl = max(n·sun, 0) and the NEE mask
//   hit and ndotl > 0, which the any-hit wave K2b takes as its active lanes;
//
//   wave_bounce_kernel, after each NEE wave K2b: the radiance plus
//   throughput·(base·(ndotl·unoccluded)) where hit (occluded: K2b's
//   triangle ≥ 0); then a cosine-weighted direction around n from the
//   draws u1, u2 (the Frisvad basis), and o, d, throughput and alive of
//   the next wave. On the sample's last wave it instead adds the sky term
//   of the paths still alive and writes only the radiance: to each lane's
//   pixel of the (H, W, 3) image (the inverse of lane_of_pixel, lanes.cuh),
//   or in lane order where the lanes were compacted.
//
// What bounds it on the card: bytes. A lane reads and writes ≈ 110 B in
// each kernel (its 3-vectors of 12 B, its planes of 4 B, its masks of 1 B):
// the two kernels of a 1080p wave move ≈ 0.46 GB, ≈ 0.14 ms at 3.35 TB/s.
// A lane does a few dozen flops and one sinf and cosf.
//
// What the design does about it: one thread a lane, 1-D blocks of 256
// threads, each input read once and each output written once, every
// intermediate in registers; a lane that did not hit reads neither n nor p
// in the bounce kernel, nor draws its direction.
//
// Exactness: each value is the plain version's on the card bit for bit
// (value for value where a sum is ±0). Every torch op there rounds once,
// so this source performs the same IEEE operations in the same order,
// built with -fmad=false and no fast math (ops/cuda/build.py): n·d and
// n·sun are summed as (x + z) + y, the order of torch's CUDA sum of a row
// of three; -1.0 / x is torch's x.reciprocal() * -1.0; Python scalars
// multiply as f32 (2π·u2 is f32(2π)·u2); sqrtf, sinf and cosf are the IEEE
// functions torch's CUDA ops call; clamp_min keeps a NaN.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace {

constexpr int kThreads = 256;  // threads a block, one a lane
// Python's 2.0 * math.pi, as torch rounds a Python scalar for an f32 tensor
constexpr float kTwoPi = (float)6.283185307179586;

struct V3 {
  float x, y, z;
};

// the three words from element i on
__device__ __forceinline__ V3 load3(const float* __restrict__ a, size_t i) {
  return {__ldg(a + i), __ldg(a + i + 1), __ldg(a + i + 2)};
}

__device__ __forceinline__ void store3(float* __restrict__ a, size_t i, V3 v) {
  a[i] = v.x;
  a[i + 1] = v.y;
  a[i + 2] = v.z;
}

// torch.clamp_min(v, 0.0) on CUDA: a NaN stays.
__device__ __forceinline__ float clamp_min0(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

__global__ void __launch_bounds__(kThreads)
wave_hit_kernel(int lanes, const float* __restrict__ t, const int* __restrict__ tri,
                const float* __restrict__ nx, const float* __restrict__ ny,
                const float* __restrict__ nz, int n_stride, const float* __restrict__ o,
                int o_stride, const float* __restrict__ d, const uint8_t* __restrict__ alive,
                const float* __restrict__ throughput, const float* __restrict__ radiance,
                float sun_x, float sun_y, float sun_z, float env, float eps,
                float* __restrict__ n_out, uint8_t* __restrict__ hit_out,
                float* __restrict__ radiance_out, float* __restrict__ p_out,
                float* __restrict__ ndotl_out, uint8_t* __restrict__ nee_out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const size_t l = (size_t)lane;
  const size_t ln = l * (size_t)n_stride;
  const V3 dl = load3(d, 3 * l);
  V3 n = {__ldg(nx + ln), __ldg(ny + ln), __ldg(nz + ln)};
  const float dot = (n.x * dl.x + n.z * dl.z) + n.y * dl.y;
  const float flip = dot > 0.0f ? -1.0f : 1.0f;
  n = {n.x * flip, n.y * flip, n.z * flip};

  const bool live = __ldg(alive + l) != 0;
  const int tri_l = __ldg(tri + l);
  const bool hit = tri_l >= 0 && live;
  const bool miss = tri_l < 0 && live;
  const V3 thr = load3(throughput, 3 * l);
  V3 rad = load3(radiance, 3 * l);
  rad = {rad.x + (miss ? thr.x * env : 0.0f), rad.y + (miss ? thr.y * env : 0.0f),
         rad.z + (miss ? thr.z * env : 0.0f)};

  const float tl = __ldg(t + l);
  const V3 ol = load3(o, l * (size_t)o_stride);
  const V3 p = {(ol.x + dl.x * tl) + n.x * eps, (ol.y + dl.y * tl) + n.y * eps,
                (ol.z + dl.z * tl) + n.z * eps};
  const float ndotl = clamp_min0((n.x * sun_x + n.z * sun_z) + n.y * sun_y);

  store3(n_out, 3 * l, n);
  hit_out[l] = hit;
  store3(radiance_out, 3 * l, rad);
  store3(p_out, 3 * l, p);
  ndotl_out[l] = ndotl;
  nee_out[l] = hit && ndotl > 0.0f;
}

__global__ void __launch_bounds__(kThreads)
wave_bounce_kernel(int lanes, int last, int width, int height, const int* __restrict__ occ,
                   const uint8_t* __restrict__ hit_in, const float* __restrict__ ndotl,
                   const float* __restrict__ throughput, const float* __restrict__ radiance,
                   const float* __restrict__ n_in, const float* __restrict__ p_in,
                   const float* __restrict__ o, int o_stride, const float* __restrict__ d,
                   const float* __restrict__ u1, const float* __restrict__ u2, float base_x,
                   float base_y, float base_z, float sky, float* __restrict__ o_out,
                   float* __restrict__ d_out, float* __restrict__ throughput_out,
                   uint8_t* __restrict__ alive_out, float* __restrict__ radiance_out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const size_t l = (size_t)lane;
  const bool hit = __ldg(hit_in + l) != 0;
  // direct light: base · (ndotl · unoccluded) where hit
  const float m = __ldg(ndotl + l) * (__ldg(occ + l) >= 0 ? 0.0f : 1.0f);
  const V3 direct = {base_x * m, base_y * m, base_z * m};
  const V3 thr = load3(throughput, 3 * l);
  V3 rad = load3(radiance, 3 * l);
  rad = {rad.x + (hit ? thr.x * direct.x : 0.0f), rad.y + (hit ? thr.y * direct.y : 0.0f),
         rad.z + (hit ? thr.z * direct.z : 0.0f)};
  const V3 thr_next = hit ? V3{thr.x * base_x, thr.y * base_y, thr.z * base_z} : thr;

  if (last) {
    // the paths still alive after the last bounce collect the sky
    rad = {rad.x + (hit ? thr_next.x * sky : 0.0f), rad.y + (hit ? thr_next.y * sky : 0.0f),
           rad.z + (hit ? thr_next.z * sky : 0.0f)};
    size_t row = l;
    if (width > 0) {
      int x, y;
      rt::pixel_of_lane(lane, width, height, x, y);
      row = (size_t)y * (size_t)width + (size_t)x;
    }
    store3(radiance_out, 3 * row, rad);
    return;
  }

  V3 o_next, d_next;
  if (hit) {
    // a cosine-weighted direction around n (render_pt's _cosine_sample)
    const float a1 = __ldg(u1 + l), a2 = __ldg(u2 + l);
    const float r = sqrtf(a1);
    const float phi = kTwoPi * a2;
    const float x = r * cosf(phi);
    const float y = r * sinf(phi);
    const float z = sqrtf(clamp_min0(1.0f - a1));
    // the orthonormal basis around n (Frisvad-style, branchless: _onb)
    const V3 n = load3(n_in, 3 * l);
    const float s = n.z >= 0.0f ? 1.0f : -1.0f;
    const float a = (1.0f / (s + n.z)) * -1.0f;
    const float b = (n.x * n.y) * a;
    const V3 tb = {1.0f + (s * (n.x * n.x)) * a, s * b, -s * n.x};
    const V3 bt = {b, s + (n.y * n.y) * a, -n.y};
    d_next = {(tb.x * x + bt.x * y) + n.x * z, (tb.y * x + bt.y * y) + n.y * z,
              (tb.z * x + bt.z * y) + n.z * z};
    o_next = load3(p_in, 3 * l);
  } else {
    d_next = load3(d, 3 * l);
    o_next = load3(o, l * (size_t)o_stride);
  }
  store3(o_out, 3 * l, o_next);
  store3(d_out, 3 * l, d_next);
  store3(throughput_out, 3 * l, thr_next);
  alive_out[l] = hit;
  store3(radiance_out, 3 * l, rad);
}

int blocks(int lanes) { return (lanes + kThreads - 1) / kThreads; }

bool bad_lanes(int lanes) { return lanes <= 0 || lanes > 0x7FFFFFFF - kThreads; }

}  // namespace

// Launch the hit kernel on `stream` over `lanes` lanes: the closest-hit
// wave's t (f32) and tri (int32) planes; its normals as three f32 planes
// read at element stride `n_stride` (1: K2a's planes; 3: the columns of an
// (R, 3) array); o (R, 3) f32 at row stride `o_stride` (3, or 0 where every
// lane starts at the camera); d, throughput and radiance (R, 3) f32; alive
// (R,) bool; the sun's direction, the miss term env and the offset eps → n
// (R, 3), hit (R,) bool, radiance (R, 3), p (R, 3), ndotl (R,) f32 and nee
// (R,) bool. Returns cudaGetLastError() after the launch (0 on success, or
// cudaErrorInvalidValue for no lanes or 2^31 or more); synchronises nothing.
extern "C" int rt_wave_hit(int lanes, const float* t, const int* tri, const float* nx,
                           const float* ny, const float* nz, int n_stride, const float* o,
                           int o_stride, const float* d, const uint8_t* alive,
                           const float* throughput, const float* radiance, float sun_x,
                           float sun_y, float sun_z, float env, float eps, float* n,
                           uint8_t* hit, float* radiance_out, float* p, float* ndotl,
                           uint8_t* nee, void* stream) {
  if (bad_lanes(lanes) || (o_stride != 0 && o_stride != 3)) return (int)cudaErrorInvalidValue;
  wave_hit_kernel<<<blocks(lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lanes, t, tri, nx, ny, nz, n_stride, o, o_stride, d, alive, throughput, radiance, sun_x,
      sun_y, sun_z, env, eps, n, hit, radiance_out, p, ndotl, nee);
  return (int)cudaGetLastError();
}

// Launch the bounce kernel on `stream` over `lanes` lanes: K2b's triangle
// plane occ (int32, ≥ 0 where the shadow ray is blocked), the hit kernel's
// hit, ndotl, n and p, the wave's throughput, radiance, o (row stride
// `o_stride`, 3 or 0) and d, the draws u1 and u2 (R,) f32, the albedo base
// and the sky's radiance → o, d, throughput (R, 3), alive (R,) bool and
// radiance (R, 3) of the next wave. With `last` != 0 it writes the
// radiance alone, the sky term added, in lane order where width is 0, else
// to the pixels of the width × height image (R = width · height; o, d, n,
// p, u1, u2 and the other outputs are not read or written and may be
// null). Returns cudaGetLastError() after the launch; synchronises nothing.
extern "C" int rt_wave_bounce(int lanes, int last, int width, int height, const int* occ,
                              const uint8_t* hit, const float* ndotl, const float* throughput,
                              const float* radiance, const float* n, const float* p,
                              const float* o, int o_stride, const float* d, const float* u1,
                              const float* u2, float base_x, float base_y, float base_z,
                              float sky, float* o_out, float* d_out, float* throughput_out,
                              uint8_t* alive_out, float* radiance_out, void* stream) {
  if (bad_lanes(lanes) || (o_stride != 0 && o_stride != 3) ||
      (last && width > 0 && (long long)width * height != lanes)) {
    return (int)cudaErrorInvalidValue;
  }
  wave_bounce_kernel<<<blocks(lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lanes, last, width, height, occ, hit, ndotl, throughput, radiance, n, p, o, o_stride, d,
      u1, u2, base_x, base_y, base_z, sky, o_out, d_out, throughput_out, alive_out,
      radiance_out);
  return (int)cudaGetLastError();
}
