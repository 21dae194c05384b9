// The primary ray of a pixel: the subpixel jitter hash and the unit
// direction. K1's tile kernels (traverse_tiles.cu::trace_primary) trace
// these rays and the camera wave's lanes (camera_lanes.cu) hand the same
// directions to the sample's later waves, so both include this one header
// and their directions are equal bit for bit by construction.
//
// Exactness: ray generation follows the TPU kernel (raytracer_tpu/ops/
// pallas/traverse.py:714-736) in the operation order of the plain torch
// version (raytracer_tpu_torch/ops/camera.py::primary_dirs), with IEEE
// 1.0f / sqrtf where the TPU kernel uses rsqrt; the sources build with
// -fmad=false, so no product is contracted into an FMA.
#pragma once

#include <stdint.h>

namespace rt {

// The columns of a camera row: a row of K1c's camera table
// (traverse_tiles.cu, the TPU kernel's (F, 16) layout: origin, quaternion
// xyzw, focal, aspect, raygen W and H, jitter seed, row and column offset of
// the window, 2 unused). A progressive sample's uniform block is one such
// row on the device (raytracer_tpu_torch/render_pt.py::uniform_block), with
// the running mean's sample count in the first unused column; the camera
// wave's lanes (camera_lanes.cu) read it too.
enum CamCol { kOx = 0, kQx = 3, kFocal = 7, kAspect = 8, kFw = 9, kFh = 10, kSeed = 11,
              kRowOff = 12, kColOff = 13, kCamCols = 16 };

// raytracer_tpu/ops/camera.py::subpixel_hash01 in uint32 arithmetic.
__device__ __forceinline__ float subpixel_hash01(int px, int py, int seed) {
  uint32_t h = (uint32_t)px * 0x9E3779B1u + (uint32_t)py * 0x85EBCA77u +
               (uint32_t)seed * 0xC2B2AE3Du;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return (float)(h >> 8) * 5.9604644775390625e-8f;  // 2^-24
}

// The unit direction of the ray through (gx + jx, gy + jy) of a fw × fh
// frame (focal and aspect as camera_constants gives them), rotated by the
// camera quaternion (qx, qy, qz, qw).
__device__ __forceinline__ void primary_dir(int gx, int gy, float jx, float jy, float fw,
                                            float fh, float focal, float aspect, float qx,
                                            float qy, float qz, float qw, float& dx, float& dy,
                                            float& dz) {
  const float u = ((float)gx + jx) / fw * 2.0f - 1.0f;
  const float v = ((float)gy + jy) / fh * 2.0f - 1.0f;
  dx = u * aspect;
  dy = v;
  dz = -focal;
  const float inv_len = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx * inv_len;
  dy = dy * inv_len;
  dz = dz * inv_len;
  const float uvx = qy * dz - qz * dy;
  const float uvy = qz * dx - qx * dz;
  const float uvz = qx * dy - qy * dx;
  const float uuvx = qy * uvz - qz * uvy;
  const float uuvy = qz * uvx - qx * uvz;
  const float uuvz = qx * uvy - qy * uvx;
  dx = 2.0f * (qw * uvx + uuvx) + dx;
  dy = 2.0f * (qw * uvy + uuvy) + dy;
  dz = 2.0f * (qw * uvz + uuvz) + dz;
}

}  // namespace rt
