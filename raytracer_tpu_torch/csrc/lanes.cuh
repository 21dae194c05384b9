// The lanes of a progressive sample: the 32×32 tile-block order of a
// frame's pixels (raytracer_tpu_torch/ops/lanes.py). The camera wave's
// lanes (camera_lanes.cu) read K1b's planes at each lane's pixel, and the
// last wave of a sample (wave_glue.cu) writes each lane's radiance to its
// pixel, both through this one inverse of ops/lanes.py::lane_of_pixel.
#pragma once

namespace rt {

constexpr int kLaneTile = 32;  // pixels a side of a block of the lane order

// The pixel (x, y) of tile-block lane `lane` of a width × height frame,
// partial blocks at the bottom and right edges included. A band of
// kLaneTile rows holds kLaneTile·width lanes; in it, the blocks before the
// lane's are kLaneTile wide and as high as the band. In a full block the 32
// lanes of a warp are one row of 32 pixels.
__device__ __forceinline__ void pixel_of_lane(int lane, int width, int height, int& x,
                                              int& y) {
  const int band = kLaneTile * width;
  const int by = lane / band;
  const int in_band = lane - by * band;
  const int block_h = min(height - by * kLaneTile, kLaneTile);
  const int bx = in_band / (kLaneTile * block_h);
  const int in_block = in_band - bx * kLaneTile * block_h;
  const int block_w = min(width - bx * kLaneTile, kLaneTile);
  y = by * kLaneTile + in_block / block_w;
  x = bx * kLaneTile + in_block % block_w;
}

}  // namespace rt
