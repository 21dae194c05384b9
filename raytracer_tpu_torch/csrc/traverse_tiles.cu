// K1a — closest-hit primary-ray traversal of the supernode records, one
// frame, one ray per pixel.
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas/traverse.py::
// _persistent_kernel (with its per-visit core _consume) on the path of one
// frame, no jitter, 4-wide records, K triangles per leaf, and no per-tile
// entry nodes or depth bounds. It computes what
// trace_tiles_pallas(qnodes, pos, quat, W, H, fov, leaf_k=K)[:5] computes
// and writes the same five (H, W) planes. Like the TPU kernel it can trace
// a window of a larger frame (raygen_size with row/col offsets), which
// renders one band or crop with the full frame's rays.
//
// What bounds it on the card: every visit is a dependent fetch of one record
// (1,792 f32 words = 7,168 bytes at K = 32) through L1 and L2, and the
// records of the 871,200-triangle main-path scene (54,449 rows, ~390 MB)
// are far larger than the 50 MB L2, so a visit that misses waits on device
// memory before the next node is known.
//
// What the design does about it:
//  * One thread per pixel with its own 64-entry stack, in 8×8 blocks: the
//    32 rays of a warp are an 8×4 patch of neighbours that walk nearly the
//    same nodes, so their record loads hit the same L1/L2 lines.
//  * Only what a visit needs is read: the 32-word header as eight float4
//    loads, and the 12-word triangle records of a leaf slot only when the
//    ray's own slab test passes it, K of them at most, in float4 loads.
//  * Children are pushed far→near by the ray's own slab entry distance and
//    entries at or beyond the current best t are dropped at pop, so the
//    nearest surface is found first and the rest of the tree culls.
//
// The TPU kernel shares one stack among the 1,024 rays of a 32×32 tile and
// orders children by the tile-centre ray; ordering by each ray's own entry
// distance is the per-ray form of that and changes only the visit order.
//
// Exactness: built with -fmad=false and without fast math, and every
// expression is evaluated in the operation order of the plain torch version
// (raytracer_tpu_torch/ops/cuda/traverse.py::trace_tiles_reference) and of
// the TPU kernel: division and square root are IEEE (1.0f / sqrtf, not
// rsqrtf), so the two differ only where two triangles tie.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStackMax = 64;           // pushes beyond this are dropped
constexpr int kSlots = 4;               // child slots per record
constexpr float kInf = 1e30f;
constexpr float kMtEps = 1e-7f;
constexpr float kEmptyRef = -268435456.0f;  // -2^28: empty child slot

struct Camera {
  float ox, oy, oz;
  float qx, qy, qz, qw;
  float focal, aspect, fw, fh;
};

__device__ __forceinline__ float safe_inv(float d) {
  return fabsf(d) > 1e-8f ? 1.0f / d : kInf;
}

__global__ void __launch_bounds__(64)
trace_tiles_k1a(const float* __restrict__ qn, int recw, int leaf_k, Camera cam,
                int width, int height, int row_off, int col_off,
                float* __restrict__ t_out,
                float* __restrict__ nx_out, float* __restrict__ ny_out,
                float* __restrict__ nz_out, int* __restrict__ tri_out) {
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= width || py >= height) return;

  // ray generation: traverse.py:714-736, same f32 operation order
  const float u = ((float)(px + col_off) + 0.5f) / cam.fw * 2.0f - 1.0f;
  const float v = ((float)(py + row_off) + 0.5f) / cam.fh * 2.0f - 1.0f;
  float dx = u * cam.aspect;
  float dy = v;
  float dz = -cam.focal;
  const float inv_len = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx * inv_len;
  dy = dy * inv_len;
  dz = dz * inv_len;
  {
    const float uvx = cam.qy * dz - cam.qz * dy;
    const float uvy = cam.qz * dx - cam.qx * dz;
    const float uvz = cam.qx * dy - cam.qy * dx;
    const float uuvx = cam.qy * uvz - cam.qz * uvy;
    const float uuvy = cam.qz * uvx - cam.qx * uvz;
    const float uuvz = cam.qx * uvy - cam.qy * uvx;
    dx = 2.0f * (cam.qw * uvx + uuvx) + dx;
    dy = 2.0f * (cam.qw * uvy + uuvy) + dy;
    dz = 2.0f * (cam.qw * uvz + uuvz) + dz;
  }
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const float ox = cam.ox, oy = cam.oy, oz = cam.oz;

  const int vbase = 8 * kSlots;
  const int ibase = vbase + kSlots * 12 * leaf_k;

  float best = kInf, bnx = 0.0f, bny = 0.0f, bnz = 0.0f;
  int btri = -1;
  int stack_n[kStackMax];
  float stack_d[kStackMax];
  int sp = 0;
  stack_n[0] = 0;
  stack_d[0] = 0.0f;

  while (sp >= 0) {
    const int node = stack_n[sp];
    const float key = stack_d[sp];
    --sp;
    if (!(key < best)) continue;

    const float* rec = qn + (size_t)node * (size_t)recw;
    float h[32];  // [0:24] child boxes, [24:28] refs, [28:32] counts/radii
    const float4* hdr = reinterpret_cast<const float4*>(rec);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
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
      const float ref = h[24 + k];
      if (!(hit[k] && ref < 0.0f && ref > kEmptyRef)) continue;
      const float cnt = h[28 + k];
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
          bnx = c.y * g_inv;
          bny = c.z * g_inv;
          bnz = c.w * g_inv;
          btri = (int)__ldg(rec + ibase + k * leaf_k + j);
        }
      }
    }

    // internal slots that passed: push far→near by the slab entry distance
    // (a stable descending insertion sort, so equal keys keep slot order)
    int cand[kSlots];
    float ckey[kSlots];
    int nc = 0;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (hit[k] && h[24 + k] >= 0.0f) {
        const int cn = (int)h[24 + k];
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

  const size_t p = (size_t)py * (size_t)width + (size_t)px;
  t_out[p] = best;
  nx_out[p] = bnx;
  ny_out[p] = bny;
  nz_out[p] = bnz;
  tri_out[p] = btri;
}

}  // namespace

// Launch K1a on `stream`. qnodes: (M, recw) f32, 16-byte aligned rows;
// outputs: (height, width) planes of the window at (row_off, col_off) of a
// rg_width × rg_height frame (focal and aspect are the frame's). Returns
// cudaGetLastError() after the launch (0 on success); synchronises nothing.
extern "C" int rt_trace_tiles_k1a(const float* qnodes, int recw, int leaf_k,
                                  float ox, float oy, float oz, float qx, float qy,
                                  float qz, float qw, float focal, float aspect,
                                  int rg_width, int rg_height, int row_off,
                                  int col_off, int width, int height, float* t, float* nx,
                                  float* ny, float* nz, int* tri, void* stream) {
  const Camera cam{ox, oy, oz, qx, qy, qz, qw, focal, aspect,
                   (float)rg_width, (float)rg_height};
  const dim3 block(8, 8);
  const dim3 grid((width + 7) / 8, (height + 7) / 8);
  trace_tiles_k1a<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      qnodes, recw, leaf_k, cam, width, height, row_off, col_off, t, nx, ny, nz, tri);
  return (int)cudaGetLastError();
}
