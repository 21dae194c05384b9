// Microbenchmarks of the primitives a traversal is made of, on the H100:
// MB1 mb_walk, MB2 mb_scalar, MB3 mb_visit, MB4 mb_smem_probe.
//
// Replace the TPU microbenchmark kernels of tools/mb_kernel.py (k_loop,
// k_smem24, make_k_dma(...), k_mxu, k_bcast, k_reduce, launched by _run),
// tools/mb_kernel2.py (k_dma_smem_pipe, k_dma_smem_ser, k_consume, launched
// by run) and tools/mb_smem_probe.py (kern, launched by probe). Those
// measured what a TPU primitive costs per loop iteration: a scalar-indexed
// DMA of 512 B rows, scalar SMEM reads, sublane broadcasts, a lane
// reduction, the per-visit mix, and how large an SMEM input may be. These
// ask the same questions of this card's primitives. Each runs one warp (the
// TPU kernels ran one program), n iterations of a loop whose result feeds a
// checksum, so the compiler cannot drop the loop; the caller times two
// values of n and takes (t(n_hi) - t(n_lo)) / (n_hi - n_lo). Lane 0 also
// reads clock64() around the loop, for cycles per iteration.
//
// What bounds them is latency, not bytes or operations: one warp keeps at
// most a few loads in flight, so each iteration waits on the chain the
// benchmark builds. That is the point: a BVH visit is such a chain (pop →
// record fetch → slab tests → push), and these put a number of cycles on
// each link.
//
// MB1 mb_walk (make_k_dma, k_dma_smem_ser, k_dma_smem_pipe): a warp walks
//   rows of 512 B (128 f32) of a table, rows_per rows an iteration, in the
//   TPU kernels' order: chain s of S visits rows ((i·S + s)·97) mod span.
//   Dependent: each lane loads 16 bytes of each row through L1 (ld.global.nc)
//   and the next row of a chain is word 0 of the row just loaded (the table
//   holds (r + 97·S) mod span there as int bits), broadcast from lane 0 by
//   __shfl_sync: the latency of a dependent fetch, as a BVH child fetch. No
//   division sits on the chain: the table holds each successor.
//   With vec_ops, ten rounds of the TPU kernel's four vector operations run
//   between the loads and their use. Pipelined: the rows follow from the
//   walk's stride (no table read), and cp.async copies row i + 1 into the
//   other half of a shared buffer while row i is read (the TPU's
//   pipelined=True). Checksum: a += word 1 of the
//   first row of each fetch, in the TPU kernel's order (f32); the dependent
//   walk also XORs the bits of every word loaded.
// MB2 mb_scalar: the empty loop (k_loop: a += i as int32, the floor); 24
//   reads an iteration from shared memory (k_smem24, whose record the port
//   fills from the table first) and the same 24 words through L1; one word
//   to 32 lanes by __shfl_sync, by a load of one shared address and by a
//   load of one global address (what k_mxu / k_bcast broadcast through the
//   MXU and sublanes); k_reduce: 1,024 values (32 a lane) scaled by
//   1.000001, truncated and summed by a 32-lane __shfl_xor_sync reduction.
// MB3 mb_visit (k_consume): one visit of traverse_core.cuh's loop on a
//   record held in shared memory or in registers, at 4 or 8 slots, split into
//   its parts by a mask: the slab tests, one Möller–Trumbore test, the
//   insertion sort of the hit children, the push of the children onto a
//   64-entry local-memory stack and the pop of the next node, which chooses
//   the next iteration's record offset and ray. The formulas are the
//   traversal's; the loop is this file's own (traverse_core.cuh is not
//   touched).
// MB4 mb_smem_probe (kern): fills `words` f32 of dynamic shared memory from
//   the input and reads one word at a dynamic index; the caller raises
//   cudaFuncAttributeMaxDynamicSharedMemorySize step by step until the
//   attribute or the launch is refused.
//
// Built like the traversal kernels (-fmad=false): the vector rounds and the
// visit's arithmetic round as their plain versions do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWords = 128;
constexpr int kMaxRowsPer = 16;  // the pipelined walk's limit

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float ld_shared_volatile(const float* p) {
  float v;
  asm volatile("ld.volatile.shared.f32 %0, [%1];"
               : "=f"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

__device__ __forceinline__ float ld_global_ca(const float* p) {
  float v;
  asm volatile("ld.global.ca.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t xor4(float4 q) {
  return __float_as_uint(q.x) ^ __float_as_uint(q.y) ^ __float_as_uint(q.z) ^
         __float_as_uint(q.w);
}

// the TPU kernel's four vector operations, ten times
__device__ __forceinline__ float vec_rounds(float v) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    v = __fadd_rn(__fmul_rn(v, 1.000001f), 1e-7f);
    v = fmaxf(v, __fmul_rn(v, 0.999999f));
  }
  return v;
}

// ---- MB1 -------------------------------------------------------------------

template <int kRowsPer, int kChains, bool kVec>
__global__ void mb_walk_dep_kernel(const float* __restrict__ table, int span, int n,
                                   float* out, uint32_t* out_xor, long long* cycles) {
  const int lane = threadIdx.x;
  int row[kChains];
#pragma unroll
  for (int s = 0; s < kChains; ++s) row[s] = (int)(((long long)s * 97) % span);
  float a = 0.0f, v = 0.0f;
  uint32_t x = 0;
  const long long c0 = clock64();
  for (int i = 0; i < n; ++i) {
    float4 q[kChains][kRowsPer];
#pragma unroll
    for (int s = 0; s < kChains; ++s)
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r)
        q[s][r] = ldg4(table + (size_t)(row[s] + r) * kRowWords + 4 * lane);
    if (kVec) v = vec_rounds(v);
#pragma unroll
    for (int s = 0; s < kChains; ++s) {
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) x ^= xor4(q[s][r]);
      row[s] = __shfl_sync(kFull, __float_as_int(q[s][0].x), 0);
      a = a + __shfl_sync(kFull, q[s][0].y, 0);
    }
  }
  const long long c1 = clock64();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(kFull, x, o);
  if (lane == 0) {
    out[0] = a;
    out[1] = v;
    *out_xor = x;
    *cycles = c1 - c0;
  }
}

__global__ void mb_walk_pipe_kernel(const float* __restrict__ table, int span, int rows_per,
                                    int n, float* out, uint32_t* out_xor, long long* cycles) {
  extern __shared__ float4 buf[];  // [2][rows_per][32] float4
  const int lane = threadIdx.x;
  const int stride = 97 % span;
  int row = 0;  // the next row to fetch: (i · 97) mod span
  auto fetch = [&](int slot) {
    for (int r = 0; r < rows_per; ++r) {
      const float* src = table + (size_t)(row + r) * kRowWords + 4 * lane;
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(buf + (slot * rows_per + r) * 32 + lane));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src));
    }
    asm volatile("cp.async.commit_group;");
    row += stride;
    if (row >= span) row -= span;
  };
  float a = 0.0f;
  const long long c0 = clock64();
  fetch(0);
  for (int i = 0; i < n; ++i) {
    fetch((i + 1) & 1);
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncwarp();
    a = a + ld_shared_volatile(reinterpret_cast<const float*>(buf + (i & 1) * rows_per * 32) + 1);
    __syncwarp();
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  const long long c1 = clock64();
  if (lane == 0) {
    out[0] = a;
    out[1] = 0.0f;
    *out_xor = 0;
    *cycles = c1 - c0;
  }
}

// ---- MB2 -------------------------------------------------------------------

enum ScalarVariant {
  kLoop = 0, kSmem24 = 1, kL1x24 = 2, kShfl = 3, kSmemBcast = 4, kL1Bcast = 5, kReduce = 6
};

__global__ void mb_scalar_kernel(const float* __restrict__ table, const float* __restrict__ ones,
                                 int variant, int n, int* out_i, float* out_f,
                                 long long* cycles) {
  __shared__ float rec[64];
  const int lane = threadIdx.x;
  rec[lane] = table[lane];
  rec[lane + 32] = table[lane + 32];
  __syncwarp();
  int ai = 0;
  float af = 0.0f, vf = 0.0f;
  long long c0 = 0, c1 = 0;
  switch (variant) {
    case kLoop:
      c0 = clock64();
      for (int i = 0; i < n; ++i) {
        ai += i;
        asm volatile("" : "+r"(ai));
      }
      c1 = clock64();
      break;
    case kSmem24:
      c0 = clock64();
      for (int i = 0; i < n; ++i) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < 24; ++k) s = s + ld_shared_volatile(rec + (k * 5 + 1) % 64);
        af = af + s;
      }
      c1 = clock64();
      break;
    case kL1x24:
      c0 = clock64();
      for (int i = 0; i < n; ++i) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < 24; ++k) s = s + ld_global_ca(table + (k * 5 + 1) % 64);
        af = af + s;
      }
      c1 = clock64();
      break;
    case kShfl: {
      const float mine = rec[lane];
      c0 = clock64();
      for (int i = 0; i < n; ++i) af = af + __shfl_sync(kFull, mine, i & 31);
      c1 = clock64();
      break;
    }
    case kSmemBcast:
      c0 = clock64();
      for (int i = 0; i < n; ++i) af = af + ld_shared_volatile(rec + (i & 31));
      c1 = clock64();
      break;
    case kL1Bcast:
      c0 = clock64();
      for (int i = 0; i < n; ++i) af = af + ld_global_ca(table + (i & 31));
      c1 = clock64();
      break;
    case kReduce: {
      float v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = ones[j * 32 + lane];
      c0 = clock64();
      for (int i = 0; i < n; ++i) {
        int s = 0;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          v[j] = __fmul_rn(v[j], 1.000001f);
          s += (int)v[j];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
        ai += s;
      }
      c1 = clock64();
      vf = v[0];
      break;
    }
    default:
      break;
  }
  if (lane == 0) {
    out_i[0] = ai;
    out_f[0] = af;
    out_f[1] = vf;
    *cycles = c1 - c0;
  }
}

// ---- MB3 -------------------------------------------------------------------

constexpr int kPartSlab = 1, kPartMt = 2, kPartSort = 4, kPartStack = 8;
constexpr int kStackMax = 64;
constexpr float kInf = 1e30f;

// The record: [0:6w] child boxes, [6w:7w] child ids, [7w:8w] unused,
// [8w:8w+12] one triangle [v0, e1, e2, g]. The popped node moves the ray's
// origin by 0.125·(node & 7) in x, so every iteration tests another ray.
template <int kSlots, bool kRegs>
__global__ void mb_visit_kernel(const float* __restrict__ record, int parts, int n,
                                const float* __restrict__ ray, uint32_t* out,
                                float* out_best, long long* cycles) {
  constexpr int kWords = 8 * kSlots + 12;
  __shared__ float rec[kWords];
  const int lane = threadIdx.x;
  for (int w = lane; w < kWords; w += 32) rec[w] = record[w];
  __syncwarp();
  float regs[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) regs[w] = rec[w];

  const float dx = ray[3], dy = ray[4], dz = ray[5];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  int stack_n[kStackMax];
  float stack_d[kStackMax];
  int sp = 0, node = 0;
  stack_n[0] = 0;
  stack_d[0] = 0.0f;
  uint32_t acc = 0;
  float best_out = kInf;
  const long long c0 = clock64();
  for (int i = 0; i < n; ++i) {
    const float ox = ray[0] + 0.125f * (float)(node & 7), oy = ray[1], oz = ray[2];
    float h[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) h[w] = kRegs ? regs[w] : ld_shared_volatile(rec + w);
    float best = kInf;
    bool hit[kSlots];
    float tmin[kSlots];
    uint32_t mask = 0;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (parts & kPartSlab) {
        const float t1x = (h[6 * k + 0] - ox) * ix, t2x = (h[6 * k + 3] - ox) * ix;
        const float t1y = (h[6 * k + 1] - oy) * iy, t2y = (h[6 * k + 4] - oy) * iy;
        const float t1z = (h[6 * k + 2] - oz) * iz, t2z = (h[6 * k + 5] - oz) * iz;
        const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
        const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
        hit[k] = (tf >= fmaxf(tn, 0.0f)) && (tn < best);
        tmin[k] = tn;
      } else {
        hit[k] = true;
        tmin[k] = h[6 * k] - ox;
      }
      mask |= (uint32_t)hit[k] << k;
    }
    if (parts & kPartMt) {
      const float* t = h + 8 * kSlots;
      const float e1x = t[3], e1y = t[4], e1z = t[5];
      const float e2x = t[6], e2y = t[7], e2z = t[8];
      const float pxv = dy * e2z - dz * e2y;
      const float pyv = dz * e2x - dx * e2z;
      const float pzv = dx * e2y - dy * e2x;
      const float det = e1x * pxv + e1y * pyv + e1z * pzv;
      const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
      const float sx = ox - t[0], sy = oy - t[1], sz = oz - t[2];
      const float uu = inv_det * (sx * pxv + sy * pyv + sz * pzv);
      const float qcx = sy * e1z - sz * e1y;
      const float qcy = sz * e1x - sx * e1z;
      const float qcz = sx * e1y - sy * e1x;
      const float vv = inv_det * (dx * qcx + dy * qcy + dz * qcz);
      const float tt = inv_det * (e2x * qcx + e2y * qcy + e2z * qcz);
      if (fabsf(det) >= 1e-7f && uu >= 0.0f && uu <= 1.0f && vv >= 0.0f && uu + vv <= 1.0f &&
          tt > 1e-7f && tt < best) {
        best = tt;
        acc ^= __float_as_uint(tt);
      }
    }
    int cand[kSlots];
    float ckey[kSlots];
    int nc = 0;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (!hit[k]) continue;
      const int cn = (int)h[6 * kSlots + k];
      const float ck = tmin[k];
      int j = nc - 1;
      if (parts & kPartSort) {
        while (j >= 0 && ckey[j] < ck) {
          cand[j + 1] = cand[j];
          ckey[j + 1] = ckey[j];
          --j;
        }
      }
      cand[j + 1] = cn;
      ckey[j + 1] = ck;
      ++nc;
    }
    if (parts & kPartStack) {
      for (int j = 0; j < nc; ++j) {
        if (sp < kStackMax - 1) {
          ++sp;
          stack_n[sp] = cand[j];
          stack_d[sp] = ckey[j];
        }
      }
      node = stack_n[sp];
      acc += __float_as_uint(stack_d[sp]);
      if (sp > 0) --sp;
      if (sp > kStackMax / 2) sp -= kStackMax / 4;
    } else {
      node = nc > 0 ? cand[0] : node + 1;
    }
    acc += (uint32_t)node * 2654435761u + mask;
    best_out = best;
  }
  const long long c1 = clock64();
  if (lane == 0) {
    *out = acc;
    *out_best = best_out;
    *cycles = c1 - c0;
  }
}

// ---- MB4 -------------------------------------------------------------------

__global__ void mb_smem_probe_kernel(const float* __restrict__ x, int words, float* out) {
  extern __shared__ float sbuf[];
  for (int w = threadIdx.x; w < words; w += blockDim.x) sbuf[w] = x[w];
  __syncthreads();
  if (threadIdx.x == 0) {
    const int i = ((int)x[0] % words + words) % words;
    out[0] = sbuf[i] + sbuf[words - 1];
  }
}

template <int kRowsPer, int kChains, bool kVec>
cudaError_t launch_dep(const float* table, int span, int n, float* out, uint32_t* out_xor,
                       long long* cycles, cudaStream_t stream) {
  mb_walk_dep_kernel<kRowsPer, kChains, kVec>
      <<<1, 32, 0, stream>>>(table, span, n, out, out_xor, cycles);
  return cudaGetLastError();
}

template <int kSlots>
cudaError_t launch_visit(int regs, const float* record, int parts, int n, const float* ray,
                         uint32_t* out, float* out_best, long long* cycles,
                         cudaStream_t stream) {
  if (regs)
    mb_visit_kernel<kSlots, true><<<1, 32, 0, stream>>>(record, parts, n, ray, out, out_best,
                                                         cycles);
  else
    mb_visit_kernel<kSlots, false><<<1, 32, 0, stream>>>(record, parts, n, ray, out, out_best,
                                                          cycles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mode 0: dependent walk; 1: dependent walk with the vector rounds;
// 2: pipelined (cp.async double buffer). The dependent walks exist for
// (rows_per, chains, mode) = (1|4|16, 1, 0), (1, 2|4, 0), (4, 4, 0) and
// (4, 1, 1): the TPU script's variants and the chain counts.
int rt_mb_walk(const float* table, int span, int rows_per, int mode, int chains, int n,
               float* out, uint32_t* out_xor, long long* cycles, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rows_per < 1 || rows_per > kMaxRowsPer || span < 1 || n < 0) return cudaErrorInvalidValue;
  if (mode == 2) {
    if (chains != 1) return cudaErrorInvalidValue;
    const size_t smem = 2 * (size_t)rows_per * kRowWords * sizeof(float);
    mb_walk_pipe_kernel<<<1, 32, smem, stream>>>(table, span, rows_per, n, out, out_xor,
                                                  cycles);
    return cudaGetLastError();
  }
  const int key = rows_per * 100 + chains * 10 + mode;
  switch (key) {
    case 110: return launch_dep<1, 1, false>(table, span, n, out, out_xor, cycles, stream);
    case 410: return launch_dep<4, 1, false>(table, span, n, out, out_xor, cycles, stream);
    case 1610: return launch_dep<16, 1, false>(table, span, n, out, out_xor, cycles, stream);
    case 120: return launch_dep<1, 2, false>(table, span, n, out, out_xor, cycles, stream);
    case 140: return launch_dep<1, 4, false>(table, span, n, out, out_xor, cycles, stream);
    case 440: return launch_dep<4, 4, false>(table, span, n, out, out_xor, cycles, stream);
    case 411: return launch_dep<4, 1, true>(table, span, n, out, out_xor, cycles, stream);
    default: return cudaErrorInvalidValue;
  }
}

int rt_mb_scalar(const float* table, const float* ones, int variant, int n, int* out_i,
                 float* out_f, long long* cycles, void* stream_ptr) {
  if (variant < kLoop || variant > kReduce || n < 0) return cudaErrorInvalidValue;
  mb_scalar_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      table, ones, variant, n, out_i, out_f, cycles);
  return cudaGetLastError();
}

int rt_mb_visit(int slots, int regs, const float* record, int parts, int n, const float* ray,
                uint32_t* out, float* out_best, long long* cycles, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 0) return cudaErrorInvalidValue;
  if (slots == 4) return launch_visit<4>(regs, record, parts, n, ray, out, out_best, cycles, stream);
  if (slots == 8) return launch_visit<8>(regs, record, parts, n, ray, out, out_best, cycles, stream);
  return cudaErrorInvalidValue;
}

// Sets the kernel's dynamic shared memory limit to `bytes`, then launches
// it over `bytes / 4` words. Returns the first error (the attribute or the
// launch refused), 0 when it ran.
int rt_mb_smem_probe(const float* x, int bytes, float* out, void* stream_ptr) {
  cudaError_t err = cudaFuncSetAttribute(mb_smem_probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  mb_smem_probe_kernel<<<1, 256, bytes, static_cast<cudaStream_t>(stream_ptr)>>>(x, bytes / 4,
                                                                                  out);
  err = cudaGetLastError();
  return err;
}

}  // extern "C"
