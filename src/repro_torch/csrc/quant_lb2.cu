// Mixed-precision candidate scan on Hopper (sm_90a): widened squared lower
// bounds from int8 or bf16 candidate codes.
//
// Replaces the TPU kernel repro/kernels/fused_topk.py::quant_lb2_pallas
// (_quant_lb2_kernel). Per query g and candidate c:
//   cross = qc_g . code_gc            (int8: exact in int32; bf16: fp32)
//   d2h   = max(0, (qqq + cppq) - s * cross),
//           s = (2 qscale) cscale for int8, 2 for bf16
//   dhat  = sqrt(d2h);  mag = max(0, qqq + cppq)
//   slack = (SLACK_ABS + SLACK_REL dhat) + SLACK_MAG sqrt(mag)
//   lbr   = max(0, (dhat - (qeps + ceps)) - slack)
//   out   = lbr^2 where valid, +inf elsewhere
// in the reference's order of operations, each rounded once (no fused
// multiply-add), so the int8 bounds equal the plain version's bit for bit.
//
// Bound on this card: the valid candidates' codes (D bytes each for int8,
// 2*D for bf16) and 12 bytes of metadata, plus a validity byte and a 4-byte
// output for every candidate, for 2*D int8 or bf16 operations per valid
// candidate: bound by device-memory bytes at any shape the engine gives it.
// Design: a block of 8 warps takes one query's run of 256 candidates and
// holds the query's codes in shared memory; a warp streams whole
// candidate rows, each lane loading 16 contiguous bytes (512 bytes per
// int8 row at D=512: one coalesced load per lane), and an invalid
// candidate's row is never read. Lane j of a warp keeps the cross term of
// the warp's j-th candidate, so the epilogue reads metadata and writes
// bounds coalesced.
//
// The conservative-bound contract (lb2 <= exact squared distance) at
// D=512, with u = 2^-24:
//   * int8: __dp4a accumulates code products in int32, exactly
//     (|sum| <= 127^2 * D < 2^24 for D <= 1040, so the conversion to fp32
//     is exact too). Only the epilogue rounds, which the slack covers.
//   * bf16: each product of two bf16 values is exact in fp32, but their sum
//     is not. Lanes sum D/32 lane-strided products in a chain, then a
//     5-level shuffle tree adds the 32 partial sums: at most D/32 + 5 = 21
//     roundings on any path, so |cross error| <= 21 u |q||p| and the error
//     of d2h is at most 21 u (|q|^2 + |p|^2) = 21 u mag, plus the norms'
//     own roundings (a few tens of u mag). Its square root,
//     sqrt(~45 u) sqrt(mag) ~ 1.6e-3 sqrt(mag), stays under the slack's
//     SLACK_MAG = 2e-3 sqrt(mag). A sequential sum of all D products would
//     give sqrt(512 u) ~ 5.5e-3, above it.
// Making it fast (int8 mma/wgmma, fusing the engine's gather of codes by
// tile selection into the kernel, TMA) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCands = kWarps * 32;   // candidates per block
// repro/utils/quant.py: SLACK_ABS, SLACK_REL, SLACK_MAG as fp32
constexpr float kSlackAbs = 1e-4f;
constexpr float kSlackRel = 1e-4f;
constexpr float kSlackMag = 2e-3f;

__device__ __forceinline__ int dot_i8(const int8_t* __restrict__ row,
                                      const int8_t* qs, int D, int lane,
                                      bool vec) {
  int s = 0;
  if (vec) {  // 16 codes per lane per step, four __dp4a
    const int4* r4 = reinterpret_cast<const int4*>(row);
    const int4* q4 = reinterpret_cast<const int4*>(qs);
    for (int ch = lane; ch < D / 16; ch += 32) {
      const int4 a = __ldg(r4 + ch);
      const int4 b = q4[ch];
      s = __dp4a(a.x, b.x, s);
      s = __dp4a(a.y, b.y, s);
      s = __dp4a(a.z, b.z, s);
      s = __dp4a(a.w, b.w, s);
    }
  } else {
    for (int d = lane; d < D; d += 32) s += (int)row[d] * (int)qs[d];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__device__ __forceinline__ float dot_bf16(const __nv_bfloat16* __restrict__ row,
                                          const __nv_bfloat16* qs, int D,
                                          int lane, bool vec) {
  float s = 0.f;
  if (vec) {  // 8 values per lane per step, summed in a chain
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const uint4* q4 = reinterpret_cast<const uint4*>(qs);
    for (int ch = lane; ch < D / 8; ch += 32) {
      const uint4 a = __ldg(r4 + ch);
      const uint4 b = q4[ch];
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(a2[i]);
        const float2 y = __bfloat1622float2(b2[i]);
        // the product of two bf16 values is exact in fp32: each step
        // rounds once, in the sum
        s = __fadd_rn(s, __fmul_rn(x.x, y.x));
        s = __fadd_rn(s, __fmul_rn(x.y, y.y));
      }
    }
  } else {
    for (int d = lane; d < D; d += 32)
      s = __fadd_rn(s, __fmul_rn(__bfloat162float(row[d]),
                                 __bfloat162float(qs[d])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
quant_lb2_kernel(const void* __restrict__ qc, const float* __restrict__ qscale,
                 const float* __restrict__ qqq, const float* __restrict__ qeps,
                 const void* __restrict__ codes,
                 const float* __restrict__ cscale,
                 const float* __restrict__ cppq,
                 const float* __restrict__ ceps,
                 const uint8_t* __restrict__ valid, float* __restrict__ out,
                 int C, int D, int vec) {
  typedef typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);

  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* qg = reinterpret_cast<const T*>(qc) + (size_t)g * D;
  for (int d = tid; d < D; d += kThreads) qs[d] = qg[d];
  __syncthreads();

  const int base = blockIdx.x * kCands + warp * 32;  // this warp's run
  const size_t gc = (size_t)g * C;
  const uint8_t* vg = valid + gc;
  const T* cg = reinterpret_cast<const T*>(codes) + gc * D;
  float mine = 0.f;  // lane j: cross term of candidate base + j
  const int n = min(32, C - base);
  for (int j = 0; j < n; ++j) {
    const int c = base + j;
    if (vg[c] == 0) continue;  // warp-uniform: invalid rows are not read
    float cr;
    if constexpr (kInt8)
      cr = (float)dot_i8(reinterpret_cast<const int8_t*>(cg) + (size_t)c * D,
                         reinterpret_cast<const int8_t*>(qs), D, lane, vec);
    else
      cr = dot_bf16(reinterpret_cast<const __nv_bfloat16*>(cg) + (size_t)c * D,
                    reinterpret_cast<const __nv_bfloat16*>(qs), D, lane, vec);
    if (lane == j) mine = cr;
  }
  const int c = base + lane;
  if (c >= C) return;
  if (vg[c] == 0) {
    out[gc + c] = __int_as_float(0x7f800000);
    return;
  }
  const float qq = qqq[g];
  const float cp = cppq[gc + c];
  const float nrm = __fadd_rn(qq, cp);
  const float s = kInt8 ? __fmul_rn(__fmul_rn(2.f * qscale[g], cscale[gc + c]),
                                    mine)
                        : 2.f * mine;
  const float d2h = fmaxf(__fsub_rn(nrm, s), 0.f);
  const float dhat = __fsqrt_rn(d2h);
  const float mag = fmaxf(nrm, 0.f);
  const float slack = __fadd_rn(__fadd_rn(kSlackAbs, __fmul_rn(kSlackRel, dhat)),
                                __fmul_rn(kSlackMag, __fsqrt_rn(mag)));
  const float lbr = fmaxf(
      __fsub_rn(__fsub_rn(dhat, __fadd_rn(qeps[g], ceps[gc + c])), slack), 0.f);
  out[gc + c] = __fmul_rn(lbr, lbr);
}

}  // namespace

// qc (G, D) int8 or bf16 query codes; qscale, qqq, qeps (G,) fp32 (see
// repro_torch/utils/quant.py::quantize_query); codes (G, C, D) of the same
// type; cscale, cppq, ceps (G, C) fp32; valid (G, C) uint8; out (G, C) fp32.
// int8 = 1 for int8 codes, 0 for bf16. All contiguous device buffers.
// Returns cudaGetLastError().
extern "C" int quant_lb2_launch(const void* qc, const float* qscale,
                                const float* qqq, const float* qeps,
                                const void* codes, const float* cscale,
                                const float* cppq, const float* ceps,
                                const uint8_t* valid, float* out, int G,
                                int C, int D, int int8, void* stream) {
  const int esz = int8 ? 1 : 2;
  // 16-byte loads need rows that start on 16-byte boundaries
  const int vec = ((D * esz) % 16 == 0) &&
                  ((uintptr_t)codes % 16 == 0) && ((uintptr_t)qc % 16 == 0);
  const size_t smem = ((size_t)D * esz + 15) / 16 * 16;
  dim3 grid((C + kCands - 1) / kCands, G);
  cudaError_t set;
  if (int8) {
    set = cudaFuncSetAttribute(quant_lb2_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    quant_lb2_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        qc, qscale, qqq, qeps, codes, cscale, cppq, ceps, valid, out, C, D,
        vec);
  } else {
    set = cudaFuncSetAttribute(quant_lb2_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    quant_lb2_kernel<false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        qc, qscale, qqq, qeps, codes, cscale, cppq, ceps, valid, out, C, D,
        vec);
  }
  const cudaError_t err = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : set);
}
