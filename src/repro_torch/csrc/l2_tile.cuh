// One IEEE-fp32 distance tile for Hopper (sm_90a), shared by the
// pairwise_sq_l2 kernel (csrc/pairwise_l2.cu, the store epilogue), the
// topk_l2 kernel (csrc/fused_topk.cu, the running top-k epilogue) and the
// lpgf_force kernels (csrc/lpgf_force.cu: the distances with a mirrored
// store and partial minima, then w @ x as the tile's dot product).
//
// It computes, for a 128 x 128 tile of (q row m, p row n) pairs, the dot
// products q_m . p_n and the row norms |q_m|^2 and |p_n|^2; an epilogue
// turns them into max(0, (|q_m|^2 + |p_n|^2) - 2 q_m . p_n), the TPU
// kernels' quadratic expansion (repro/kernels/pairwise_l2.py::_kernel,
// repro/kernels/fused_topk.py::_kernel).
//
// Bound on this card: 2*M*N*D fp32 operations on (M + N)*D floats, so the
// SIMT fp32 pipe (67 TFLOP/s at 700 W). There is no tensor-core path: TF32
// would break the V.R slack constants and the certified re-rank, which
// assume IEEE fp32 products, and wgmma has no IEEE fp32 type. The design
// is a classic SIMT SGEMM tile sized for one 256-thread block per SM:
//
//   * 128 x 128 outputs a block, an 8 x 8 micro-tile a thread: per k, 8 + 8
//     operands give 64 FMAs;
//   * q and p stay row-major in shared memory ([row][k], rows padded to 68
//     floats), so 16-byte cp.async.cg copies them straight from the
//     row-major inputs with no transpose; a thread reads four k of one row
//     as one float4, and its rows (a warp's 4 q rows, 8 p rows at a time)
//     are consecutive, which the 68-float stride makes conflict-free;
//   * three stages of 64-wide D slices in flight (204 KB), one barrier
//     per slice;
//     the walk over a block's tiles is one continuous pipeline, so the
//     next tile's first slices load while an epilogue runs;
//   * ragged M, N and D are zero-filled by the copies (src-size 0); a D
//     that is not a multiple of 4, or an unaligned base, takes 4-byte
//     copies into the same layout.
//
// Self-distances are exactly 0. Every dot product and every row norm is
// one fmaf chain over k = 0, 1, ..., D - 1 in that order, read from the
// same staged slices; the norm of row r is that chain with both operands
// equal. So a row against itself gives (n + n) - 2n = 0 bit for bit, and a
// row's norm is the same in every tile and in both kernels: topk_l2's
// distances are pairwise_sq_l2's, bit for bit. No split of D across
// blocks, no shuffle-tree norm and no norm from another pass.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace l2tile {

constexpr int BM = 128;       // q rows a tile
constexpr int BN = 128;       // p rows a tile
constexpr int BK = 64;        // D slice a stage
constexpr int LDS = BK + 4;   // shared row stride, floats
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int TM = 8;         // micro-tile rows a thread
constexpr int TN = 8;         // micro-tile columns a thread

constexpr int STAGE_FLOATS = (BM + BN) * LDS;
// the pipeline's stages, then the tile's norms (BM q rows, BN p rows)
constexpr size_t PIPE_BYTES = (size_t)STAGES * STAGE_FLOATS * sizeof(float);
constexpr size_t SMEM_BYTES = PIPE_BYTES + (size_t)(BM + BN) * sizeof(float);

// A thread's place: warp (wm, wn) owns 32 q rows x 64 p rows of the tile;
// lane (ty, tx) owns q rows wm*32 + ty + 4i and p rows wn*64 + tx + 8j.
struct Lane {
  int tid, wm, wn, ty, tx;
  __device__ __forceinline__ int row(int i) const { return wm * 32 + ty + 4 * i; }
  __device__ __forceinline__ int col(int j) const { return wn * 64 + tx + 8 * j; }
  // the slot of this thread among the 16 that share each of its rows
  __device__ __forceinline__ int row_slot() const { return wn * 8 + tx; }
};

__device__ __forceinline__ Lane lane_of(int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  return Lane{tid, warp >> 1, warp & 1, lane >> 3, lane & 7};
}

// The expansion and its clamp, in the plain version's order. The clamp
// keeps NaN, as torch.clamp_min and jnp.maximum do (fmaxf alone would
// turn a NaN row's distance into 0); every other value's bits are
// fmaxf's.
__device__ __forceinline__ float sq_dist(float qn, float pn, float dot) {
  const float d = (qn + pn) - 2.f * dot;
  return d != d ? d : fmaxf(d, 0.f);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(unsigned dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp4(unsigned dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows r0 .. r0 + BM - 1 of X (R rows of width D), columns k0 .. k0 +
// BK - 1, into dst[row][k]; what lies outside X reads as zero.
__device__ __forceinline__ void load_rows(float* dst, const float* X, int r0,
                                          int R, int k0, int D, bool vec,
                                          int tid) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BK / 4), c = e % (BK / 4) * 4;
      const bool ok = r0 + r < R && k0 + c < D;
      cp16(smem_u32(dst + r * LDS + c),
           ok ? X + (size_t)(r0 + r) * D + k0 + c : X, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK, c = e % BK;
      const bool ok = r0 + r < R && k0 + c < D;
      cp4(smem_u32(dst + r * LDS + c),
          ok ? X + (size_t)(r0 + r) * D + k0 + c : X, ok ? 4 : 0);
    }
  }
}

// One staged slice: acc[i][j] += q_row(i) . p_col(j) over its BK k, and
// this thread's norm chain (threads 0..127: q row tid; 128..255: p row
// tid - 128) over the same k, in the same order.
__device__ __forceinline__ void slice(const float* As, const float* Bs,
                                      float (&acc)[TM][TN], float& nrm,
                                      const Lane& L) {
  const float* a0 = As + L.row(0) * LDS;
  const float* b0 = Bs + L.col(0) * LDS;
#pragma unroll
  for (int k = 0; k < BK; k += 4) {
    float4 a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(a0 + 4 * i * LDS + k);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      b[j] = *reinterpret_cast<const float4*>(b0 + 8 * j * LDS + k);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
  }
  const float* r = L.tid < BM ? As + L.tid * LDS : Bs + (L.tid - BM) * LDS;
#pragma unroll
  for (int k = 0; k < BK; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(r + k);
    nrm = fmaf(v.x, v.x, nrm);
    nrm = fmaf(v.y, v.y, nrm);
    nrm = fmaf(v.z, v.z, nrm);
    nrm = fmaf(v.w, v.w, nrm);
  }
}

// Persistent blocks for `kernel` (THREADS threads, `smem` bytes of dynamic
// shared memory, already opted in): as many as the card holds at once, at
// most `tiles`.
inline int persistent_grid(const void* kernel, size_t smem, long long tiles) {
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, smem);
  const long long slots = (long long)sms * (occ > 0 ? occ : 1);
  return (int)(tiles < slots ? tiles : slots);
}

// Whether the 16-byte copies may be used: D a multiple of 4 and both bases
// 16-byte aligned.
inline bool vec_ok(const float* q, const float* p, int D) {
  return D % 4 == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)p % 16 == 0;
}

// Walk this block's `ntiles` tiles. tile(t, m0, n0) names the origin of the
// t-th; epi(t, acc, qn, pn, L) consumes it, with the tile's q and p row
// norms in shared memory (qn[BM], pn[BN]); every thread of the block calls
// it, so it may synchronise the block. smem: SMEM_BYTES (16-byte aligned).
template <class TileFn, class EpiFn>
__device__ __forceinline__ void walk(const float* __restrict__ q,
                                     const float* __restrict__ p, int M, int N,
                                     int D, bool vec, int ntiles, TileFn tile,
                                     EpiFn epi, float* smem) {
  const Lane L = lane_of(threadIdx.x);
  float* norms = smem + STAGES * STAGE_FLOATS;
  const int KT = D > 0 ? (D + BK - 1) / BK : 1;
  // the next slice to load: tile lt at (lm0, ln0), slice lk
  int lt = 0, lk = 0, lm0 = 0, ln0 = 0;
  if (ntiles > 0) tile(0, lm0, ln0);
  auto fetch = [&](int stage) {
    if (lt < ntiles) {
      float* st = smem + stage * STAGE_FLOATS;
      load_rows(st, q, lm0, M, lk * BK, D, vec, L.tid);
      load_rows(st + BM * LDS, p, ln0, N, lk * BK, D, vec, L.tid);
      if (++lk == KT) {
        lk = 0;
        if (++lt < ntiles) tile(lt, lm0, ln0);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  float acc[TM][TN];
  float nrm = 0.f;
  int t = 0, kt = 0, stage = 0;
  const int total = ntiles * KT;
  for (int it = 0; it < total; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    // the stage computed last iteration is free again: refill it
    fetch(stage == 0 ? STAGES - 1 : stage - 1);
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      nrm = 0.f;
    }
    const float* st = smem + stage * STAGE_FLOATS;
    slice(st, st + BM * LDS, acc, nrm, L);
    stage = stage == STAGES - 1 ? 0 : stage + 1;
    if (++kt == KT) {
      norms[L.tid] = nrm;
      __syncthreads();
      epi(t, acc, norms, norms + BM, L);
      kt = 0;
      ++t;
    }
  }
  cp_wait<0>();
}

}  // namespace l2tile
