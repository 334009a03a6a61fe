// Blocked pairwise squared-L2 distances on Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel repro/kernels/pairwise_l2.py::pairwise_sq_l2_pallas
// (_kernel): out[m, n] = max(0, |q_m|^2 + |p_n|^2 - 2 q_m . p_n).
//
// Bound on this card: at the main path's shapes ((256, ~3.5k, 512) in the
// KNN prologue, (256, 200k, 512) in the dense V.R mask, (4096, 200k, 512)
// in LPGF) the work is 2*M*N*D fp32 operations against (M + N)*D + M*N
// floats moved, so it is operation-bound: fp32 outside the tensor cores,
// since the V.R slack constants assume IEEE fp32 products (no TF32).
//
// Design: a classic shared-memory SGEMM tile. Each 256-thread block owns a
// 64x64 output tile and streams 16-wide slices of D for both operands
// through shared memory (stored transposed, padded against bank
// conflicts); each thread accumulates a 4x4 register micro-tile with fp32
// FMA. The row norms are accumulated from the same staged slices (threads
// 0..127, one row each) and fused into the epilogue with the clamp, so q
// and p are read from device memory once per tile. Ragged M, N and D are
// masked with zero fill. Making it fast (wgmma is not available for IEEE
// fp32; a deeper pipeline with cp.async/TMA and larger micro-tiles) is
// later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int PAD = 4;  // keeps float4 alignment, breaks store conflicts

__global__ void __launch_bounds__(256)
pairwise_sq_l2_kernel(const float* __restrict__ q, const float* __restrict__ p,
                      float* __restrict__ out, int M, int N, int D) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  __shared__ float qn[BM];
  __shared__ float pn[BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256;
      const int r = e / BK;
      const int c = e % BK;
      const int gk = k0 + c;
      const int gm = m0 + r;
      const int gn = n0 + r;
      As[c][r] = (gm < M && gk < D) ? q[(size_t)gm * D + gk] : 0.f;
      Bs[c][r] = (gn < N && gk < D) ? p[(size_t)gn * D + gk] : 0.f;
    }
    __syncthreads();
    if (tid < BM) {
#pragma unroll
      for (int c = 0; c < BK; ++c) {
        const float v = As[c][tid];
        nrm = fmaf(v, v, nrm);
      }
    } else if (tid < BM + BN) {
#pragma unroll
      for (int c = 0; c < BK; ++c) {
        const float v = Bs[c][tid - BM];
        nrm = fmaf(v, v, nrm);
      }
    }
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&As[c][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[c][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < BM) {
    qn[tid] = nrm;
  } else if (tid < BM + BN) {
    pn[tid - BM] = nrm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      const float d = (qn[ty * 4 + i] + pn[tx * 4 + j]) - 2.f * acc[i][j];
      out[(size_t)gm * N + gn] = fmaxf(d, 0.f);
    }
  }
}

}  // namespace

// q (M, D), p (N, D), out (M, N): contiguous fp32 device buffers. Launches
// on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int pairwise_sq_l2_launch(const float* q, const float* p,
                                     float* out, int M, int N, int D,
                                     void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  pairwise_sq_l2_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(q, p, out, M,
                                                                 N, D);
  return (int)cudaGetLastError();
}
