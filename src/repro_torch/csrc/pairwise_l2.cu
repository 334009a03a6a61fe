// Blocked pairwise squared-L2 distances on Hopper (sm_90a), IEEE fp32.
//
// Replaces the TPU kernel repro/kernels/pairwise_l2.py::pairwise_sq_l2_pallas
// (_kernel): out[m, n] = max(0, |q_m|^2 + |p_n|^2 - 2 q_m . p_n).
//
// Bound on this card: at the path's shapes ((<= 256, ~3.5k-200k, 512) in the
// KNN prologue and the dense V.R mask, (1024, 200k, 512) in LPGF, (4096,
// 200k, 512) in DPC) the work is 2*M*N*D fp32 operations against
// (M + N)*D + M*N floats moved: operation-bound, on the SIMT pipe (IEEE
// fp32, no TF32).
//
// Design: the shared tile of l2_tile.cuh (128 x 128 outputs a block, 8 x 8
// a thread, three cp.async stages of 64-wide D slices) with the store
// epilogue. Blocks are persistent, one per SM: block b takes tiles b, b +
// grid, ... in an order that walks all row tiles of a column tile before
// the next column tile, so the q rows stay in L2 and each p tile is read
// from device memory about once.
#include "l2_tile.cuh"

namespace {

using namespace l2tile;

__global__ void __launch_bounds__(THREADS, 1)
pairwise_sq_l2_kernel(const float* __restrict__ q, const float* __restrict__ p,
                      float* __restrict__ out, int M, int N, int D, int vec) {
  extern __shared__ __align__(16) float smem[];
  const long long rows = (M + BM - 1) / BM;
  const long long total = rows * ((N + BN - 1) / BN);
  const int ntiles =
      (int)((total - blockIdx.x + gridDim.x - 1) / gridDim.x);
  auto tile = [&](int t, int& m0, int& n0) {
    const long long g = blockIdx.x + (long long)t * gridDim.x;
    m0 = (int)(g % rows) * BM;
    n0 = (int)(g / rows) * BN;
  };
  auto store = [&](int t, float (&acc)[TM][TN], const float* qn,
                   const float* pn, const Lane& L) {
    int m0, n0;
    tile(t, m0, n0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + L.row(i);
      if (m >= M) continue;
      const float qv = qn[L.row(i)];
      float* o = out + (size_t)m * N;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + L.col(j);
        if (n < N) o[n] = sq_dist(qv, pn[L.col(j)], acc[i][j]);
      }
    }
  };
  walk(q, p, M, N, D, vec != 0, ntiles, tile, store, smem);
}

}  // namespace

// q (M, D), p (N, D), out (M, N): contiguous fp32 device buffers, M, N >= 1.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int pairwise_sq_l2_launch(const float* q, const float* p,
                                     float* out, int M, int N, int D,
                                     void* stream) {
  const cudaError_t set = cudaFuncSetAttribute(
      pairwise_sq_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  const int grid = persistent_grid(
      (const void*)pairwise_sq_l2_kernel, SMEM_BYTES,
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN));
  pairwise_sq_l2_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      q, p, out, M, N, D, (int)vec_ok(q, p, D));
  const cudaError_t err = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : set);
}
