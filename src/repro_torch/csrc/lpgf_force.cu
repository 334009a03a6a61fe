// LPGF resultant-force field on Hopper (sm_90a), fp32 (paper Fig 13).
//
// Replaces the TPU kernel repro/kernels/lpgf_force.py::lpgf_force_pallas
// (_nn_kernel, then _force_kernel). For points x (N, D), with self and
// padding excluded by index:
//   phase 1: d1_i = min_{j != i} d2_ij        (squared nearest neighbour)
//   phase 2: near = d2 <= g * sqrt(d1_i), in_r = d2 <= r2, far = in_r & !near
//            w_ij = far ? d1_i / max(d2, 1e-12) : 0  +  (near & in_r) ? 1/c : 0
//            F_i = sum_j w_ij x_j - W_i x_i,  W_i = sum_j w_ij
// with d2_ij = max(0, (|x_i|^2 + |x_j|^2) - 2 x_i.x_j), the reference's
// force law as written (near compares d2 against g * d1, not its square).
//
// Bound on this card: the function needs every squared distance once (N^2*D
// operations, using the Gram matrix's symmetry) and w @ x (2*N^2*D) on N*D
// floats, in IEEE fp32 (the ring thresholds assume it; no TF32), so it is
// bound by fp32 operations outside the tensor cores: 3*N^2*D, about 0.38 ms
// at N=4096, D=512. This kernel does 6*N^2*D: like the TPU kernel, it forms
// each distance tile in both phases (2*N^2*D each) rather than keep N^2
// distances between them. Design: the 64-column SIMT tile of
// csrc/pairwise_l2.cu, cut to 32 rows so that N=4096 gives 128 blocks. Each
// block owns 32 rows and walks every 64-point column tile in order: a 2x4
// register micro-tile per thread accumulates the tile's dot products over D
// in 16-wide slices staged through shared memory. Phase 1 keeps a running
// row minimum; phase 2 forms w in shared memory and adds w @ x_tile into the
// block's own (32, D) fp32 accumulator in shared memory, slice by slice. No
// atomics: every sum runs in a fixed order, so the result is deterministic.
// Row norms come from one warp per row. Making it fast (tensor cores are out
// for IEEE fp32; a deeper cp.async pipeline and larger micro-tiles) is later
// work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 32;    // rows per block
constexpr int BN = 64;    // points per column tile
constexpr int BK = 16;    // D slice of the distance tile
constexpr int BD = 64;    // D slice of the force accumulation
constexpr int kThreads = 256;

__global__ void sq_norms_kernel(const float* __restrict__ x,
                                float* __restrict__ nrm, int N, int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const float* r = x + (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(r[d], r[d], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) nrm[row] = s;
}

struct TileSmem {
  float As[BK][BM + 4];
  float Bs[BK][BN + 4];
};

// d2 of rows [i0, i0+32) against points [j0, j0+64): thread (ty, tx) gets
// rows 2ty, 2ty+1 and points 4tx..4tx+3 in d2[2][4]; rows and points
// past N read as zeros.
__device__ __forceinline__ void d2_tile(const float* __restrict__ x,
                                        const float* __restrict__ nrm, int N,
                                        int D, int i0, int j0, TileSmem& t,
                                        float d2[2][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int e = tid; e < (BM + BN) * BK; e += kThreads) {
      const int r = e / BK, c = e % BK, k = k0 + c;
      if (r < BM) {
        const int m = i0 + r;
        t.As[c][r] = (m < N && k < D) ? x[(size_t)m * D + k] : 0.f;
      } else {
        const int n = j0 + r - BM;
        t.Bs[c][r - BM] = (n < N && k < D) ? x[(size_t)n * D + k] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      const float a0 = t.As[c][2 * ty], a1 = t.As[c][2 * ty + 1];
      const float4 b = *reinterpret_cast<const float4*>(&t.Bs[c][4 * tx]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[0][j] = fmaf(a0, bv[j], acc[0][j]);
        acc[1][j] = fmaf(a1, bv[j], acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = i0 + 2 * ty + i;
    const float qn = m < N ? nrm[m] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = j0 + 4 * tx + j;
      const float pn = n < N ? nrm[n] : 0.f;
      d2[i][j] = fmaxf(__fsub_rn(__fadd_rn(qn, pn), 2.f * acc[i][j]), 0.f);
    }
  }
}

// phase 1: d1 (N,) squared nearest-neighbour distances
__global__ void __launch_bounds__(kThreads)
lpgf_nn_kernel(const float* __restrict__ x, const float* __restrict__ nrm,
               float* __restrict__ d1, int N, int D) {
  __shared__ __align__(16) TileSmem t;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.x * BM;
  float rmin[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};
  for (int j0 = 0; j0 < N; j0 += BN) {
    float d2[2][4];
    d2_tile(x, nrm, N, D, i0, j0, t, d2);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = j0 + 4 * tx + j;
        if (n < N && n != i0 + 2 * ty + i) rmin[i] = fminf(rmin[i], d2[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v = rmin[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)  // the 16 threads of one row pair
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int m = i0 + 2 * ty + i;
    if (tx == 0 && m < N) d1[m] = v;
  }
}

// phase 2: F (N, D), W (N,)
__global__ void __launch_bounds__(kThreads)
lpgf_force_kernel(const float* __restrict__ x, const float* __restrict__ nrm,
                  const float* __restrict__ d1, float* __restrict__ F,
                  float* __restrict__ W, int N, int D, int Dp, float r2,
                  float g, float inv_c) {
  extern __shared__ __align__(16) float facc[];   // (BM, Dp)
  __shared__ __align__(16) TileSmem t;
  __shared__ float Ws[BM][BN + 1];
  __shared__ __align__(16) float Ps[BN][BD + 4];
  __shared__ float d1s[BM], thr[BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.x * BM;
  for (int e = tid; e < BM * Dp; e += kThreads) facc[e] = 0.f;
  if (tid < BM) {
    const int m = i0 + tid;
    const float v = m < N ? d1[m] : 0.f;
    d1s[tid] = v;
    thr[tid] = __fmul_rn(g, __fsqrt_rn(v));
  }
  float wpart[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < N; j0 += BN) {
    float d2[2][4];
    d2_tile(x, nrm, N, D, i0, j0, t, d2);   // its syncs order d1s/thr too
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * ty + i;
      const int m = i0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = j0 + 4 * tx + j;
        const bool ok = m < N && n < N && n != m;
        const float d = d2[i][j];
        const bool near = ok && d <= thr[r];
        const bool in_r = ok && d <= r2;
        const bool far = in_r && !near;
        const float w = (far ? __fdiv_rn(d1s[r], fmaxf(d, 1e-12f)) : 0.f) +
                        ((near && in_r) ? inv_c : 0.f);
        Ws[r][4 * tx + j] = w;
        wpart[i] += w;
      }
    }
    // facc += Ws @ x[j0:j0+64, :], one 64-wide slice of D at a time
    for (int s0 = 0; s0 < D; s0 += BD) {
      __syncthreads();   // Ws written; the previous slice's Ps consumed
      for (int e = tid; e < BN * BD; e += kThreads) {
        const int r = e / BD, c = e % BD;
        const int n = j0 + r, k = s0 + c;
        Ps[r][c] = (n < N && k < D) ? x[(size_t)n * D + k] : 0.f;
      }
      __syncthreads();
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 8
      for (int jj = 0; jj < BN; ++jj) {
        const float a0 = Ws[2 * ty][jj], a1 = Ws[2 * ty + 1][jj];
        const float4 b = *reinterpret_cast<const float4*>(&Ps[jj][4 * tx]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][j] = fmaf(a0, bv[j], acc[0][j]);
          acc[1][j] = fmaf(a1, bv[j], acc[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          facc[(2 * ty + i) * Dp + s0 + 4 * tx + j] += acc[i][j];
    }
    __syncthreads();   // Ws and Ps free for the next column tile
  }
  __shared__ float wsum[BM];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v = wpart[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (tx == 0) wsum[2 * ty + i] = v;
  }
  __syncthreads();
  for (int e = tid; e < BM * D; e += kThreads) {
    const int r = e / D, k = e % D;
    const int m = i0 + r;
    if (m < N)
      F[(size_t)m * D + k] =
          __fsub_rn(facc[r * Dp + k], __fmul_rn(wsum[r], x[(size_t)m * D + k]));
  }
  if (tid < BM && i0 + tid < N) W[i0 + tid] = wsum[tid];
}

size_t force_smem(int Dp) { return (size_t)BM * Dp * sizeof(float); }

int force_smem_limit() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, lpgf_force_kernel);
  return optin - (int)attr.sharedSizeBytes;
}

}  // namespace

// Largest D the force kernel's shared-memory accumulator holds.
extern "C" int lpgf_force_max_d() {
  return force_smem_limit() / (BM * (int)sizeof(float)) / BD * BD;
}

// x (N, D) fp32; scratch (2N,) fp32 (row norms, then d1); F (N, D) and
// W (N,) fp32 outputs. All contiguous device buffers. Launches three
// kernels on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int lpgf_force_launch(const float* x, float* scratch, float* F,
                                 float* W, int N, int D, float r2, float g,
                                 float inv_c, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* nrm = scratch;
  float* d1 = scratch + N;
  const int Dp = (D + BD - 1) / BD * BD;
  const size_t smem = force_smem(Dp);
  const cudaError_t set = cudaFuncSetAttribute(
      lpgf_force_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  const int blocks = (N + BM - 1) / BM;
  sq_norms_kernel<<<(N + 7) / 8, 256, 0, st>>>(x, nrm, N, D);
  lpgf_nn_kernel<<<blocks, kThreads, 0, st>>>(x, nrm, d1, N, D);
  lpgf_force_kernel<<<blocks, kThreads, smem, st>>>(x, nrm, d1, F, W, N, D,
                                                    Dp, r2, g, inv_c);
  const cudaError_t err = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : set);
}
