// LPGF resultant-force field on Hopper (sm_90a), IEEE fp32 (paper Fig 13).
//
// Replaces the TPU kernel repro/kernels/lpgf_force.py::lpgf_force_pallas
// (_nn_kernel, then _force_kernel). For points x (N, D), with self and
// padding excluded by index:
//   d1_i = min_{j != i} d2_ij                 (squared nearest neighbour)
//   near = d2 <= g * sqrt(d1_i), in_r = d2 <= r2, far = in_r & !near
//   w_ij = far ? d1_i / max(d2, 1e-12) : 0  +  (near & in_r) ? 1/c : 0
//   F_i = sum_j w_ij x_j - W_i x_i,  W_i = sum_j w_ij
// with d2_ij = max(0, (|x_i|^2 + |x_j|^2) - 2 x_i.x_j), the reference's
// force law as written (near compares d2 against g * sqrt(d1), not its
// square).
//
// Bound on this card: every squared distance once (N^2*D operations, by
// the Gram matrix's symmetry) and w @ x (2*N^2*D), in IEEE fp32 (the ring
// thresholds assume it: no TF32, no wgmma), on N*D floats in and out: bound
// by fp32 operations outside the tensor cores, 3*N^2*D, about 0.38 ms at
// N=4096, D=512.
//
// Design: four kernels on the caller's stream, no atomics, every sum in a
// fixed order, so two calls give the same bits.
//   A. lpgf_d2_kernel: the distance tile of l2_tile.cuh over (x, x), only
//      the tile pairs with row tile <= column tile (528 at N=4096), on
//      persistent blocks. Its dot products and norms are in-order fmaf
//      chains, so d2(m, n) and d2(n, m) are the same bits: the epilogue
//      stores each tile into an (N, N) scratch and, off the diagonal, its
//      mirror, so the scratch equals pairwise_sq_l2(x, x) bit for bit. It
//      also writes each row's minimum over the tile's columns and, off the
//      diagonal, each column's minimum over the tile's rows into an (N,
//      ceil(N/128)) partial-min scratch, each entry once.
//   B. lpgf_weights_kernel, one block per row: d1 is the least of the
//      row's partials; w replaces d2 (in place, unless the caller keeps
//      the distances) and W is summed over j in a fixed order.
//   C. transpose_kernel makes x^T (D, N); then lpgf_wx_kernel walks the
//      same tile over (q = w, p = x^T) with depth N, so the tile's dot
//      product is sum_j w_ij x_jd, and its epilogue writes
//      F = acc - W_i * x_id. (The tile's norm chain runs there too and is
//      unused: about 1.5% more operations.)
// Memory: N^2 + N*ceil(N/128) + D*N floats of scratch from the caller
// (about 72.5 MiB at (4096, 512)); no limit on N or D below that.
#include "l2_tile.cuh"

namespace {

using namespace l2tile;

constexpr int kRowThreads = 256;   // kernel B
// kernel A's reduction buffers after the tile's shared memory: the row
// minima of the two column warps, the column minima of the four row warps
constexpr size_t kD2Smem =
    SMEM_BYTES + (size_t)(2 * BM + 4 * BN) * sizeof(float);

__device__ __forceinline__ float inf_f() {
  return __int_as_float(0x7f800000);
}

// min that keeps NaN, as the plain version's torch.min and the reference's
// jnp.minimum do (fminf returns the other operand); every other pair of
// operands gets fminf's bits
__device__ __forceinline__ float min_keep_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// The g-th tile pair (rt <= ct), column tile by column tile.
__device__ __forceinline__ void upper_tile(int g, int& rt, int& ct) {
  int c = (int)((sqrtf(8.f * (float)g + 1.f) - 1.f) * 0.5f);
  while (c > 0 && (long long)c * (c + 1) / 2 > g) --c;
  while ((long long)(c + 1) * (c + 2) / 2 <= g) ++c;
  ct = c;
  rt = g - (int)((long long)c * (c + 1) / 2);
}

__global__ void __launch_bounds__(THREADS, 1)
lpgf_d2_kernel(const float* __restrict__ x, float* __restrict__ d2,
               float* __restrict__ pmin, int N, int D, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* rmin_s = smem + SMEM_BYTES / sizeof(float);   // [2][BM]
  float* cmin_s = rmin_s + 2 * BM;                      // [4][BN]
  const int T = (N + BM - 1) / BM;
  const long long total = (long long)T * (T + 1) / 2;
  const int ntiles = (int)((total - blockIdx.x + gridDim.x - 1) / gridDim.x);
  auto tile = [&](int t, int& m0, int& n0) {
    int rt, ct;
    upper_tile(blockIdx.x + t * gridDim.x, rt, ct);
    m0 = rt * BM;
    n0 = ct * BN;
  };
  auto epi = [&](int t, float (&acc)[TM][TN], const float* qn,
                 const float* pn, const Lane& L) {
    int m0, n0;
    tile(t, m0, n0);
    const bool diag = m0 == n0;
    float cmin[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) cmin[j] = inf_f();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + L.row(i);
      const float qv = qn[L.row(i)];
      float rmin = inf_f();
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + L.col(j);
        const float d = sq_dist(qv, pn[L.col(j)], acc[i][j]);
        if (m < N && n < N) {
          d2[(size_t)m * N + n] = d;
          if (!diag) d2[(size_t)n * N + m] = d;
          if (n != m) {
            rmin = min_keep_nan(rmin, d);
            cmin[j] = min_keep_nan(cmin[j], d);
          }
        }
      }
      // the 8 lanes (tx) of this warp that share row i
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rmin = min_keep_nan(rmin, __shfl_xor_sync(0xffffffffu, rmin, off));
      if (L.tx == 0) rmin_s[L.wn * BM + L.row(i)] = rmin;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      // the 4 lanes (ty) of this warp that share column j
      float v = cmin[j];
      v = min_keep_nan(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = min_keep_nan(v, __shfl_xor_sync(0xffffffffu, v, 16));
      if (L.ty == 0) cmin_s[L.wm * BN + L.col(j)] = v;
    }
    __syncthreads();
    if (L.tid < BM) {
      const int m = m0 + L.tid;
      if (m < N)
        pmin[(size_t)m * T + n0 / BN] =
            min_keep_nan(rmin_s[L.tid], rmin_s[BM + L.tid]);
    } else if (!diag) {
      const int c = L.tid - BM, n = n0 + c;
      if (n < N)
        pmin[(size_t)n * T + m0 / BM] =
            min_keep_nan(min_keep_nan(cmin_s[c], cmin_s[BN + c]),
                  min_keep_nan(cmin_s[2 * BN + c], cmin_s[3 * BN + c]));
    }
    // the walk's next barrier comes before the buffers are written again
  };
  walk(x, x, N, N, D, vec != 0, ntiles, tile, epi, smem);
}

// Row i: d1 from its partial minima, then w over the row (d2 and w may be
// the same buffer: each element is read, then written, by one thread) and
// W_i, summed in a fixed order.
__global__ void __launch_bounds__(kRowThreads)
lpgf_weights_kernel(const float* d2, float* w, const float* __restrict__ pmin,
                    float* __restrict__ W, int N, int T, float r2, float g,
                    float inv_c) {
  __shared__ float red[kRowThreads / 32];
  __shared__ float d1_s;
  const int i = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float v = inf_f();
  for (int t = tid; t < T; t += kRowThreads)
    v = min_keep_nan(v, pmin[(size_t)i * T + t]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min_keep_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
    for (int k = 1; k < kRowThreads / 32; ++k) m = min_keep_nan(m, red[k]);
    d1_s = m;
  }
  __syncthreads();
  const float d1 = d1_s;
  const float thr = __fmul_rn(g, __fsqrt_rn(d1));
  const float* drow = d2 + (size_t)i * N;
  float* wrow = w + (size_t)i * N;
  float s = 0.f;
  for (int j = tid; j < N; j += kRowThreads) {
    const float d = drow[j];
    const bool ok = j != i;
    const bool near = ok && d <= thr;
    const bool in_r = ok && d <= r2;
    const bool far = in_r && !near;
    const float wv = __fadd_rn(far ? __fdiv_rn(d1, fmaxf(d, 1e-12f)) : 0.f,
                               (near && in_r) ? inv_c : 0.f);
    wrow[j] = wv;
    s = __fadd_rn(s, wv);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if (lane == 0) red[warp] = s;   // tid 0 read the minima before d1_s
  __syncthreads();
  if (tid == 0) {
    float tot = red[0];
    for (int k = 1; k < kRowThreads / 32; ++k) tot = __fadd_rn(tot, red[k]);
    W[i] = tot;
  }
}

// xt (D, N) = x (N, D)^T through 32 x 32 shared tiles.
__global__ void transpose_kernel(const float* __restrict__ x,
                                 float* __restrict__ xt, int N, int D) {
  __shared__ float t[32][33];
  const int n0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int n = n0 + r, d = d0 + threadIdx.x;
    if (n < N && d < D) t[r][threadIdx.x] = x[(size_t)n * D + d];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int d = d0 + r, n = n0 + threadIdx.x;
    if (d < D && n < N) xt[(size_t)d * N + n] = t[threadIdx.x][r];
  }
}

// F = w @ x - W * x: the tile over (w (N, N), x^T (D, N)) with depth N, on
// persistent blocks; the blocks that share a row tile of w run together.
__global__ void __launch_bounds__(THREADS, 1)
lpgf_wx_kernel(const float* __restrict__ w, const float* __restrict__ xt,
               const float* __restrict__ x, const float* __restrict__ W,
               float* __restrict__ F, int N, int D, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int ctiles = (D + BN - 1) / BN;
  const long long total = (long long)((N + BM - 1) / BM) * ctiles;
  const int ntiles = (int)((total - blockIdx.x + gridDim.x - 1) / gridDim.x);
  auto tile = [&](int t, int& m0, int& n0) {
    const long long g = blockIdx.x + (long long)t * gridDim.x;
    m0 = (int)(g / ctiles) * BM;
    n0 = (int)(g % ctiles) * BN;
  };
  auto epi = [&](int t, float (&acc)[TM][TN], const float*, const float*,
                 const Lane& L) {
    int m0, n0;
    tile(t, m0, n0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + L.row(i);
      if (m >= N) continue;
      const float wi = W[m];
      const float* xr = x + (size_t)m * D;
      float* fr = F + (size_t)m * D;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int d = n0 + L.col(j);
        if (d < D) fr[d] = __fsub_rn(acc[i][j], __fmul_rn(wi, xr[d]));
      }
    }
  };
  walk(w, xt, N, D, N, vec != 0, ntiles, tile, epi, smem);
}

}  // namespace

// x (N, D) fp32, N, D >= 1; scratch: d2 (N, N), w (N, N; may be d2 itself,
// then the weights replace the distances), pmin (N, ceil(N / 128)),
// xt (D, N); outputs F (N, D) and W (N,). All contiguous fp32 device
// buffers. Launches four kernels on `stream`; returns cudaGetLastError()
// (0 = launched).
extern "C" int lpgf_force_launch(const float* x, float* d2, float* w,
                                 float* pmin, float* xt, float* F, float* W,
                                 int N, int D, float r2, float g, float inv_c,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int T = (N + BM - 1) / BM;
  cudaError_t set = cudaFuncSetAttribute(
      lpgf_d2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kD2Smem);
  const cudaError_t set2 = cudaFuncSetAttribute(
      lpgf_wx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (set == cudaSuccess) set = set2;
  const long long upper = (long long)T * (T + 1) / 2;
  lpgf_d2_kernel<<<persistent_grid((const void*)lpgf_d2_kernel, kD2Smem,
                                   upper),
                   THREADS, kD2Smem, st>>>(x, d2, pmin, N, D,
                                           (int)vec_ok(x, x, D));
  lpgf_weights_kernel<<<N, kRowThreads, 0, st>>>(d2, w, pmin, W, N, T, r2, g,
                                                 inv_c);
  transpose_kernel<<<dim3((N + 31) / 32, (D + 31) / 32), dim3(32, 8), 0,
                     st>>>(x, xt, N, D);
  const long long wx = (long long)T * ((D + BN - 1) / BN);
  lpgf_wx_kernel<<<persistent_grid((const void*)lpgf_wx_kernel, SMEM_BYTES,
                                   wx),
                   THREADS, SMEM_BYTES, st>>>(w, xt, x, W, F, N, D,
                                              (int)vec_ok(w, xt, N));
  const cudaError_t err = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : set);
}
