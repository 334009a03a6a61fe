// Fused distance + running top-k on Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels in repro/kernels/fused_topk.py:
//   * topk_l2_masked_pallas (_masked_kernel): per-query candidate tiles
//     q (G, D), p (G, C, D), valid (G, C), optional lb2 (G, C) ->
//     (G, K) ascending squared distances + int64 indices into [0, C);
//     exhausted slots (inf, -1); the lower index wins ties; the lb2
//     early-out skips a chunk none of whose valid candidates has
//     lb2 < running kth, which never changes the ids.
//   * topk_l2_pallas (_kernel): one shared point set q (M, D) vs p (N, D)
//     -> (M, K) ascending squared distances + int64 indices.
//
// Ranking: every candidate becomes one unique 64-bit key
// (fp32 bits of its clamped non-negative distance << 32) | index, whose
// integer order is the (distance, index) order, so "ties keep the lower
// index" is plain integer order. A chunk of keys merges into the sorted
// running buffer of K keys by rank: each key's output slot is its rank in
// its own list plus its rank in the other, and slots >= K fall off. A
// chunk with no key below the running kth skips the merge.
//
// Any K: the running buffer and its merge target (2K keys per query) live
// in dynamic shared memory, opted in above 48 KB, while they fit beside
// the chunk keys; above that K they live in a global-memory scratch that
// the wrapper allocates (*_scratch_bytes says how much, 0 when shared
// memory holds them). The code is the same either way: B and T are
// generic pointers, and __syncthreads orders global writes within the
// block as it does shared ones.
//
// Bounds on this card:
//   * topk_l2_masked reads G*C*D*4 bytes of candidates for G*C*D*2
//     operations: memory-bound (a batched GEMV). One 256-thread block
//     per query keeps q in shared memory; each warp computes whole
//     candidate rows (lanes stride D, so loads are coalesced) and masked
//     candidates are never read. Chunks of 256 candidates.
//   * topk_l2 does 2*M*N*D operations on (M + N)*D floats: operation-
//     bound. A block of 16 queries shares every staged 64-point chunk
//     (sliced along D through shared memory), so the point set is read
//     M/16 times instead of M times; the main path calls it with M=4096
//     sampled queries against all N=200k rows (LPGF's mean NN distance).
#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kInfHi = 0x7f800000ull;

__device__ __forceinline__ u64 pack_key(float d, unsigned idx) {
  d = (d > 0.f) ? d : 0.f;  // clamp, and -0.0 -> +0.0
  return ((u64)__float_as_uint(d) << 32) | (u64)idx;
}

__device__ __forceinline__ u64 inf_key(unsigned idx) {
  return (kInfHi << 32) | (u64)idx;
}

// Empty buffer slots sort after every candidate and stay unique.
__device__ __forceinline__ u64 empty_key(int slot) {
  return 0xFFFFFFFF00000000ull | (u64)slot;
}

__device__ __forceinline__ float key_dist(u64 key) {
  const unsigned hi = (unsigned)(key >> 32);
  return hi >= (unsigned)kInfHi ? __int_as_float(0x7f800000)
                                : __uint_as_float(hi);
}

__device__ __forceinline__ int count_lt(const u64* s, int n, u64 key) {
  int c = 0;
  for (int j = 0; j < n; ++j) c += (s[j] < key);
  return c;
}

__device__ __forceinline__ int lower_bound(const u64* b, int n, u64 key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Rank-merge `ns` unsorted chunk keys into the sorted buffer `b` (K keys),
// writing the K smallest of the union, sorted, into `t`. Run by a group
// of `gsz` threads (lane `gl`); the caller synchronises and copies back.
__device__ void merge_chunk(const u64* s, int ns, const u64* b, u64* t, int K,
                            int gl, int gsz) {
  const u64 kth = b[K - 1];
  for (int j = gl; j < ns; j += gsz) {
    const u64 key = s[j];
    if (key < kth) {
      const int pos = count_lt(s, ns, key) + lower_bound(b, K, key);
      if (pos < K) t[pos] = key;
    }
  }
  for (int i = gl; i < K; i += gsz) {
    const u64 key = b[i];
    const int pos = i + count_lt(s, ns, key);
    if (pos < K) t[pos] = key;
  }
}

__device__ __forceinline__ void write_out(const u64* b, int K, float* outd,
                                          long long* outi, int tid, int nthr) {
  for (int i = tid; i < K; i += nthr) {
    const u64 key = b[i];
    const unsigned hi = (unsigned)(key >> 32);
    if (hi >= (unsigned)kInfHi) {
      outd[i] = __int_as_float(0x7f800000);
      outi[i] = -1;
    } else {
      outd[i] = __uint_as_float(hi);
      outi[i] = (long long)(unsigned)(key & 0xFFFFFFFFull);
    }
  }
}

// ---------------------------------------------------------------- masked
constexpr int kChunk = 256;
constexpr int kMaskedThreads = 256;

__global__ void __launch_bounds__(kMaskedThreads)
topk_l2_masked_kernel(const float* __restrict__ q, const float* __restrict__ p,
                      const uint8_t* __restrict__ valid,
                      const float* __restrict__ lb2, float* __restrict__ outd,
                      long long* __restrict__ outi, u64* scratch, int C,
                      int D, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* S = reinterpret_cast<u64*>(smem);  // kChunk keys
  float* qs = reinterpret_cast<float*>(S + kChunk);
  const int g = blockIdx.x;
  // K running keys + K merge output: shared memory after q, or scratch
  u64* B = scratch ? scratch + (size_t)g * 2 * K
                   : reinterpret_cast<u64*>(qs + ((D + 1) & ~1));
  u64* T = B + K;
  __shared__ float qq_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kMaskedThreads / 32;
  const float* qg = q + (size_t)g * D;
  const uint8_t* vg = valid + (size_t)g * C;
  const float* lg = lb2 ? lb2 + (size_t)g * C : nullptr;

  for (int d = tid; d < D; d += kMaskedThreads) qs[d] = qg[d];
  for (int i = tid; i < K; i += kMaskedThreads) B[i] = empty_key(i);
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(qs[d], qs[d], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) qq_s = s;
  }
  __syncthreads();
  const float qq = qq_s;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int n = min(kChunk, C - c0);
    if (lg != nullptr) {
      // tile early-out: only a valid candidate whose squared lower bound
      // is below the running kth can change the buffer (an equal one
      // can only tie, and ties never displace the lower index)
      const float kthd = key_dist(B[K - 1]);
      int live = 0;
      for (int j = tid; j < n; j += kMaskedThreads)
        live |= (vg[c0 + j] != 0) && (lg[c0 + j] < kthd);
      if (!__syncthreads_or(live)) continue;
    }
    for (int j = warp; j < n; j += nwarps) {
      const int c = c0 + j;
      u64 key;
      if (vg[c] != 0) {
        const float* row = p + ((size_t)g * C + c) * D;
        float pp = 0.f, cr = 0.f;
#pragma unroll 4
        for (int d = lane; d < D; d += 32) {
          const float x = row[d];
          pp = fmaf(x, x, pp);
          cr = fmaf(qs[d], x, cr);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          pp += __shfl_xor_sync(0xffffffffu, pp, off);
          cr += __shfl_xor_sync(0xffffffffu, cr, off);
        }
        key = pack_key((qq + pp) - 2.f * cr, (unsigned)c);
      } else {
        key = inf_key((unsigned)c);
      }
      if (lane == 0) S[j] = key;
    }
    __syncthreads();
    int hit = 0;
    for (int j = tid; j < n; j += kMaskedThreads) hit |= (S[j] < B[K - 1]);
    if (!__syncthreads_or(hit)) continue;
    merge_chunk(S, n, B, T, K, tid, kMaskedThreads);
    __syncthreads();
    for (int i = tid; i < K; i += kMaskedThreads) B[i] = T[i];
    __syncthreads();
  }
  write_out(B, K, outd + (size_t)g * K, outi + (size_t)g * K, tid,
            kMaskedThreads);
}

// ---------------------------------------------------------------- shared
constexpr int QB = 16;   // queries per block
constexpr int PC = 64;   // points per staged chunk
constexpr int BK = 32;   // D slice per stage

__global__ void __launch_bounds__(256)
topk_l2_kernel(const float* __restrict__ q, const float* __restrict__ p,
               float* __restrict__ outd, long long* __restrict__ outi,
               u64* scratch, int M, int N, int D, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* S = reinterpret_cast<u64*>(smem);  // QB * PC
  // QB * K running keys + QB * K merge output: shared memory after the
  // chunk keys, or this block's slice of the scratch
  u64* B = scratch ? scratch + (size_t)blockIdx.x * 2 * QB * K : S + QB * PC;
  u64* T = B + QB * K;
  __shared__ float Qs[QB][BK + 1];
  __shared__ float Ps[PC][BK + 1];
  __shared__ float qqs[QB];
  __shared__ float pps[PC];

  const int tid = threadIdx.x;
  const int qi = tid / 16;     // this thread's query within the block
  const int l16 = tid % 16;    // lane within the query's 16-thread group
  const int m0 = blockIdx.x * QB;
  const int gm = m0 + qi;

  {
    float s = 0.f;
    if (gm < M) {
      const float* row = q + (size_t)gm * D;
      for (int d = l16; d < D; d += 16) s = fmaf(row[d], row[d], s);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (l16 == 0) qqs[qi] = s;
  }
  for (int i = tid; i < QB * K; i += 256) B[i] = empty_key(i % K);
  __syncthreads();

  for (int n0 = 0; n0 < N; n0 += PC) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float pn = 0.f;
    for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
      for (int i = 0; i < (QB * BK) / 256; ++i) {
        const int e = tid + i * 256;
        const int r = e / BK, c = e % BK;
        const int m = m0 + r, k = k0 + c;
        Qs[r][c] = (m < M && k < D) ? q[(size_t)m * D + k] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < (PC * BK) / 256; ++i) {
        const int e = tid + i * 256;
        const int r = e / BK, c = e % BK;
        const int n = n0 + r, k = k0 + c;
        Ps[r][c] = (n < N && k < D) ? p[(size_t)n * D + k] : 0.f;
      }
      __syncthreads();
      if (tid < PC) {
#pragma unroll
        for (int c = 0; c < BK; ++c) pn = fmaf(Ps[tid][c], Ps[tid][c], pn);
      }
#pragma unroll
      for (int c = 0; c < BK; ++c) {
        const float a = Qs[qi][c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r] = fmaf(a, Ps[l16 + 16 * r][c], acc[r]);
      }
      __syncthreads();
    }
    if (tid < PC) pps[tid] = pn;
    __syncthreads();
    u64* Sq = S + qi * PC;
    u64* Bq = B + qi * K;
    int hit = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = l16 + 16 * r;
      const int n = n0 + j;
      u64 key;
      if (n < N && gm < M)
        key = pack_key((qqs[qi] + pps[j]) - 2.f * acc[r], (unsigned)n);
      else
        key = inf_key((unsigned)n);
      Sq[j] = key;
      hit |= key < Bq[K - 1];
    }
    if (!__syncthreads_or(hit)) continue;
    merge_chunk(Sq, PC, Bq, T + qi * K, K, l16, 16);
    __syncthreads();
    for (int i = l16; i < K; i += 16) Bq[i] = T[qi * K + i];
    __syncthreads();
  }
  if (gm < M)
    write_out(B + qi * K, K, outd + (size_t)gm * K, outi + (size_t)gm * K,
              l16, 16);
}

// Dynamic shared memory the kernel may take beside its static arrays.
int dyn_smem_limit(const void* kernel) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, kernel);
  return optin - (int)attr.sharedSizeBytes;
}

size_t masked_base_smem(int D) {
  return (size_t)kChunk * sizeof(u64) + (size_t)((D + 1) & ~1) * sizeof(float);
}

size_t masked_buffer_bytes(int K) { return (size_t)2 * K * sizeof(u64); }

size_t shared_base_smem() { return (size_t)QB * PC * sizeof(u64); }

size_t shared_buffer_bytes(int K) { return (size_t)2 * QB * K * sizeof(u64); }

int launch_error(cudaError_t set) {
  const cudaError_t err = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : set);
}

}  // namespace

// Bytes of global scratch topk_l2_masked_launch needs for G queries of
// width D at this K: 0 while the running buffers fit in shared memory.
extern "C" long long topk_l2_masked_scratch_bytes(int G, int D, int K) {
  const size_t smem = masked_base_smem(D) + masked_buffer_bytes(K);
  if (smem <= (size_t)dyn_smem_limit((const void*)topk_l2_masked_kernel))
    return 0;
  return (long long)G * (long long)masked_buffer_bytes(K);
}

// q (G, D), p (G, C, D), valid (G, C) uint8, lb2 (G, C) or NULL; outd (G, K)
// fp32, outi (G, K) int64; 1 <= K <= C; scratch: NULL, or
// topk_l2_masked_scratch_bytes(G, D, K) bytes. Returns cudaGetLastError().
extern "C" int topk_l2_masked_launch(const float* q, const float* p,
                                     const uint8_t* valid, const float* lb2,
                                     float* outd, long long* outi,
                                     void* scratch, int G, int C, int D,
                                     int K, void* stream) {
  const size_t smem =
      masked_base_smem(D) + (scratch ? 0 : masked_buffer_bytes(K));
  const cudaError_t set = cudaFuncSetAttribute(
      topk_l2_masked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  topk_l2_masked_kernel<<<G, kMaskedThreads, smem, (cudaStream_t)stream>>>(
      q, p, valid, lb2, outd, outi, (u64*)scratch, C, D, K);
  return launch_error(set);
}

// Bytes of global scratch topk_l2_launch needs for M queries at this K: 0
// while the running buffers fit in shared memory.
extern "C" long long topk_l2_scratch_bytes(int M, int K) {
  const size_t smem = shared_base_smem() + shared_buffer_bytes(K);
  if (smem <= (size_t)dyn_smem_limit((const void*)topk_l2_kernel)) return 0;
  return (long long)((M + QB - 1) / QB) * (long long)shared_buffer_bytes(K);
}

// q (M, D), p (N, D); outd (M, K) fp32, outi (M, K) int64; 1 <= K <= N;
// scratch: NULL, or topk_l2_scratch_bytes(M, K) bytes. Returns
// cudaGetLastError().
extern "C" int topk_l2_launch(const float* q, const float* p, float* outd,
                              long long* outi, void* scratch, int M, int N,
                              int D, int K, void* stream) {
  const size_t smem =
      shared_base_smem() + (scratch ? 0 : shared_buffer_bytes(K));
  const cudaError_t set = cudaFuncSetAttribute(
      topk_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  topk_l2_kernel<<<(M + QB - 1) / QB, 256, smem, (cudaStream_t)stream>>>(
      q, p, outd, outi, (u64*)scratch, M, N, D, K);
  return launch_error(set);
}
