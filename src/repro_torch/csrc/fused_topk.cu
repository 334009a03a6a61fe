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
// index" is plain integer order. A NaN distance (a row with a NaN
// coordinate) keys as the positive quiet NaN 0x7fc00000, which sorts after
// +inf and before the padding keys (high word 0xFFFFFFFF): NaN rows rank
// last and keep their index order, as in ref.stable_topk and lax.top_k. A chunk of keys merges into the sorted
// running buffer of K keys by rank: each key's output slot is its rank in
// its own list plus its rank in the other, and slots >= K fall off. A
// chunk with no key below the running kth skips the merge.
//
// topk_l2_masked at any K: the running buffer and its merge target (2K
// keys per query) live in dynamic shared memory, opted in above 48 KB,
// while they fit beside the chunk keys; above that K they live in a
// global-memory scratch that the wrapper allocates
// (topk_l2_masked_scratch_bytes says how much, 0 when shared memory holds
// them). The code is the same either way: B and T are generic pointers,
// and __syncthreads orders global writes within the block as it does
// shared ones.
//
// Bounds on this card:
//   * topk_l2_masked reads G*C*D*4 bytes of candidates for G*C*D*2
//     operations: memory-bound (a batched GEMV). One 256-thread block
//     per query keeps q in shared memory; each warp computes whole
//     candidate rows (lanes stride D, so loads are coalesced) and masked
//     candidates are never read. Chunks of 256 candidates.
//   * topk_l2 does 2*M*N*D operations on (M + N)*D floats: operation-
//     bound, on the SIMT fp32 pipe. It forms its distances with the tile
//     pairwise_sq_l2 uses (l2_tile.cuh), bit for bit the same, and splits
//     N across blocks so that the card is full at the path's shape: LPGF's
//     mean NN distance, 2048 sampled rows against all N=200k rows, k=2
//     (see the "shared" section below).
#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

#include "l2_tile.cuh"

namespace {

typedef unsigned long long u64;

constexpr u64 kInfHi = 0x7f800000ull;

constexpr u64 kNanHi = 0x7fc00000ull;
constexpr unsigned kPadHi = 0xFFFFFFFFu;

__device__ __forceinline__ u64 pack_key(float d, unsigned idx) {
  if (d != d) return (kNanHi << 32) | (u64)idx;
  d = (d > 0.f) ? d : 0.f;  // clamp, and -0.0 -> +0.0
  return ((u64)__float_as_uint(d) << 32) | (u64)idx;
}

__device__ __forceinline__ u64 inf_key(unsigned idx) {
  return (kInfHi << 32) | (u64)idx;
}

// Empty buffer slots, and columns past N, sort after every candidate and
// stay unique (a slot is below K <= N, a column at or past N).
__device__ __forceinline__ u64 empty_key(int slot) {
  return ((u64)kPadHi << 32) | (u64)(unsigned)slot;
}

// The running kth as a bound for the early-out: NaN and padding read +inf.
__device__ __forceinline__ float key_dist(u64 key) {
  const unsigned hi = (unsigned)(key >> 32);
  return hi >= (unsigned)kInfHi ? __int_as_float(0x7f800000)
                                : __uint_as_float(hi);
}

// The distance a key reports: its own bits (NaN stays NaN), +inf for a
// padding key.
__device__ __forceinline__ float out_dist(u64 key) {
  const unsigned hi = (unsigned)(key >> 32);
  return hi == kPadHi ? __int_as_float(0x7f800000) : __uint_as_float(hi);
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
    // exhausted, invalid (+inf) and NaN slots carry index -1, as the
    // plain version's isfinite test gives them
    const u64 key = b[i];
    const unsigned hi = (unsigned)(key >> 32);
    outd[i] = out_dist(key);
    outi[i] = hi < (unsigned)kInfHi
                  ? (long long)(unsigned)(key & 0xFFFFFFFFull) : -1;
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
// topk_l2 in two kernels: topk_l2_split_kernel walks, for one 128-row tile
// of q, the column tiles of one split of p through the shared distance
// tile (l2_tile.cuh) and leaves that split's k best keys per row in a
// partial buffer (M, splits, K); topk_merge_kernel then merges each row's
// splits. The grid (row tiles, splits) fills the card where the row tiles
// alone would not: at (2048, 200k, 512) 16 row tiles x 8 splits.
//
// Two routes, chosen by the wrapper from K alone:
//   * registers (K <= kRegK): each thread keeps, for each of its 8 rows, the
//     kRegK best keys over its own columns, sorted, in registers; after the
//     walk the 16 threads that share a row pool theirs in shared memory and
//     one of them keeps the row's best;
//   * rank merge (any K): each tile's keys go to shared memory, 16 rows at a
//     time, and 16 threads per row rank-merge them (merge_chunk) into the
//     row's sorted running buffer, which lives in the partial buffer itself
//     (its merge target in a second global buffer); a tile with no key below
//     the running kth skips the merge.
// Keys are pack_key's (distance bits, index), unique per column, so "ties
// keep the lower index" holds in any split order and any merge order.
constexpr int kRegK = 2;
constexpr int kSLD = l2tile::BN + 8;   // shared key row stride (u64)
constexpr int kPassRows = 16;          // rows a merge pass
constexpr int kGroup = l2tile::THREADS / kPassRows;   // threads a row
constexpr size_t kMergeSmem =
    l2tile::SMEM_BYTES + (size_t)kPassRows * kSLD * sizeof(u64);

// Insert `key` into the sorted list `b` (the largest key falls off).
template <int KR>
__device__ __forceinline__ void insert_key(u64 (&b)[KR], u64 key) {
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const u64 lo = key < b[r] ? key : b[r];
    key = key < b[r] ? b[r] : key;
    b[r] = lo;
  }
}

// The first column tile of split s when T column tiles are cut into S
// splits: split s takes tiles [s * T / S, (s + 1) * T / S).
__device__ __forceinline__ int split_tile(int s, int tiles, int splits) {
  return (int)((long long)s * tiles / splits);
}

template <bool REG>
__global__ void __launch_bounds__(l2tile::THREADS, 1)
topk_l2_split_kernel(const float* __restrict__ q, const float* __restrict__ p,
                     u64* part, u64* tmp, int M, int N, int D, int K,
                     int vec) {
  using namespace l2tile;
  extern __shared__ __align__(16) float tile_smem[];
  const int splits = gridDim.y, s = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  const int tiles = (N + BN - 1) / BN;
  const int c0 = split_tile(s, tiles, splits);
  const int ntiles = split_tile(s + 1, tiles, splits) - c0;
  auto tile = [&](int t, int& a, int& b) {
    a = m0;
    b = (c0 + t) * BN;
  };
  // row m's partial for this split: its running buffer on the merge route
  auto row_part = [&](int m) { return part + ((size_t)m * splits + s) * K; };
  const Lane L0 = lane_of(threadIdx.x);

  if constexpr (REG) {
    u64 best[TM][kRegK];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int r = 0; r < kRegK; ++r) best[i][r] = ~0ull;
    auto keep = [&](int t, float (&acc)[TM][TN], const float* qn,
                    const float* pn, const Lane& L) {
      const int n0 = (c0 + t) * BN;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float qv = qn[L.row(i)];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + L.col(j);
          const u64 key =
              pack_key(sq_dist(qv, pn[L.col(j)], acc[i][j]), (unsigned)n);
          if (n < N && key < best[i][kRegK - 1]) insert_key(best[i], key);
        }
      }
    };
    walk(q, p, M, N, D, vec != 0, ntiles, tile, keep, tile_smem);
    // pool the 16 lists of each row, then keep the row's best kRegK
    __syncthreads();
    u64* pool = reinterpret_cast<u64*>(tile_smem);    // [BM][16][kRegK]
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int r = 0; r < kRegK; ++r)
        pool[(L0.row(i) * 16 + L0.row_slot()) * kRegK + r] = best[i][r];
    __syncthreads();
    if (L0.tid < BM && m0 + L0.tid < M) {
      u64 top[kRegK];
#pragma unroll
      for (int r = 0; r < kRegK; ++r) top[r] = ~0ull;
      const u64* row = pool + L0.tid * 16 * kRegK;
      for (int e = 0; e < 16 * kRegK; ++e)
        if (row[e] < top[kRegK - 1]) insert_key(top, row[e]);
      u64* dst = row_part(m0 + L0.tid);
#pragma unroll
      for (int r = 0; r < kRegK; ++r)
        if (r < K) dst[r] = top[r];
    }
  } else {
    u64* S = reinterpret_cast<u64*>(tile_smem + SMEM_BYTES / sizeof(float));
    for (int r = 0; r < BM && m0 + r < M; ++r) {
      u64* b = row_part(m0 + r);
      for (int i = threadIdx.x; i < K; i += THREADS) b[i] = empty_key(i);
    }
    __syncthreads();
    auto merge = [&](int t, float (&acc)[TM][TN], const float* qn,
                     const float* pn, const Lane& L) {
      const int n0 = (c0 + t) * BN;
      const int g = L.tid / kGroup, gl = L.tid % kGroup;
      // pass h takes rows [16h, 16h + 16): warp row wm = h / 2, and of
      // each thread's rows wm*32 + ty + 4i those with i / 4 == h % 2
#pragma unroll
      for (int h = 0; h < BM / kPassRows; ++h) {
        if (L.wm == h / 2) {
#pragma unroll
          for (int i = 4 * (h % 2); i < 4 * (h % 2) + 4; ++i) {
            const float qv = qn[L.row(i)];
            u64* srow = S + (L.row(i) - h * kPassRows) * kSLD;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int n = n0 + L.col(j);
              srow[L.col(j)] =
                  n < N ? pack_key(sq_dist(qv, pn[L.col(j)], acc[i][j]),
                                   (unsigned)n)
                        : empty_key(n);
            }
          }
        }
        __syncthreads();
        const int m = m0 + h * kPassRows + g;
        const u64* srow = S + g * kSLD;
        u64* b = m < M ? row_part(m) : nullptr;
        const u64 kth = b ? b[K - 1] : 0ull;
        int hit = 0;
        for (int c = gl; c < BN; c += kGroup) hit |= srow[c] < kth;
#pragma unroll
        for (int o = 1; o < kGroup; o <<= 1)
          hit |= __shfl_xor_sync(0xffffffffu, hit, o);
        u64* tb = b ? tmp + ((size_t)m * splits + s) * K : nullptr;
        if (hit) merge_chunk(srow, BN, b, tb, K, gl, kGroup);
        __syncwarp();
        if (hit)
          for (int i = gl; i < K; i += kGroup) b[i] = tb[i];
        __syncthreads();
      }
    };
    walk(q, p, M, N, D, vec != 0, ntiles, tile, merge, tile_smem);
  }
}

// Row m's splits (each sorted, K keys) -> its K best, ascending. A real
// key's output slot is its place in its own split plus, in every other
// split, the keys below it: each column lies in one split, so real keys
// are unique and the slots a permutation. Padding keys (empty slots, and
// columns past N) sort after every real key, NaN ones included, and
// K <= N real keys exist, so none can take a slot below K; they are
// skipped. A real key reports its own distance (+inf or NaN too) and
// index, as the plain version does.
__global__ void topk_merge_kernel(const u64* __restrict__ part,
                                  float* __restrict__ outd,
                                  long long* __restrict__ outi, int splits,
                                  int K) {
  const int m = blockIdx.x;
  const u64* rowp = part + (size_t)m * splits * K;
  const long long total = (long long)splits * K;
  for (long long e = threadIdx.x; e < total; e += blockDim.x) {
    const u64 key = rowp[e];
    if ((unsigned)(key >> 32) == kPadHi) continue;
    const int s = (int)(e / K);
    long long slot = e - (long long)s * K;
    for (int t = 0; t < splits && slot < K; ++t) {
      if (t == s) continue;
      slot += lower_bound(rowp + (size_t)t * K, K, key);
    }
    if (slot < K) {
      outd[(size_t)m * K + slot] = out_dist(key);
      outi[(size_t)m * K + slot] = (long long)(unsigned)(key & 0xFFFFFFFFull);
    }
  }
}

template <bool REG>
int split_occupancy() {
  int occ = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, topk_l2_split_kernel<REG>, l2tile::THREADS,
      REG ? l2tile::SMEM_BYTES : kMergeSmem);
  return occ > 0 ? occ : 1;
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

// The number of N splits topk_l2_launch uses for M queries over N points
// at this K on one route (reg = K <= topk_l2_reg_k()): as many as fill the
// card's block slots beside the row tiles, at most one a column tile, and
// on the rank-merge route at most one per 4K points (each split fills a
// K-key buffer, and the split merge's work grows with splits^2 * K).
extern "C" int topk_l2_splits(int M, int N, int K, int reg) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int slots = sms * (reg ? split_occupancy<true>()
                               : split_occupancy<false>());
  const int rows = (M + l2tile::BM - 1) / l2tile::BM;
  const int tiles = (N + l2tile::BN - 1) / l2tile::BN;
  int splits = slots / rows;
  if (!reg) {
    const long long cap = (long long)N / (4ll * K);
    if (splits > cap) splits = (int)cap;
  }
  if (splits > tiles) splits = tiles;
  return splits > 1 ? splits : 1;
}

// The largest K the register route takes.
extern "C" int topk_l2_reg_k() { return kRegK; }

// Bytes of global scratch topk_l2_launch needs: the (M, splits, K) partial
// keys, and on the rank-merge route their merge target beside them.
extern "C" long long topk_l2_scratch_bytes(int M, int K, int splits,
                                           int reg) {
  return (long long)(reg ? 1 : 2) * M * splits * K * (long long)sizeof(u64);
}

// q (M, D), p (N, D) fp32; 1 <= K <= N (K <= topk_l2_reg_k() when reg);
// scratch: topk_l2_scratch_bytes(M, K, splits, reg) bytes. Leaves each
// row's best K keys of every split in the scratch, for
// topk_l2_merge_launch. Returns cudaGetLastError().
extern "C" int topk_l2_launch(const float* q, const float* p, void* scratch,
                              int M, int N, int D, int K, int splits,
                              int reg, void* stream) {
  if (reg && K > kRegK) return (int)cudaErrorInvalidValue;
  u64* part = (u64*)scratch;
  u64* tmp = reg ? nullptr : part + (size_t)M * splits * K;
  const dim3 grid((M + l2tile::BM - 1) / l2tile::BM, splits);
  const int vec = (int)l2tile::vec_ok(q, p, D);
  cudaError_t set;
  if (reg) {
    set = cudaFuncSetAttribute(topk_l2_split_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)l2tile::SMEM_BYTES);
    topk_l2_split_kernel<true>
        <<<grid, l2tile::THREADS, l2tile::SMEM_BYTES, (cudaStream_t)stream>>>(
            q, p, part, tmp, M, N, D, K, vec);
  } else {
    set = cudaFuncSetAttribute(topk_l2_split_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMergeSmem);
    topk_l2_split_kernel<false>
        <<<grid, l2tile::THREADS, kMergeSmem, (cudaStream_t)stream>>>(
            q, p, part, tmp, M, N, D, K, vec);
  }
  return launch_error(set);
}

// Merge the splits topk_l2_launch left in `scratch` into outd (M, K) fp32
// ascending and outi (M, K) int64. Returns cudaGetLastError().
extern "C" int topk_l2_merge_launch(const void* scratch, float* outd,
                                    long long* outi, int M, int K, int splits,
                                    void* stream) {
  topk_merge_kernel<<<M, 128, 0, (cudaStream_t)stream>>>(
      (const u64*)scratch, outd, outi, splits, K);
  return launch_error(cudaSuccess);
}
