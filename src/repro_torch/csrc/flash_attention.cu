// Blocked online-softmax attention (forward) in IEEE fp32 on the SIMT
// cores of Hopper (sm_90a): every fp32 input, and bf16 at hd 16 and 32.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (_kernel). For q, k, v of shape (B, S, H, hd),
// with H already expanded by the caller (GQA is a gather before the call),
// and every (b, h, query position i):
//   s_j  = (q_i * scale) . k_j          fp32, scale = fp32(1/sqrt(hd))
//   s_j  = -1e30 where masked           causal: j > i; window: j <= i - window
//   out  = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
// with m the running row maximum of an online softmax: fp32 m, l and
// accumulators, one 64-key tile at a time, as the TPU kernel does. The
// output is cast to the inputs' type. The scale multiplies q in fp32
// before the dot, as in the TPU kernel. Positions >= S are no keys (weight
// exactly 0) and their query rows are not written. Products are IEEE fp32
// fmaf on the SIMT cores: no TF32.
//
// Bound on this card: 4*hd*B*H*(pairs the mask leaves open) fp32
// operations against 4 reads or writes of B*S*H*hd elements, so at a
// prefill's shapes (S in the thousands, hd 128) the SIMT fp32 rate, 67
// TFLOP/s at 700 W.
//
// Design: one block of 256 threads (8 warps) per (b*h, BQ-query block),
// BQ = 16*RQ: 128 queries at hd 64 and 128 (RQ = 8), 64 at hd 16 and 32
// (RQ = 4, twice the blocks for the short rows of small heads), chosen
// by hd alone in `dispatch` (mirrored by `flash_attention.SIMT_BLOCK_Q`
// for the tests' model of the walk). Query blocks run
// last-first, so under the causal mask the longest start first.
//
//   * Lane (warp w, half h, tx) owns RQ query rows, w*2*RQ + h*RQ + i,
//     and, of each 64-key tile, the keys tx + 16c (c < 4): RQ x 4 scores
//     (8 x 4 at hd 128: 12 float4 reads give 128 FMAs). Its output is the
//     same RQ rows times hd/16 columns (8 x 8 accumulators at hd 128). A
//     row's 16 lanes are one half-warp, so its max and sum are shuffles.
//   * Q is staged once, scaled, as fp32 rows in shared memory: a row is
//     read by one half-warp at one address (a broadcast), so it needs no
//     padding. K and V tiles keep the inputs' type and are staged by
//     16-byte (fp32) or 8-byte (bf16) cp.async copies, each lane copying
//     four elements along hd, so a warp's copies coalesce; bf16 is
//     widened where it is read. K rows are padded to hd + 4 elements, so
//     the 8 lanes of a quarter-warp read 8 distinct rows in distinct
//     banks; V rows are read by all lanes at once along hd and need no
//     padding.
//   * A ring of 2 K/V stages (fp32 at hd 128: 204 KB with Q and P) or 3,
//     one barrier a tile: the next tiles load while this one computes.
//   * P stays in the warp: each lane's probabilities of one 16-key chunk
//     go to the warp's own slice of shared memory, [key][row] with rows
//     padded to 2*RQ + 4 floats, between two __syncwarp (no block
//     barrier), and the P.V product reads them back as broadcasts.
//   * The row sum l is kept per lane and summed over the 16 lanes once at
//     the end (the correction is the same on all of them).
//   * Tiles the mask covers for every query of the block are not walked,
//     and a warp skips the walked tiles it covers for all of its 2*RQ rows
//     (under the causal mask, half the warps on the last diagonal tile);
//     the mask and the ragged-S test are applied only to the tiles they
//     cut (the causal diagonal, a window's edge, the last tile of a ragged
//     S). A row whose first tile computed is all masked takes weights 1
//     there, and the next tile's correction exp(-1e30 - m) = 0 clears
//     them, as in the plain version; a tile skipped for a row would only
//     have added such weights, so skipping it changes no result.
//
// The inputs may be strided in B, S and H (stride 1 in hd; every stride
// and the base 4-element aligned, which the wrapper ensures); the output
// is a contiguous (B, S, H, hd) tensor.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "l2_tile.cuh"

namespace {

using l2tile::cp16;
using l2tile::cp_commit;
using l2tile::cp_wait;
using l2tile::smem_u32;

constexpr int kBK = 64;               // keys a tile
constexpr int kThreads = 256;         // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;
constexpr size_t kSmemMax = 232448;   // a block's dynamic shared memory

__device__ __forceinline__ void cp8(unsigned dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// Copy four elements (16 bytes of fp32, 8 of bf16) to shared memory;
// with ok false nothing is read and the four read as zero.
__device__ __forceinline__ void cp_four(float* dst, const float* src,
                                        bool ok) {
  cp16(smem_u32(dst), src, ok ? 16 : 0);
}

__device__ __forceinline__ void cp_four(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, bool ok) {
  cp8(smem_u32(dst), src, ok ? 8 : 0);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {
  long long b, s, h;  // elements; hd has stride 1
};

// Shapes and shared-memory layout of one instantiation: Q (fp32, BQ x hd),
// the warps' P slices (fp32), then the K/V ring in the inputs' type.
template <typename T, int HD, int RQ>
struct Cfg {
  static constexpr int BQ = 2 * kWarps * RQ;   // queries a block
  static constexpr int LDK = HD + 4;           // padded K row (elements)
  static constexpr int CPT = HD / 16;          // output columns a lane
  static constexpr int PST = 2 * RQ + 4;       // padded P slice row (floats)
  static constexpr size_t Q_BYTES = (size_t)BQ * HD * sizeof(float);
  static constexpr size_t P_BYTES = (size_t)kWarps * 16 * PST * sizeof(float);
  static constexpr int STAGE_ELEMS = kBK * (LDK + HD);
  static constexpr size_t STAGE_BYTES = (size_t)STAGE_ELEMS * sizeof(T);
  static constexpr int STAGES =
      Q_BYTES + P_BYTES + 3 * STAGE_BYTES <= kSmemMax ? 3 : 2;
  static constexpr size_t SMEM = Q_BYTES + P_BYTES + STAGES * STAGE_BYTES;
  static_assert(SMEM <= kSmemMax, "shared memory");
  static_assert(RQ % 4 == 0 && HD % 16 == 0, "shape");
};

template <typename T, int HD, int RQ>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int H, int BH,
          int causal, int window, float scale, Strides qs, Strides ks,
          Strides vs) {
  using C = Cfg<T, HD, RQ>;
  constexpr int BQ = C::BQ, LDK = C::LDK, CPT = C::CPT, PST = C::PST;
  constexpr int STAGES = C::STAGES;
  constexpr int kG = HD / 4;  // four-element groups in a row
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ps = Qs + BQ * HD;
  T* ring = reinterpret_cast<T*>(Ps + kWarps * 16 * PST);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = lane & 15, half = lane >> 4;
  const int row0 = (2 * warp + half) * RQ;  // this lane's first row
  const int nqb = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (nqb - 1 - (int)(blockIdx.x / BH)) * BQ;
  const int bi = bh / H, hi = bh % H;
  const T* kb = k + bi * ks.b + hi * ks.h;
  const T* vb = v + bi * vs.b + hi * vs.h;

  // the key tiles the mask leaves open for some query of the block
  const int nkt = (S + kBK - 1) / kBK;
  int j_end = nkt - 1;
  if (causal) j_end = min(j_end, (q0 + BQ - 1) / kBK);
  int j_begin = 0;
  if (window > 0) {
    // a tile is masked for every query of the block iff its last key is
    // <= q0 - window (the first query's mask is the least strict)
    const int lo = q0 - window;
    if (lo >= kBK - 1) j_begin = (lo - (kBK - 1)) / kBK + 1;
  }
  const int ntiles = j_end - j_begin + 1;

  // the it-th tile into ring stage it % STAGES; one commit group either way
  auto fetch = [&](int it) {
    if (it < ntiles) {
      const int k0 = (j_begin + it) * kBK;
      T* Ks = ring + (it % STAGES) * C::STAGE_ELEMS;
      T* Vs = Ks + kBK * LDK;
#pragma unroll
      for (int i = 0; i < kBK * kG / kThreads; ++i) {
        const int e = tid + i * kThreads, r = e / kG, c = e % kG * 4;
        const bool ok = k0 + r < S;
        const long long kr = ok ? (long long)(k0 + r) : 0;
        cp_four(Ks + r * LDK + c, kb + kr * ks.s + c, ok);
        cp_four(Vs + r * HD + c, vb + kr * vs.s + c, ok);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  // Q, scaled, while the first tiles are in flight
  {
    const T* qb = q + bi * qs.b + hi * qs.h;
#pragma unroll
    for (int i = 0; i < BQ * kG / kThreads; ++i) {
      const int e = tid + i * kThreads, r = e / kG, c = e % kG * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < S) x = load4(qb + (long long)(q0 + r) * qs.s + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
      store4(Qs + r * HD + c, x);
    }
  }

  float m[RQ], l[RQ], acc[RQ][CPT];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }
  const float* Qr = Qs + row0 * HD;
  float* Pw = Ps + warp * 16 * PST;

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<STAGES - 2>();   // this lane's copies of tile it have landed
    __syncthreads();         // everyone's; and tile it - 1 is done with
    fetch(it + STAGES - 1);  // into the stage tile it - 1 used
    const int k0 = (j_begin + it) * kBK;
    const T* Ks = ring + (it % STAGES) * C::STAGE_ELEMS;
    const T* Vs = Ks + kBK * LDK;
    // a tile the mask covers for all of this warp's rows adds nothing
    const int wq0 = q0 + warp * 2 * RQ;
    if ((causal && k0 > wq0 + 2 * RQ - 1) ||
        (window > 0 && k0 + kBK - 1 <= wq0 - window))
      continue;

    // scores: this lane's RQ rows x keys tx + 16c
    float s[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    const T* Kl = Ks + tx * LDK;
#pragma unroll 8
    for (int d = 0; d < HD; d += 4) {
      float4 a[RQ], b[4];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qr + i * HD + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = load4(Kl + c * 16 * LDK + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(a[i].x, b[c].x, s[i][c]);
          s[i][c] = fmaf(a[i].y, b[c].y, s[i][c]);
          s[i][c] = fmaf(a[i].z, b[c].z, s[i][c]);
          s[i][c] = fmaf(a[i].w, b[c].w, s[i][c]);
        }
    }

    // the mask, on the tiles it cuts only
    const bool cut = (causal && k0 + kBK - 1 > q0) ||
                     (window > 0 && k0 <= q0 + BQ - 1 - window) ||
                     k0 + kBK > S;
    if (cut) {
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int qpos = q0 + row0 + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kpos = k0 + tx + 16 * c;
          const bool keep = (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
          // a position past the end is no key at all: weight exactly 0
          s[i][c] = kpos >= S ? -INFINITY : (keep ? s[i][c] : kMasked);
        }
      }
    }

    // online softmax: the row max over the half-warp, p in place of s
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - mn);
        sum += s[i][c];
      }
      l[i] = fmaf(l[i], corr, sum);
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }

    // O += P.V, one 16-key chunk at a time through the warp's P slice
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      __syncwarp();  // the slice's previous chunk has been read
      float* pd = Pw + tx * PST + half * RQ;
#pragma unroll
      for (int i = 0; i < RQ; i += 4)
        store4(pd + i, make_float4(s[i][c], s[i + 1][c], s[i + 2][c],
                                   s[i + 3][c]));
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const float* pr = Pw + t * PST + half * RQ;
        float p[RQ];
#pragma unroll
        for (int i = 0; i < RQ; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(pr + i);
          p[i] = x.x;
          p[i + 1] = x.y;
          p[i + 2] = x.z;
          p[i + 3] = x.w;
        }
        const T* vr = Vs + (16 * c + t) * HD;
        float vv[CPT];
        if constexpr (CPT >= 4) {
#pragma unroll
          for (int g = 0; g < CPT / 4; ++g) {
            const float4 x = load4(vr + g * 64 + tx * 4);
            vv[4 * g] = x.x;
            vv[4 * g + 1] = x.y;
            vv[4 * g + 2] = x.z;
            vv[4 * g + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) vv[cc] = load1(vr + tx * CPT + cc);
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc)
            acc[i][cc] = fmaf(p[i], vv[cc], acc[i][cc]);
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int qpos = q0 + row0 + i;
    if (qpos >= S) continue;
    const float inv_l = 1.f / fmaxf(lt, 1e-30f);
    T* orow = o + (((long long)bi * S + qpos) * H + hi) * HD;
    if constexpr (CPT >= 4) {
#pragma unroll
      for (int g = 0; g < CPT / 4; ++g)
        store4(orow + g * 64 + tx * 4,
               make_float4(acc[i][4 * g] * inv_l, acc[i][4 * g + 1] * inv_l,
                           acc[i][4 * g + 2] * inv_l,
                           acc[i][4 * g + 3] * inv_l));
    } else {
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc)
        store1(orow + tx * CPT + cc, acc[i][cc] * inv_l);
    }
  }
}

template <typename T, int HD, int RQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int causal, int window, float scale,
                   Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  using C = Cfg<T, HD, RQ>;
  const cudaError_t set = cudaFuncSetAttribute(
      flash_fwd<T, HD, RQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (set != cudaSuccess) return set;
  const int BH = B * H;
  const long long blocks = (long long)((S + C::BQ - 1) / C::BQ) * BH;
  flash_fwd<T, HD, RQ><<<dim3((unsigned)blocks), kThreads, C::SMEM,
                         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, BH, causal,
      window, scale, qs, ks, vs);
  return cudaGetLastError();
}

// One instantiation per head dim: RQ = 8 (128-query blocks) at hd 64 and
// 128, RQ = 4 (64-query blocks) at hd 16 and 32. Another hd is refused.
template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, int B, int S, int H, int causal, int window,
                     float scale, Strides qs, Strides ks, Strides vs,
                     cudaStream_t stream) {
  if (hd == 16)
    return launch<T, 16, 4>(q, k, v, o, B, S, H, causal, window, scale, qs,
                            ks, vs, stream);
  if (hd == 32)
    return launch<T, 32, 4>(q, k, v, o, B, S, H, causal, window, scale, qs,
                            ks, vs, stream);
  if (hd == 64)
    return launch<T, 64, 8>(q, k, v, o, B, S, H, causal, window, scale, qs,
                            ks, vs, stream);
  if (hd == 128)
    return launch<T, 128, 8>(q, k, v, o, B, S, H, causal, window, scale, qs,
                             ks, vs, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: (B, S, H, hd) fp32 (bf16 = 0) or bf16 (bf16 = 1) device buffers
// with element strides (b, s, h) each and stride 1 in hd; o: contiguous
// (B, S, H, hd) of the same type. hd in {16, 32, 64, 128}; window = 0 is
// no window. Returns cudaGetLastError() (cudaErrorInvalidValue for
// another hd).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int hd, int bf16, int causal, int window, float scale,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, o, B, S, H, causal,
                                     window, scale, qs, ks, vs, st)
           : dispatch<float>(hd, q, k, v, o, B, S, H, causal, window,
                             scale, qs, ks, vs, st);
  return (int)err;
}
