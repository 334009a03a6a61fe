// Blocked online-softmax attention (forward) on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (_kernel). For q, k, v of shape (B, S, H, hd),
// with H already expanded by the caller (GQA is a gather before the call),
// and every (b, h, query position i):
//   s_j  = (q_i * scale) . k_j          fp32, scale = fp32(1/sqrt(hd))
//   s_j  = -1e30 where masked           causal: j > i; window: j <= i - window
//   out  = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
// with m the running row maximum of an online softmax: fp32 m, l and
// accumulators, one KV tile at a time, as the TPU kernel does. The output
// is cast to the inputs' type (fp32 or bf16). The scale multiplies q in
// fp32 before the dot, as in the TPU kernel (the plain version divides the
// scores after it; the two differ by an fp32 rounding).
//
// Bound on this card: 4*hd*S^2*B*H operations (half under the causal mask)
// against 4 reads or writes of B*S*H*hd elements; at the prefill's shapes
// (S >= 1000, hd = 128) it is bound by operations, at the bf16 tensor-core
// rate. This first kernel does its products in fp32 on the SIMT cores
// (67 TFLOP/s at most), so it stays well above that bound; wgmma on bf16
// tiles, with TMA staging, is later work.
//
// Design: one block of 256 threads per (b*h, 64-query block). The block
// stages its queries, pre-scaled, in shared memory once, then walks the
// 64-key tiles of K and V that its mask leaves open: tiles the causal or
// window mask covers for every query of the block are skipped (their
// weights would be exp(-1e30 - m) = 0 and their correction 1, since the
// first tile walked holds an unmasked key for every query). A thread owns
// a 4 x 4 block of scores and the same 4 query rows of the output, 4 x
// hd/16 accumulators; the rows' max and sum run over the 16 lanes that
// share them with shuffles. Q and K tiles are held transposed (hd x 64,
// rows padded to 68 floats) so each step of the dot reads one float4 of
// each; the probabilities go through shared memory, transposed the same
// way, into the P.V product. Ragged S: positions >= S are not keys
// (weight exactly 0) and their query rows are not written. Query blocks
// run last-first, so under the causal mask the longest blocks start first.
// The inputs may be strided in B, S and H (stride 1 in hd; every stride and
// base 4-element aligned, which the wrapper ensures); the output is a
// contiguous (B, S, H, hd) tensor.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // queries per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;     // 16 x 16: ty owns 4 query rows, tx 4 keys
constexpr int kTP = kBK + 4;      // padded row of a transposed tile (floats)
constexpr float kMasked = -1e30f;

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

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {
  long long b, s, h;  // elements; hd has stride 1
};

// Copy a 64-row tile of (row, hd) into t[d * kTP + row] as fp32, times
// `mul`; rows at or past `valid` read as 0. Consecutive threads take
// consecutive rows, so the transposed shared-memory stores hit distinct
// banks.
template <typename T, int HD>
__device__ __forceinline__ void stage_transposed(float* t, const T* base,
                                                 long long row_stride,
                                                 int valid, float mul) {
  constexpr int kV4 = HD / 4;
  for (int idx = threadIdx.x; idx < kBK * kV4; idx += kThreads) {
    const int r = idx % kBK, g = idx / kBK;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = load4(base + (long long)r * row_stride + 4 * g);
    t[(4 * g + 0) * kTP + r] = x.x * mul;
    t[(4 * g + 1) * kTP + r] = x.y * mul;
    t[(4 * g + 2) * kTP + r] = x.z * mul;
    t[(4 * g + 3) * kTP + r] = x.w * mul;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int H, int BH,
          int causal, int window, float scale, Strides qs, Strides ks,
          Strides vs) {
  constexpr int kCPT = HD / 16;  // output columns per thread and row
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // [HD][kTP] scaled queries, transposed
  float* Kt = Qt + HD * kTP;     // [HD][kTP] key tile, transposed
  float* Vs = Kt + HD * kTP;     // [kBK][HD] value tile
  float* Pt = Vs + kBK * HD;     // [kBK][kTP] probabilities, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nqb = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qblk = nqb - 1 - blockIdx.x / BH;
  const int bi = bh / H, hi = bh % H;
  const int q0 = qblk * kBQ;
  const T* qb = q + bi * qs.b + hi * qs.h + (long long)q0 * qs.s;
  const T* kb = k + bi * ks.b + hi * ks.h;
  const T* vb = v + bi * vs.b + hi * vs.h;

  stage_transposed<T, HD>(Qt, qb, qs.s, S - q0, scale);

  const int nkt = (S + kBK - 1) / kBK;
  int j_end = nkt - 1;
  if (causal) j_end = min(j_end, (q0 + kBQ - 1) / kBK);
  int j_begin = 0;
  if (window > 0) {
    // a tile is masked for every query of the block iff its last key is
    // <= q0 - window (the first query's mask is the least strict)
    const int lo = q0 - window;
    if (lo >= kBK - 1) j_begin = (lo - (kBK - 1)) / kBK + 1;
  }

  float m[4], l[4], acc[4][kCPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCPT; ++c) acc[i][c] = 0.f;
  }

  for (int j = j_begin; j <= j_end; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's readers are done
    stage_transposed<T, HD>(Kt, kb + (long long)k0 * ks.s, ks.s, S - k0,
                            1.f);
    {
      constexpr int kV4 = HD / 4;
      for (int idx = tid; idx < kBK * kV4; idx += kThreads) {
        const int r = idx / kV4, g = idx % kV4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + r < S) x = load4(vb + (long long)(k0 + r) * vs.s + 4 * g);
        *reinterpret_cast<float4*>(&Vs[r * HD + 4 * g]) = x;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * kTP + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Kt[d * kTP + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(av[i], bv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float rmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx * 4 + c;
        bool keep = true;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        // a position past the end is no key at all: weight exactly 0
        s[i][c] = kpos >= S ? -INFINITY : (keep ? s[i][c] : kMasked);
        rmax = fmaxf(rmax, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        Pt[(tx * 4 + c) * kTP + ty * 4 + i] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Pt[key * kTP + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float* vrow = Vs + key * HD;
      float vv[kCPT];
      if constexpr (kCPT >= 4) {
#pragma unroll
        for (int g = 0; g < kCPT / 4; ++g) {
          const float4 t = *reinterpret_cast<const float4*>(vrow + g * 64 + tx * 4);
          vv[4 * g + 0] = t.x;
          vv[4 * g + 1] = t.y;
          vv[4 * g + 2] = t.z;
          vv[4 * g + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCPT; ++c) vv[c] = vrow[tx * kCPT + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCPT; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)bi * S + qpos) * H + hi) * HD;
#pragma unroll
    for (int c = 0; c < kCPT; ++c) {
      const int col = kCPT >= 4 ? (c >> 2) * 64 + tx * 4 + (c & 3)
                                : tx * kCPT + c;
      store1(orow + col, acc[i][c] * inv_l);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int causal, int window, float scale,
                   Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * HD * kTP + kBK * HD + kBK * kTP) *
                      sizeof(float);
  const cudaError_t set = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (set != cudaSuccess) return set;
  const int BH = B * H;
  const long long blocks = (long long)((S + kBQ - 1) / kBQ) * BH;
  flash_fwd<T, HD><<<dim3((unsigned)blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, BH, causal,
      window, scale, qs, ks, vs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, int B, int S, int H, int causal, int window,
                     float scale, Strides qs, Strides ks, Strides vs,
                     cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, H, causal, window, scale, qs,
                           ks, vs, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, causal, window, scale, qs,
                           ks, vs, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, causal, window, scale, qs,
                           ks, vs, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, causal, window, scale, qs,
                            ks, vs, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (B, S, H, hd) fp32 (bf16 = 0) or bf16 (bf16 = 1) device buffers
// with element strides (b, s, h) each and stride 1 in hd; o: contiguous
// (B, S, H, hd) of the same type. hd in {16, 32, 64, 128}; window = 0 is no
// window. Returns cudaGetLastError() (cudaErrorInvalidValue for another
// hd).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int hd, int bf16, int causal, int window, float scale,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, o, B, S, H, causal, window,
                                     scale, qs, ks, vs, st)
           : dispatch<float>(hd, q, k, v, o, B, S, H, causal, window, scale,
                             qs, ks, vs, st);
  return (int)err;
}
