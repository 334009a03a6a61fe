// Blocked online-softmax attention (forward) for bf16 on Hopper (sm_90a):
// both products on the tensor cores with wgmma, K and V tiles staged by
// TMA into a ring in shared memory.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (_kernel) for bf16 q, k, v of shape (B, S, H, hd),
// hd in {64, 128}, H already expanded (GQA is a gather before the call).
// For every (b, h, query position i):
//   s_j = fp32(q_i . k_j) * scale      q unscaled bf16, products summed in
//                                      fp32 by wgmma; scale = fp32(1/sqrt(hd))
//   s_j = -1e30 where masked           causal: j > i; window: j <= i - window
//   out = sum_j p_j v_j / max(sum_j p_j, 1e-30),  p_j = exp(s_j - m)
// with m, l and the output accumulators in fp32 (an online softmax over
// 128-key tiles), the output cast to bf16. Positions >= S are no keys
// (weight exactly 0) and their query rows are not written.
//
// Precision of P.V: the TPU kernel multiplies fp32 weights by V. wgmma
// takes bf16 operands, and one bf16 P would err by up to 2^-8 sum_j p_j
// |v_j|, which is not small against |out| where values cancel. So P is
// split, P_hi = bf16(p) and P_lo = bf16(p - P_hi), and both are multiplied
// by V into the same fp32 accumulator: the residual is at most 2^-16
// sum_j p_j |v_j| / l <= 2^-16 max|v|. The row sum l is the sum of the
// fp32 p themselves.
//
// Bound on this card: 4*hd*B*H*(pairs the mask leaves open) operations at
// the bf16 tensor-core rate (989 TFLOP/s); the split makes the kernel do
// 1.5x that (Q.K^T once, P.V twice), which the bound does not count.
//
// Design: one block of 384 threads per (b*h, 128-query block), query
// blocks last-first (under the causal mask the longest start first).
// Warpgroups 0 and 1 are consumers of 64 query rows each; warpgroup 2 is
// the producer, one thread of which issues the TMA loads: the block's Q
// tile once, then the K and V tiles of every 128-key tile that the mask
// leaves open for some query of the block (tiles covered for the whole
// block are skipped, as the plain version gives them weight exactly 0)
// into a 2-stage ring, each stage with a "full" mbarrier (transaction
// bytes) and an "empty" one (the 256 consumer threads). Tiles are 64
// bf16 wide (128 bytes) with the 128-byte swizzle, hd = 128 as two such
// column blocks. The tensor maps are 4-D over (hd, H, S, B) with the
// caller's strides, so rows past S read as zero (and are masked) and no
// tile reaches into the next batch row. A consumer runs, per tile:
// S = Q.K^T (wgmma m64n128k16, Q and K K-major from shared memory); the
// scale, the mask on tiles that need it, the row max over the 4 lanes
// that share a row, p = exp(s - m), the correction of l and O; then
// O += P_hi.V + P_lo.V (wgmma with P from registers in the accumulator's
// own fragment layout, V as an MN-major operand read straight from its
// (keys, hd) tile); then it frees the stage. setmaxnreg gives the
// consumers 232 registers and the producer 40.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;          // queries per block (two warpgroups)
constexpr int kBK = 128;          // keys per tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kThreads = 384;     // consumers 0-255, producer 256-383
constexpr int kConsumers = 256;
constexpr int kRow = 128;         // bytes of one swizzled tile row (64 bf16)
constexpr float kMasked = -1e30f;
constexpr int kMaxDevices = 64;   // devices whose attribute is remembered

// -------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the 4-D tensor map at coordinates (c0 = hd, c1 = head,
// c2 = position, c3 = batch) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. K-major tiles
// (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused. MN-major tiles (V): the same rows, keys along
// K; LBO is the distance between 64-wide column blocks of hd.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Tell the compiler that the asynchronous wgmma owns these registers up
// to this point, so nothing reads or reuses them across an issue or a
// wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D(64 x 128) (+)= A(64 x 16, smem, K-major) * B(16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 128) += A(64 x 16, registers) * B(16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D(64 x 64) += A(64 x 16, registers) * B(16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 128)
    wgmma_rs_n128(o, a, db);
  else
    wgmma_rs_n64(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

template <int HD>
struct Smem {
  static constexpr int kCols = HD / 64;                 // column blocks
  static constexpr int kQ = kBQ * HD * 2;               // Q tile bytes
  static constexpr int kTile = kBK * HD * 2;            // one K or V tile
  static constexpr int kK = kQ;                         // K ring offset
  static constexpr int kV = kK + kStages * kTile;       // V ring offset
  static constexpr int kBar = kV + kStages * kTile;     // mbarriers
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1);
  static constexpr int kAlloc = kBytes + 1024;          // + alignment
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tmq,
                const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv,
                __nv_bfloat16* __restrict__ o, int S, int H, int BH,
                int causal, int window, float scale) {
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles want 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar_full = base + L::kBar;              // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;     // [kStages]
  const uint32_t bar_q = bar_empty + 8 * kStages;

  const int nqb = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qblk = nqb - 1 - blockIdx.x / BH;
  const int bi = bh / H, hi = bh % H;
  const int q0 = qblk * kBQ;

  // the key tiles that the mask leaves open for some query of the block
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

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, L::kQ);
#pragma unroll
      for (int c = 0; c < L::kCols; ++c)
        tma_load(sq + c * kBQ * kRow, &tmq, bar_q, 64 * c, hi, q0, bi);
      for (int j = j_begin, it = 0; j <= j_end; ++j, ++it) {
        const int st = it % kStages;
        // the stage's previous round must be released (the first round
        // passes: parity 1 is the phase before the barrier's first)
        mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * st, 2 * L::kTile);
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) {
          tma_load(sk + st * L::kTile + c * kBK * kRow, &tmk,
                   bar_full + 8 * st, 64 * c, hi, j * kBK, bi);
          tma_load(sv + st * L::kTile + c * kBK * kRow, &tmv,
                   bar_full + 8 * st, 64 * c, hi, j * kBK, bi);
        }
      }
    }
  } else {
    // ----------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int qlo = q0 + wg * 64;            // the warpgroup's first query
    const int row_a = qlo + w * 16 + lane / 4, row_b = row_a + 8;
    const int col_l = (lane % 4) * 2;        // the thread's column in an 8
    float m[2] = {-INFINITY, -INFINITY};     // rows a and b
    float l[2] = {0.f, 0.f};                 // this thread's part of l
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    mbar_wait(bar_q, 0);
    const uint32_t qw = sq + wg * 64 * kRow;
    for (int j = j_begin, it = 0; j <= j_end; ++j, ++it) {
      const int st = it % kStages;
      const int k0 = j * kBK;
      const uint32_t kt = sk + st * L::kTile, vt = sv + st * L::kTile;
      mbar_wait(bar_full + 8 * st, (it / kStages) & 1);

      // S = Q.K^T, 64 x 128, k-steps of 16 along hd
      float s[64];
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBQ * kRow + (kk % 4) * 32;
        const uint32_t offk = (kk / 4) * kBK * kRow + (kk % 4) * 32;
        wgmma_ss_n128(s, sw128_desc(qw + off, 16), sw128_desc(kt + offk, 16),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale, mask, online softmax; s[i] sits at row (i & 2 ? b : a),
      // column k0 + (i / 4) * 8 + col_l + (i & 1)
      const bool need_mask = k0 + kBK > S || (causal && k0 + kBK - 1 > qlo) ||
                             (window > 0 && k0 <= qlo + 63 - window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float x = s[i] * scale;
        if (need_mask) {
          const int kpos = k0 + (i / 4) * 8 + col_l + (i & 1);
          const int qpos = (i & 2) ? row_b : row_a;
          const bool keep = (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
          // a position past the end is no key at all: weight exactly 0
          x = kpos >= S ? -INFINITY : (keep ? x : kMasked);
        }
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = expf(s[i] - m[r]);
        l[r] += s[i];
      }
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      // P in the A-operand fragment of each 16-key step: register r of
      // step kk holds s[8 kk + 2 r], s[8 kk + 2 r + 1]
      uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
          const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(h);
          p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
          p_lo[kk][r] = pack_bf16(x0 - hf.x, x1 - hf.y);
        }

      // O += P_hi.V + P_lo.V, k-steps of 16 keys (2048 bytes of V)
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = sw128_desc(vt + kk * 16 * kRow, kBK * kRow);
        wgmma_pv<HD>(acc, p_hi[kk], dv);
        wgmma_pv<HD>(acc, p_lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(bar_empty + 8 * st);
    }

    // l over the 4 lanes of each row, then out = acc / l as bf16 pairs
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const int qpos = r ? row_b : row_a;
      if (qpos < S) {
        const int col = (i / 4) * 8 + col_l;
        __nv_bfloat16* dst = o + (((long long)bi * S + qpos) * H + hi) * HD +
                             col;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[i] * l[r], acc[i + 1] * l[r]);
      }
    }
  }
}

// ------------------------------------------------------------ host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess && p)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, S, H, hd) bf16 at `ptr` with element strides (sb, ss, sh) and 1,
// as a 4-D map (hd, H, S, B) read in boxes of 64 x 1 x `rows` x 1 with
// the 128-byte swizzle; rows past S read as zero.
CUresult make_map(CUtensorMap* map, EncodeTiled enc, const void* ptr, int B,
                  int S, int H, int hd, long long sb, long long ss,
                  long long sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, void* o, int B, int S, int H, int causal,
           int window, float scale, cudaStream_t stream) {
  const int smem = Smem<HD>::kAlloc;
  // the shared-memory limit is an attribute of the function on each
  // device: set it on a device's first launch only
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  const int BH = B * H;
  const long long blocks = (long long)((S + kBQ - 1) / kBQ) * BH;
  flash_fwd_wgmma<HD><<<dim3((unsigned)blocks), kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), S, H, BH, causal, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, S, H, hd) bf16 device buffers with element strides (b, s,
// h) each, stride 1 in hd, every stride a multiple of 8 elements and every
// base 16-byte aligned (TMA's rule); o: contiguous (B, S, H, hd) bf16. hd
// in {64, 128}; window = 0 is no window. Returns cudaGetLastError() after
// the launch, cudaErrorInvalidValue for another hd, FLASH_NO_ENCODE when
// the driver has no cuTensorMapEncodeTiled, and FLASH_ENCODE_BASE + the
// CUresult when a tensor map is refused.
#define FLASH_NO_ENCODE 9000
#define FLASH_ENCODE_BASE 10000
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int hd, int causal, int window, float scale, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    void* stream) {
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return FLASH_NO_ENCODE;
  CUtensorMap mq, mk, mv;
  CUresult r = make_map(&mq, enc, q, B, S, H, hd, qsb, qss, qsh, kBQ);
  if (r == CUDA_SUCCESS)
    r = make_map(&mk, enc, k, B, S, H, hd, ksb, kss, ksh, kBK);
  if (r == CUDA_SUCCESS)
    r = make_map(&mv, enc, v, B, S, H, hd, vsb, vss, vsh, kBK);
  if (r != CUDA_SUCCESS) return FLASH_ENCODE_BASE + (int)r;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd == 128
             ? launch<128>(mq, mk, mv, o, B, S, H, causal, window, scale, st)
             : launch<64>(mq, mk, mv, o, B, S, H, causal, window, scale, st);
}
