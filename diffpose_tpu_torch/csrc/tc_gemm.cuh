// Channel products on the tensor cores and LayerNorms a warp a row, for the
// 72-row tile of tile.cuh; shared by the eval network (net_kernel.cuh: rows
// 1-3, row 9's spatial phase) and the train pair (train_kernel.cuh: rows
// 5-8).
//
//   tc_gemm      C (epilogue) A @ W on mma.sync m16n8k8 at 3xTF32 with f32
//                accumulation (the counterpart of the TPU kernels' bf16x3
//                products, diffpose_tpu/ops/pallas_denoiser.py:_dot), a fresh
//                partial sum each k-step of 8 added in f32 with
//                round-to-nearest; W streams from L2 in K-slabs through a ring
//                in shared memory, filled by cp.async (stage_slab), each
//                weight split into its TF32 parts once a CTA (split_slab),
//                or staged as parts split once on the host (PRESPLIT);
//                with TIER a one-pass tier (mma_tf32.cuh: bf16 or 1xTF32),
//                one pass of operands rounded to the tier straight into the
//                accumulator, the weights rounded once on the host;
//   tc_prefetch  a product's first slabs, requested before the stages that
//                precede it;
//   EpSmem       the epilogue that stores (bias, ReLU, residual add) into
//                shared memory; frag_row / frag_col / frag_bias index an
//                accumulator fragment for the kernels' own epilogues;
//   layer_norm_warp  one warp a row, shuffle reductions.
//
// ops/tf32.py:matmul_3xtf32 is the plain model of tc_gemm's arithmetic, bit
// for bit (chip_smoke.py phase 24, probes/tf32_gemm.py).
#pragma once

#include <cstdint>

#include "mma_tf32.cuh"
#include "tile.cuh"

namespace netk {

constexpr int WARPS = THREADS / 32;                      // 9
static_assert(ROWS_PAD == 9 * 8, "the tile's padded rows are 9 n8 tiles");

// The products run 96 output columns at a time (a "chunk"), so that a warp
// holds 2 x 3 accumulator tiles whatever the width.  The weight ring: S
// stages of a slab of KS rows of W's chunk, each as TF32 big and small parts,
// rows LDR floats apart (== 8 mod 32: conflict-free A fragments).
constexpr int CW = HID;                                  // columns a chunk
constexpr int LDR = CW + 8;
// The ring's floats for S stages of KS rows.
template <int S, int KS>
constexpr int ring_floats() { return S * 2 * KS * LDR; }
// The parts of a weight matrix staged on the host for a tier: TF32 big and
// small for 3xTF32, the rounded weight alone for a one-pass tier.
template <int TIER>
constexpr int WEIGHT_PARTS = TIER == tf32::TIER_3XTF32 ? 2 : 1;

// Slab j of a product, chunk j / NSK and rows (j % NSK) * KS .. of W (global,
// read-only, rows LDW floats apart), into ring stage j % S by cp.async, 16
// bytes a thread and piece.  SMALL > 0: W holds TF32 big parts and, SMALL
// floats further on, the small parts, each copied to its half of the stage.
template <int LDW, int NSK, int S, int KS, int SMALL = 0, int NT = THREADS>
__device__ __forceinline__ void stage_slab(const float* __restrict__ W, float* ring, int j,
                                           int tid) {
  constexpr int NG = CW / 4;
  float* dst = ring + (j % S) * 2 * KS * LDR;
  const float* src = W + static_cast<size_t>(j % NSK) * KS * LDW + (j / NSK) * CW;
  for (int it = tid; it < KS * NG; it += NT) {
    const int r = it / NG, c = 4 * (it % NG);
    tf32::cp_async16(dst + r * LDR + c, src + r * LDW + c);
    if constexpr (SMALL > 0)
      tf32::cp_async16(dst + (KS + r) * LDR + c, src + SMALL + r * LDW + c);
  }
}

// After the wait: every thread splits the pieces it copied itself (its own
// cp.async writes are visible to it without a barrier): big in place, small
// KS rows further on.  So each weight is split once per CTA.
template <int S, int KS, int NT = THREADS>
__device__ __forceinline__ void split_slab(float* ring, int j, int tid) {
  constexpr int NG = CW / 4;
  float* big = ring + (j % S) * 2 * KS * LDR;
  for (int it = tid; it < KS * NG; it += NT) {
    float* p = big + (it / NG) * LDR + 4 * (it % NG);
    const float4 v = ld4(p);
    uint32_t b[4], sm[4];
    tf32::split(v.x, b[0], sm[0]);
    tf32::split(v.y, b[1], sm[1]);
    tf32::split(v.z, b[2], sm[2]);
    tf32::split(v.w, b[3], sm[3]);
    st4(p, make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]),
                       __uint_as_float(b[3])));
    st4(p + KS * LDR, make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]),
                                  __uint_as_float(sm[2]), __uint_as_float(sm[3])));
  }
}

// The first S - 1 slabs of the product A @ W (K x N, W's rows LDW floats
// apart; PRESPLIT as tc_gemm's) into the ring, one commit group each: issued
// as soon as the ring is free (after the barrier that follows the previous
// product), so that they land during the stages before tc_gemm.  No other
// cp.async may be issued in between.
template <int K, int N, int S, int KS, int LDW = N, bool PRESPLIT = false, int NT = THREADS,
          int TIER = tf32::TIER_3XTF32>
__device__ __forceinline__ void tc_prefetch(const float* __restrict__ W, float* ring, int tid) {
  constexpr int NSK = K / KS, TOTAL = (N / CW) * NSK;
  constexpr int SMALL = PRESPLIT && TIER == tf32::TIER_3XTF32 ? K * LDW : 0;
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < TOTAL) stage_slab<LDW, NSK, S, KS, SMALL, NT>(W, ring, j, tid);
    tf32::cp_async_commit();
  }
}

// C (epilogue) A[r, :K] @ W[:K, :N] for the tile's 72 padded rows, as
// Cᵀ = Wᵀ Aᵀ on mma.sync m16n8k8 TF32 at 3xTF32 (big·big + big·small +
// small·big, f32 accumulation), N / 96 chunks of 96 columns one after the
// other: a chunk's 96 columns are the M side (6 m16 tiles), the 72 rows the
// N side (9 n8 tiles).  NT = 288 threads (9 warps): warp w = (w / 3, w % 3)
// owns m tiles 2 (w / 3) .. +1 and n tiles 3 (w % 3) .. +2.  NT = 384 (12
// warps; the SM's four schedulers take warps w % 4, three each): warp w owns
// m tiles 2 p .. +1, p = w / 4, and n group q = (w % 4 + p) % 4, the n tiles
// 0..2 (q = 0) or 2q + 1 .. 2q + 2, so that no scheduler's three warps hold
// more than 14 of the 54 tile pairs (9 warps: 18 on one of them).  W streams
// through the S-stage ring in slabs of KS rows of a chunk, S - 1 slabs in
// flight while one multiplies, one barrier a slab, across chunk boundaries.  A's rows are LDA ≡ 4 (mod 32)
// floats apart, so its B fragments load without bank conflicts.  After a
// chunk's last slab the warp hands its accumulators to the epilogue,
// epi(acc, m0, rb, g, t) (12 warps: epi(acc, m0, rb, g, t, nts), the warp's
// n tiles being nt < nts): acc[mt][nt][i] is column m0 + 16 mt + g + 8 (i >> 1),
// row rb + 8 nt + 2 t + (i & 1).  C must not overlap A; nothing reads C
// before the caller's barrier.  The caller brackets the call with barriers:
// A is complete before it, and the ring is not written again until after
// the next; tc_prefetch<K, N, S, KS, LDW, PRESPLIT, NT>(W, ...) has been
// called since that barrier.  W's rows are LDW floats apart (N unless W is the first
// N columns of a wider matrix).  PRESPLIT: W [2, K, LDW] holds the TF32 big
// parts of the weights, then their small parts (ops/tf32.py:split_tf32, made
// once on the host), and the CTA splits nothing.  TIER a one-pass tier
// (PRESPLIT only): W [K, LDW] holds the weights rounded to the tier on the
// host (ops/fused_denoiser.py:tier_weights), A's operands are rounded as
// they load, and one mma a tile pair and k-step adds straight into the
// accumulator (ops/tf32.py:matmul_1xtf32, matmul_1xbf16 model it).
template <int K, int N, int LDA, int S, int KS, int LDW = N, bool PRESPLIT = false,
          int NT = THREADS, int TIER = tf32::TIER_3XTF32, class Epi>
__device__ __forceinline__ void tc_gemm(const float* A, const float* __restrict__ W, float* ring,
                                        const Epi& epi, int tid) {
  constexpr int NSK = K / KS, TOTAL = (N / CW) * NSK;
  constexpr bool THREE = TIER == tf32::TIER_3XTF32;
  constexpr int SMALL = PRESPLIT && THREE ? K * LDW : 0;
  static_assert(K % KS == 0 && KS % 8 == 0 && N % CW == 0 && S >= 2, "product shape");
  static_assert(THREE || PRESPLIT, "a one-pass tier takes weights rounded on the host");
  static_assert(LDR % 32 == 8, "slab rows must be 8 mod 32 floats apart");
  static_assert(LDA % 32 == 4, "A's row stride must be 4 mod 32 floats");
  static_assert(NT == THREADS || NT == 384, "the warp layouts are for 9 or 12 warps");
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  int m_warp, rb, nts;
  if constexpr (NT == THREADS) {
    m_warp = (warp / 3) * 32, rb = (warp % 3) * 24, nts = 3;
  } else {
    const int p = warp >> 2, q = ((warp & 3) + p) & 3;
    m_warp = p * 32, rb = q == 0 ? 0 : 8 + 16 * q, nts = q == 0 ? 3 : 2;
  }

  float acc[2][3][4];
  for (int j = 0; j < TOTAL; ++j) {
    if (j % NSK == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
    tf32::cp_async_wait<S - 2>();      // slab j has landed (this thread's part)
    if constexpr (!PRESPLIT) split_slab<S, KS, NT>(ring, j, tid);
    __syncthreads();                   // slab j split everywhere; slab j - 1 read by all
    if (j + S - 1 < TOTAL)
      stage_slab<LDW, NSK, S, KS, SMALL, NT>(W, ring, j + S - 1, tid);
    tf32::cp_async_commit();
    const float* wb = ring + (j % S) * 2 * KS * LDR;
    const float* ws = wb + KS * LDR;
    const float* a0 = A + (rb + g) * LDA + (j % NSK) * KS + t;
    if constexpr (!THREE) {
      // one pass: the tier's operands, one mma a tile pair into the accumulator
#pragma unroll 1
      for (int kk = 0; kk < KS; kk += 8) {
        uint32_t bt[3][2];
#pragma unroll
        for (int nt = 0; nt < 3; ++nt) {
          if (nt >= nts) continue;
          bt[nt][0] = tf32::operand<TIER>(a0[8 * nt * LDA + kk]);
          bt[nt][1] = tf32::operand<TIER>(a0[8 * nt * LDA + kk + 4]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int o0 = (kk + t) * LDR + m_warp + 16 * mt + g, o1 = o0 + 4 * LDR;
          const uint32_t at[4] = {__float_as_uint(wb[o0]), __float_as_uint(wb[o0 + 8]),
                                  __float_as_uint(wb[o1]), __float_as_uint(wb[o1 + 8])};
#pragma unroll
          for (int nt = 0; nt < 3; ++nt)
            if (nt < nts) tf32::mma(acc[mt][nt], at, bt[nt]);
        }
      }
    }
#pragma unroll 1   // unrolled, the k-steps' hoisted fragments outgrow 168 registers
    for (int kk = 0; kk < (THREE ? KS : 0); kk += 8) {
      uint32_t bb[3][2], bs[3][2];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
        if (nt >= nts) continue;
        tf32::split(a0[8 * nt * LDA + kk], bb[nt][0], bs[nt][0]);
        tf32::split(a0[8 * nt * LDA + kk + 4], bb[nt][1], bs[nt][1]);
      }
      // An m tile at a time: its k-step's three passes (the small products
      // first, then the big one; the three n tiles take turns) go to a fresh
      // partial sum, added to the accumulator in f32 with round-to-nearest.
      // The tensor cores' own accumulation truncates; fed the whole K, its
      // bias grows with K and through the implicit family's solves.
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int o0 = (kk + t) * LDR + m_warp + 16 * mt + g, o1 = o0 + 4 * LDR;
        const int o[4] = {o0, o0 + 8, o1, o1 + 8};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ab[i] = __float_as_uint(wb[o[i]]);
          as[i] = __float_as_uint(ws[o[i]]);
        }
        float part[3][4] = {};
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
          if (nt < nts) tf32::mma(part[nt], ab, bs[nt]);
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
          if (nt < nts) tf32::mma(part[nt], as, bb[nt]);
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
          if (nt < nts) tf32::mma(part[nt], ab, bb[nt]);
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[nt][i];
      }
    }
    if (j % NSK == NSK - 1) {
      if constexpr (NT == THREADS)
        epi(acc, (j / NSK) * CW + m_warp, rb, g, t);
      else
        epi(acc, (j / NSK) * CW + m_warp, rb, g, t, nts);
    }
  }
}

// Epilogues.  Each gathers what it reads from global memory for a group of
// the warp's elements before it stores anything, so that the loads overlap.
using Acc = float[2][3][4];
__device__ __forceinline__ int frag_row(int rb, int nt, int i, int t) { return rb + 8 * nt + 2 * t + (i & 1); }
__device__ __forceinline__ int frag_col(int m0, int mt, int i, int g) { return m0 + 16 * mt + g + 8 * (i >> 1); }

// The bias of the warp's four columns, [mt][i >> 1].
__device__ __forceinline__ void frag_bias(const float* __restrict__ bias, int m0, int g,
                                          float (&b)[2][2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) b[mt][h] = __ldg(bias + m0 + 16 * mt + g + 8 * h);
}

// C[r, c] (=, +=) acc (+ bias[c]), with RELU relu(acc + bias[c]), for the
// tile's rows; RND: the stored value rounded to bf16 (the bf16 tier's
// activations, the TPU kernels' .astype(act)).
template <int LDC, bool BIAS, bool ADD, bool RELU = false, bool RND = false>
struct EpSmem {
  float* c;
  const float* bias;
  __device__ __forceinline__ void operator()(const Acc& d, int m0, int rb, int g, int t,
                                             int nts = 3) const {
    float b[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    if constexpr (BIAS) frag_bias(bias, m0, g, b);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = frag_row(rb, nt, i, t), col = frag_col(m0, mt, i, g);
          if (nt >= nts || r >= ROWS) continue;
          float v = d[mt][nt][i] + b[mt][i >> 1];
          if constexpr (RELU) v = fmaxf(v, 0.f);
          if constexpr (ADD) v += c[r * LDC + col];
          if constexpr (RND) v = tf32::round_bf16(v);
          c[r * LDC + col] = v;
        }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = LayerNorm(x) per row, a * (x - mean) / (std + 1e-6) + b with the
// Bessel std, one warp a row (columns lane, lane + 32, lane + 64); also into
// stash for the real rows where given.  NW: the CTA's warps.
template <int NW = WARPS>
__device__ __forceinline__ void layer_norm_warp(const float* in, float* out,
                                                const float* __restrict__ scale,
                                                const float* __restrict__ shift,
                                                float* __restrict__ stash, int nreal, int tid) {
  const int lane = tid & 31;
  float sc[3], sh[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    sc[j] = __ldg(scale + lane + 32 * j);
    sh[j] = __ldg(shift + lane + 32 * j);
  }
  // two rows at a time, r and r + NW (NW warps), so that their reductions interleave
  for (int r0 = tid >> 5; r0 < ROWS; r0 += 2 * NW) {
    float v[2][3], mean[2], ss[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = min(r0 + q * NW, ROWS - 1);
#pragma unroll
      for (int j = 0; j < 3; ++j) v[q][j] = in[r * LDH + lane + 32 * j];
      mean[q] = v[q][0] + v[q][1] + v[q][2];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < 2; ++q) mean[q] += __shfl_xor_sync(0xffffffffu, mean[q], o);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      mean[q] /= HID;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        v[q][j] -= mean[q];
        ss[q] = fmaf(v[q][j], v[q][j], ss[q]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < 2; ++q) ss[q] += __shfl_xor_sync(0xffffffffu, ss[q], o);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = r0 + q * NW;
      if (r >= ROWS) break;
      const float den = sqrtf(ss[q] / (HID - 1)) + 1e-6f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int c = lane + 32 * j;
        const float o = sc[j] * v[q][j] / den + sh[j];
        out[r * LDH + c] = o;
        if (stash != nullptr && r < nreal) stash[r * HID + c] = o;
      }
    }
  }
}

}  // namespace netk
