// Training forward and backward of the GCNDiff layer stack (L x attention
// layer + residual Chebyshev block, with dropout), one launch each.
//
// Counterparts of diffpose_tpu/ops/pallas_train.py:_stack_fwd_kernel and
// _stack_bwd_kernel (explicit dropout masks, PRNG = false) and of
// _stack_fwd_kernel_prng and _stack_bwd_kernel_prng (PRNG = true: every
// dropout decision is drawn in the kernel with Philox4x32-10 from the step
// seed and the element's place, keyed as philox.cuh sets out, so the
// backward regenerates the forward's masks and none exists in device
// memory; the forward can dump what it drew).  One CTA of 288 threads (9
// warps) owns TB = 4 samples (ROWS joint rows, sample-major, padded to 72);
// the forward keeps the residual stream h in shared memory through all
// layers, the backward its gradient dh.  Everything in global memory is
// batch-major:
//
//   stashes / d-stashes  [L, B*17, width]   f32
//   site masks           [L, B*17, HID]     uint8 0/1
//   attention mask       [L, B, HEADS, 17 (query), 17 (key)]  uint8 0/1
//
// Rows of absent samples in a ragged last tile hold zeros in h / dh, are
// never loaded from or stored to global memory, and stay finite elsewhere.
//
// Bound on the H100: the channel products (92-94% of the operations).
// The design for it:
//   - every channel product (QKV, out-projection, fc1, fc2, the two
//     Chebyshev convs, and in the backward their transposes and the QKV
//     recompute) runs on the tensor cores, mma.sync m16n8k8 at 3xTF32 with
//     f32 accumulation (tc_gemm.cuh, shared with net_kernel.cuh; the
//     counterpart of the TPU kernels' bf16x3 products,
//     pallas_denoiser.py:_dot);
//   - the weights stream from L2 in K-slabs of 32 rows through a ring in
//     shared memory (3 stages in the forward, 2 in the backward), filled by
//     cp.async while the previous slab multiplies, each weight split into
//     its TF32 parts once per CTA; a product's first slabs are requested as
//     soon as the ring is free, before the stages that precede it; the
//     backward's ring shares its space with the attention-backward scratch,
//     the forward's lends the attention its score rows;
//   - the LayerNorms and their backward take one warp a row, with
//     shuffle reductions;
//   - elementwise stages that only need what one thread (or one product
//     fragment) holds run in the epilogue of the stage that feeds them:
//     the out-projection's residual dropout, fc1's stash, the backward's
//     ReLU gate of df1 and the dropout of du; the mixes carry the
//     residuals after them.
// The graph mixes, attention and Philox stay on CUDA cores, one work item a
// thread between barriers, as in net_kernel.cuh.  With 9 warps a thread has
// at most 168 registers (3 warps share an SM quarter's 16K); every stage is
// written to fit them: ptxas reports no spill for any instantiation.
//
// TIER (mma_tf32.cuh; TIER_3XTF32 in train_kernel.cu, the one-pass tiers in
// train_kernel_tiers.cu) is the --kernel_precision of the TPU kernels
// (pallas_train.py's `precision`, pallas_denoiser.py:_dot): every channel
// product through tc_gemm at that tier, on weights rounded on the host
// (ops/fused_train.py:rounded_stacks) and activations rounded as they load.
// TIER_BF16 also rounds where pallas_train.py:_attention_fwd and
// _attention_bwd round through _dot_exact_w: each product q_d k_d before the
// per-head sum (scores, forward and backward), each probability before the
// dropout and the sum over V (and dv), each v_d datt_d mask/keep before the
// per-head sum that gives dp, and the softmax gradient before it multiplies
// k and q.  Stashes, the LayerNorms, the mixes, biases and every sum stay
// f32.  The one-pass tiers take the TPU kernel's order where a rounding does
// not commute with the learned-adjacency mix: the forward mixes lap . r1
// before the fc2 product (the parity build: lap . (r1 W_fc2), a narrower
// mix), and the backward multiplies df2 W_fc2^T before the lap^T mix (the
// parity build mixes first).  Every `if constexpr` on the tier leaves the
// parity build's code as it was.
#pragma once

#include <cmath>

#include "net_kernel.cuh"
#include "philox.cuh"

namespace traink {

using namespace netk;

constexpr int PAIRS = N_PTS * N_PTS;
// attention backward: thread = (sample, head, joint), one item each
static_assert(TB * HEADS * N_PTS <= THREADS, "attention backward needs a thread per (b, head, joint)");
constexpr int TTERMS = 3 * N_PTS;                       // (order, joint) lists of the transposed mixes
constexpr int TPTR_PAD = (TTERMS + 1 + 3) / 4 * 4;
// dropout streams: 0 attention probabilities, 1..4 the sites after attention,
// after GraphNet, after Chebyshev conv 1 and 2
constexpr int DROPS = 5;

// Where the dropout decisions come from.  Explicit masks: m[s] (uint8 0/1).
// Drawn in the kernel: the step seed, one int32 in device memory, and
// thresh[s] = ceil(keep_s * 2^23); the forward writes what it drew to dump[s]
// where that is not null.
struct DropArgs {
  const unsigned char* m[DROPS];
  unsigned char* dump[DROPS];
  unsigned thresh[DROPS];
  const unsigned* seed;
};

struct FwdArgs {
  const float* h0;     // [B, 17, HID]
  const float* tp;     // [L, B, HID]
  DropArgs drop;
  const float* ln1s; const float* ln1b; const float* ln2s; const float* ln2b;
  const float* wqkv; const float* bqkv; const float* wao; const float* bao;
  const float* lap;
  const float* wfc1; const float* bfc1; const float* wfc2; const float* bfc2;
  const float* wg1; const float* bg1; const float* wg2; const float* bg2;
  const int* cheb_ptr; const int* cheb_idx; const float* cheb_val;
  int cheb_nnz;
  float* d5;           // [B, 17, HID]
  float* ha; float* hb; float* hc; float* y1; float* att;
  float* r1;           // 2*HID wide
  float* rc1; float* u; float* rd1;
  int batch; int num_layers;
  float ikp, iks, ikc; // 1 / keep of the three dropout rates
};

struct BwdArgs {
  const float* dd5;    // [B, 17, HID]
  DropArgs drop;
  const float* ha; const float* hb; const float* y1; const float* r1;
  const float* rc1; const float* rd1;
  const float* ln1s; const float* ln2s;
  const float* wqkv; const float* bqkv;
  const float* wqkvt;  // [L, 3*HID, HID]
  const float* waot;   // [L, HID, HID]
  const float* lap;
  const float* wfc1t;  // [L, 2*HID, HID]
  const float* wfc2t;  // [L, HID, 2*HID]
  const float* wg1t;   // [L, 3*HID, HID]: W_0^T ; W_1^T ; W_2^T
  const float* wg2t;
  const int* tptr;     // [3*17 + 1] term lists of the transposed Chebyshev mixes
  const int* tidx;     // [nnz] source joint j
  const float* tval;   // [nnz] T_k[j, m]
  int tnnz;
  float* da0;          // [B, 17, HID]
  float* dtp;          // [L, B, HID]
  float* dqkv;         // 3*HID wide
  float* do1;
  float* df1;          // 2*HID wide
  float* df2; float* dc1; float* dc2;
  int batch; int num_layers;
  float ikp, iks, ikc;
};

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
// Four 0/1 mask bytes (4-byte aligned) as dropout factors 0 or s.
__device__ __forceinline__ float4 mask4(const unsigned char* m, float s) {
  const unsigned int v = __ldg(reinterpret_cast<const unsigned int*>(m));
  return make_float4((v & 0xffu) ? s : 0.f, (v & 0xff00u) ? s : 0.f, (v & 0xff0000u) ? s : 0.f,
                     (v & 0xff000000u) ? s : 0.f);
}
// Keep decisions (bits 0..3) as dropout factors 0 or s.
__device__ __forceinline__ float4 keep_factors(unsigned bits, float s) {
  return make_float4((bits & 1u) ? s : 0.f, (bits & 2u) ? s : 0.f, (bits & 4u) ? s : 0.f,
                     (bits & 8u) ? s : 0.f);
}

// The dropout of one site over one tile in one layer: factor(r, c, s) gives the
// factors (0 or s) of row r, columns c..c+3.
template <bool PRNG>
struct Site {
  const unsigned char* m;   // explicit: the tile's first row in [L, B*17, HID]
  unsigned char* dump;      // drawn: the same place in the dump, or null
  unsigned k0, k1, thresh, b0;
  __device__ __forceinline__ float4 factor(int r, int c, float s) const {
    if constexpr (PRNG) {
      const unsigned group = (r % N_PTS) * (HID / 4) + c / 4;
      const unsigned bits = philox::keep4(
          philox::philox4x32_10(make_uint4(group, b0 + r / N_PTS, 0u, 0u), k0, k1), thresh);
      if (dump != nullptr)
        *reinterpret_cast<unsigned int*>(dump + r * HID + c) =
            (bits & 1u) | (bits & 2u) << 7 | (bits & 4u) << 14 | (bits & 8u) << 21;
      return keep_factors(bits, s);
    } else {
      return mask4(m + r * HID + c, s);
    }
  }
  // The same decisions for the elements of an mma accumulator fragment
  // (tc_gemm): rows rb + 2t + (i & 1), columns m0 + g + 8 (i >> 1) of a 16x8
  // tile, g = lane / 4, t = lane % 4.  Drawn: frag_draw has each lane of the
  // warp make one Philox call, row rb + 2t + (g & 1) and columns m0 + 4 (g >> 1)
  // .. +3 (so a tile's 8 (row, group of 4) calls are made once), and dumps it
  // for a real row; frag_factor fetches an element's bit from the lane that
  // drew it.  Both run on every lane of the warp.  Explicit: frag_draw reads
  // the mask bytes of the lane's own 4 elements (0 past the real rows) as bits
  // 0..3.
  __device__ __forceinline__ unsigned frag_draw(int rb, int m0, int g, int t, int nreal) const {
    if constexpr (PRNG) {
      const int r = rb + 2 * t + (g & 1);
      const int c = m0 + 4 * (g >> 1);
      const unsigned group = (r % N_PTS) * (HID / 4) + c / 4;
      const unsigned bits = philox::keep4(
          philox::philox4x32_10(make_uint4(group, b0 + r / N_PTS, 0u, 0u), k0, k1), thresh);
      if (dump != nullptr && r < nreal)
        *reinterpret_cast<unsigned int*>(dump + r * HID + c) =
            (bits & 1u) | (bits & 2u) << 7 | (bits & 4u) << 14 | (bits & 8u) << 21;
      return bits;
    } else {
      unsigned bits = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rb + 2 * t + (i & 1);
        if (r < nreal && __ldg(m + r * HID + m0 + g + 8 * (i >> 1)) != 0) bits |= 1u << i;
      }
      return bits;
    }
  }
  __device__ __forceinline__ float frag_factor(unsigned bits, int i, int g, int t, float s) const {
    if constexpr (PRNG) {
      const int cc = g + 8 * (i >> 1);                       // column in the tile
      const unsigned b = __shfl_sync(0xffffffffu, bits, ((2 * (cc >> 2) + (i & 1)) << 2) | t);
      return (b >> (cc & 3) & 1u) ? s : 0.f;
    } else {
      return (bits >> i & 1u) ? s : 0.f;
    }
  }
};

// The dropout of the attention probabilities over one tile in one layer:
// row(b, hd, n) gives the query's row as bits, bit m set where the
// probability of key m is kept, drawn once (or read from the mask once).
template <bool PRNG>
struct Probs {
  const unsigned char* m;   // explicit: the tile's first sample in [L, B, HEADS, 17, 17]
  unsigned char* dump;
  unsigned k0, k1, thresh, b0;
  static __device__ __forceinline__ int at(int b, int hd, int n) {
    return ((b * HEADS + hd) * N_PTS + n) * N_PTS;
  }
  static __device__ __forceinline__ bool keep(unsigned bits, int k) { return (bits >> k & 1u) != 0u; }
  __device__ __forceinline__ unsigned row(int b, int hd, int n) const {
    unsigned bits = 0u;
    const int pos = at(b, hd, n);
    if constexpr (PRNG) {
      const unsigned group = static_cast<unsigned>(hd * N_PTS + n) << 3;
#pragma unroll
      for (int j = 0; j < (N_PTS + 3) / 4; ++j)
        bits |= philox::keep4(
                    philox::philox4x32_10(make_uint4(group + j, b0 + b, 0u, 0u), k0, k1), thresh)
                << (4 * j);
      bits &= (1u << N_PTS) - 1u;
      if (dump != nullptr) {
#pragma unroll
        for (int k = 0; k < N_PTS; ++k) dump[pos + k] = (bits >> k) & 1u;
      }
    } else {
#pragma unroll
      for (int k = 0; k < N_PTS; ++k) bits |= (__ldg(m + pos + k) != 0 ? 1u : 0u) << k;
    }
    return bits;
  }
};

// Stream s of layer l for the tile whose first sample is b0 (smp = l*B + b0).
template <bool PRNG>
__device__ __forceinline__ Site<PRNG> site_of(const DropArgs& d, int s, int l, int b0,
                                              size_t smp) {
  const size_t at = smp * N_PTS * HID;
  return Site<PRNG>{PRNG ? nullptr : d.m[s] + at,
                    PRNG && d.dump[s] != nullptr ? d.dump[s] + at : nullptr,
                    PRNG ? __ldg(d.seed) : 0u,
                    static_cast<unsigned>(l * philox::STREAMS + s), d.thresh[s],
                    static_cast<unsigned>(b0)};
}
template <bool PRNG>
__device__ __forceinline__ Probs<PRNG> probs_of(const DropArgs& d, int l, int b0, size_t smp) {
  const size_t at = smp * HEADS * PAIRS;
  return Probs<PRNG>{PRNG ? nullptr : d.m[0] + at,
                     PRNG && d.dump[0] != nullptr ? d.dump[0] + at : nullptr,
                     PRNG ? __ldg(d.seed) : 0u,
                     static_cast<unsigned>(l * philox::STREAMS), d.thresh[0],
                     static_cast<unsigned>(b0)};
}

// Where x > 0 keep g, else 0 (ReLU backward).
__device__ __forceinline__ float4 gate4(float4 g, float4 x) {
  return make_float4(x.x > 0.f ? g.x : 0.f, x.y > 0.f ? g.y : 0.f, x.z > 0.f ? g.z : 0.f,
                     x.w > 0.f ? g.w : 0.f);
}

// dst[r, :W] = src[r, :W] for the tile's nb real samples, dst in global memory.
template <int W>
__device__ __forceinline__ void store_rows(const float* src, int lds, float* __restrict__ dst,
                                           int nb, int tid) {
  constexpr int NG = W / 4;
  for (int it = tid; it < nb * N_PTS * NG; it += THREADS) {
    const int r = it / NG;
    const int c = 4 * (it % NG);
    st4(dst + r * W + c, ld4(src + r * lds + c));
  }
}

// dst[r, :W] = src[r, :W] from global memory; rows of absent samples get zeros.
template <int W>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* dst, int ldd,
                                          int nb, int tid) {
  constexpr int NG = W / 4;
  for (int it = tid; it < ROWS * NG; it += THREADS) {
    const int r = it / NG;
    const int c = 4 * (it % NG);
    st4(dst + r * ldd + c, r < nb * N_PTS ? ldg4(src + r * W + c) : zero4());
  }
}

// ---------------------------------------------------------------------------
// Tensor-core epilogues of the train pair (tc_gemm and its helpers:
// tc_gemm.cuh)
// ---------------------------------------------------------------------------

constexpr int FWD_KS = 32, FWD_STAGES = 3;               // rows of W a slab, slabs in the ring
constexpr int BWD_KS = 32, BWD_STAGES = 2;
constexpr int FWD_RING = ring_floats<FWD_STAGES, FWD_KS>();
constexpr int BWD_RING = ring_floats<BWD_STAGES, BWD_KS>();

// fc1: relu(acc + bias) into C (LDB), stashed (W wide) for the real rows.
template <int W>
struct EpReluStash {
  float* c;
  const float* bias;
  float* stash;
  int nreal;
  __device__ __forceinline__ void operator()(const Acc& d, int m0, int rb, int g, int t) const {
    float b[2][2];
    frag_bias(bias, m0, g, b);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = frag_row(rb, nt, i, t), col = frag_col(m0, mt, i, g);
          if (r >= ROWS) continue;
          const float v = fmaxf(d[mt][nt][i] + b[mt][i >> 1], 0.f);
          c[r * LDB + col] = v;
          if (r < nreal) stash[r * W + col] = v;
        }
  }
};

// The Philox draws of the warp's 6 tiles (Site::frag_draw), [mt][nt].
template <bool PRNG>
__device__ __forceinline__ void frag_draws(const Site<PRNG>& mask, int m0, int rb, int g, int t,
                                           int nreal, unsigned (&bits)[2][3]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 3; ++nt) bits[mt][nt] = mask.frag_draw(rb + 8 * nt, m0 + 16 * mt, g, t, nreal);
}

// The out-projection's residual: h += (acc + bias) * mask * scale over the
// real rows, the new h stashed.
template <bool PRNG>
struct EpResidual {
  float* h;
  const float* bias;
  Site<PRNG> mask;
  float scale;
  float* stash_h;
  int nreal;
  __device__ __forceinline__ void operator()(const Acc& d, int m0, int rb, int g, int t) const {
    float b[2][2];
    unsigned bits[2][3];
    frag_bias(bias, m0, g, b);
    frag_draws(mask, m0, rb, g, t, nreal, bits);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float f = mask.frag_factor(bits[mt][nt], i, g, t, scale);
          const int r = frag_row(rb, nt, i, t), col = frag_col(m0, mt, i, g);
          if (r >= nreal) continue;
          const float hv = h[r * LDH + col] + (d[mt][nt][i] + b[mt][i >> 1]) * f;
          h[r * LDH + col] = hv;
          stash_h[r * HID + col] = hv;
        }
  }
};

// du = the product, into du; dc1 = du * mask * scale where rc1 > 0 into dc
// and its d-stash (real rows; 0 in the absent ones).  An m tile (12
// elements) at a time: its 3 Philox draws, then its 12 values of rc1.
template <bool PRNG>
struct EpDu {
  float* du;
  float* dc;
  Site<PRNG> mask;
  float scale;
  const float* rc1;
  float* dstash;
  int nreal;
  __device__ __forceinline__ void operator()(const Acc& d, int m0, int rb, int g, int t) const {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      unsigned bits[3];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) bits[nt] = mask.frag_draw(rb + 8 * nt, m0 + 16 * mt, g, t, nreal);
      float x[3][4];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = frag_row(rb, nt, i, t), col = frag_col(m0, mt, i, g);
          x[nt][i] = r < nreal ? __ldg(rc1 + r * HID + col) : 0.f;
        }
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float f = mask.frag_factor(bits[nt], i, g, t, scale);
          const int r = frag_row(rb, nt, i, t), col = frag_col(m0, mt, i, g);
          if (r >= ROWS) continue;
          du[r * LDH + col] = d[mt][nt][i];
          const float v = x[nt][i] > 0.f ? d[mt][nt][i] * f : 0.f;
          if (r < nreal) dstash[r * HID + col] = v;
          dc[r * LDH + col] = v;
        }
    }
  }
};

// df1 = the product where r1 > 0, into C (LDB) and its d-stash (2·HID
// wide); absent rows 0.  r1 is gathered an m tile at a time.
struct EpGate {
  float* c;
  const float* r1;
  float* dstash;
  int nreal;
  __device__ __forceinline__ void operator()(const Acc& d, int m0, int rb, int g, int t) const {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float x[3][4];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = frag_row(rb, nt, i, t), col = frag_col(m0, mt, i, g);
          x[nt][i] = r < nreal ? __ldg(r1 + r * 2 * HID + col) : 0.f;
        }
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = frag_row(rb, nt, i, t), col = frag_col(m0, mt, i, g);
          if (r >= ROWS) continue;
          const float v = x[nt][i] > 0.f ? d[mt][nt][i] : 0.f;
          if (r < nreal) dstash[r * 2 * HID + col] = v;
          c[r * LDB + col] = v;
        }
    }
  }
};

// dh += d/dx of the LayerNorm scale*(x-mean)/(std+1e-6)+shift (Bessel std,
// eps outside the root), given the output gradient g (shared memory) and x
// (the forward's stash in global memory); one warp a real row.
__device__ __forceinline__ void ln_bwd_add_warp(float* dh, const float* g,
                                                const float* __restrict__ x,
                                                const float* __restrict__ scale, int nreal,
                                                int tid) {
  const int lane = tid & 31;
  float scl[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) scl[j] = __ldg(scale + lane + 32 * j);
  float xn[3];   // the warp's next row of x, loaded one row ahead
#pragma unroll
  for (int j = 0; j < 3; ++j) xn[j] = (tid >> 5) < nreal ? __ldg(x + (tid >> 5) * HID + lane + 32 * j) : 0.f;
  for (int r = tid >> 5; r < nreal; r += WARPS) {
    float d[3], gs[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      d[j] = xn[j];
      xn[j] = r + WARPS < nreal ? __ldg(x + (r + WARPS) * HID + lane + 32 * j) : 0.f;
      gs[j] = g[r * LDH + lane + 32 * j] * scl[j];
    }
    const float mean = warp_sum(d[0] + d[1] + d[2]) / HID;
    float ss = 0.f, s1 = 0.f, sg = 0.f, sc = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      d[j] -= mean;
      ss = fmaf(d[j], d[j], ss);
      s1 = fmaf(gs[j], d[j], s1);
      sg += gs[j];
      sc += d[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      sg += __shfl_xor_sync(0xffffffffu, sg, o);
      sc += __shfl_xor_sync(0xffffffffu, sc, o);
    }
    const float sd = sqrtf(ss / (HID - 1));
    const float rinv = 1.f / (sd + 1e-6f);
    const float coef = s1 * rinv * rinv / ((HID - 1) * fmaxf(sd, 1e-20f));
    const float mdc = (sg * rinv - sc * coef) / HID;   // mean of dc over the row
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int c = lane + 32 * j;
      dh[r * LDH + c] += gs[j] * rinv - d[j] * coef - mdc;
    }
  }
}

// ---------------------------------------------------------------------------
// Forward stages
// ---------------------------------------------------------------------------

// sum_e val_e * in[b, m_e, k_e*HID + c .. +3] over row n's Chebyshev terms;
// src = in + b*17*LDB + c.
__device__ __forceinline__ float4 cheb_mix4(const float* src, int n, const int* ptr,
                                            const int* idx, const float* val) {
  float4 v = zero4();
  for (int e = ptr[n]; e < ptr[n + 1]; ++e) {
    const int km = idx[e];
    fma4(v, val[e], ld4(src + (km & 0xff) * LDB + (km >> 8) * HID));
  }
  return v;
}

// The GraphNet sublayer's output and residual, real rows:
// h += (lap . y + bias) * mask * scale, the new h stashed.
template <bool PRNG>
__device__ __forceinline__ void lap_residual(const float* y, float* h, const float* lap,
                                             const float* __restrict__ bias, const Site<PRNG> mask,
                                             float scale, float* __restrict__ stash_h, int nb,
                                             int tid) {
  constexpr int NG = HID / 4;
  for (int it = tid; it < nb * N_PTS * NG; it += THREADS) {
    const int r = it / NG;
    const int c = 4 * (it % NG);
    const int n = r % N_PTS;
    const float* src = y + (r / N_PTS) * N_PTS * LDH + c;
    float4 v = zero4();
#pragma unroll
    for (int m = 0; m < N_PTS; ++m) fma4(v, lap[n * N_PTS + m], ld4(src + m * LDH));
    v = add4(v, ldg4(bias + c));
    const float4 hv = add4(ld4(h + r * LDH + c), mul4(v, mask.factor(r, c, scale)));
    st4(h + r * LDH + c, hv);
    st4(stash_h + r * HID + c, hv);
  }
}

// The first Chebyshev conv's mixing and what follows it: v = relu(mix + bias),
// stashed as rc1; y = v * mask * scale + tp[b], stashed as u (real rows;
// absent rows get v).
template <bool PRNG>
__device__ __forceinline__ void cheb1_dropout_tp(const float* big, float* y, const int* ptr,
                                                 const int* idx, const float* val,
                                                 const float* __restrict__ bias,
                                                 const Site<PRNG> mask, float scale,
                                                 const float* __restrict__ tp,
                                                 float* __restrict__ rc1, float* __restrict__ u,
                                                 int nb, int tid) {
  constexpr int NG = HID / 4;
  for (int it = tid; it < ROWS * NG; it += THREADS) {
    const int r = it / NG;
    const int c = 4 * (it % NG);
    const int b = r / N_PTS;
    float4 v = relu4(add4(cheb_mix4(big + b * N_PTS * LDB + c, r % N_PTS, ptr, idx, val),
                          ldg4(bias + c)));
    if (b < nb) {
      st4(rc1 + r * HID + c, v);
      v = add4(mul4(v, mask.factor(r, c, scale)), ldg4(tp + b * HID + c));
      st4(u + r * HID + c, v);
    }
    st4(y + r * LDH + c, v);
  }
}

// The second Chebyshev conv's mixing and the block's residual, real rows:
// v = relu(mix + bias), stashed as rd1; h += v * mask * scale.
template <bool PRNG>
__device__ __forceinline__ void cheb2_residual(const float* big, float* h, const int* ptr,
                                               const int* idx, const float* val,
                                               const float* __restrict__ bias,
                                               const Site<PRNG> mask, float scale,
                                               float* __restrict__ rd1, int nb, int tid) {
  constexpr int NG = HID / 4;
  for (int it = tid; it < nb * N_PTS * NG; it += THREADS) {
    const int r = it / NG;
    const int c = 4 * (it % NG);
    const float4 v = relu4(add4(
        cheb_mix4(big + (r / N_PTS) * N_PTS * LDB + c, r % N_PTS, ptr, idx, val), ldg4(bias + c)));
    st4(rd1 + r * HID + c, v);
    st4(h + r * LDH + c, add4(ld4(h + r * LDH + c), mul4(v, mask.factor(r, c, scale))));
  }
}

// The attention stages run over a query's 17 keys in rolled loops and keep
// the row's scores in shared memory (srow, 17 floats a thread), so that only
// one q (or dA, or output) row of DK columns and the loads of two keys are
// in registers at a time: fully unrolled, the loops' hoisted loads spill.

// a . rows[m] over the head's DK columns, in one chain (as netk::attention).
__device__ __forceinline__ float head_dot(const float4 (&a)[DK / 4], const float* row) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DK / 4; ++d) {
    const float4 kv = ld4(row + 4 * d);
    acc = fmaf(a[d].x, kv.x, acc);
    acc = fmaf(a[d].y, kv.y, acc);
    acc = fmaf(a[d].z, kv.z, acc);
    acc = fmaf(a[d].w, kv.w, acc);
  }
  return acc;
}

// head_dot at the bf16 tier: each product rounded to bf16, then times s
// (SCALED) and rounded again, the roundings summed in f32
// (pallas_train.py's _dot_exact_w of a product against the 0/1 segment
// matrix; SCALED: dp's v_d datt_d mask/keep).
template <bool SCALED = false>
__device__ __forceinline__ float head_dot_bf16(const float4 (&a)[DK / 4], const float* row,
                                               float s = 1.f) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DK / 4; ++d) {
    const float4 kv = ld4(row + 4 * d);
    const float p[4] = {__fmul_rn(a[d].x, kv.x), __fmul_rn(a[d].y, kv.y),
                        __fmul_rn(a[d].z, kv.z), __fmul_rn(a[d].w, kv.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) acc += tf32::round_bf16(SCALED ? __fmul_rn(p[i], s) : p[i]);
  }
  return acc;
}

// netk::attention with dropout on the probabilities: p * mask * ikp.
// scratch: TB * HEADS * 17 rows of 17 floats.  TIER_BF16: the scores' and
// the probabilities' roundings (the file's text).
template <bool PRNG, int TIER = tf32::TIER_3XTF32>
__device__ __forceinline__ void attention_dropout(const float* qkv, float* out, float* scratch,
                                                  const Probs<PRNG> mp, float ikp,
                                                  int nb, int tid) {
  constexpr bool RND = TIER == tf32::TIER_BF16;
  for (int it = tid; it < nb * HEADS * N_PTS; it += THREADS) {
    const int n = it % N_PTS;
    const int hd = (it / N_PTS) % HEADS;
    const int b = it / (N_PTS * HEADS);
    const float* base = qkv + b * N_PTS * LDB + hd * DK;
    float* srow = scratch + it * N_PTS;
    const unsigned kept = mp.row(b, hd, n);
    float mx = -INFINITY;
    {
      float4 q[DK / 4];
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) q[d] = ld4(base + n * LDB + 4 * d);
#pragma unroll 1
      for (int m = 0; m < N_PTS; ++m) {
        float sv;
        if constexpr (RND) sv = head_dot_bf16(q, base + m * LDB + HID);
        else sv = head_dot(q, base + m * LDB + HID);
        srow[m] = sv;
        mx = fmaxf(mx, sv);
      }
    }
    float sum = 0.f;
#pragma unroll 1
    for (int m = 0; m < N_PTS; ++m) {
      const float e = expf(srow[m] - mx);
      srow[m] = e;
      sum += e;
    }
    float4 o[DK / 4];
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) o[d] = zero4();
#pragma unroll 1
    for (int m = 0; m < N_PTS; ++m) {
      float p;
      if constexpr (RND) p = mp.keep(kept, m) ? tf32::round_bf16(srow[m] / sum) * ikp : 0.f;
      else p = mp.keep(kept, m) ? srow[m] / sum * ikp : 0.f;
      const float* vr = base + m * LDB + 2 * HID;
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) fma4(o[d], p, ld4(vr + 4 * d));
    }
    float* dst = out + (b * N_PTS + n) * LDH + hd * DK;
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) st4(dst + 4 * d, o[d]);
  }
}

// Forward shared memory: h, y, big, the weight ring, lap and the Chebyshev
// term list.
constexpr int FWD_SMEM_FLOATS = ACT_FLOATS + FWD_RING + LAP_PAD + 2 * TERMS_PAD + 20;
constexpr size_t FWD_SMEM_BYTES = sizeof(float) * FWD_SMEM_FLOATS;
static_assert(FWD_RING >= TB * HEADS * PAIRS, "the attention's scores borrow the ring");
static_assert(FWD_SMEM_BYTES <= 232448, "forward tile exceeds an SM's shared memory");

// The products of the forward and of the backward at TIER: tc_gemm and
// tc_prefetch over the pass's ring, on weights [K, N] (N wide rows), split
// in the CTA at the parity grade and rounded on the host at a one-pass tier.
template <int K, int N, int LDA, int S, int KS, int TIER, class Epi>
__device__ __forceinline__ void stack_gemm(const float* A, const float* __restrict__ W, float* ring,
                                     const Epi& epi, int tid) {
  tc_gemm<K, N, LDA, S, KS, N, TIER != tf32::TIER_3XTF32, THREADS, TIER>(A, W, ring, epi, tid);
}
template <int K, int N, int S, int KS, int TIER>
__device__ __forceinline__ void stack_prefetch(const float* __restrict__ W, float* ring, int tid) {
  tc_prefetch<K, N, S, KS, N, TIER != tf32::TIER_3XTF32, THREADS, TIER>(W, ring, tid);
}

// The thread index a layer of the forward works with: at a one-pass tier
// taken anew each layer and opaque to the compiler, so that nothing derived
// from it is held across the layer loop (at 168 registers the seeded 1xTF32
// build spilled 8 bytes of such addresses); at the parity grade the index
// itself.
template <int TIER>
__device__ __forceinline__ int layer_index(int tid) {
  if constexpr (TIER != tf32::TIER_3XTF32) asm volatile("" : "+r"(tid));
  return tid;
}

template <bool PRNG, int TIER = tf32::TIER_3XTF32>
__global__ void __launch_bounds__(THREADS, 1) train_forward_kernel(const FwdArgs a) {
  constexpr int S = FWD_STAGES, KS = FWD_KS;
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);
  float* y = h + ROWS_PAD * LDH;
  float* big = y + ROWS_PAD * LDH;
  float* ring = big + ROWS_PAD * LDB;
  float* lap = ring + FWD_RING;
  float* cval = lap + LAP_PAD;
  int* cidx = reinterpret_cast<int*>(cval + TERMS_PAD);
  int* cptr = cidx + TERMS_PAD;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TB;
  const int nb = min(TB, a.batch - b0);
  const int nreal = nb * N_PTS;

  for (int i = tid; i < ACT_FLOATS; i += THREADS) h[i] = 0.f;
  for (int i = tid; i < a.cheb_nnz; i += THREADS) {
    cval[i] = a.cheb_val[i];
    cidx[i] = a.cheb_idx[i];
  }
  for (int i = tid; i <= N_PTS; i += THREADS) cptr[i] = a.cheb_ptr[i];
  __syncthreads();
  load_rows<HID>(a.h0 + static_cast<size_t>(b0) * N_PTS * HID, h, LDH, nb, tid);
  __syncthreads();

  for (int l = 0; l < a.num_layers; ++l) {
    const int lt = layer_index<TIER>(tid);
    // first row of this tile in the [L, B*17, .] arrays, and its sample in [L, B, .]
    const size_t smp = static_cast<size_t>(l) * a.batch + b0;
    const size_t row = smp * N_PTS;
    const size_t wsq = static_cast<size_t>(l) * HID * HID;

    // attention sublayer: h += dropout(out_proj(attention_dropout(LN1(h))))
    stack_prefetch<HID, 3 * HID, S, KS, TIER>(a.wqkv + 3 * wsq, ring, lt);
    store_rows<HID>(h, LDH, a.ha + row * HID, nb, lt);
    layer_norm_warp(h, y, a.ln1s + l * HID, a.ln1b + l * HID, a.y1 + row * HID, nreal, lt);
    for (int i = lt; i < PAIRS; i += THREADS) lap[i] = a.lap[l * PAIRS + i];
    __syncthreads();
    stack_gemm<HID, 3 * HID, LDH, S, KS, TIER>(
        y, a.wqkv + 3 * wsq, ring, EpSmem<LDB, true, false>{big, a.bqkv + l * 3 * HID}, lt);
    __syncthreads();
    attention_dropout<PRNG, TIER>(big, y, ring, probs_of<PRNG>(a.drop, l, b0, smp), a.ikp, nb,
                                  lt);
    __syncthreads();
    stack_prefetch<HID, HID, S, KS, TIER>(a.wao + wsq, ring, lt);
    store_rows<HID>(y, LDH, a.att + row * HID, nb, lt);
    stack_gemm<HID, HID, LDH, S, KS, TIER>(
        y, a.wao + wsq, ring,
        EpResidual<PRNG>{h, a.bao + l * HID, site_of<PRNG>(a.drop, 1, l, b0, smp), a.iks,
                         a.hb + row * HID, nreal},
        lt);
    __syncthreads();

    // GraphNet sublayer: h += dropout(lap . (relu(fc1(lap . LN2(h)))) @ W_fc2 + b_fc2)
    stack_prefetch<HID, 2 * HID, S, KS, TIER>(a.wfc1 + 2 * wsq, ring, lt);
    layer_norm_warp(h, y, a.ln2s + l * HID, a.ln2b + l * HID, nullptr, nreal, lt);
    __syncthreads();
    mix<HID, LDH, LDB, kMixStore, true>(y, big, cptr, cidx, cval, lap, nullptr, nullptr, nb, lt);
    __syncthreads();
    stack_gemm<HID, 2 * HID, LDB, S, KS, TIER>(
        big, a.wfc1 + 2 * wsq, ring,
        EpReluStash<2 * HID>{big + HID, a.bfc1 + l * 2 * HID, a.r1 + row * 2 * HID, nreal}, lt);
    __syncthreads();
    stack_prefetch<2 * HID, HID, S, KS, TIER>(a.wfc2 + 2 * wsq, ring, lt);
    if constexpr (TIER == tf32::TIER_3XTF32) {
      // lap . (r1 @ W_fc2): the product, then the HID-wide mix with the residual
      stack_gemm<2 * HID, HID, LDB, S, KS, TIER>(big + HID, a.wfc2 + 2 * wsq, ring,
                                           EpSmem<LDH, false, false>{y, nullptr}, lt);
      __syncthreads();
      stack_prefetch<HID, 3 * HID, S, KS, TIER>(a.wg1 + 3 * wsq, ring, lt);
      lap_residual(y, h, lap, a.bfc2 + l * HID, site_of<PRNG>(a.drop, 2, l, b0, smp), a.iks,
                   a.hc + row * HID, nb, lt);
    } else {
      // (lap . r1) @ W_fc2, the TPU kernel's order: r1's two halves mixed
      // into big's first 2 HID columns one after the other (the second half
      // is written where the first is read), then the product with the
      // dropout and the residual in its epilogue
      mix<HID, LDB, LDB, kMixStore, true>(big + HID, big, cptr, cidx, cval, lap, nullptr, nullptr,
                                          nb, lt);
      __syncthreads();
      mix<HID, LDB, LDB, kMixStore, true>(big + 2 * HID, big + HID, cptr, cidx, cval, lap,
                                          nullptr, nullptr, nb, lt);
      __syncthreads();
      stack_gemm<2 * HID, HID, LDB, S, KS, TIER>(
          big, a.wfc2 + 2 * wsq, ring,
          EpResidual<PRNG>{h, a.bfc2 + l * HID, site_of<PRNG>(a.drop, 2, l, b0, smp), a.iks,
                           a.hc + row * HID, nreal},
          lt);
      __syncthreads();
      stack_prefetch<HID, 3 * HID, S, KS, TIER>(a.wg1 + 3 * wsq, ring, lt);
    }
    __syncthreads();

    // residual Chebyshev block: h += dropout(relu(cheb2(dropout(relu(cheb1(h))) + tp)))
    stack_gemm<HID, 3 * HID, LDH, S, KS, TIER>(h, a.wg1 + 3 * wsq, ring,
                                         EpSmem<LDB, false, false>{big, nullptr}, lt);
    __syncthreads();
    stack_prefetch<HID, 3 * HID, S, KS, TIER>(a.wg2 + 3 * wsq, ring, lt);
    cheb1_dropout_tp(big, y, cptr, cidx, cval, a.bg1 + l * HID,
                     site_of<PRNG>(a.drop, 3, l, b0, smp), a.ikc, a.tp + smp * HID,
                     a.rc1 + row * HID, a.u + row * HID, nb, lt);
    __syncthreads();
    stack_gemm<HID, 3 * HID, LDH, S, KS, TIER>(y, a.wg2 + 3 * wsq, ring,
                                         EpSmem<LDB, false, false>{big, nullptr}, lt);
    __syncthreads();
    cheb2_residual(big, h, cptr, cidx, cval, a.bg2 + l * HID,
                   site_of<PRNG>(a.drop, 4, l, b0, smp), a.ikc, a.rd1 + row * HID, nb, lt);
    __syncthreads();
  }
  store_rows<HID>(h, LDH, a.d5 + static_cast<size_t>(b0) * N_PTS * HID, nb, tid);
}

// ---------------------------------------------------------------------------
// Backward stages
// ---------------------------------------------------------------------------

constexpr int SP_FLOATS = TB * HEADS * 2 * PAIRS;       // ds and p*mask per (sample, head)
constexpr int BWD_ACT_FLOATS = 3 * ROWS_PAD * LDH + ROWS_PAD * LDB;
// sp (attention_bwd only) and the weight ring (the products only) share the
// last region.
constexpr int BWD_REGION = SP_FLOATS > BWD_RING ? SP_FLOATS : BWD_RING;
constexpr int BWD_SMEM_FLOATS = BWD_ACT_FLOATS + LAP_PAD + 2 * TERMS_PAD + TPTR_PAD + BWD_REGION;
constexpr size_t BWD_SMEM_BYTES = sizeof(float) * BWD_SMEM_FLOATS;
static_assert(BWD_SMEM_BYTES <= 232448, "backward tile exceeds an SM's shared memory");
static_assert((BWD_SMEM_FLOATS - BWD_REGION) % 4 == 0, "the ring must be 16-byte aligned");

// out = g * mask * scale, gated by relu_src > 0 where given; written to the
// d-stash too.  Rows of absent samples get zeros.  out may alias g.
template <bool PRNG>
__device__ __forceinline__ void dropout_bwd(const float* g, float* out,
                                            const Site<PRNG> mask, float scale,
                                            const float* __restrict__ relu_src,
                                            float* __restrict__ dstash, int nb, int tid) {
  constexpr int NG = HID / 4;
  for (int it = tid; it < ROWS * NG; it += THREADS) {
    const int r = it / NG;
    const int c = 4 * (it % NG);
    float4 v = zero4();
    if (r < nb * N_PTS) {
      v = mul4(ld4(g + r * LDH + c), mask.factor(r, c, scale));
      if (relu_src != nullptr) v = gate4(v, ldg4(relu_src + r * HID + c));
      st4(dstash + r * HID + c, v);
    }
    st4(out + r * LDH + c, v);
  }
}

// The transposed Chebyshev mixes side by side:
//   out[b, m, k*HID : (k+1)*HID] = sum_j T_k[j, m] * in[b, j, :]
// Thread = (order, joint, column group) for all TB samples, so that each
// term is read once and feeds TB independent sums.
__device__ __forceinline__ void mix_t(const float* in, float* out, const int* tptr,
                                      const int* tidx, const float* tval, int tid) {
  constexpr int NG = HID / 4;
  for (int it = tid; it < 3 * N_PTS * NG; it += THREADS) {
    const int c = 4 * (it % NG);
    const int km = it / NG;                  // k * N_PTS + m
    const int k = km / N_PTS, m = km % N_PTS;
    float4 v[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) v[b] = zero4();
    for (int e = tptr[km]; e < tptr[km + 1]; ++e) {
      const float w = tval[e];
      const float* src = in + tidx[e] * LDH + c;
#pragma unroll
      for (int b = 0; b < TB; ++b) fma4(v[b], w, ld4(src + b * N_PTS * LDH));
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) st4(out + (b * N_PTS + m) * LDB + k * HID + c, v[b]);
  }
}

// out[b, m, :] = sum_n lap[n, m] * in[b, n, :]  (the learned adjacency, transposed)
__device__ __forceinline__ void lap_mix_t(const float* in, float* out, const float* lap, int tid) {
  constexpr int NG = HID / 4;
  for (int it = tid; it < ROWS * NG; it += THREADS) {
    const int r = it / NG;
    const int c = 4 * (it % NG);
    const int b = r / N_PTS;
    const int m = r % N_PTS;
    const float* src = in + b * N_PTS * LDH + c;
    float4 v = zero4();
#pragma unroll
    for (int n = 0; n < N_PTS; ++n) fma4(v, lap[n * N_PTS + m], ld4(src + n * LDH));
    st4(out + r * LDH + c, v);
  }
}

// The one-pass tiers' fc2 backward: out[b, m, :HID] (LDB) = sum_n lap[n, m] *
// in[b, n, :HID] (LDB), where r1 > 0 (r1 and the d-stash 2 HID wide, their
// columns of this half), also into the d-stash for the real rows; absent
// rows 0 (EpGate's function after the mix instead of before it).
__device__ __forceinline__ void lap_mix_t_gate(const float* in, float* out, const float* lap,
                                               const float* __restrict__ r1,
                                               float* __restrict__ dstash, int nreal, int tid) {
  constexpr int NG = HID / 4;
  for (int it = tid; it < ROWS * NG; it += THREADS) {
    const int r = it / NG;
    const int c = 4 * (it % NG);
    const int m = r % N_PTS;
    const float* src = in + (r / N_PTS) * N_PTS * LDB + c;
    float4 v = zero4();
#pragma unroll
    for (int n = 0; n < N_PTS; ++n) fma4(v, lap[n * N_PTS + m], ld4(src + n * LDB));
    if (r < nreal) {
      v = gate4(v, ldg4(r1 + r * 2 * HID + c));
      st4(dstash + r * 2 * HID + c, v);
    } else {
      v = zero4();
    }
    st4(out + r * LDB + c, v);
  }
}

// dtp[b, :] = sum over the joints of du[b, :, :]
__device__ __forceinline__ void joint_sum(const float* du, float* __restrict__ dtp, int nb,
                                          int tid) {
  for (int it = tid; it < nb * HID; it += THREADS) {
    const int b = it / HID;
    const int c = it % HID;
    float acc = 0.f;
    for (int n = 0; n < N_PTS; ++n) acc += du[(b * N_PTS + n) * LDH + c];
    dtp[it] = acc;
  }
}

// Attention backward of one (sample, head) per 17 threads, thread = joint.
// qkv holds q | k | v (q pre-scaled) and is overwritten by dq | dk | dv;
// datt is the gradient of the attention output.  Phase 1, thread = query n:
// recompute the softmax row, ds[n, :] and the dropped probabilities into sp,
// dq[n] into dqs.  Phase 2, thread = key m: dk[m] and dv[m] from the columns
// of sp, written over k[m] and v[m], which no thread reads any more.  Phase 3:
// dq[n] over q[n] (dqs is a free HID-wide buffer).  The dropout decisions of
// a query's row are fetched (or drawn) once, in phase 1; phase 2 meets them
// again in the dropped probabilities of sp.  TIER_BF16: the roundings of the
// file's text (the recomputed scores and probabilities, dp's terms, ds).
template <bool PRNG, int TIER = tf32::TIER_3XTF32>
__device__ __forceinline__ void attention_bwd(float* qkv, const float* datt,
                                              const Probs<PRNG> mp, float ikp,
                                              float* sp, float* dqs, int nb, int tid) {
  constexpr bool RND = TIER == tf32::TIER_BF16;
  const int n = tid % N_PTS;
  const int hd = (tid / N_PTS) % HEADS;
  const int b = tid / (N_PTS * HEADS);
  const bool live = b < nb;              // also false for the threads past TB*HEADS*17
  const int bs = live ? b : 0;           // keeps the unused pointers in bounds
  float* base = qkv + bs * N_PTS * LDB + hd * DK;
  const float* dbase = datt + bs * N_PTS * LDH + hd * DK;
  float* ds_s = sp + (bs * HEADS + hd) * 2 * PAIRS;
  float* pd_s = ds_s + PAIRS;

  float* dq_row = dqs + (bs * N_PTS + n) * LDH + hd * DK;
  if (live) {
    const unsigned kept = mp.row(b, hd, n);
    float* prow = pd_s + n * N_PTS;   // scores, then exp, then p * mask
    float* drow = ds_s + n * N_PTS;   // dp, then dp * mask, then ds
    float mx = -INFINITY;
    {
      float4 q[DK / 4];
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) q[d] = ld4(base + n * LDB + 4 * d);
#pragma unroll 1
      for (int m = 0; m < N_PTS; ++m) {
        float sv;
        if constexpr (RND) sv = head_dot_bf16(q, base + m * LDB + HID);
        else sv = head_dot(q, base + m * LDB + HID);
        prow[m] = sv;
        mx = fmaxf(mx, sv);
      }
    }
    {
      float4 da[DK / 4];
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) da[d] = ld4(dbase + n * LDH + 4 * d);
#pragma unroll 1
      for (int m = 0; m < N_PTS; ++m) {
        if constexpr (RND)   // dp, its terms dropped, scaled and rounded
          drow[m] = mp.keep(kept, m) ? head_dot_bf16<true>(da, base + m * LDB + 2 * HID, ikp)
                                     : 0.f;
        else
          drow[m] = head_dot(da, base + m * LDB + 2 * HID);
      }
    }
    float sum = 0.f;
#pragma unroll 1
    for (int m = 0; m < N_PTS; ++m) {
      const float e = expf(prow[m] - mx);
      prow[m] = e;
      sum += e;
    }
    float rowdot = 0.f;
#pragma unroll 1
    for (int m = 0; m < N_PTS; ++m) {
      float dpk;
      if constexpr (RND) {
        dpk = drow[m];
      } else {
        dpk = drow[m] * (mp.keep(kept, m) ? ikp : 0.f);
        drow[m] = dpk;
      }
      rowdot = fmaf(prow[m] / sum, dpk, rowdot);
    }
    float4 dq[DK / 4];
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) dq[d] = zero4();
#pragma unroll 1
    for (int m = 0; m < N_PTS; ++m) {
      const float pv = prow[m] / sum;
      float dsv = pv * (drow[m] - rowdot);
      if constexpr (RND) dsv = tf32::round_bf16(dsv);
      drow[m] = dsv;
      prow[m] = (RND ? tf32::round_bf16(pv) : pv) * (mp.keep(kept, m) ? ikp : 0.f);
      const float* kr = base + m * LDB + HID;
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) fma4(dq[d], dsv, ld4(kr + 4 * d));
    }
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) st4(dq_row + 4 * d, dq[d]);
  }
  __syncthreads();
  // k and v are read no more: dk and dv go straight to their columns
  if (live) {
    float4 acc[DK / 4];
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) acc[d] = zero4();
#pragma unroll 1
    for (int q = 0; q < N_PTS; ++q) {
      const float dsv = ds_s[q * N_PTS + n];
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) fma4(acc[d], dsv, ld4(base + q * LDB + 4 * d));
    }
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) {
      st4(base + n * LDB + HID + 4 * d, acc[d]);                // dk = dsᵀ q
      acc[d] = zero4();
    }
#pragma unroll 1
    for (int q = 0; q < N_PTS; ++q) {
      const float pdv = pd_s[q * N_PTS + n];
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) fma4(acc[d], pdv, ld4(dbase + q * LDH + 4 * d));
    }
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) st4(base + n * LDB + 2 * HID + 4 * d, acc[d]);  // dv = (p·mask)ᵀ datt
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) st4(base + n * LDB + 4 * d, ld4(dq_row + 4 * d));
  }
}

template <bool PRNG, int TIER = tf32::TIER_3XTF32>
__global__ void __launch_bounds__(THREADS, 1) train_backward_kernel(const BwdArgs a) {
  constexpr int S = BWD_STAGES, KS = BWD_KS;
  extern __shared__ float4 smem4[];
  float* dh = reinterpret_cast<float*>(smem4);
  float* ba = dh + ROWS_PAD * LDH;
  float* bb = ba + ROWS_PAD * LDH;
  float* big = bb + ROWS_PAD * LDH;
  float* lap = big + ROWS_PAD * LDB;
  float* tval = lap + LAP_PAD;
  int* tidx = reinterpret_cast<int*>(tval + TERMS_PAD);
  int* tptr = tidx + TERMS_PAD;
  float* ring = reinterpret_cast<float*>(tptr + TPTR_PAD);   // also sp
  float* sp = ring;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TB;
  const int nb = min(TB, a.batch - b0);
  const int nreal = nb * N_PTS;

  for (int i = tid; i < BWD_ACT_FLOATS; i += THREADS) dh[i] = 0.f;
  for (int i = tid; i < a.tnnz; i += THREADS) {
    tval[i] = a.tval[i];
    tidx[i] = a.tidx[i];
  }
  for (int i = tid; i <= TTERMS; i += THREADS) tptr[i] = a.tptr[i];
  __syncthreads();
  load_rows<HID>(a.dd5 + static_cast<size_t>(b0) * N_PTS * HID, dh, LDH, nb, tid);
  __syncthreads();

  for (int l = a.num_layers - 1; l >= 0; --l) {
    const size_t smp = static_cast<size_t>(l) * a.batch + b0;
    const size_t row = smp * N_PTS;
    const size_t wsq = static_cast<size_t>(l) * HID * HID;

    // Chebyshev block: h_out = hc + rd1*m4*ikc, rd1 = relu(cheb2(u)), u = rc1*m3*ikc + tp
    stack_prefetch<3 * HID, HID, S, KS, TIER>(a.wg2t + 3 * wsq, ring, tid);
    dropout_bwd(dh, ba, site_of<PRNG>(a.drop, 4, l, b0, smp), a.ikc, a.rd1 + row * HID,
                a.dc2 + row * HID, nb, tid);
    for (int i = tid; i < PAIRS; i += THREADS) lap[i] = a.lap[l * PAIRS + i];
    __syncthreads();
    mix_t(ba, big, tptr, tidx, tval, tid);
    __syncthreads();
    // du into ba, dc1 = du * m3 * ikc where rc1 > 0 into bb
    stack_gemm<3 * HID, HID, LDB, S, KS, TIER>(
        big, a.wg2t + 3 * wsq, ring,
        EpDu<PRNG>{ba, bb, site_of<PRNG>(a.drop, 3, l, b0, smp), a.ikc, a.rc1 + row * HID,
                   a.dc1 + row * HID, nreal},
        tid);
    __syncthreads();
    stack_prefetch<3 * HID, HID, S, KS, TIER>(a.wg1t + 3 * wsq, ring, tid);
    joint_sum(ba, a.dtp + smp * HID, nb, tid);
    mix_t(bb, big, tptr, tidx, tval, tid);
    __syncthreads();
    stack_gemm<3 * HID, HID, LDB, S, KS, TIER>(big, a.wg1t + 3 * wsq, ring,
                                               EpSmem<LDH, false, true>{dh, nullptr}, tid);  // dh = d hc
    __syncthreads();

    // GraphNet: hc = hb + f2*m2*iks, f2 = (lap.r1) @ W2 + b2, r1 = relu(fc1(lap.LN2(hb)))
    stack_prefetch<HID, 2 * HID, S, KS, TIER>(a.wfc2t + 2 * wsq, ring, tid);
    dropout_bwd(dh, ba, site_of<PRNG>(a.drop, 2, l, b0, smp), a.iks, nullptr,
                a.df2 + row * HID, nb, tid);
    __syncthreads();
    if constexpr (TIER == tf32::TIER_3XTF32) {
      // df1 = (lap^T . df2) @ W2^T where r1 > 0: the mix, then the product
      lap_mix_t(ba, bb, lap, tid);
      __syncthreads();
      stack_gemm<HID, 2 * HID, LDH, S, KS, TIER>(
          bb, a.wfc2t + 2 * wsq, ring,
          EpGate{big, a.r1 + row * 2 * HID, a.df1 + row * 2 * HID, nreal}, tid);
      __syncthreads();
      stack_prefetch<2 * HID, HID, S, KS, TIER>(a.wfc1t + 2 * wsq, ring, tid);
    } else {
      // df1 = lap^T . (df2 @ W2^T) where r1 > 0, the TPU kernel's order: the
      // product into big's last 2 HID columns, then its halves mixed into
      // the first 2 HID one after the other (the second half is written
      // where the first is read)
      stack_gemm<HID, 2 * HID, LDH, S, KS, TIER>(ba, a.wfc2t + 2 * wsq, ring,
                                                 EpSmem<LDB, false, false>{big + HID, nullptr},
                                                 tid);
      __syncthreads();
      stack_prefetch<2 * HID, HID, S, KS, TIER>(a.wfc1t + 2 * wsq, ring, tid);
      lap_mix_t_gate(big + HID, big, lap, a.r1 + row * 2 * HID, a.df1 + row * 2 * HID, nreal,
                     tid);
      __syncthreads();
      lap_mix_t_gate(big + 2 * HID, big + HID, lap, a.r1 + row * 2 * HID + HID,
                     a.df1 + row * 2 * HID + HID, nreal, tid);
      __syncthreads();
    }
    stack_gemm<2 * HID, HID, LDB, S, KS, TIER>(big, a.wfc1t + 2 * wsq, ring,
                                               EpSmem<LDH, false, false>{ba, nullptr}, tid);  // d g1
    __syncthreads();
    stack_prefetch<HID, 3 * HID, S, KS, TIER>(a.wqkv + 3 * wsq, ring, tid);
    lap_mix_t(ba, bb, lap, tid);                                                     // d y2
    __syncthreads();
    ln_bwd_add_warp(dh, bb, a.hb + row * HID, a.ln2s + l * HID, nreal, tid);         // dh = d hb
    __syncthreads();

    // attention: hb = ha + o1*m1*iks, o1 = att @ Wo + bo; probabilities recomputed from y1
    dropout_bwd(dh, ba, site_of<PRNG>(a.drop, 1, l, b0, smp), a.iks, nullptr,
                a.do1 + row * HID, nb, tid);
    load_rows<HID>(a.y1 + row * HID, bb, LDH, nb, tid);
    __syncthreads();
    stack_gemm<HID, 3 * HID, LDH, S, KS, TIER>(
        bb, a.wqkv + 3 * wsq, ring, EpSmem<LDB, true, false>{big, a.bqkv + l * 3 * HID}, tid);
    __syncthreads();
    stack_prefetch<HID, HID, S, KS, TIER>(a.waot + wsq, ring, tid);
    stack_gemm<HID, HID, LDH, S, KS, TIER>(ba, a.waot + wsq, ring,
                                           EpSmem<LDH, false, false>{bb, nullptr}, tid);     // d att
    __syncthreads();
    attention_bwd<PRNG, TIER>(big, bb, probs_of<PRNG>(a.drop, l, b0, smp), a.ikp, sp, ba, nb,
                              tid);
    __syncthreads();
    stack_prefetch<3 * HID, HID, S, KS, TIER>(a.wqkvt + 3 * wsq, ring, tid);
    store_rows<3 * HID>(big, LDB, a.dqkv + row * 3 * HID, nb, tid);
    stack_gemm<3 * HID, HID, LDB, S, KS, TIER>(big, a.wqkvt + 3 * wsq, ring,
                                               EpSmem<LDH, false, false>{ba, nullptr}, tid);  // d y1
    __syncthreads();
    ln_bwd_add_warp(dh, ba, a.ha + row * HID, a.ln1s + l * HID, nreal, tid);         // dh = d ha
    __syncthreads();
  }
  store_rows<HID>(dh, LDH, a.da0 + static_cast<size_t>(b0) * N_PTS * HID, nb, tid);
}

}  // namespace traink
