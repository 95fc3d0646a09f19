// Whole-network eval forward of GCNDiff / GCNPose: in-Cheb -> L x (attention
// layer + residual Chebyshev block) -> out-Cheb, one launch per forward; and,
// with HAS_IO false, the bare L-layer stack [B, 17, HID] -> [B, 17, HID] of
// the implicit model's fixed-point function (no in/out ChebConv).
//
// Counterpart of diffpose_tpu/ops/pallas_denoiser.py:_net_kernel (its
// has_io=False build is make_pallas_backbone_fn).  One CTA of NET_THREADS
// threads owns a tile of TB = 4 samples (tile.cuh: 68 joint rows,
// sample-major, padded to 72) and keeps their activations in shared memory
// for every layer:
//
//   h    [ROWS, HID]     residual stream
//   y    [ROWS, HID]     LayerNorm output / attention output / fc2 product
//   big  [ROWS, 3*HID]   QKV, or [lap-mixed LN2 | fc1 output], or the three
//                        Chebyshev products X.W_k side by side
//   ring                 the weight slabs of the current channel product
//
// Bound on the H100: the channel products (QKV, out-projection, fc1, fc2 and
// the two residual ChebConvs' X.[W_0|W_1|W_2]: 94% of the operations).  The
// design for it, as the train forward's (train_kernel.cuh) without its
// dropout and stashes:
//   - every channel product runs on the tensor cores through tc_gemm
//     (tc_gemm.cuh): mma.sync m16n8k8 at 3xTF32, f32 accumulation, a fresh
//     partial sum each k-step added in f32 with round-to-nearest (the
//     tensor cores' own accumulation truncates, and the bare stack feeds the
//     implicit family's fixed-point solve, which compounds a bias);
//   - the weights are fixed for an evaluation, so prepare_weights splits
//     them into their TF32 parts once (ops/tf32.py:split_tf32; 5.3 MB at
//     hid 96 / 5 layers, L2 holds them for all CTAs) and no CTA splits any;
//     the parts arrive in K-slabs of NET_KS rows through an NET_STAGES-stage
//     cp.async ring; each product's first slabs are requested as soon as the
//     ring is free, before the stages that precede the product (the next
//     layer's QKV slabs during the last mix of this one);
//   - the LayerNorms take one warp a row;
//   - 12 warps (NET_THREADS = 384; the stages take their thread count as a
//     template argument NT): the SM's four schedulers take three warps
//     each, where 9 warps would give one scheduler a third of the work, and
//     168 registers a thread remain;
//   - bias, ReLU and residual add of a product run in its fragment
//     epilogue; the graph mixes carry the bias, ReLU, timestep projection
//     and residual that follow them.
// The graph mixes, the 17-joint attention (a thread per (sample, head,
// query)) and the input and output ChebConvs (K = 5 or 2 in, 3 * C_OUT out)
// stay on CUDA cores in f32, one work item a thread between barriers.
//
// SKIP (a template argument of stack_layer and net_forward_kernel, 0 in
// production) leaves parts out for the cost-split probe
// (csrc/probe_kernel.cu, counterpart of scripts/probe_ablate.py): every
// `if constexpr` on it is true at 0, so SKIP = 0 compiles today's code.
//
// TIER (mma_tf32.cuh; TIER_3XTF32 in net_kernel.cu, the one-pass tiers in
// net_kernel_tiers.cu) is the --kernel_precision of the TPU kernel
// (pallas_denoiser.py:_dot and act): the products through tc_gemm at that
// tier on weights rounded on the host; under TIER_BF16 also the activations
// rounded to bf16 where _gra_layer_eval and _net_kernel cast to act (QKV,
// the residual stream after each sublayer, the input ChebConv's output),
// each attention score a sum of bf16-rounded products q_d k_d (the segment
// product of bf16 operands) and each probability rounded to bf16.  The
// LayerNorm statistics, the softmax, the graph mixes and every sum stay f32.
// The one-pass tiers mix lap . r before the fc2 product, as the TPU kernel
// does, so that its operand is rounded where the TPU kernel rounds it (the
// parity grade computes lap . (r W_fc2), a narrower mix).
#pragma once

#include "tc_gemm.cuh"
#include "tile.cuh"

namespace netk {

constexpr int MAX_TERMS = 3 * N_PTS * N_PTS;           // Chebyshev order 2
constexpr int TERMS_PAD = (MAX_TERMS + 3) / 4 * 4;
constexpr int LAP_PAD = (N_PTS * N_PTS + 3) / 4 * 4;
constexpr int ACT_FLOATS = 2 * ROWS_PAD * LDH + ROWS_PAD * LDB;
constexpr int NET_THREADS = 384;                       // 12 warps; row 9's layer runs at THREADS
constexpr int NET_KS = 48, NET_STAGES = 2;             // rows of W a slab, slabs in the ring
constexpr int NET_RING = ring_floats<NET_STAGES, NET_KS>();
constexpr int SMEM_FLOATS = ACT_FLOATS + NET_RING + LAP_PAD + 2 * TERMS_PAD + 20;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;
static_assert(SMEM_BYTES <= 232448, "the tile exceeds an SM's shared memory");
static_assert(ACT_FLOATS % 4 == 0, "the ring must be 16-byte aligned");

// Parts the probe leaves out (bits of SKIP), as scripts/probe_ablate.py names them.
enum Skip : int {
  kSkipAttn = 1,      // no_attn: the attention sublayer
  kSkipGnetCheb = 2,  // attn_only: the GraphNet sublayer and the residual Chebyshev block
  kSkipLap = 4,       // no_lap: GraphNet's two learned-Laplacian mixes
  kSkipChebMix = 8,   // no_chebmix: every ChebConv is its order-0 product plus the bias
  kSkipLn = 16,       // no_ln: both LayerNorms are the identity
};

struct NetArgs {
  const float* x;      // [B, 17, C_IN]
  const float* tp;     // [L, B, HID] timestep projections (denoiser only)
  float* out;          // [B, 17, C_OUT]
  const float* win;    // [C_IN, 3*HID]: W_0 | W_1 | W_2 of the input ChebConv
  const float* bin;    // [HID]
  const float* ln1s; const float* ln1b; const float* ln2s; const float* ln2b;  // [L, HID]
  // The channel products' weights W [K, N] as TF32 parts, [L, 2, K, N]:
  // layer l's big parts, then its small parts.
  const float* wqkv;   // [L, 2, HID, 3*HID], q columns pre-scaled by 1/sqrt(DK)
  const float* bqkv;   // [L, 3*HID], q part pre-scaled
  const float* wao; const float* bao;    // [L, 2, HID, HID], [L, HID]
  const float* lap;    // [L, 17, 17] normalized learned adjacency
  const float* wfc1; const float* bfc1;  // [L, 2, HID, 2*HID], [L, 2*HID]
  const float* wfc2; const float* bfc2;  // [L, 2, 2*HID, HID], [L, HID]
  const float* wg1; const float* bg1;    // [L, 2, HID, 3*HID] (W_0 | W_1 | W_2), [L, HID]
  const float* wg2; const float* bg2;
  const float* wout;   // [HID, 3*C_OUT]
  const float* bout;   // [C_OUT]
  const int* cheb_ptr;    // [18] row starts of the Chebyshev term list
  const int* cheb_idx;    // [nnz] (k << 8) | m
  const float* cheb_val;  // [nnz] T_k[n, m]
  int cheb_nnz;
  int batch;
  int num_layers;
};

// The CTA's shared memory: the activations, the weight ring, the layer's
// learned adjacency and the Chebyshev term list.
struct Tile {
  float* h;
  float* y;
  float* big;
  float* ring;
  float* lap;
  float* cval;
  int* cidx;
  int* cptr;
};

__device__ __forceinline__ Tile carve(float* smem) {
  Tile s;
  s.h = smem;
  s.y = s.h + ROWS_PAD * LDH;
  s.big = s.y + ROWS_PAD * LDH;
  s.ring = s.big + ROWS_PAD * LDB;
  s.lap = s.ring + NET_RING;
  s.cval = s.lap + LAP_PAD;
  s.cidx = reinterpret_cast<int*>(s.cval + TERMS_PAD);
  s.cptr = s.cidx + TERMS_PAD;
  return s;
}

// The input ChebConv's products C[r, :N] = A[r, :K] @ W[K, :N] for the
// tile's rows on CUDA cores (K = C_IN is 5 or 2); W's rows are LDW apart.
// Thread = (row, column group of 4).
template <int K, int N, int LDA, int LDC, int LDW, int NT>
__device__ __forceinline__ void in_gemm(const float* A, const float* __restrict__ W, float* C,
                                        int tid) {
  constexpr int NG = N / 4;
  static_assert(N % 4 == 0, "the product's width must be a multiple of 4");
  for (int it = tid; it < ROWS * NG; it += NT) {
    const int r = it / NG, c = 4 * (it % NG);
    float4 acc = zero4();
#pragma unroll
    for (int k = 0; k < K; ++k) fma4(acc, A[r * LDA + k], ldg4(W + k * LDW + c));
    st4(C + r * LDC + c, acc);
  }
}

enum MixEpi { kMixStore, kMixStoreBias, kMixReluBiasTp, kMixAddReluBias, kMixAddBias };

// Graph mixing over the joints of each sample:
//   out[b, n, :W] (=, +=) epilogue(sum_e val_e * in[b, m_e, k_e*W : k_e*W + W])
// over the Chebyshev term list of row n (sparse, all orders k), or over the
// dense learned adjacency lap[n, m] (DENSE, k = 0); ORDER0 (probe only) takes
// in[b, n, :W] alone, no mixing.
// RND: the stored value rounded to bf16.
template <int W, int LDI, int LDO, MixEpi EPI, bool DENSE, bool ORDER0 = false, int NT = THREADS,
          bool RND = false>
__device__ __forceinline__ void mix(const float* in, float* out, const int* ptr, const int* idx,
                                    const float* val, const float* lap,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ tp, int nb, int tid) {
  constexpr int NG = W / 4;
  static_assert(W % 4 == 0, "mix width must be a multiple of 4");
  for (int it = tid; it < ROWS * NG; it += NT) {
    const int r = it / NG;
    const int c = 4 * (it % NG);
    const int b = r / N_PTS;
    const int n = r % N_PTS;
    const float* src = in + b * N_PTS * LDI + c;
    float4 v = zero4();
    if constexpr (DENSE) {
#pragma unroll
      for (int m = 0; m < N_PTS; ++m) fma4(v, lap[n * N_PTS + m], ld4(src + m * LDI));
    } else if constexpr (ORDER0) {
      v = ld4(src + n * LDI);
    } else {
      for (int e = ptr[n]; e < ptr[n + 1]; ++e) {
        const int km = idx[e];
        fma4(v, val[e], ld4(src + (km & 0xff) * LDI + (km >> 8) * W));
      }
    }
    if constexpr (EPI != kMixStore) v = add4(v, ldg4(bias + c));
    if constexpr (EPI == kMixReluBiasTp || EPI == kMixAddReluBias) v = relu4(v);
    if constexpr (EPI == kMixReluBiasTp) {
      if (tp != nullptr && b < nb) v = add4(v, ldg4(tp + b * HID + c));
    }
    float* dst = out + r * LDO + c;
    if constexpr (EPI == kMixAddReluBias || EPI == kMixAddBias) v = add4(ld4(dst), v);
    if constexpr (RND)
      v = make_float4(tf32::round_bf16(v.x), tf32::round_bf16(v.y), tf32::round_bf16(v.z),
                      tf32::round_bf16(v.w));
    st4(dst, v);
  }
}

// Multi-head attention over the 17 joints of each sample; q is pre-scaled.
// Thread = (sample, head, query joint): 17 scores, softmax with the max
// subtracted, then the probability-weighted sum of the value rows.  TIER_BF16:
// each score the f32 sum of the products q_d k_d rounded to bf16, each
// probability rounded to bf16 (pallas_denoiser.py:_seg_attention on bf16).
template <int NT, int TIER = tf32::TIER_3XTF32>
__device__ __forceinline__ void attention(const float* qkv, float* out, int tid) {
  constexpr bool RND = TIER == tf32::TIER_BF16;
  for (int it = tid; it < TB * HEADS * N_PTS; it += NT) {
    const int n = it % N_PTS;
    const int hd = (it / N_PTS) % HEADS;
    const int b = it / (N_PTS * HEADS);
    const float* base = qkv + b * N_PTS * LDB + hd * DK;
    float4 q[DK / 4];
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) q[d] = ld4(base + n * LDB + 4 * d);
    float s[N_PTS];
#pragma unroll
    for (int m = 0; m < N_PTS; ++m) {
      const float* kr = base + m * LDB + HID;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) {
        const float4 kv = ld4(kr + 4 * d);
        if constexpr (RND) {
          acc += tf32::round_bf16(__fmul_rn(q[d].x, kv.x));
          acc += tf32::round_bf16(__fmul_rn(q[d].y, kv.y));
          acc += tf32::round_bf16(__fmul_rn(q[d].z, kv.z));
          acc += tf32::round_bf16(__fmul_rn(q[d].w, kv.w));
        } else {
          acc = fmaf(q[d].x, kv.x, acc);
          acc = fmaf(q[d].y, kv.y, acc);
          acc = fmaf(q[d].z, kv.z, acc);
          acc = fmaf(q[d].w, kv.w, acc);
        }
      }
      s[m] = acc;
    }
    float mx = s[0];
#pragma unroll
    for (int m = 1; m < N_PTS; ++m) mx = fmaxf(mx, s[m]);
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < N_PTS; ++m) {
      s[m] = expf(s[m] - mx);
      sum += s[m];
    }
    float4 o[DK / 4];
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) o[d] = zero4();
#pragma unroll
    for (int m = 0; m < N_PTS; ++m) {
      const float p = RND ? tf32::round_bf16(s[m] / sum) : s[m] / sum;
      const float* vr = base + m * LDB + 2 * HID;
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) fma4(o[d], p, ld4(vr + 4 * d));
    }
    float* dst = out + (b * N_PTS + n) * LDH + hd * DK;
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) st4(dst + 4 * d, o[d]);
  }
}

// The three output-ChebConv products h @ [W_0 | W_1 | W_2], C_OUT wide each
// (ORDER0, probe only: h @ W_0 alone).
template <int C_OUT, bool ORDER0, int NT>
__device__ __forceinline__ void out_gemm(const float* h, const float* __restrict__ w,
                                         float* big, int tid) {
  constexpr int LDW = 3 * C_OUT;
  constexpr int N = ORDER0 ? C_OUT : LDW;
  for (int it = tid; it < ROWS * N; it += NT) {
    const int r = it / N;
    const int j = it % N;
    const float* a = h + r * LDH;
    float acc = 0.f;
    for (int k = 0; k < HID; ++k) acc = fmaf(a[k], __ldg(w + k * LDW + j), acc);
    big[r * LDB + j] = acc;
  }
}

// Output ChebConv mixing + bias, written straight to global memory for the
// tile's nb real samples (ORDER0, probe only: the order-0 product, no mixing).
template <int C_OUT, bool ORDER0, int NT>
__device__ __forceinline__ void out_mix(const float* big, float* __restrict__ out, const int* ptr,
                                        const int* idx, const float* val,
                                        const float* __restrict__ bias, int nb, int tid) {
  for (int it = tid; it < nb * N_PTS * C_OUT; it += NT) {
    const int r = it / C_OUT;
    const int c = it % C_OUT;
    const int b = r / N_PTS;
    const int n = r % N_PTS;
    const float* src = big + b * N_PTS * LDB + c;
    float acc = 0.f;
    if constexpr (ORDER0) {
      acc = src[n * LDB];
    } else {
      for (int e = ptr[n]; e < ptr[n + 1]; ++e) {
        const int km = idx[e];
        acc = fmaf(val[e], src[(km & 0xff) * LDB + (km >> 8) * C_OUT], acc);
      }
    }
    out[it] = acc + __ldg(bias + c);
  }
}

// The Chebyshev term list into shared memory (once per CTA).
template <int NT = THREADS>
__device__ __forceinline__ void load_cheb(const NetArgs& a, const Tile& s, int tid) {
  for (int i = tid; i < a.cheb_nnz; i += NT) {
    s.cval[i] = a.cheb_val[i];
    s.cidx[i] = a.cheb_idx[i];
  }
  for (int i = tid; i <= N_PTS; i += NT) s.cptr[i] = a.cheb_ptr[i];
}

// The first slabs of layer l's first channel product (QKV, or fc1 where the
// probe leaves the attention out) into the ring, which must be free.  Every
// stack_layer call follows one.
template <int SKIP = 0, int NT = THREADS, int TIER = tf32::TIER_3XTF32>
__device__ __forceinline__ void prefetch_layer(const NetArgs& a, int l, float* ring, int tid) {
  constexpr int WP = WEIGHT_PARTS<TIER>;
  if constexpr (!(SKIP & kSkipAttn))
    tc_prefetch<HID, 3 * HID, NET_STAGES, NET_KS, 3 * HID, true, NT, TIER>(
        a.wqkv + static_cast<size_t>(l) * WP * HID * 3 * HID, ring, tid);
  else
    tc_prefetch<HID, 2 * HID, NET_STAGES, NET_KS, 2 * HID, true, NT, TIER>(
        a.wfc1 + static_cast<size_t>(l) * WP * HID * 2 * HID, ring, tid);
}

// Layer l of the stack on the tile's residual stream h (samples b0 ..
// b0 + nb - 1), with y, big, the ring and lap as scratch, by NT threads.
// Starts after a __syncthreads() and prefetch_layer<SKIP, NT, TIER>(a, l, ...);
// requests layer l + 1's first slabs where l + 1 < a.num_layers; ends on a
// __syncthreads().  TIER as the file's text says (the weights' parts: WP).
// NEXT false: a one-layer caller (row 9's spatial phase) that never requests
// a next layer, whose addresses would otherwise stay live through the layer.
template <bool HAS_TEMB, int SKIP, int NT, int TIER = tf32::TIER_3XTF32, bool NEXT = true>
__device__ __forceinline__ void stack_layer(const NetArgs& a, int l, const Tile& s, int b0,
                                            int nb, int tid) {
  constexpr bool ATTN = !(SKIP & kSkipAttn), REST = !(SKIP & kSkipGnetCheb);
  constexpr bool LAP = !(SKIP & kSkipLap), MIX = !(SKIP & kSkipChebMix), LN = !(SKIP & kSkipLn);
  constexpr int NCHEB = MIX ? 3 * HID : HID;  // columns of a residual ChebConv's products
  constexpr int S = NET_STAGES, KS = NET_KS, NW = NT / 32, WP = WEIGHT_PARTS<TIER>;
  constexpr bool RND = TIER == tf32::TIER_BF16;   // activations stored as bf16
  float* const h = s.h;
  float* const y = s.y;
  float* const big = s.big;
  float* const ring = s.ring;
  const float* normed = LN ? y : h;           // the LayerNorms' output
  const size_t wsq = static_cast<size_t>(l) * WP * HID * HID;  // layer l of [L, WP, HID, HID]
  using EpFc1 = EpSmem<LDB, true, false, true>;               // relu(acc + b) into big + HID

  // attention sublayer: h += out_proj(attention(LN1(h)))
  if constexpr (ATTN && LN)
    layer_norm_warp<NW>(h, y, a.ln1s + l * HID, a.ln1b + l * HID, nullptr, 0, tid);
  for (int i = tid; i < N_PTS * N_PTS; i += NT) s.lap[i] = a.lap[l * N_PTS * N_PTS + i];
  __syncthreads();
  if constexpr (ATTN) {
    tc_gemm<HID, 3 * HID, LDH, S, KS, 3 * HID, true, NT, TIER>(normed, a.wqkv + 3 * wsq, ring,
                                      EpSmem<LDB, true, false, false, RND>{big, a.bqkv + l * 3 * HID},
                                      tid);
    __syncthreads();
    tc_prefetch<HID, HID, S, KS, HID, true, NT, TIER>(a.wao + wsq, ring, tid);
    attention<NT, TIER>(big, y, tid);
    __syncthreads();
    tc_gemm<HID, HID, LDH, S, KS, HID, true, NT, TIER>(y, a.wao + wsq, ring,
                                  EpSmem<LDH, true, true, false, RND>{h, a.bao + l * HID}, tid);
    __syncthreads();
    if constexpr (!REST) {
      if (NEXT && l + 1 < a.num_layers) prefetch_layer<SKIP, NT, TIER>(a, l + 1, ring, tid);
      return;
    }
    tc_prefetch<HID, 2 * HID, S, KS, 2 * HID, true, NT, TIER>(a.wfc1 + 2 * wsq, ring, tid);
  }

  // GraphNet sublayer: h += fc2(lap . relu(fc1(lap . LN2(h)))), computed
  // as lap . (relu(...) @ W_fc2) + b_fc2 so that the second mix is HID wide.
  if constexpr (LN) {
    layer_norm_warp<NW>(h, y, a.ln2s + l * HID, a.ln2b + l * HID, nullptr, 0, tid);
    __syncthreads();
  }
  if constexpr (LAP) {
    mix<HID, LDH, LDB, kMixStore, true, false, NT>(normed, big, s.cptr, s.cidx, s.cval, s.lap,
                                                   nullptr, nullptr, nb, tid);
    __syncthreads();
    tc_gemm<HID, 2 * HID, LDB, S, KS, 2 * HID, true, NT, TIER>(big, a.wfc1 + 2 * wsq, ring,
                                      EpFc1{big + HID, a.bfc1 + l * 2 * HID},
                                      tid);
    __syncthreads();
    if constexpr (TIER == tf32::TIER_3XTF32) {
      tc_prefetch<2 * HID, HID, S, KS, HID, true, NT, TIER>(a.wfc2 + 2 * wsq, ring, tid);
      tc_gemm<2 * HID, HID, LDB, S, KS, HID, true, NT, TIER>(big + HID, a.wfc2 + 2 * wsq, ring,
                                        EpSmem<LDH, false, false>{y, nullptr}, tid);
      __syncthreads();
      tc_prefetch<HID, NCHEB, S, KS, 3 * HID, true, NT, TIER>(a.wg1 + 3 * wsq, ring, tid);
      mix<HID, LDH, LDH, kMixAddBias, true, false, NT>(y, h, s.cptr, s.cidx, s.cval, s.lap,
                                                       a.bfc2 + l * HID, nullptr, nb, tid);
    } else {
      // One pass: lap . relu(fc1) first, so that the fc2 product's operand is
      // rounded where the TPU kernel rounds it, its 192 columns in two halves
      // (y and big's first HID columns), the product as two of K = HID.
      // The halves' prefetches take the thread index made opaque, so that
      // their addresses are formed here and not held live from the layer's
      // first prefetch (at 288 threads that spilled a register).
      const float* w2 = a.wfc2 + 2 * wsq;
      int tid2 = tid;
      asm volatile("" : "+r"(tid2));
      tc_prefetch<HID, HID, S, KS, HID, true, NT, TIER>(w2, ring, tid2);
      mix<HID, LDB, LDH, kMixStore, true, false, NT>(big + HID, y, s.cptr, s.cidx, s.cval, s.lap,
                                                     nullptr, nullptr, nb, tid);
      mix<HID, LDB, LDB, kMixStore, true, false, NT>(big + 2 * HID, big, s.cptr, s.cidx, s.cval,
                                                     s.lap, nullptr, nullptr, nb, tid);
      __syncthreads();
      tc_gemm<HID, HID, LDH, S, KS, HID, true, NT, TIER>(y, w2, ring,
                                                         EpSmem<LDH, false, true>{h, nullptr}, tid);
      __syncthreads();
      asm volatile("" : "+r"(tid2));
      tc_prefetch<HID, HID, S, KS, HID, true, NT, TIER>(w2 + HID * HID, ring, tid2);
      tc_gemm<HID, HID, LDB, S, KS, HID, true, NT, TIER>(
          big, w2 + HID * HID, ring, EpSmem<LDH, true, true, false, RND>{h, a.bfc2 + l * HID}, tid);
      __syncthreads();
      tc_prefetch<HID, NCHEB, S, KS, 3 * HID, true, NT, TIER>(a.wg1 + 3 * wsq, ring, tid);
    }
  } else {
    tc_gemm<HID, 2 * HID, LDH, S, KS, 2 * HID, true, NT, TIER>(normed, a.wfc1 + 2 * wsq, ring,
                                      EpFc1{big + HID, a.bfc1 + l * 2 * HID},
                                      tid);
    __syncthreads();
    tc_prefetch<2 * HID, HID, S, KS, HID, true, NT, TIER>(a.wfc2 + 2 * wsq, ring, tid);
    tc_gemm<2 * HID, HID, LDB, S, KS, HID, true, NT, TIER>(big + HID, a.wfc2 + 2 * wsq, ring,
                                      EpSmem<LDH, true, true, false, RND>{h, a.bfc2 + l * HID},
                                      tid);
    __syncthreads();
    tc_prefetch<HID, NCHEB, S, KS, 3 * HID, true, NT, TIER>(a.wg1 + 3 * wsq, ring, tid);
  }
  __syncthreads();

  // residual Chebyshev block: h += relu(cheb2(relu(cheb1(h)) + tp))
  tc_gemm<HID, NCHEB, LDH, S, KS, 3 * HID, true, NT, TIER>(h, a.wg1 + 3 * wsq, ring,
                                           EpSmem<LDB, false, false>{big, nullptr}, tid);
  __syncthreads();
  tc_prefetch<HID, NCHEB, S, KS, 3 * HID, true, NT, TIER>(a.wg2 + 3 * wsq, ring, tid);
  const float* tp = HAS_TEMB ? a.tp + (static_cast<size_t>(l) * a.batch + b0) * HID : nullptr;
  mix<HID, LDB, LDH, kMixReluBiasTp, false, !MIX, NT>(big, y, s.cptr, s.cidx, s.cval, s.lap,
                                                  a.bg1 + l * HID, tp, nb, tid);
  __syncthreads();
  tc_gemm<HID, NCHEB, LDH, S, KS, 3 * HID, true, NT, TIER>(y, a.wg2 + 3 * wsq, ring,
                                           EpSmem<LDB, false, false>{big, nullptr}, tid);
  __syncthreads();
  if (NEXT && l + 1 < a.num_layers) prefetch_layer<SKIP, NT, TIER>(a, l + 1, ring, tid);
  mix<HID, LDB, LDH, kMixAddReluBias, false, !MIX, NT, RND>(big, h, s.cptr, s.cidx, s.cval,
                                                            s.lap, a.bg2 + l * HID, nullptr, nb,
                                                            tid);
  __syncthreads();
}

// The tile's nb samples of the HID-wide input x [B, 17, HID] into h.
template <int NT = THREADS>
__device__ __forceinline__ void load_tile(const float* __restrict__ x, float* h, int nb, int tid) {
  for (int i = tid; i < nb * N_PTS * (HID / 4); i += NT) {
    const int r = i / (HID / 4);
    const int c = 4 * (i % (HID / 4));
    st4(h + r * LDH + c, ldg4(x + r * HID + c));
  }
}

// The tile's nb samples of h out to [B, 17, HID].
template <int NT = THREADS>
__device__ __forceinline__ void store_tile(const float* h, float* out, int nb, int tid) {
  for (int i = tid; i < nb * N_PTS * (HID / 4); i += NT) {
    const int r = i / (HID / 4);
    const int c = 4 * (i % (HID / 4));
    st4(out + r * HID + c, ld4(h + r * LDH + c));
  }
}

// HAS_IO false: x and out are [B, 17, HID] (C_IN = C_OUT = HID); x goes
// straight into the residual stream and the stream is stored after the last
// layer; win, bin, wout and bout are not read.  TIER: the file's text.
template <bool HAS_TEMB, bool HAS_IO, int C_IN, int C_OUT, int SKIP = 0,
          int TIER = tf32::TIER_3XTF32>
__global__ void __launch_bounds__(NET_THREADS, 1) net_forward_kernel(const NetArgs a) {
  constexpr int NT = NET_THREADS;
  static_assert(HAS_IO || (C_IN == HID && C_OUT == HID), "the bare stack is HID wide");
  constexpr bool MIX = !(SKIP & kSkipChebMix);
  extern __shared__ float4 smem4[];
  const Tile s = carve(reinterpret_cast<float*>(smem4));

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TB;
  const int nb = min(TB, a.batch - b0);  // the last tile may be ragged

  if (a.num_layers > 0) prefetch_layer<SKIP, NT, TIER>(a, 0, s.ring, tid);
  // Rows of absent samples hold zeros and stay finite; they are never stored.
  for (int i = tid; i < ACT_FLOATS; i += NT) s.h[i] = 0.f;
  load_cheb<NT>(a, s, tid);
  __syncthreads();
  const float* x = a.x + static_cast<size_t>(b0) * N_PTS * C_IN;
  if constexpr (HAS_IO) {
    for (int i = tid; i < nb * N_PTS * C_IN; i += NT) s.y[(i / C_IN) * LDH + i % C_IN] = x[i];
    __syncthreads();
    in_gemm<C_IN, MIX ? 3 * HID : HID, LDH, LDB, 3 * HID, NT>(s.y, a.win, s.big, tid);
    __syncthreads();
    mix<HID, LDB, LDH, kMixStoreBias, false, !MIX, NT, TIER == tf32::TIER_BF16>(
        s.big, s.h, s.cptr, s.cidx, s.cval, s.lap, a.bin, nullptr, nb, tid);
  } else {
    load_tile<NT>(x, s.h, nb, tid);
  }
  __syncthreads();

  for (int l = 0; l < a.num_layers; ++l)
    stack_layer<HAS_TEMB, SKIP, NT, TIER>(a, l, s, b0, nb, tid);

  float* out = a.out + static_cast<size_t>(b0) * N_PTS * C_OUT;
  if constexpr (HAS_IO) {
    out_gemm<C_OUT, !MIX, NT>(s.h, a.wout, s.big, tid);
    __syncthreads();
    out_mix<C_OUT, !MIX, NT>(s.big, out, s.cptr, s.cidx, s.cval, a.bout, nb, tid);
  } else {
    store_tile<NT>(s.h, out, nb, tid);
  }
}

}  // namespace netk
