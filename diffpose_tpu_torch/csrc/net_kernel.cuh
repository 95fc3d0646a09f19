// Whole-network eval forward of GCNDiff / GCNPose: in-Cheb -> L x (attention
// layer + residual Chebyshev block) -> out-Cheb, one launch per forward; and,
// with HAS_IO false, the bare L-layer stack [B, 17, HID] -> [B, 17, HID] of
// the implicit model's fixed-point function (no in/out ChebConv).
//
// Counterpart of diffpose_tpu/ops/pallas_denoiser.py:_net_kernel (its
// has_io=False build is make_pallas_backbone_fn).  One CTA
// owns a tile of TB samples (ROWS = TB * 17 joint rows, sample-major) and
// keeps its activations in shared memory for every layer:
//
//   h    [ROWS, HID]     residual stream
//   y    [ROWS, HID]     LayerNorm output / attention output / fc2 product
//   big  [ROWS, 3*HID]   QKV, or [lap-mixed LN2 | fc1 output], or the three
//                        Chebyshev products X.W_k side by side
//
// Weights (2.6 MB f32 at hid 96 / 5 layers) do not fit on-chip; every GEMM
// streams its weight from global memory, where L2 holds it for all CTAs.
// All arithmetic is f32 FMA on CUDA cores with f32 accumulation.
//
// Each stage is a loop over work items of the form
// `for (it = tid; it < n; it += THREADS)`, separated by __syncthreads(), so a
// stage never depends on another thread's result within itself.
//
// SKIP (a template argument of stack_layer and net_forward_kernel, 0 in
// production) leaves parts out for the cost-split probe
// (csrc/probe_kernel.cu, counterpart of scripts/probe_ablate.py): every
// `if constexpr` on it is true at 0, so SKIP = 0 compiles today's code.
#pragma once

namespace netk {

constexpr int N_PTS = 17;
constexpr int HID = 96;
constexpr int HEADS = 4;
constexpr int DK = HID / HEADS;
constexpr int TB = 4;                                  // samples per CTA
constexpr int THREADS = 3 * HID;                       // 288 = 9 warps
constexpr int ROWS = TB * N_PTS;                       // 68
// GEMM row groups are 4, 6 or 12 threads apart; padding the tile to a
// multiple of 12 rows keeps their (discarded) reads of the last rows in bounds.
constexpr int ROWS_PAD = (ROWS + 11) / 12 * 12;        // 72
constexpr int LDH = HID + 4;                           // row strides, in floats
constexpr int LDB = 3 * HID + 4;
constexpr int MAX_TERMS = 3 * N_PTS * N_PTS;           // Chebyshev order 2
constexpr int TERMS_PAD = (MAX_TERMS + 3) / 4 * 4;
constexpr int LAP_PAD = (N_PTS * N_PTS + 3) / 4 * 4;
constexpr int ACT_FLOATS = 2 * ROWS_PAD * LDH + ROWS_PAD * LDB;
constexpr int SMEM_FLOATS = ACT_FLOATS + LAP_PAD + 2 * TERMS_PAD + 20;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;

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
  const float* wqkv;   // [L, HID, 3*HID], q columns pre-scaled by 1/sqrt(DK)
  const float* bqkv;   // [L, 3*HID], q part pre-scaled
  const float* wao; const float* bao;    // [L, HID, HID], [L, HID]
  const float* lap;    // [L, 17, 17] normalized learned adjacency
  const float* wfc1; const float* bfc1;  // [L, HID, 2*HID], [L, 2*HID]
  const float* wfc2; const float* bfc2;  // [L, 2*HID, HID], [L, HID]
  const float* wg1; const float* bg1;    // [L, HID, 3*HID], [L, HID]
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

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ldg4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
}
__device__ __forceinline__ void fma4(float4& acc, float s, float4 v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

enum Epi { kStore, kStoreBias, kReluBias, kAddBias, kAdd };

// C[r, :N] (=, +=) A[r, :K] @ W[K, :N] (+ bias) for the tile's rows; W's rows
// are LDW apart.  Thread = (column group of 4, row group); row group g takes
// rows g, g+G, ... so that the THREADS threads cover the N/4 column groups
// exactly.
template <int K, int N, int LDA, int LDC, Epi EPI, int LDW = N>
__device__ __forceinline__ void gemm(const float* A, const float* __restrict__ W,
                                     const float* __restrict__ bias, float* C, int tid) {
  constexpr int NG = N / 4;
  static_assert(N % 4 == 0 && THREADS % NG == 0, "column groups must tile the block");
  constexpr int G = THREADS / NG;
  constexpr int RPT = (ROWS + G - 1) / G;
  static_assert(RPT * G <= ROWS_PAD, "row groups read past the padded tile");
  const int cg = tid % NG;
  const int rg = tid / NG;
  const float* wc = W + 4 * cg;
  float4 acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = zero4();
  if constexpr (K % 4 == 0) {
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      const float4 w0 = ldg4(wc + (k + 0) * LDW);
      const float4 w1 = ldg4(wc + (k + 1) * LDW);
      const float4 w2 = ldg4(wc + (k + 2) * LDW);
      const float4 w3 = ldg4(wc + (k + 3) * LDW);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 a = ld4(A + (rg + i * G) * LDA + k);
        fma4(acc[i], a.x, w0);
        fma4(acc[i], a.y, w1);
        fma4(acc[i], a.z, w2);
        fma4(acc[i], a.w, w3);
      }
    }
  } else {
    for (int k = 0; k < K; ++k) {
      const float4 w = ldg4(wc + k * LDW);
#pragma unroll
      for (int i = 0; i < RPT; ++i) fma4(acc[i], A[(rg + i * G) * LDA + k], w);
    }
  }
  float4 b = zero4();
  if constexpr (EPI != kStore && EPI != kAdd) b = ldg4(bias + 4 * cg);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + i * G;
    if (r >= ROWS) continue;
    float* c = C + r * LDC + 4 * cg;
    float4 v = add4(acc[i], b);
    if constexpr (EPI == kReluBias) v = relu4(v);
    if constexpr (EPI == kAddBias || EPI == kAdd) v = add4(ld4(c), v);
    st4(c, v);
  }
}

enum MixEpi { kMixStore, kMixStoreBias, kMixReluBiasTp, kMixAddReluBias, kMixAddBias };

// Graph mixing over the joints of each sample:
//   out[b, n, :W] (=, +=) epilogue(sum_e val_e * in[b, m_e, k_e*W : k_e*W + W])
// over the Chebyshev term list of row n (sparse, all orders k), or over the
// dense learned adjacency lap[n, m] (DENSE, k = 0); ORDER0 (probe only) takes
// in[b, n, :W] alone, no mixing.
template <int W, int LDI, int LDO, MixEpi EPI, bool DENSE, bool ORDER0 = false>
__device__ __forceinline__ void mix(const float* in, float* out, const int* ptr, const int* idx,
                                    const float* val, const float* lap,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ tp, int nb, int tid) {
  constexpr int NG = W / 4;
  static_assert(W % 4 == 0, "mix width must be a multiple of 4");
  for (int it = tid; it < ROWS * NG; it += THREADS) {
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
    st4(dst, v);
  }
}

// y = LayerNorm(x) per row: a * (x - mean) / (std + 1e-6) + b, Bessel std.
__device__ __forceinline__ void layer_norm(const float* in, float* out,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ shift, int tid) {
  for (int r = tid; r < ROWS; r += THREADS) {
    const float* x = in + r * LDH;
    float sum = 0.f;
    for (int c = 0; c < HID; c += 4) {
      const float4 v = ld4(x + c);
      sum += v.x; sum += v.y; sum += v.z; sum += v.w;
    }
    const float mean = sum / HID;
    float ss = 0.f;
    for (int c = 0; c < HID; c += 4) {
      const float4 v = ld4(x + c);
      const float dx = v.x - mean, dy = v.y - mean, dz = v.z - mean, dw = v.w - mean;
      ss = fmaf(dx, dx, ss); ss = fmaf(dy, dy, ss); ss = fmaf(dz, dz, ss); ss = fmaf(dw, dw, ss);
    }
    const float den = sqrtf(ss / (HID - 1)) + 1e-6f;
    float* o = out + r * LDH;
    for (int c = 0; c < HID; c += 4) {
      const float4 v = ld4(x + c);
      const float4 s = ldg4(scale + c);
      const float4 t = ldg4(shift + c);
      st4(o + c, make_float4(s.x * (v.x - mean) / den + t.x, s.y * (v.y - mean) / den + t.y,
                             s.z * (v.z - mean) / den + t.z, s.w * (v.w - mean) / den + t.w));
    }
  }
}

// Multi-head attention over the 17 joints of each sample; q is pre-scaled.
// Thread = (sample, head, query joint): 17 scores, softmax with the max
// subtracted, then the probability-weighted sum of the value rows.
__device__ __forceinline__ void attention(const float* qkv, float* out, int tid) {
  for (int it = tid; it < TB * HEADS * N_PTS; it += THREADS) {
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
        acc = fmaf(q[d].x, kv.x, acc);
        acc = fmaf(q[d].y, kv.y, acc);
        acc = fmaf(q[d].z, kv.z, acc);
        acc = fmaf(q[d].w, kv.w, acc);
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
      const float p = s[m] / sum;
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
template <int C_OUT, bool ORDER0 = false>
__device__ __forceinline__ void out_gemm(const float* h, const float* __restrict__ w,
                                         float* big, int tid) {
  constexpr int LDW = 3 * C_OUT;
  constexpr int N = ORDER0 ? C_OUT : LDW;
  for (int it = tid; it < ROWS * N; it += THREADS) {
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
template <int C_OUT, bool ORDER0 = false>
__device__ __forceinline__ void out_mix(const float* big, float* __restrict__ out, const int* ptr,
                                        const int* idx, const float* val,
                                        const float* __restrict__ bias, int nb, int tid) {
  for (int it = tid; it < nb * N_PTS * C_OUT; it += THREADS) {
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
__device__ __forceinline__ void load_cheb(const NetArgs& a, int* cptr, int* cidx, float* cval,
                                          int tid) {
  for (int i = tid; i < a.cheb_nnz; i += THREADS) {
    cval[i] = a.cheb_val[i];
    cidx[i] = a.cheb_idx[i];
  }
  for (int i = tid; i <= N_PTS; i += THREADS) cptr[i] = a.cheb_ptr[i];
}

// Layer l of the stack on the tile's residual stream h (samples b0 ..
// b0 + nb - 1), with y, big and lap as scratch.  Starts and ends on a
// __syncthreads().
template <bool HAS_TEMB, int SKIP = 0>
__device__ __forceinline__ void stack_layer(const NetArgs& a, int l, float* h, float* y,
                                            float* big, float* lap, const int* cptr,
                                            const int* cidx, const float* cval, int b0, int nb,
                                            int tid) {
  constexpr bool ATTN = !(SKIP & kSkipAttn), REST = !(SKIP & kSkipGnetCheb);
  constexpr bool LAP = !(SKIP & kSkipLap), MIX = !(SKIP & kSkipChebMix), LN = !(SKIP & kSkipLn);
  constexpr int NCHEB = MIX ? 3 * HID : HID;  // columns of a residual ChebConv's products
  const float* normed = LN ? y : h;           // the LayerNorms' output

  // attention sublayer: h += out_proj(attention(LN1(h)))
  if constexpr (ATTN && LN) layer_norm(h, y, a.ln1s + l * HID, a.ln1b + l * HID, tid);
  for (int i = tid; i < N_PTS * N_PTS; i += THREADS) lap[i] = a.lap[l * N_PTS * N_PTS + i];
  __syncthreads();
  if constexpr (ATTN) {
    gemm<HID, 3 * HID, LDH, LDB, kStoreBias>(normed,
                                             a.wqkv + static_cast<size_t>(l) * HID * 3 * HID,
                                             a.bqkv + l * 3 * HID, big, tid);
    __syncthreads();
    attention(big, y, tid);
    __syncthreads();
    gemm<HID, HID, LDH, LDH, kAddBias>(y, a.wao + static_cast<size_t>(l) * HID * HID,
                                       a.bao + l * HID, h, tid);
    __syncthreads();
  }
  if constexpr (!REST) return;

  // GraphNet sublayer: h += fc2(lap . relu(fc1(lap . LN2(h)))), computed
  // as lap . (relu(...) @ W_fc2) + b_fc2 so that the second mix is HID wide.
  if constexpr (LN) {
    layer_norm(h, y, a.ln2s + l * HID, a.ln2b + l * HID, tid);
    __syncthreads();
  }
  if constexpr (LAP) {
    mix<HID, LDH, LDB, kMixStore, true>(normed, big, cptr, cidx, cval, lap, nullptr, nullptr, nb,
                                        tid);
    __syncthreads();
    gemm<HID, 2 * HID, LDB, LDB, kReluBias>(big,
                                            a.wfc1 + static_cast<size_t>(l) * HID * 2 * HID,
                                            a.bfc1 + l * 2 * HID, big + HID, tid);
    __syncthreads();
    gemm<2 * HID, HID, LDB, LDH, kStore>(big + HID,
                                         a.wfc2 + static_cast<size_t>(l) * 2 * HID * HID,
                                         nullptr, y, tid);
    __syncthreads();
    mix<HID, LDH, LDH, kMixAddBias, true>(y, h, cptr, cidx, cval, lap, a.bfc2 + l * HID, nullptr,
                                          nb, tid);
  } else {
    gemm<HID, 2 * HID, LDH, LDB, kReluBias>(normed,
                                            a.wfc1 + static_cast<size_t>(l) * HID * 2 * HID,
                                            a.bfc1 + l * 2 * HID, big + HID, tid);
    __syncthreads();
    gemm<2 * HID, HID, LDB, LDH, kAddBias>(big + HID,
                                           a.wfc2 + static_cast<size_t>(l) * 2 * HID * HID,
                                           a.bfc2 + l * HID, h, tid);
  }
  __syncthreads();

  // residual Chebyshev block: h += relu(cheb2(relu(cheb1(h)) + tp))
  gemm<HID, NCHEB, LDH, LDB, kStore, 3 * HID>(h, a.wg1 + static_cast<size_t>(l) * HID * 3 * HID,
                                              nullptr, big, tid);
  __syncthreads();
  const float* tp = HAS_TEMB ? a.tp + (static_cast<size_t>(l) * a.batch + b0) * HID : nullptr;
  mix<HID, LDB, LDH, kMixReluBiasTp, false, !MIX>(big, y, cptr, cidx, cval, lap, a.bg1 + l * HID,
                                                  tp, nb, tid);
  __syncthreads();
  gemm<HID, NCHEB, LDH, LDB, kStore, 3 * HID>(y, a.wg2 + static_cast<size_t>(l) * HID * 3 * HID,
                                              nullptr, big, tid);
  __syncthreads();
  mix<HID, LDB, LDH, kMixAddReluBias, false, !MIX>(big, h, cptr, cidx, cval, lap,
                                                   a.bg2 + l * HID, nullptr, nb, tid);
  __syncthreads();
}

// The tile's nb samples of the HID-wide input x [B, 17, HID] into h.
__device__ __forceinline__ void load_tile(const float* __restrict__ x, float* h, int nb, int tid) {
  for (int i = tid; i < nb * N_PTS * (HID / 4); i += THREADS) {
    const int r = i / (HID / 4);
    const int c = 4 * (i % (HID / 4));
    st4(h + r * LDH + c, ldg4(x + r * HID + c));
  }
}

// The tile's nb samples of h out to [B, 17, HID].
__device__ __forceinline__ void store_tile(const float* h, float* out, int nb, int tid) {
  for (int i = tid; i < nb * N_PTS * (HID / 4); i += THREADS) {
    const int r = i / (HID / 4);
    const int c = 4 * (i % (HID / 4));
    st4(out + r * HID + c, ld4(h + r * LDH + c));
  }
}

// HAS_IO false: x and out are [B, 17, HID] (C_IN = C_OUT = HID); x goes
// straight into the residual stream and the stream is stored after the last
// layer; win, bin, wout and bout are not read.
template <bool HAS_TEMB, bool HAS_IO, int C_IN, int C_OUT, int SKIP = 0>
__global__ void __launch_bounds__(THREADS, 1) net_forward_kernel(const NetArgs a) {
  static_assert(HAS_IO || (C_IN == HID && C_OUT == HID), "the bare stack is HID wide");
  constexpr bool MIX = !(SKIP & kSkipChebMix);
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);
  float* y = h + ROWS_PAD * LDH;
  float* big = y + ROWS_PAD * LDH;
  float* lap = big + ROWS_PAD * LDB;
  float* cval = lap + LAP_PAD;
  int* cidx = reinterpret_cast<int*>(cval + TERMS_PAD);
  int* cptr = cidx + TERMS_PAD;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TB;
  const int nb = min(TB, a.batch - b0);  // the last tile may be ragged

  // Rows of absent samples hold zeros and stay finite; they are never stored.
  for (int i = tid; i < ACT_FLOATS; i += THREADS) h[i] = 0.f;
  load_cheb(a, cptr, cidx, cval, tid);
  __syncthreads();
  const float* x = a.x + static_cast<size_t>(b0) * N_PTS * C_IN;
  if constexpr (HAS_IO) {
    for (int i = tid; i < nb * N_PTS * C_IN; i += THREADS) y[(i / C_IN) * LDH + i % C_IN] = x[i];
    __syncthreads();
    gemm<C_IN, MIX ? 3 * HID : HID, LDH, LDB, kStore, 3 * HID>(y, a.win, nullptr, big, tid);
    __syncthreads();
    mix<HID, LDB, LDH, kMixStoreBias, false, !MIX>(big, h, cptr, cidx, cval, lap, a.bin, nullptr,
                                                   nb, tid);
  } else {
    load_tile(x, h, nb, tid);
  }
  __syncthreads();

  for (int l = 0; l < a.num_layers; ++l)
    stack_layer<HAS_TEMB, SKIP>(a, l, h, y, big, lap, cptr, cidx, cval, b0, nb, tid);

  float* out = a.out + static_cast<size_t>(b0) * N_PTS * C_OUT;
  if constexpr (HAS_IO) {
    out_gemm<C_OUT, !MIX>(h, a.wout, big, tid);
    __syncthreads();
    out_mix<C_OUT, !MIX>(big, out, cptr, cidx, cval, a.bout, nb, tid);
  } else {
    store_tile(h, out, nb, tid);
  }
}

}  // namespace netk
