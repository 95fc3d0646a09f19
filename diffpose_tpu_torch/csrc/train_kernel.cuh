// Training forward and backward of the GCNDiff layer stack (L x attention
// layer + residual Chebyshev block, with dropout), one launch each.
//
// Counterparts of diffpose_tpu/ops/pallas_train.py:_stack_fwd_kernel and
// _stack_bwd_kernel (explicit dropout masks, PRNG = false) and of
// _stack_fwd_kernel_prng and _stack_bwd_kernel_prng (PRNG = true: every
// dropout decision is drawn in the kernel with Philox4x32-10 from the step
// seed and the element's place, keyed as philox.cuh sets out, so the
// backward regenerates the forward's masks and none exists in device
// memory; the forward can dump what it drew).  The tile, the thread block
// and the GEMM, mixing and LayerNorm stages are those of net_kernel.cuh:
// one CTA owns TB samples (ROWS joint rows, sample-major); the forward keeps
// the residual stream h in shared memory through all layers, the backward
// its gradient dh.  Everything in global memory is batch-major:
//
//   stashes / d-stashes  [L, B*17, width]   f32
//   site masks           [L, B*17, HID]     uint8 0/1
//   attention mask       [L, B, HEADS, 17 (query), 17 (key)]  uint8 0/1
//
// Rows of absent samples in a ragged last tile hold zeros in h / dh, are
// never loaded from or stored to global memory, and stay finite elsewhere.
//
// As in net_kernel.cuh, every stage is a loop over work items separated by
// __syncthreads(), with no warp intrinsics.
#pragma once

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
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
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
};

// The dropout of the attention probabilities over one tile in one layer.
// Drawn: row(b, hd, n) draws the query's row once, bit m set where the
// probability of key m is kept.  Explicit: keep() reads the mask's byte.
template <bool PRNG>
struct Probs {
  const unsigned char* m;   // explicit: the tile's first sample in [L, B, HEADS, 17, 17]
  unsigned char* dump;
  unsigned k0, k1, thresh, b0;
  static __device__ __forceinline__ int at(int b, int hd, int n) {
    return ((b * HEADS + hd) * N_PTS + n) * N_PTS;
  }
  __device__ __forceinline__ bool keep(unsigned bits, int pos, int k) const {
    if constexpr (PRNG) {
      return (bits >> k & 1u) != 0u;
    } else {
      return __ldg(m + pos + k) != 0;
    }
  }
  __device__ __forceinline__ unsigned row(int b, int hd, int n) const {
    unsigned bits = 0u;
    if constexpr (PRNG) {
      const int pos = at(b, hd, n);
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
// Forward stages
// ---------------------------------------------------------------------------

// netk::attention with dropout on the probabilities: p * mask * ikp.
template <bool PRNG>
__device__ __forceinline__ void attention_dropout(const float* qkv, float* out,
                                                  const Probs<PRNG> mp, float ikp,
                                                  int nb, int tid) {
  for (int it = tid; it < nb * HEADS * N_PTS; it += THREADS) {
    const int n = it % N_PTS;
    const int hd = (it / N_PTS) % HEADS;
    const int b = it / (N_PTS * HEADS);
    const float* base = qkv + b * N_PTS * LDB + hd * DK;
    const unsigned kept = mp.row(b, hd, n);
    const int mat = mp.at(b, hd, n);
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
      const float p = mp.keep(kept, mat, m) ? s[m] / sum * ikp : 0.f;
      const float* vr = base + m * LDB + 2 * HID;
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) fma4(o[d], p, ld4(vr + 4 * d));
    }
    float* dst = out + (b * N_PTS + n) * LDH + hd * DK;
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) st4(dst + 4 * d, o[d]);
  }
}

// h += src * mask * scale over the real rows; optionally stashes src (before
// the dropout) and the new h.
template <bool PRNG>
__device__ __forceinline__ void residual_dropout(float* h, const float* src, int lds,
                                                 const Site<PRNG> mask, float scale, float* __restrict__ stash_src,
                                                 float* __restrict__ stash_h, int nb, int tid) {
  constexpr int NG = HID / 4;
  for (int it = tid; it < nb * N_PTS * NG; it += THREADS) {
    const int r = it / NG;
    const int c = 4 * (it % NG);
    const float4 v = ld4(src + r * lds + c);
    if (stash_src != nullptr) st4(stash_src + r * HID + c, v);
    const float4 hv = add4(ld4(h + r * LDH + c), mul4(v, mask.factor(r, c, scale)));
    st4(h + r * LDH + c, hv);
    if (stash_h != nullptr) st4(stash_h + r * HID + c, hv);
  }
}

// y = rc1 on entry; stashes rc1, then y = rc1 * mask * scale + tp[b], stashed as u.
template <bool PRNG>
__device__ __forceinline__ void cheb_dropout_tp(float* y, const Site<PRNG> mask, float scale, const float* __restrict__ tp,
                                                float* __restrict__ rc1, float* __restrict__ u,
                                                int nb, int tid) {
  constexpr int NG = HID / 4;
  for (int it = tid; it < nb * N_PTS * NG; it += THREADS) {
    const int r = it / NG;
    const int c = 4 * (it % NG);
    const float4 v = ld4(y + r * LDH + c);
    st4(rc1 + r * HID + c, v);
    const float4 uv = add4(mul4(v, mask.factor(r, c, scale)),
                           ldg4(tp + (r / N_PTS) * HID + c));
    st4(y + r * LDH + c, uv);
    st4(u + r * HID + c, uv);
  }
}

template <bool PRNG>
__global__ void __launch_bounds__(THREADS, 1) train_forward_kernel(const FwdArgs a) {
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
  const int nb = min(TB, a.batch - b0);

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
    // first row of this tile in the [L, B*17, .] arrays, and its sample in [L, B, .]
    const size_t smp = static_cast<size_t>(l) * a.batch + b0;
    const size_t row = smp * N_PTS;

    // attention sublayer: h += dropout(out_proj(attention_dropout(LN1(h))))
    store_rows<HID>(h, LDH, a.ha + row * HID, nb, tid);
    layer_norm(h, y, a.ln1s + l * HID, a.ln1b + l * HID, tid);
    for (int i = tid; i < PAIRS; i += THREADS) lap[i] = a.lap[l * PAIRS + i];
    __syncthreads();
    store_rows<HID>(y, LDH, a.y1 + row * HID, nb, tid);
    gemm<HID, 3 * HID, LDH, LDB, kStoreBias>(y, a.wqkv + static_cast<size_t>(l) * HID * 3 * HID,
                                             a.bqkv + l * 3 * HID, big, tid);
    __syncthreads();
    attention_dropout(big, y, probs_of<PRNG>(a.drop, l, b0, smp), a.ikp, nb, tid);
    __syncthreads();
    store_rows<HID>(y, LDH, a.att + row * HID, nb, tid);
    gemm<HID, HID, LDH, LDB, kStoreBias>(y, a.wao + static_cast<size_t>(l) * HID * HID,
                                         a.bao + l * HID, big, tid);
    __syncthreads();
    residual_dropout(h, big, LDB, site_of<PRNG>(a.drop, 1, l, b0, smp), a.iks, nullptr,
                     a.hb + row * HID, nb, tid);
    __syncthreads();

    // GraphNet sublayer: h += dropout(lap . (relu(fc1(lap . LN2(h))) @ W_fc2) + b_fc2)
    layer_norm(h, y, a.ln2s + l * HID, a.ln2b + l * HID, tid);
    __syncthreads();
    mix<HID, LDH, LDB, kMixStore, true>(y, big, cptr, cidx, cval, lap, nullptr, nullptr, nb, tid);
    __syncthreads();
    gemm<HID, 2 * HID, LDB, LDB, kReluBias>(big, a.wfc1 + static_cast<size_t>(l) * HID * 2 * HID,
                                            a.bfc1 + l * 2 * HID, big + HID, tid);
    __syncthreads();
    store_rows<2 * HID>(big + HID, LDB, a.r1 + row * 2 * HID, nb, tid);
    gemm<2 * HID, HID, LDB, LDH, kStore>(big + HID, a.wfc2 + static_cast<size_t>(l) * 2 * HID * HID,
                                         nullptr, y, tid);
    __syncthreads();
    mix<HID, LDH, LDB, kMixStoreBias, true>(y, big, cptr, cidx, cval, lap, a.bfc2 + l * HID,
                                            nullptr, nb, tid);
    __syncthreads();
    residual_dropout(h, big, LDB, site_of<PRNG>(a.drop, 2, l, b0, smp), a.iks, nullptr,
                     a.hc + row * HID, nb, tid);
    __syncthreads();

    // residual Chebyshev block: h += dropout(relu(cheb2(dropout(relu(cheb1(h))) + tp)))
    gemm<HID, 3 * HID, LDH, LDB, kStore>(h, a.wg1 + static_cast<size_t>(l) * HID * 3 * HID,
                                         nullptr, big, tid);
    __syncthreads();
    mix<HID, LDB, LDH, kMixReluBiasTp, false>(big, y, cptr, cidx, cval, lap, a.bg1 + l * HID,
                                              nullptr, nb, tid);
    __syncthreads();
    cheb_dropout_tp(y, site_of<PRNG>(a.drop, 3, l, b0, smp), a.ikc, a.tp + smp * HID,
                    a.rc1 + row * HID, a.u + row * HID, nb, tid);
    __syncthreads();
    gemm<HID, 3 * HID, LDH, LDB, kStore>(y, a.wg2 + static_cast<size_t>(l) * HID * 3 * HID,
                                         nullptr, big, tid);
    __syncthreads();
    mix<HID, LDB, LDH, kMixReluBiasTp, false>(big, y, cptr, cidx, cval, lap, a.bg2 + l * HID,
                                              nullptr, nb, tid);
    __syncthreads();
    residual_dropout(h, y, LDH, site_of<PRNG>(a.drop, 4, l, b0, smp), a.ikc, a.rd1 + row * HID,
                     nullptr, nb, tid);
    __syncthreads();
  }
  store_rows<HID>(h, LDH, a.d5 + static_cast<size_t>(b0) * N_PTS * HID, nb, tid);
}

// ---------------------------------------------------------------------------
// Backward stages
// ---------------------------------------------------------------------------

constexpr int SP_FLOATS = TB * HEADS * 2 * PAIRS;       // ds and p*mask per (sample, head)
constexpr int BWD_ACT_FLOATS = 3 * ROWS_PAD * LDH + ROWS_PAD * LDB;
constexpr int BWD_SMEM_FLOATS =
    BWD_ACT_FLOATS + SP_FLOATS + LAP_PAD + 2 * TERMS_PAD + TPTR_PAD;
constexpr size_t BWD_SMEM_BYTES = sizeof(float) * BWD_SMEM_FLOATS;
static_assert(BWD_SMEM_BYTES <= 232448, "backward tile exceeds an SM's shared memory");

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
__device__ __forceinline__ void mix_t(const float* in, float* out, const int* tptr,
                                      const int* tidx, const float* tval, int tid) {
  constexpr int NG = HID / 4;
  for (int it = tid; it < ROWS * 3 * NG; it += THREADS) {
    const int c = 4 * (it % NG);
    const int k = (it / NG) % 3;
    const int r = it / (3 * NG);
    const int b = r / N_PTS;
    const int m = r % N_PTS;
    const float* src = in + b * N_PTS * LDH + c;
    float4 v = zero4();
    for (int e = tptr[k * N_PTS + m]; e < tptr[k * N_PTS + m + 1]; ++e)
      fma4(v, tval[e], ld4(src + tidx[e] * LDH));
    st4(out + r * LDB + k * HID + c, v);
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

// buf[r, :2*HID] gated by r1 > 0 (ReLU backward) -> df1, stashed.
__device__ __forceinline__ void relu_gate_wide(float* buf, const float* __restrict__ r1,
                                               float* __restrict__ df1, int nb, int tid) {
  constexpr int W = 2 * HID;
  constexpr int NG = W / 4;
  for (int it = tid; it < nb * N_PTS * NG; it += THREADS) {
    const int r = it / NG;
    const int c = 4 * (it % NG);
    const float4 v = gate4(ld4(buf + r * LDB + c), ldg4(r1 + r * W + c));
    st4(buf + r * LDB + c, v);
    st4(df1 + r * W + c, v);
  }
}

// dh += d/dx of the LayerNorm scale*(x-mean)/(std+1e-6)+shift (Bessel std,
// eps outside the root), given the output gradient g; x in shared memory.
__device__ __forceinline__ void ln_bwd_add(float* dh, const float* g, const float* xs,
                                           const float* __restrict__ scale, int nb, int tid) {
  for (int r = tid; r < nb * N_PTS; r += THREADS) {
    const float* x = xs + r * LDH;
    const float* gr = g + r * LDH;
    float sum = 0.f;
    for (int c = 0; c < HID; c += 4) {
      const float4 v = ld4(x + c);
      sum += v.x; sum += v.y; sum += v.z; sum += v.w;
    }
    const float mean = sum / HID;
    float ss = 0.f, s1 = 0.f, sg = 0.f, sc = 0.f;
    for (int c = 0; c < HID; c += 4) {
      const float4 v = ld4(x + c);
      const float4 gs = mul4(ld4(gr + c), ldg4(scale + c));
      const float4 d = make_float4(v.x - mean, v.y - mean, v.z - mean, v.w - mean);
      ss = fmaf(d.x, d.x, ss); ss = fmaf(d.y, d.y, ss); ss = fmaf(d.z, d.z, ss); ss = fmaf(d.w, d.w, ss);
      s1 = fmaf(gs.x, d.x, s1); s1 = fmaf(gs.y, d.y, s1); s1 = fmaf(gs.z, d.z, s1); s1 = fmaf(gs.w, d.w, s1);
      sg += gs.x; sg += gs.y; sg += gs.z; sg += gs.w;
      sc += d.x; sc += d.y; sc += d.z; sc += d.w;
    }
    const float sd = sqrtf(ss / (HID - 1));
    const float rinv = 1.f / (sd + 1e-6f);
    const float coef = s1 * rinv * rinv / ((HID - 1) * fmaxf(sd, 1e-20f));
    const float mdc = (sg * rinv - sc * coef) / HID;   // mean of dc over the row
    float* o = dh + r * LDH;
    for (int c = 0; c < HID; c += 4) {
      const float4 v = ld4(x + c);
      const float4 gs = mul4(ld4(gr + c), ldg4(scale + c));
      const float4 d = ld4(o + c);
      st4(o + c, make_float4(d.x + gs.x * rinv - (v.x - mean) * coef - mdc,
                             d.y + gs.y * rinv - (v.y - mean) * coef - mdc,
                             d.z + gs.z * rinv - (v.z - mean) * coef - mdc,
                             d.w + gs.w * rinv - (v.w - mean) * coef - mdc));
    }
  }
}

// Attention backward of one (sample, head) per 17 threads, thread = joint.
// qkv holds q | k | v (q pre-scaled) and is overwritten by dq | dk | dv;
// datt is the gradient of the attention output.  Phase 1, thread = query n:
// recompute the softmax row, ds[n, :] and the dropped probabilities into sp,
// dq[n] in registers.  Phase 2, thread = key m: dk[m] and dv[m] from the
// columns of sp.  Phase 3: all three overwrite this head's columns.  The
// dropout decisions of a query's row are fetched (or drawn) once, in phase 1;
// phase 2 meets them again in the dropped probabilities of sp.
template <bool PRNG>
__device__ __forceinline__ void attention_bwd(float* qkv, const float* datt,
                                              const Probs<PRNG> mp, float ikp,
                                              float* sp, int nb, int tid) {
  const int n = tid % N_PTS;
  const int hd = (tid / N_PTS) % HEADS;
  const int b = tid / (N_PTS * HEADS);
  const bool live = b < nb;              // also false for the threads past TB*HEADS*17
  const int bs = live ? b : 0;           // keeps the unused pointers in bounds
  float* base = qkv + bs * N_PTS * LDB + hd * DK;
  const float* dbase = datt + bs * N_PTS * LDH + hd * DK;
  float* ds_s = sp + (bs * HEADS + hd) * 2 * PAIRS;
  float* pd_s = ds_s + PAIRS;

  float4 dq[DK / 4], dk[DK / 4], dv[DK / 4];
  if (live) {
    const unsigned kept = mp.row(b, hd, n);
    const int mat = mp.at(b, hd, n);
    float4 q[DK / 4], da[DK / 4];
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) {
      q[d] = ld4(base + n * LDB + 4 * d);
      da[d] = ld4(dbase + n * LDH + 4 * d);
      dq[d] = zero4();
    }
    float s[N_PTS], dp[N_PTS];
#pragma unroll
    for (int m = 0; m < N_PTS; ++m) {
      const float* kr = base + m * LDB + HID;
      const float* vr = base + m * LDB + 2 * HID;
      float acc = 0.f, accv = 0.f;
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) {
        const float4 kv = ld4(kr + 4 * d);
        const float4 vv = ld4(vr + 4 * d);
        acc = fmaf(q[d].x, kv.x, acc); acc = fmaf(q[d].y, kv.y, acc);
        acc = fmaf(q[d].z, kv.z, acc); acc = fmaf(q[d].w, kv.w, acc);
        accv = fmaf(da[d].x, vv.x, accv); accv = fmaf(da[d].y, vv.y, accv);
        accv = fmaf(da[d].z, vv.z, accv); accv = fmaf(da[d].w, vv.w, accv);
      }
      s[m] = acc;
      dp[m] = accv;
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
    float rowdot = 0.f;
#pragma unroll
    for (int m = 0; m < N_PTS; ++m) {
      const float keep = mp.keep(kept, mat, m) ? ikp : 0.f;
      s[m] = s[m] / sum;
      dp[m] *= keep;
      pd_s[n * N_PTS + m] = s[m] * keep;
      rowdot = fmaf(s[m], dp[m], rowdot);
    }
#pragma unroll
    for (int m = 0; m < N_PTS; ++m) {
      const float dsv = s[m] * (dp[m] - rowdot);
      ds_s[n * N_PTS + m] = dsv;
      const float* kr = base + m * LDB + HID;
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) fma4(dq[d], dsv, ld4(kr + 4 * d));
    }
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) {
      dk[d] = zero4();
      dv[d] = zero4();
    }
#pragma unroll
    for (int q = 0; q < N_PTS; ++q) {
      const float dsv = ds_s[q * N_PTS + n];
      const float pdv = pd_s[q * N_PTS + n];
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) {
        fma4(dk[d], dsv, ld4(base + q * LDB + 4 * d));
        fma4(dv[d], pdv, ld4(dbase + q * LDH + 4 * d));
      }
    }
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) {
      st4(base + n * LDB + 4 * d, dq[d]);
      st4(base + n * LDB + HID + 4 * d, dk[d]);
      st4(base + n * LDB + 2 * HID + 4 * d, dv[d]);
    }
  }
}

template <bool PRNG>
__global__ void __launch_bounds__(THREADS, 1) train_backward_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* dh = reinterpret_cast<float*>(smem4);
  float* ba = dh + ROWS_PAD * LDH;
  float* bb = ba + ROWS_PAD * LDH;
  float* big = bb + ROWS_PAD * LDH;
  float* sp = big + ROWS_PAD * LDB;
  float* lap = sp + SP_FLOATS;
  float* tval = lap + LAP_PAD;
  int* tidx = reinterpret_cast<int*>(tval + TERMS_PAD);
  int* tptr = tidx + TERMS_PAD;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TB;
  const int nb = min(TB, a.batch - b0);

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
    dropout_bwd(dh, ba, site_of<PRNG>(a.drop, 4, l, b0, smp), a.ikc, a.rd1 + row * HID,
                a.dc2 + row * HID, nb, tid);
    for (int i = tid; i < PAIRS; i += THREADS) lap[i] = a.lap[l * PAIRS + i];
    __syncthreads();
    mix_t(ba, big, tptr, tidx, tval, tid);
    __syncthreads();
    gemm<3 * HID, HID, LDB, LDH, kStore>(big, a.wg2t + 3 * wsq, nullptr, ba, tid);   // du
    __syncthreads();
    joint_sum(ba, a.dtp + smp * HID, nb, tid);
    __syncthreads();
    dropout_bwd(ba, ba, site_of<PRNG>(a.drop, 3, l, b0, smp), a.ikc, a.rc1 + row * HID,
                a.dc1 + row * HID, nb, tid);
    __syncthreads();
    mix_t(ba, big, tptr, tidx, tval, tid);
    __syncthreads();
    gemm<3 * HID, HID, LDB, LDH, kAdd>(big, a.wg1t + 3 * wsq, nullptr, dh, tid);     // dh = d hc
    __syncthreads();

    // GraphNet: hc = hb + f2*m2*iks, f2 = lap.(r1 @ W2) + b2, r1 = relu(fc1(lap.LN2(hb)))
    dropout_bwd(dh, ba, site_of<PRNG>(a.drop, 2, l, b0, smp), a.iks, nullptr,
                a.df2 + row * HID, nb, tid);
    __syncthreads();
    lap_mix_t(ba, bb, lap, tid);
    __syncthreads();
    gemm<HID, 2 * HID, LDH, LDB, kStore>(bb, a.wfc2t + 2 * wsq, nullptr, big, tid);
    __syncthreads();
    relu_gate_wide(big, a.r1 + row * 2 * HID, a.df1 + row * 2 * HID, nb, tid);
    __syncthreads();
    gemm<2 * HID, HID, LDB, LDH, kStore>(big, a.wfc1t + 2 * wsq, nullptr, ba, tid);  // d g1
    __syncthreads();
    lap_mix_t(ba, bb, lap, tid);                                                     // d y2
    __syncthreads();
    load_rows<HID>(a.hb + row * HID, ba, LDH, nb, tid);
    __syncthreads();
    ln_bwd_add(dh, bb, ba, a.ln2s + l * HID, nb, tid);                               // dh = d hb
    __syncthreads();

    // attention: hb = ha + o1*m1*iks, o1 = att @ Wo + bo; probabilities recomputed from y1
    dropout_bwd(dh, ba, site_of<PRNG>(a.drop, 1, l, b0, smp), a.iks, nullptr,
                a.do1 + row * HID, nb, tid);
    __syncthreads();
    gemm<HID, HID, LDH, LDH, kStore>(ba, a.waot + wsq, nullptr, bb, tid);            // d att
    __syncthreads();
    load_rows<HID>(a.y1 + row * HID, ba, LDH, nb, tid);
    __syncthreads();
    gemm<HID, 3 * HID, LDH, LDB, kStoreBias>(ba, a.wqkv + 3 * wsq, a.bqkv + l * 3 * HID, big, tid);
    __syncthreads();
    attention_bwd(big, bb, probs_of<PRNG>(a.drop, l, b0, smp), a.ikp, sp, nb, tid);
    __syncthreads();
    store_rows<3 * HID>(big, LDB, a.dqkv + row * 3 * HID, nb, tid);
    gemm<3 * HID, HID, LDB, LDH, kStore>(big, a.wqkvt + 3 * wsq, nullptr, ba, tid);  // d y1
    load_rows<HID>(a.ha + row * HID, bb, LDH, nb, tid);
    __syncthreads();
    ln_bwd_add(dh, ba, bb, a.ln1s + l * HID, nb, tid);                               // dh = d ha
    __syncthreads();
  }
  store_rows<HID>(dh, LDH, a.da0 + static_cast<size_t>(b0) * N_PTS * HID, nb, tid);
}

}  // namespace traink
