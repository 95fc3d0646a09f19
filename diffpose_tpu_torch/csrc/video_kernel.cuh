// The video denoiser's layer kernels (hid 96, 4 heads, 17 joints):
//
// * temporal_kernel (row 10): one TemporalBlock on [N, F, HID] rows, N =
//   windows x joints: x += out_proj(MHA over the F frames(LN1(x))), then
//   x += ff2(relu(ff1(LN2(x)))).  Counterpart of
//   diffpose_tpu/ops/pallas_video_full.py:_temporal_only_kernel.
// * st_layer_kernel (row 9): one whole video layer, the spatial block of
//   every frame (the bare-stack layer of net_kernel.cuh) and then the
//   temporal block of every (window, joint).  Counterpart of
//   pallas_video_full.py:_st_kernel.
//
// Bound on the H100: operations, 8 HID^2 multiply-adds of channel products a
// frame vector and 2 F HID of attention products, all on the tensor cores.
// The design starts from one fact: every LayerNorm, product, bias, ReLU and
// residual of the block acts on one frame vector; only the attention needs a
// (window, joint) row.  So the block runs as three phases over work items
// that fill the card, with a grid-wide barrier between them (both kernels
// are cooperative launches of as many CTAs as can be co-resident):
//
//   T1  tiles of 68 frame vectors (tile.cuh's tile, padded to 72) of the
//       flat [N F, HID] input: LN1 a warp a row, then Q|K|V = LN1(x) W_qkv +
//       b into a global scratch [N F, 3 HID] (L2-resident).  In row 9, T1
//       follows the spatial layer on the same 4-frame tile while it is still
//       in shared memory; the spatial output is stored once, as the
//       residual.
//   T2  attention, one warp a task of 16 queries of one (row, head): the
//       warp's Q fragments in registers, the row's K and V streamed through
//       the warp's own shared-memory buffers in chunks of KEYS keys by
//       cp.async (two buffers, the next chunk in flight), S = Q K^T and
//       O = P V on mma.sync m16n8k8 at 3xTF32 with per-k-step partials, an
//       online softmax over the chunks in f32 (keys past F masked, their
//       V rows zero), O divided by the row sum at the end.  P goes from the
//       accumulator layout to the A-operand layout without a shuffle: an
//       A column t (t + 4) of a key tile is its key 2t (2t + 1), and V's
//       B-fragment rows follow the same order.  Output to a scratch
//       [N F, HID].  The warps take the tasks grid-wide; no barrier.
//   T3  tiles of 68 frame vectors: x += O W_ao + b, LN2, relu(ff1), x += ff2,
//       stored to out.
//
// Every channel product runs through tc_gemm (tc_gemm.cuh: 3xTF32 mma.sync,
// per-k-step partials, weights split into TF32 parts once on the host and
// streamed through a cp.async ring).  Frame f of row n is the flat vector
// (n / J) F J + f J + n % J: J = 1 for row 10's [N, F, HID], J = 17 for row
// 9's [B, F, 17, HID].  Scratch written inside the launch is read through
// L2 only (cp.async.cg, __ldcg), never through __ldg.
//
// TIER (mma_tf32.cuh; TIER_3XTF32 in video_kernel.cu, the one-pass tiers in
// video_kernel_tiers.cu) is the --kernel_precision of the TPU kernels
// (pallas_video_full.py:_temporal_layer and _st_kernel): every product, the
// attention's too, in one pass of operands rounded to the tier, the weights
// rounded on the host; under TIER_BF16 also Q|K|V and the residual stream
// after each sublayer stored as bf16 and the probabilities rounded to bf16
// (row 9's spatial phase as net_kernel.cuh's layer at that tier).  A
// rounded probability needs the row's max and sum first, so T2 then runs
// over the keys twice: the scores for the max and the sum, then the scores
// again, P = bf16(exp(S - max) / sum) and O = P V.  The products q_d k_d
// of a score are summed exact on the tensor cores, where the TPU kernel
// rounds each to bf16 before its segment sum (net_kernel.cuh rounds them).
//
// With VIDK_STAMPS defined, thread 0 of block 0 sums clock64() cycles by
// phase into vidk_cycles (probes/video_phases.py builds that variant).
#pragma once

#include <cooperative_groups.h>

#include <cmath>

#include "net_kernel.cuh"

#ifdef VIDK_STAMPS
__device__ long long vidk_cycles[8];
#define VIDK_CLOCK_START long long vidk_last = clock64()
#define VIDK_MARK(k)                                                         \
  do {                                                                       \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                               \
      const long long now_ = clock64();                                      \
      vidk_cycles[k] += now_ - vidk_last;                                    \
      vidk_last = now_;                                                      \
    }                                                                        \
  } while (0)
#else
#define VIDK_CLOCK_START do {} while (0)
#define VIDK_MARK(k) do {} while (0)
#endif

namespace vidk {

using netk::DK;
using netk::HEADS;
using netk::HID;
using netk::LDH;
using netk::N_PTS;
using netk::NET_KS;
using netk::NET_RING;
using netk::NET_STAGES;
using netk::ROWS;
using netk::ROWS_PAD;
using netk::THREADS;
using netk::ld4;
using netk::st4;
using netk::zero4;
using tf32::mma;
using tf32::mma3;
using tf32::quad_max;
using tf32::quad_sum;

constexpr int QKV = 3 * HID;                // a scratch row: Q | K | V
constexpr int LDF = 2 * HID + 4;            // the feed-forward hidden rows (== 4 mod 32)
constexpr int KEYS = 32;                    // keys a chunk of T2
constexpr int KT = KEYS / 8;                // key tiles a chunk
constexpr int LDK = DK + 4;                 // K and V rows in a warp's buffer
constexpr int BUF_FLOATS = 2 * KEYS * LDK;  // one buffer: K, then V
constexpr int WARP_FLOATS = 2 * BUF_FLOATS; // two buffers a warp
constexpr int TEMPORAL_THREADS = netk::NET_THREADS;  // row 10: 12 warps; row 9: THREADS
constexpr int T_ACT_FLOATS = 2 * ROWS_PAD * LDH + ROWS_PAD * LDF;
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// Row 10: its tile and ring, or T2's warp buffers; row 9: the spatial tile
// (which T1 and T3 share), or T2's warp buffers.
constexpr size_t SMEM_BYTES =
    sizeof(float) * cmax(T_ACT_FLOATS + NET_RING, (TEMPORAL_THREADS / 32) * WARP_FLOATS);
constexpr size_t ST_SMEM_BYTES =
    sizeof(float) * cmax(netk::SMEM_FLOATS, (THREADS / 32) * WARP_FLOATS);
static_assert(SMEM_BYTES <= 232448 && ST_SMEM_BYTES <= 232448, "shared memory of an SM");
static_assert(T_ACT_FLOATS % 4 == 0 && WARP_FLOATS % 4 == 0, "16-byte alignment");

struct TemporalArgs {
  const float* ln1s; const float* ln1b; const float* ln2s; const float* ln2b;  // [HID]
  // The channel products' weights W [K, N] as TF32 parts [2, K, N]: big, then
  // small (a one-pass tier: [K, N], rounded to the tier).
  const float* wqkv;   // [2, HID, 3*HID], q columns pre-scaled by 1/sqrt(DK)
  const float* bqkv;   // [3*HID], q part pre-scaled
  const float* wao; const float* bao;    // [2, HID, HID], [HID]
  const float* wff1; const float* bff1;  // [2, HID, 2*HID], [2*HID]
  const float* wff2; const float* bff2;  // [2, 2*HID, HID], [HID]
};

// Where the three phases meet: the layer's input (row 9: the spatial output,
// written in the launch), Q|K|V and the attention output, all flat over the
// N F frame vectors, and the geometry.
struct Flow {
  const float* x;     // [V, HID]
  float* qkv;         // [V, 3*HID]
  float* att;         // [V, HID]
  float* out;         // [V, HID]
  int windows, joints, frames;  // N = windows * joints rows of F frames
};

__device__ __forceinline__ int vectors(const Flow& f) { return f.windows * f.joints * f.frames; }

// C[r, c] = acc + bias[c] for the tile's first nreal rows, C in global
// memory; RND: rounded to bf16.
template <int LDC, bool RND = false>
struct EpGlobal {
  float* c;
  const float* bias;
  int nreal;
  __device__ __forceinline__ void operator()(const netk::Acc& d, int m0, int rb, int g, int t,
                                             int nts = 3) const {
    float b[2][2];
    netk::frag_bias(bias, m0, g, b);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = netk::frag_row(rb, nt, i, t), col = netk::frag_col(m0, mt, i, g);
          if (nt >= nts || r >= nreal) continue;
          const float v = d[mt][nt][i] + b[mt][i >> 1];
          c[static_cast<size_t>(r) * LDC + col] = RND ? tf32::round_bf16(v) : v;
        }
  }
};

// The first nreal vectors of a tile of src [., HID] into dst's rows (LDH
// apart); rows nreal .. ROWS - 1 become zeros.  Read through L2.
template <int NT>
__device__ __forceinline__ void load_vectors(const float* src, float* dst, int nreal, int tid) {
  for (int i = tid; i < ROWS * (HID / 4); i += NT) {
    const int r = i / (HID / 4), c = 4 * (i % (HID / 4));
    st4(dst + r * LDH + c,
        r < nreal ? __ldcg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * HID + c))
                  : zero4());
  }
}

template <int NT>
__device__ __forceinline__ void zero_floats(float* p, int n, int tid) {
  for (int i = tid; i < n / 4; i += NT) st4(p + 4 * i, zero4());
}

// The first slabs of W_qkv into the ring, which must be free.
template <int NT, int TIER>
__device__ __forceinline__ void tc_prefetch_qkv(const TemporalArgs& w, float* ring, int tid) {
  netk::tc_prefetch<HID, QKV, NET_STAGES, NET_KS, QKV, true, NT, TIER>(w.wqkv, ring, tid);
}

// T1 on a tile whose residual stream xs holds its nreal vectors (the rest
// finite): ys = LN1(xs), qkv[r] = ys[r] W_qkv + b for r < nreal.  Starts
// after the barrier that completes xs and after tc_prefetch_qkv since the
// ring was last free; ends on a barrier.
template <int NT, int TIER>
__device__ __forceinline__ void qkv_tile(const TemporalArgs& w, const float* xs, float* ys,
                                         float* ring, float* qkv, int nreal, int tid) {
  netk::layer_norm_warp<NT / 32>(xs, ys, w.ln1s, w.ln1b, nullptr, 0, tid);
  __syncthreads();
  netk::tc_gemm<HID, QKV, LDH, NET_STAGES, NET_KS, QKV, true, NT, TIER>(
      ys, w.wqkv, ring, EpGlobal<QKV, TIER == tf32::TIER_BF16>{qkv, w.bqkv, nreal}, tid);
  __syncthreads();
}

// T3 on one tile of 68 vectors from v0: xs = x + att W_ao + b_ao, then
// xs += relu(LN2(xs) W_ff1 + b_ff1) W_ff2 + b_ff2, stored to out.  hid is
// the [72, LDHID] hidden tile.  Starts and ends on a barrier; the padded
// rows of ys and hid hold zeros.
template <int NT, int LDHID, int TIER>
__device__ __forceinline__ void ffn_tile(const TemporalArgs& w, const Flow& f, int v0, float* xs,
                                         float* ys, float* hid, float* ring, int tid) {
  constexpr int S = NET_STAGES, KS = NET_KS;
  constexpr bool RND = TIER == tf32::TIER_BF16;   // the residual stream stored as bf16
  const int nreal = min(ROWS, vectors(f) - v0);
  netk::tc_prefetch<HID, HID, S, KS, HID, true, NT, TIER>(w.wao, ring, tid);
  load_vectors<NT>(f.x + static_cast<size_t>(v0) * HID, xs, nreal, tid);
  load_vectors<NT>(f.att + static_cast<size_t>(v0) * HID, ys, nreal, tid);
  __syncthreads();
  netk::tc_gemm<HID, HID, LDH, S, KS, HID, true, NT, TIER>(
      ys, w.wao, ring, netk::EpSmem<LDH, true, true, false, RND>{xs, w.bao}, tid);
  __syncthreads();
  netk::tc_prefetch<HID, 2 * HID, S, KS, 2 * HID, true, NT, TIER>(w.wff1, ring, tid);
  netk::layer_norm_warp<NT / 32>(xs, ys, w.ln2s, w.ln2b, nullptr, 0, tid);
  __syncthreads();
  netk::tc_gemm<HID, 2 * HID, LDH, S, KS, 2 * HID, true, NT, TIER>(
      ys, w.wff1, ring, netk::EpSmem<LDHID, true, false, true>{hid, w.bff1}, tid);
  __syncthreads();
  netk::tc_prefetch<2 * HID, HID, S, KS, HID, true, NT, TIER>(w.wff2, ring, tid);
  netk::tc_gemm<2 * HID, HID, LDHID, S, KS, HID, true, NT, TIER>(
      hid, w.wff2, ring, netk::EpSmem<LDH, true, true, false, RND>{xs, w.bff2}, tid);
  __syncthreads();
  float* out = f.out + static_cast<size_t>(v0) * HID;
  for (int i = tid; i < nreal * (HID / 4); i += NT) {
    const int r = i / (HID / 4), c = 4 * (i % (HID / 4));
    st4(out + static_cast<size_t>(r) * HID + c, ld4(xs + r * LDH + c));
  }
  __syncthreads();
}

// Keys k0 .. k0 + KEYS - 1 of head hd of a row (frame f at vector base + f J)
// into the warp's buffer: K rows, then V rows, LDK apart; keys past F zero.
__device__ __forceinline__ void stage_keys(const Flow& f, size_t base, int hd, int k0, float* buf,
                                           int lane) {
  constexpr int PIECES = DK / 4;
  for (int it = lane; it < KEYS * PIECES; it += 32) {
    const int r = it / PIECES, p = 4 * (it % PIECES), key = k0 + r;
    float* kd = buf + r * LDK + p;
    if (key < f.frames) {
      const float* src = f.qkv + (base + static_cast<size_t>(key) * f.joints) * QKV + hd * DK + p;
      tf32::cp_async16(kd, src + HID);
      tf32::cp_async16(kd + KEYS * LDK, src + 2 * HID);
    } else {
      st4(kd, zero4());
      st4(kd + KEYS * LDK, zero4());
    }
  }
}

// An operand of T2's products at a tier: TF32 parts, or one part rounded
// to the one-pass tier (small unused).
template <int TIER>
__device__ __forceinline__ void split_t(float x, uint32_t& big, uint32_t& small) {
  if constexpr (TIER == tf32::TIER_3XTF32) tf32::split(x, big, small);
  else big = tf32::operand<TIER>(x), small = 0u;
}

// d += a b at the tier: 3xTF32 as a fresh partial, or one pass.
template <int TIER>
__device__ __forceinline__ void mma_t(float (&d)[4], const uint32_t (&ab)[4],
                                      const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                      const uint32_t (&bs)[2]) {
  if constexpr (TIER == tf32::TIER_3XTF32) mma3(d, ab, as, bb, bs);
  else mma(d, ab, bb);
}

// One T2 task: queries q0 .. q0 + 15 of head hd of a row against all its
// keys, by one warp, with buf its two buffers.  TWO: the keys are swept
// twice, the first sweep only finding each row's max m and sum l, the second
// adding P V with P = exp(S - m) / l, under TIER_BF16 rounded to bf16 (the
// file's text).
template <int TIER, bool TWO>
__device__ __forceinline__ void attention_task(const Flow& f, size_t base, int hd, int q0,
                                               float* buf, int lane) {
  static_assert(TWO || TIER != tf32::TIER_BF16, "a rounded probability needs two sweeps");
  const int g = lane >> 2, t = lane & 3, frames = f.frames;
  stage_keys(f, base, hd, 0, buf, lane);   // the first chunk lands while Q loads
  tf32::cp_async_commit();
  // Q fragments (A operand, 16 queries x DK), split once
  uint32_t qb[DK / 8][4], qs[DK / 8][4];
#pragma unroll
  for (int kk = 0; kk < DK / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + g + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
      const float v =
          row < frames
              ? __ldcg(f.qkv + (base + static_cast<size_t>(row) * f.joints) * QKV + hd * DK + col)
              : 0.f;
      split_t<TIER>(v, qb[kk][i], qs[kk][i]);
    }
  float o[DK / 8][4] = {}, m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, den[2] = {0.f, 0.f};
  const int chunks = (frames + KEYS - 1) / KEYS, steps = (TWO ? 2 : 1) * chunks;
  for (int it = 0; it < steps; ++it) {
    const int c = TWO ? it % chunks : it, next = TWO ? (it + 1) % chunks : it + 1;
    const bool sweep = TWO && it < chunks;   // the first of two sweeps: max and sum only
    if (TWO && it == chunks) den[0] = quad_sum(l[0]), den[1] = quad_sum(l[1]);
    if (it + 1 < steps) stage_keys(f, base, hd, next * KEYS, buf + ((it + 1) & 1) * BUF_FLOATS, lane);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();
    __syncwarp();
    const float* ks = buf + (it & 1) * BUF_FLOATS;
    const float* vs = ks + KEYS * LDK;
    const int k0 = c * KEYS, nkt = (min(KEYS, frames - k0) + 7) / 8;

    // S = Q K^T for the chunk's key tiles
    float s[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
      if (j >= nkt) continue;
#pragma unroll
      for (int kk = 0; kk < DK / 8; ++kk) {
        uint32_t bb[2], bs[2];
        split_t<TIER>(ks[(8 * j + g) * LDK + 8 * kk + t], bb[0], bs[0]);
        split_t<TIER>(ks[(8 * j + g) * LDK + 8 * kk + t + 4], bb[1], bs[1]);
        mma_t<TIER>(s[j], qb[kk], qs[kk], bb, bs);
      }
    }
    float alpha[2] = {1.f, 1.f};
    if (TWO && !sweep) {
      // the second sweep: the rounded probabilities of the row's softmax
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool real = j < nkt && k0 + 8 * j + 2 * t + (i & 1) < frames;
          const float p = expf(s[j][i] - m[i >> 1]) / den[i >> 1];
          s[j][i] = real ? (TIER == tf32::TIER_BF16 ? tf32::round_bf16(p) : p) : 0.f;
        }
    } else {
      // online softmax: rows g (entries 0, 1) and g + 8 (2, 3); key 8 j + 2 t + (i & 1)
      float mn[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j < nkt && k0 + 8 * j + 2 * t + (i & 1) < frames)
            mn[i >> 1] = fmaxf(mn[i >> 1], s[j][i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mn[h] = quad_max(mn[h]);
        alpha[h] = expf(m[h] - mn[h]);   // 0 on the first chunk (m = -inf)
        m[h] = mn[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool real = j < nkt && k0 + 8 * j + 2 * t + (i & 1) < frames;
          s[j][i] = real ? expf(s[j][i] - mn[i >> 1]) : 0.f;
          l[i >> 1] += s[j][i];
        }
    }
    if (!sweep) {
      // O_chunk = P V: A column t (t + 4) of key tile j is key 8 j + 2 t (+ 1);
      // 3xTF32 into a chunk partial, a one-pass tier straight into the
      // rescaled O
      constexpr bool THREE = TIER == tf32::TIER_3XTF32;
      float oc[DK / 8][4] = {};
      if constexpr (!THREE) {
#pragma unroll
        for (int n = 0; n < DK / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j >= nkt) continue;
        uint32_t pb[4], ps[4];
        split_t<TIER>(s[j][0], pb[0], ps[0]);
        split_t<TIER>(s[j][2], pb[1], ps[1]);
        split_t<TIER>(s[j][1], pb[2], ps[2]);
        split_t<TIER>(s[j][3], pb[3], ps[3]);
#pragma unroll
        for (int n = 0; n < DK / 8; ++n) {
          uint32_t bb[2], bs[2];
          split_t<TIER>(vs[(8 * j + 2 * t) * LDK + 8 * n + g], bb[0], bs[0]);
          split_t<TIER>(vs[(8 * j + 2 * t + 1) * LDK + 8 * n + g], bb[1], bs[1]);
          mma_t<TIER>(THREE ? oc[n] : o[n], pb, ps, bb, bs);
        }
      }
      if constexpr (THREE) {
#pragma unroll
        for (int n = 0; n < DK / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[n][i] = o[n][i] * alpha[i >> 1] + oc[n][i];
      }
    }
    __syncwarp();   // every lane is done with this buffer before it is staged again
  }
  tf32::cp_async_wait<0>();
  if (!TWO) den[0] = quad_sum(l[0]), den[1] = quad_sum(l[1]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + g + 8 * h;
    if (row >= frames) continue;
    float* dst = f.att + (base + static_cast<size_t>(row) * f.joints) * HID + hd * DK + 2 * t;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          TWO ? make_float2(o[n][2 * h], o[n][2 * h + 1])
              : make_float2(o[n][2 * h] / den[h], o[n][2 * h + 1] / den[h]);
  }
}

// T2: the tasks (row, head, 16-query tile), query tile fastest, over every
// warp of the grid.  smem holds the NT / 32 warps' buffers.
template <int NT, int TIER, bool TWO = TIER == tf32::TIER_BF16>
__device__ __forceinline__ void attention_phase(const Flow& f, float* smem, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int qtiles = (f.frames + 15) / 16;
  const int tasks = f.windows * f.joints * HEADS * qtiles;
  float* buf = smem + warp * WARP_FLOATS;
  for (int task = blockIdx.x * (NT / 32) + warp; task < tasks; task += gridDim.x * (NT / 32)) {
    const int qt = task % qtiles, hd = (task / qtiles) % HEADS, n = task / (qtiles * HEADS);
    const size_t base =
        static_cast<size_t>(n / f.joints) * f.frames * f.joints + n % f.joints;
    attention_task<TIER, TWO>(f, base, hd, 16 * qt, buf, lane);
  }
}

// T3 over every tile, grid-stride, in the tile xs | ys | hid | ring.
template <int NT, int LDHID, int TIER>
__device__ __forceinline__ void ffn_phase(const TemporalArgs& w, const Flow& f, float* xs,
                                          float* ys, float* hid, float* ring, int tid) {
  zero_floats<NT>(xs, 2 * ROWS_PAD * LDH, tid);     // xs and ys, adjacent
  zero_floats<NT>(hid, ROWS_PAD * LDHID, tid);
  __syncthreads();
  const int tiles = (vectors(f) + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    ffn_tile<NT, LDHID, TIER>(w, f, tile * ROWS, xs, ys, hid, ring, tid);
}

// Row 10: the TemporalBlock of x [N, F, HID] (f.joints == 1, f.windows == N).
template <int TIER>
__global__ void __launch_bounds__(TEMPORAL_THREADS, 1) temporal_kernel(const TemporalArgs w,
                                                                       const Flow f) {
  constexpr int NT = TEMPORAL_THREADS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem;
  float* ys = xs + ROWS_PAD * LDH;
  float* hid = ys + ROWS_PAD * LDH;
  float* ring = smem + T_ACT_FLOATS;
  const int tid = threadIdx.x;
  VIDK_CLOCK_START;

  // T1
  zero_floats<NT>(smem, T_ACT_FLOATS, tid);
  __syncthreads();
  const int tiles = (vectors(f) + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int v0 = tile * ROWS, nreal = min(ROWS, vectors(f) - v0);
    tc_prefetch_qkv<NT, TIER>(w, ring, tid);
    load_vectors<NT>(f.x + static_cast<size_t>(v0) * HID, xs, nreal, tid);
    __syncthreads();
    qkv_tile<NT, TIER>(w, xs, ys, ring, f.qkv + static_cast<size_t>(v0) * QKV, nreal, tid);
  }
  VIDK_MARK(1);
  cooperative_groups::this_grid().sync();
  VIDK_MARK(2);
  attention_phase<NT, TIER>(f, smem, tid);
  VIDK_MARK(3);
  cooperative_groups::this_grid().sync();
  VIDK_MARK(4);
  ffn_phase<NT, LDF, TIER>(w, f, xs, ys, hid, ring, tid);
  VIDK_MARK(5);
}

// Row 9: one video layer.  `a` describes the spatial block as a one-layer
// bare stack over the B*F frames (a.x the layer's input [B, F, 17, HID],
// a.out the spatial output, a.tp [1, B*F, HID]); f.x is a.out, f.out the
// layer's output (f.joints == 17).
template <int TIER>
__global__ void __launch_bounds__(THREADS, 1) st_layer_kernel(const netk::NetArgs a,
                                                              const TemporalArgs w, const Flow f) {
  namespace nk = netk;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const nk::Tile s = nk::carve(smem);
  VIDK_CLOCK_START;

  // phase S and T1: the spatial block of a tile of TB frames, then LN1 and
  // QKV of its 68 vectors, grid-stride
  nk::load_cheb(a, s, tid);
  const int tiles = (a.batch + nk::TB - 1) / nk::TB;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b0 = tile * nk::TB;
    const int nb = min(nk::TB, a.batch - b0);
    nk::prefetch_layer<0, THREADS, TIER>(a, 0, s.ring, tid);
    for (int i = tid; i < nk::ACT_FLOATS; i += THREADS) s.h[i] = 0.f;
    __syncthreads();
    nk::load_tile(a.x + static_cast<size_t>(b0) * N_PTS * HID, s.h, nb, tid);
    __syncthreads();
    // one layer: the one-pass builds drop the next layer's prefetch (its
    // addresses, live through the layer, spilled at 168 registers); the
    // parity build keeps its code as it was
    nk::stack_layer<true, 0, THREADS, TIER, TIER == tf32::TIER_3XTF32>(a, 0, s, b0, nb, tid);
    VIDK_MARK(0);
    tc_prefetch_qkv<THREADS, TIER>(w, s.ring, tid);
    nk::store_tile(s.h, a.out + static_cast<size_t>(b0) * N_PTS * HID, nb, tid);
    qkv_tile<THREADS, TIER>(w, s.h, s.y, s.ring, f.qkv + static_cast<size_t>(b0) * N_PTS * QKV,
                            nb * N_PTS, tid);
    VIDK_MARK(1);
  }
  cooperative_groups::this_grid().sync();
  VIDK_MARK(2);
  attention_phase<THREADS, TIER>(f, smem, tid);
  VIDK_MARK(3);
  cooperative_groups::this_grid().sync();
  VIDK_MARK(4);
  ffn_phase<THREADS, nk::LDB, TIER>(w, f, s.h, s.y, s.big, s.ring, tid);
  VIDK_MARK(5);
}

}  // namespace vidk
