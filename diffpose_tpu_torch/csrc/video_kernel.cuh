// The video denoiser's layer kernels (hid 96, 4 heads, 17 joints):
//
// * temporal_kernel: one TemporalBlock on [N, F, HID] rows, N = windows x
//   joints: x += out_proj(MHA over the F frames(LN1(x))), then
//   x += ff2(relu(ff1(LN2(x)))).  Counterpart of
//   diffpose_tpu/ops/pallas_video_full.py:_temporal_only_kernel.
// * st_layer_kernel: one whole video layer, the spatial block of every frame
//   (the bare-stack layer of net_kernel.cuh) and then the temporal block of
//   every (window, joint), as one cooperative launch with a grid-wide barrier
//   between the two phases.  Counterpart of pallas_video_full.py:_st_kernel.
//
// One CTA of 288 threads owns one (window, joint) row of F frames in the
// temporal phase and walks over it in tiles of QT = 36 frames, so that any F
// fits (81 and 243 are the published windows):
//
//   pass A  per tile: LN1, then K|V = LN1(x) @ W_kv + b_kv, stored to a
//           global scratch [F, 2*HID] of the row (L2-resident);
//   pass B  per tile: LN1 again, q = LN1(x) @ W_q + b_q (q carries 1/sqrt(DK)),
//           attention of each (query, head) over all F keys of the scratch
//           with an online softmax in chunks of KCH keys, split in two
//           halves of the keys whose partial sums are merged in shared
//           memory; out-projection + residual; LN2, FF 96->192 (ReLU) ->96 +
//           residual; the tile is stored.
//
// Shared memory of the temporal phase (73 KB):
//   xs   [QT, HID]     the tile's residual stream
//   ys   [QT, HID]     LayerNorm output / attention output
//   bs   [QT, 2*HID]   q, or the FF hidden layer
//   part [QT*HEADS, DK + 4]  the second key half's (max, sum, output)
//
// The spatial phase is net_kernel.cuh's layer (tensor-core products, a
// cp.async weight ring in the same shared memory).  In the temporal phase
// weights stream from global memory (L2); every product is an f32 FMA on
// CUDA cores with f32 accumulation.  The scratch and (in st_layer_kernel)
// the spatial phase's output are written inside the launch, so they are read
// with plain loads, never through __ldg.
#pragma once

#include <cooperative_groups.h>

#include <cmath>

#include "net_kernel.cuh"

namespace vidk {

using netk::DK;
using netk::HEADS;
using netk::HID;
using netk::N_PTS;
using netk::THREADS;
using netk::add4;
using netk::fma4;
using netk::ld4;
using netk::ldg4;
using netk::relu4;
using netk::st4;
using netk::zero4;

constexpr int QT = 36;                  // frames per tile: QT * HEADS * 2 == THREADS
constexpr int KCH = 16;                 // keys per online-softmax chunk
constexpr int LDH = HID + 4;
constexpr int LDF = 2 * HID + 4;
constexpr int LDP = DK + 4;             // m, l, o[DK], padded to a float4 multiple
constexpr int KV = 2 * HID;             // a scratch row: K | V
constexpr int SMEM_FLOATS = 2 * QT * LDH + QT * LDF + QT * HEADS * LDP;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;
static_assert(QT * HEADS * 2 == THREADS, "one (query, head, key half) per thread");

struct TemporalArgs {
  const float* ln1s; const float* ln1b; const float* ln2s; const float* ln2b;  // [HID]
  const float* wqkv;   // [HID, 3*HID], q columns pre-scaled by 1/sqrt(DK)
  const float* bqkv;   // [3*HID], q part pre-scaled
  const float* wao; const float* bao;    // [HID, HID], [HID]
  const float* wff1; const float* bff1;  // [HID, 2*HID], [2*HID]
  const float* wff2; const float* bff2;  // [2*HID, HID], [HID]
};

enum Epi { kStoreBias, kReluBias, kAddBias };

// C[r, :N] (=, +=) A[r, :K] @ W[K, N] (+ bias) for the QT rows of a tile,
// W with row stride LDW; rows >= nrows are not stored.  Thread = (column
// group of 4, row group).
template <int K, int N, int LDA, int LDW, int LDC, Epi EPI>
__device__ __forceinline__ void gemm(const float* A, const float* __restrict__ W,
                                     const float* __restrict__ bias, float* C, int nrows,
                                     int tid) {
  constexpr int NG = N / 4;
  static_assert(N % 4 == 0 && K % 4 == 0 && THREADS % NG == 0, "column groups must tile the block");
  constexpr int G = THREADS / NG;
  constexpr int RPT = (QT + G - 1) / G;
  static_assert(RPT * G == QT, "row groups must tile the frame tile");
  const int cg = tid % NG;
  const int rg = tid / NG;
  const float* wc = W + 4 * cg;
  float4 acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = zero4();
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
  const float4 b = ldg4(bias + 4 * cg);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + i * G;
    if (r >= nrows) continue;
    float* c = C + static_cast<size_t>(r) * LDC + 4 * cg;
    float4 v = add4(acc[i], b);
    if constexpr (EPI == kReluBias) v = relu4(v);
    if constexpr (EPI == kAddBias) v = add4(ld4(c), v);
    st4(c, v);
  }
}

// out = a * (in - mean) / (std + 1e-6) + b per row of the tile, Bessel std.
__device__ __forceinline__ void layer_norm(const float* in, float* out,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ shift, int tid) {
  for (int r = tid; r < QT; r += THREADS) {
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

// Attention of the tile's nrows queries (q in bs) over the frames keys and
// values of the row's scratch kv [frames, K | V]; output to ys.  Thread =
// (query, head, key half); the halves meet in part.
__device__ __forceinline__ void attention(const float* bs, const float* kv, float* ys,
                                          float* part, int frames, int nrows, int tid) {
  const int half = tid & 1;
  const int hd = (tid >> 1) % HEADS;
  const int qi = tid / (2 * HEADS);
  const int split = (frames + 1) / 2;
  const int k0 = half ? split : 0;
  const int k1 = half ? frames : split;
  float m = -INFINITY, l = 0.f;
  float4 o[DK / 4];
#pragma unroll
  for (int d = 0; d < DK / 4; ++d) o[d] = zero4();
  if (qi < nrows) {
    float4 q[DK / 4];
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) q[d] = ld4(bs + qi * LDF + hd * DK + 4 * d);
    for (int c0 = k0; c0 < k1; c0 += KCH) {
      float s[KCH];
      float cm = -INFINITY;
#pragma unroll
      for (int u = 0; u < KCH; ++u) {
        s[u] = -INFINITY;
        if (c0 + u < k1) {
          const float* kr = kv + static_cast<size_t>(c0 + u) * KV + hd * DK;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < DK / 4; ++d) {
            const float4 kk = ld4(kr + 4 * d);
            acc = fmaf(q[d].x, kk.x, acc);
            acc = fmaf(q[d].y, kk.y, acc);
            acc = fmaf(q[d].z, kk.z, acc);
            acc = fmaf(q[d].w, kk.w, acc);
          }
          s[u] = acc;
          cm = fmaxf(cm, acc);
        }
      }
      const float mn = fmaxf(m, cm);
      const float alpha = expf(m - mn);   // 0 on the first chunk (m = -inf)
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) {
        o[d].x *= alpha; o[d].y *= alpha; o[d].z *= alpha; o[d].w *= alpha;
      }
#pragma unroll
      for (int u = 0; u < KCH; ++u) {
        if (c0 + u < k1) {
          const float p = expf(s[u] - mn);
          l += p;
          const float* vr = kv + static_cast<size_t>(c0 + u) * KV + HID + hd * DK;
#pragma unroll
          for (int d = 0; d < DK / 4; ++d) fma4(o[d], p, ld4(vr + 4 * d));
        }
      }
      m = mn;
    }
    if (half) {
      float* p = part + (qi * HEADS + hd) * LDP;
      p[0] = m;
      p[1] = l;
#pragma unroll
      for (int d = 0; d < DK / 4; ++d) st4(p + 4 + 4 * d, o[d]);
    }
  }
  __syncthreads();
  if (!half && qi < nrows) {
    const float* p = part + (qi * HEADS + hd) * LDP;
    const float m1 = p[0], l1 = p[1];
    const float mx = fmaxf(m, m1);
    const float a0 = expf(m - mx), a1 = expf(m1 - mx);
    const float inv = 1.f / (l * a0 + l1 * a1);
    float* dst = ys + qi * LDH + hd * DK;
#pragma unroll
    for (int d = 0; d < DK / 4; ++d) {
      const float4 o1 = ld4(p + 4 + 4 * d);
      st4(dst + 4 * d, make_float4((o[d].x * a0 + o1.x * a1) * inv, (o[d].y * a0 + o1.y * a1) * inv,
                                   (o[d].z * a0 + o1.z * a1) * inv, (o[d].w * a0 + o1.w * a1) * inv));
    }
  }
}

// The tile's frames t0 .. t0 + nrows - 1 of a row (frame stride `stride`
// floats) into xs; the absent rows are zeros (finite through LayerNorm).
__device__ __forceinline__ void load_frames(const float* x, size_t stride, float* xs, int nrows,
                                            int tid) {
  for (int i = tid; i < QT * (HID / 4); i += THREADS) {
    const int r = i / (HID / 4);
    const int c = 4 * (i % (HID / 4));
    st4(xs + r * LDH + c, r < nrows ? ld4(x + r * stride + c) : zero4());
  }
}

// One TemporalBlock on one (window, joint) row of `frames` frames: x and out
// at frame stride `stride` (out may be x), kv the row's [frames, 2*HID]
// scratch.  Starts and ends on a __syncthreads().
__device__ __forceinline__ void temporal_row(const TemporalArgs& w, const float* x, float* out,
                                             size_t stride, float* kv, int frames, float* smem,
                                             int tid) {
  float* xs = smem;
  float* ys = xs + QT * LDH;
  float* bs = ys + QT * LDH;
  float* part = bs + QT * LDF;

  // pass A: K and V of every frame
  for (int t0 = 0; t0 < frames; t0 += QT) {
    const int nrows = min(QT, frames - t0);
    load_frames(x + t0 * stride, stride, xs, nrows, tid);
    __syncthreads();
    layer_norm(xs, ys, w.ln1s, w.ln1b, tid);
    __syncthreads();
    gemm<HID, KV, LDH, 3 * HID, KV, kStoreBias>(ys, w.wqkv + HID, w.bqkv + HID,
                                               kv + static_cast<size_t>(t0) * KV, nrows, tid);
    __syncthreads();
  }

  // pass B: each tile's queries against every key, then the feed-forward
  for (int t0 = 0; t0 < frames; t0 += QT) {
    const int nrows = min(QT, frames - t0);
    load_frames(x + t0 * stride, stride, xs, nrows, tid);
    __syncthreads();
    layer_norm(xs, ys, w.ln1s, w.ln1b, tid);
    __syncthreads();
    gemm<HID, HID, LDH, 3 * HID, LDF, kStoreBias>(ys, w.wqkv, w.bqkv, bs, QT, tid);
    __syncthreads();
    attention(bs, kv, ys, part, frames, nrows, tid);
    __syncthreads();
    gemm<HID, HID, LDH, HID, LDH, kAddBias>(ys, w.wao, w.bao, xs, QT, tid);
    __syncthreads();
    layer_norm(xs, ys, w.ln2s, w.ln2b, tid);
    __syncthreads();
    gemm<HID, 2 * HID, LDH, 2 * HID, LDF, kReluBias>(ys, w.wff1, w.bff1, bs, QT, tid);
    __syncthreads();
    gemm<2 * HID, HID, LDF, HID, LDH, kAddBias>(bs, w.wff2, w.bff2, xs, QT, tid);
    __syncthreads();
    for (int i = tid; i < nrows * (HID / 4); i += THREADS) {
      const int r = i / (HID / 4);
      const int c = 4 * (i % (HID / 4));
      st4(out + (t0 + r) * stride + c, ld4(xs + r * LDH + c));
    }
    __syncthreads();
  }
}

// Row 10: CTA n runs the TemporalBlock of row n of x [N, F, HID].
__global__ void __launch_bounds__(THREADS) temporal_kernel(const TemporalArgs w, const float* x,
                                                           float* out, float* kv, int frames) {
  extern __shared__ float4 smem4[];
  const size_t n = blockIdx.x;
  temporal_row(w, x + n * frames * HID, out + n * frames * HID, HID, kv + n * frames * KV,
               frames, reinterpret_cast<float*>(smem4), threadIdx.x);
}

// Row 9: one video layer.  `a` describes the spatial block as a one-layer
// bare stack over the B*F frames (a.x the layer's input [B, F, 17, HID],
// a.out the spatial output, a scratch of the same shape, a.tp [1, B*F, HID]);
// `out` receives the temporal block's output, `kv` holds B*17 rows' K | V.
__global__ void __launch_bounds__(THREADS, 1) st_layer_kernel(const netk::NetArgs a,
                                                              const TemporalArgs w, float* out,
                                                              float* kv, int windows, int frames) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;

  // phase S: the spatial block, tiles of TB frames, grid-stride
  {
    namespace nk = netk;
    const nk::Tile s = nk::carve(smem);
    nk::load_cheb(a, s, tid);
    const int tiles = (a.batch + nk::TB - 1) / nk::TB;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int b0 = tile * nk::TB;
      const int nb = min(nk::TB, a.batch - b0);
      nk::prefetch_layer(a, 0, s.ring, tid);
      for (int i = tid; i < nk::ACT_FLOATS; i += THREADS) s.h[i] = 0.f;
      __syncthreads();
      nk::load_tile(a.x + static_cast<size_t>(b0) * N_PTS * HID, s.h, nb, tid);
      __syncthreads();
      nk::stack_layer<true, 0, THREADS>(a, 0, s, b0, nb, tid);
      nk::store_tile(s.h, a.out + static_cast<size_t>(b0) * N_PTS * HID, nb, tid);
      __syncthreads();
    }
  }
  cooperative_groups::this_grid().sync();

  // phase T: the temporal block of every (window, joint) row, grid-stride;
  // frame f of row (b, j) lies at ((b * F + f) * 17 + j) * HID
  const size_t stride = static_cast<size_t>(N_PTS) * HID;
  for (int n = blockIdx.x; n < windows * N_PTS; n += gridDim.x) {
    const size_t base = (static_cast<size_t>(n / N_PTS) * frames * N_PTS + n % N_PTS) * HID;
    temporal_row(w, a.out + base, out + base, stride, kv + static_cast<size_t>(n) * frames * KV,
                 frames, smem, tid);
  }
}

}  // namespace vidk
