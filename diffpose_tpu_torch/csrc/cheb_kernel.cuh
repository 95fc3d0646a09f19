// One Chebyshev graph convolution  y[b] = sum_k T_k X[b] W_k + bias  over
// x [B, N, C] -> y [B, N, D], for any N <= 32, any C, D >= 1 and up to 8 orders.
//
// Counterpart of diffpose_tpu/ops/pallas_cheb.py:_cheb_kernel.  The term list
// is (ptr [N+1], idx, val) with idx = (k << 8) | m, sorted by order k within
// each joint (ops/fused_denoiser.py:sparse_terms); T_0 = I is in it as N
// terms.  The last tile of a ragged batch holds fewer samples.  Three kernels,
// chosen by the widths in cheb_kernel.cu (cheb_plan):
//
// cheb_kernel_wide (C and D multiples of 8: GraFormer's 128 -> 128).  Bound by
//   operations: 2 * 63 * 128 * 128 flops a sample of 21 joints for 2 * 21 *
//   128 * 4 bytes of x and y.  The graph mix first, then one channel product
//   with a K1 * C reduction, as ChebGraphConv orders them, the product on the
//   tensor cores: mma.sync m16n8k8 at 3xTF32 with f32 accumulation, a fresh
//   partial sum each k-step of 8 (ops/tf32.py:matmul_3xtf32).  A CTA of 12
//   warps owns up to WIDE_ROWS rows of whole samples (8 samples of 21 joints:
//   1024 samples are 128 CTAs, one wave on 132 SMs) and CW output columns.
//   The reduction walks slabs of KS channels of one order, channel chunk
//   outer and order inner.  Each step mixes the next slab, Z = T_k X[:, c0
//   .. c0 + KS), into one of two shared buffers, split into its TF32 parts
//   there (eight channels a thread and item), then multiplies the current
//   one.  A ring of STAGES stages, filled by cp.async one slab ahead, holds
//   each slab's W (from L2, each weight split once a CTA) and the next
//   slab's chunk of x, so that the mix reads shared memory only.  Warp w
//   holds column group w % 4 (2 m16 tiles) and row group w / 4 (n8 tiles
//   w / 4 + 3 i), and writes y + bias straight from its accumulators.  What
//   holds it: the mma.sync issue rate, and the mix, which does not overlap
//   the product (probes/cheb_levers.py).
//   Shared memory: WIDE_SMEM = 215,936 bytes, one CTA an SM.
//
// cheb_kernel_mix (D >= 8 otherwise: 2 -> 128, 5 -> 96).  Bound by the bytes
//   of y.  A CTA of 256 threads takes a few samples (enough CTAs for four an
//   SM), stages their x and mixes Z = [T_0 X | T_1 X | ...] in shared memory
//   (the term loop reads no global x), then each thread
//   writes VD adjacent outputs of a row (coalesced) from Z's row and W's
//   columns (L1).  f32 FMAs: K1 * C is a few multiply-adds an output.
//
// cheb_kernel_proj (D < 8: 128 -> 3, 96 -> 5).  Bound by the bytes of x.  The
//   product first (the TPU kernel's order): each row's K1 * D projections
//   P = x W_k are a quad's reduction over C, each lane reading a float4 of
//   x a step (coalesced, all of a row's loads in flight at once), W staged in
//   shared memory as channel quartets, the quad summed with shuffles; then
//   the mix y = sum T_k P_k + bias, one thread an output.  f32 FMAs, a few a
//   byte of x.
//
// Each f32 weight and activation enters the wide product as big = tf32(v)
// and small = tf32(v - big); the three passes small*big, big*small, big*big
// go to a fresh partial that is added to the accumulator in f32.
#pragma once

#include <cstdint>

#include "mma_tf32.cuh"
#include "tile.cuh"

namespace chebk {

using netk::fma4;
using netk::ld4;
using netk::ldg4;
using netk::st4;
using netk::zero4;

constexpr int MAX_PTS = 32;
constexpr int MAX_ORDERS = 8;      // idx = (k << 8) | m
constexpr int SEG = MAX_ORDERS + 1;  // a joint's order boundaries in the term list
constexpr int SMEM_MAX = 227 * 1024;

struct ChebArgs {
  const float* x;     // [B, N, C]
  const float* w;     // [K1, C, D]
  const float* bias;  // [D]
  float* y;           // [B, N, D]
  const int* ptr;     // [N + 1]
  const int* idx;     // [nnz]
  const float* val;   // [nnz]
  int batch, n_pts, c_in, d_out, orders, tb;
};

// ---------------------------------------------------------------------------
// wide: the tensor-core product
// ---------------------------------------------------------------------------

constexpr int WIDE_THREADS = 384;                     // 12 warps: 4 column x 3 row groups
constexpr int CW = 128;                               // output columns a CTA (8 m16 tiles)
constexpr int KS = 32;                                // channels a slab
constexpr int STAGES = 2;                             // the ring of W and x slabs
constexpr int LDR = CW + 8;                           // W slab rows, == 8 mod 32
constexpr int NPW = 7;                                // n8 row tiles a warp
constexpr int WIDE_ROWS = 3 * NPW * 8;                // 168 rows a CTA
constexpr int LDZ = KS + 4;                           // Z and x slab rows, == 4 mod 32
constexpr int W_FLOATS = 2 * KS * LDR;                // a W slab, big and small parts
constexpr int STAGE_FLOATS = W_FLOATS + WIDE_ROWS * LDZ;  // + the next slab's x
constexpr int ZBUF_FLOATS = 2 * WIDE_ROWS * LDZ;      // one slab of Z, big and small
constexpr int WIDE_SMEM = 4 * (STAGES * STAGE_FLOATS + 2 * ZBUF_FLOATS) + 4 * MAX_PTS * SEG;
static_assert(LDR % 32 == 8 && LDZ % 32 == 4, "conflict-free fragment loads");
static_assert(WIDE_SMEM <= SMEM_MAX, "one CTA an SM");

struct Slab {
  int k, c0, kw;  // order, first channel, channels (a multiple of 8)
};

// Slab j: channel chunk j / orders (outer), order j % orders (inner).
__device__ __forceinline__ Slab slab_of(const ChebArgs& a, int j) {
  const int c0 = (j / a.orders) * KS;
  return {j % a.orders, c0, min(KS, a.c_in - c0)};
}

// Ring stage j % STAGES: W rows k * C + c0 .. + kw, columns d0 .. d0 + CW of
// slab j (columns past D are zeros), and x's channels c0 .. + kw of slab
// j + 1 for the tile's rows (the mix one slab ahead reads them), by
// cp.async, 16 bytes a piece.  j = -1: slab 0's x alone, in the last stage.
__device__ __forceinline__ void stage_slab(const ChebArgs& a, const float* __restrict__ x,
                                           int rows, int d0, int dcols, int j, float* ring,
                                           int tid) {
  constexpr int NG = CW / 4;
  const int slabs = (a.c_in + KS - 1) / KS * a.orders;
  float* dst = ring + (j + STAGES) % STAGES * STAGE_FLOATS;
  if (j >= 0 && j < slabs) {
    const Slab s = slab_of(a, j);
    const float* src = a.w + (static_cast<size_t>(s.k) * a.c_in + s.c0) * a.d_out + d0;
    for (int it = tid; it < s.kw * NG; it += WIDE_THREADS) {
      const int r = it / NG, c = 4 * (it % NG);
      float* p = dst + r * LDR + c;
      if (c < dcols) {
        tf32::cp_async16(p, src + static_cast<size_t>(r) * a.d_out + c);
      } else {
        st4(p, zero4());
        st4(p + KS * LDR, zero4());
      }
    }
  }
  if (j + 1 < slabs) {
    const Slab s = slab_of(a, j + 1);
    const int groups = s.kw / 4;
    float* xs = dst + W_FLOATS;
    for (int it = tid; it < rows * groups; it += WIDE_THREADS) {
      const int r = it / groups, c = 4 * (it % groups);
      tf32::cp_async16(xs + r * LDZ + c, x + static_cast<size_t>(r) * a.c_in + s.c0 + c);
    }
  }
}

// After the wait: each thread splits the pieces it copied itself (its own
// cp.async writes are visible to it): big in place, small KS rows on.
__device__ __forceinline__ void split_w(const ChebArgs& a, int dcols, int j, float* ring, int tid) {
  constexpr int NG = CW / 4;
  const Slab s = slab_of(a, j);
  float* big = ring + (j % STAGES) * STAGE_FLOATS;
  for (int it = tid; it < s.kw * NG; it += WIDE_THREADS) {
    const int c = 4 * (it % NG);
    if (c >= dcols) continue;
    float* p = big + (it / NG) * LDR + c;
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

// Slab s's mix: Z[r, c] = sum over joint n's terms of order k of T_k[n, m]
// x[b, m, c0 + c] for the tile's rows (r = b N + n), eight channels a thread
// and item, from the slab's x in shared memory (xs, rows LDZ apart)
// straight into Z's TF32 parts: big at zb, small WIDE_ROWS rows on.
__device__ __forceinline__ void mix_slab(const ChebArgs& a, const Slab& s, const float* xs,
                                         const int* seg, int rows, float* zb, int tid) {
  const int groups = s.kw / 8;
  for (int it = tid; it < rows * groups; it += WIDE_THREADS) {
    const int r = it / groups, c = 8 * (it % groups), n = r % a.n_pts;
    const float* src = xs + (r - n) * LDZ + c;
    float4 acc[2] = {zero4(), zero4()};
    const int end = seg[n * SEG + s.k + 1];
#pragma unroll 4
    for (int e = seg[n * SEG + s.k]; e < end; ++e) {
      const float v = __ldg(a.val + e);
      const float* p = src + (__ldg(a.idx + e) & 0xff) * LDZ;
      fma4(acc[0], v, ld4(p));
      fma4(acc[1], v, ld4(p + 4));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b[4], sm[4];
      tf32::split(acc[h].x, b[0], sm[0]);
      tf32::split(acc[h].y, b[1], sm[1]);
      tf32::split(acc[h].z, b[2], sm[2]);
      tf32::split(acc[h].w, b[3], sm[3]);
      float* p = zb + r * LDZ + c + 4 * h;
      st4(p, make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]),
                         __uint_as_float(b[3])));
      st4(p + WIDE_ROWS * LDZ, make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]),
                                           __uint_as_float(sm[2]), __uint_as_float(sm[3])));
    }
  }
}

// acc += Zᵀ-slab products for the warp's tiles: Cᵀ = Wᵀ Zᵀ, W's columns the
// M side (m tiles p0 / 16 + mt, mt < mts), the rows the N side (n tiles
// q + 3 i, i < nts).  Each k-step's three passes go to a fresh partial.
__device__ __forceinline__ void product(float (&acc)[2][NPW][4], const float* zb, const float* wb,
                                        int kw, int p0, int mts, int q, int nts, int g, int t) {
  const float* ws = wb + KS * LDR;
  const float* zs = zb + WIDE_ROWS * LDZ;
#pragma unroll 1
  for (int kk = 0; kk < kw; kk += 8) {
    uint32_t bb[NPW][2], bs[NPW][2];
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      if (i >= nts) continue;
      const int o = (8 * (q + 3 * i) + g) * LDZ + kk + t;
      bb[i][0] = __float_as_uint(zb[o]);
      bb[i][1] = __float_as_uint(zb[o + 4]);
      bs[i][0] = __float_as_uint(zs[o]);
      bs[i][1] = __float_as_uint(zs[o + 4]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= mts) continue;
      const int o0 = (kk + t) * LDR + p0 + 16 * mt + g, o1 = o0 + 4 * LDR;
      const int o[4] = {o0, o0 + 8, o1, o1 + 8};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ab[i] = __float_as_uint(wb[o[i]]);
        as[i] = __float_as_uint(ws[o[i]]);
      }
      float part[NPW][4] = {};
#pragma unroll
      for (int i = 0; i < NPW; ++i)
        if (i < nts) tf32::mma(part[i], ab, bs[i]);
#pragma unroll
      for (int i = 0; i < NPW; ++i)
        if (i < nts) tf32::mma(part[i], as, bb[i]);
#pragma unroll
      for (int i = 0; i < NPW; ++i)
        if (i < nts) tf32::mma(part[i], ab, bb[i]);
#pragma unroll
      for (int i = 0; i < NPW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][i][e] += part[i][e];
    }
  }
}

// Grid (tiles, column chunks): tile blockIdx.x of a.tb samples, columns
// CW blockIdx.y .. + CW.
__global__ void __launch_bounds__(WIDE_THREADS, 1) cheb_kernel_wide(const ChebArgs a) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* zbuf = ring + STAGES * STAGE_FLOATS;
  int* seg = reinterpret_cast<int*>(zbuf + 2 * ZBUF_FLOATS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * a.tb;
  const int rows = min(a.tb, a.batch - b0) * a.n_pts;  // the last tile may be ragged
  const int d0 = blockIdx.y * CW, dcols = min(CW, a.d_out - d0);
  const float* x = a.x + static_cast<size_t>(b0) * a.n_pts * a.c_in;
  const int slabs = (a.c_in + KS - 1) / KS * a.orders;

  // each joint's term list cut by order: seg[n SEG + k] .. seg[n SEG + k + 1]
  for (int n = tid; n < a.n_pts; n += WIDE_THREADS) {
    int e = __ldg(a.ptr + n);
    const int end = __ldg(a.ptr + n + 1);
    for (int k = 0; k <= a.orders; ++k) {
      while (e < end && (__ldg(a.idx + e) >> 8) < k) ++e;
      seg[n * SEG + k] = e;
    }
  }
  // rows past the tile stay zero
  for (int i = 4 * tid; i < 2 * ZBUF_FLOATS; i += 4 * WIDE_THREADS) st4(zbuf + i, zero4());
  // slab 0's x (in the last stage, as if staged with slab -1), then the
  // first STAGES - 1 stages, a commit group each
  stage_slab(a, x, rows, d0, dcols, -1, ring, tid);
  tf32::cp_async_commit();
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    stage_slab(a, x, rows, d0, dcols, j, ring, tid);
    tf32::cp_async_commit();
  }
  tf32::cp_async_wait<STAGES - 1>();   // slab 0's x
  __syncthreads();
  mix_slab(a, slab_of(a, 0), ring + (STAGES - 1) * STAGE_FLOATS + W_FLOATS, seg, rows, zbuf, tid);

  // warp tiles: columns p0 .. p0 + 31 (m tiles with columns left), n tiles q + 3 i
  const int p0 = 32 * (warp & 3), q = warp >> 2;
  const int mts = min(2, max(0, (dcols - p0 + 15) / 16));
  const int nts = max(0, ((rows + 7) / 8 - q + 2) / 3);
  float acc[2][NPW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < NPW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;

  for (int j = 0; j < slabs; ++j) {
    tf32::cp_async_wait<STAGES - 2>();   // stage j has landed (this thread's pieces)
    split_w(a, dcols, j, ring, tid);
    __syncthreads();   // W slab j split, Z slab j mixed; slab j - 1's stage and Z buffer free
    stage_slab(a, x, rows, d0, dcols, j + STAGES - 1, ring, tid);
    tf32::cp_async_commit();
    if (j + 1 < slabs)
      mix_slab(a, slab_of(a, j + 1), ring + (j % STAGES) * STAGE_FLOATS + W_FLOATS, seg, rows,
               zbuf + ((j + 1) & 1) * ZBUF_FLOATS, tid);
    product(acc, zbuf + (j & 1) * ZBUF_FLOATS, ring + (j % STAGES) * STAGE_FLOATS,
            slab_of(a, j).kw, p0, mts, q, nts, g, t);
  }
  tf32::cp_async_wait<0>();

  // y = acc + bias: acc[mt][i][2 h + e] is column p0 + 16 mt + g + 8 h, row 8 (q + 3 i) + 2 t + e
  float* y = a.y + static_cast<size_t>(b0) * a.n_pts * a.d_out + d0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt >= mts) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = p0 + 16 * mt + g + 8 * h;
      if (col >= dcols) continue;
      const float b = __ldg(a.bias + d0 + col);
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        if (i >= nts) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * (q + 3 * i) + 2 * t + e;
          if (r < rows) y[static_cast<size_t>(r) * a.d_out + col] = acc[mt][i][2 * h + e] + b;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// narrow widths: f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int NARROW_THREADS = 256;
constexpr int QUADS = NARROW_THREADS / 4;

template <int V>
__device__ __forceinline__ void ldg_v(float (&o)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = ldg4(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else {
    o[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void st_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    st4(p, make_float4(v[0], v[1], v[2], v[3]));
  } else {
    p[0] = v[0];
  }
}

// The tile's x [rows, C] into shared memory (contiguous in x: 16-byte
// pieces where C % 4 == 0), then Z [rows, K1 C] = [T_0 x | T_1 x | ...],
// then y = Z W + bias.  VC = 4 where C % 4 == 0, VD = 4 where D % 4 == 0,
// else 1.
template <int VC, int VD>
__global__ void __launch_bounds__(NARROW_THREADS) cheb_kernel_mix(const ChebArgs a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * a.tb;
  const int rows = min(a.tb, a.batch - b0) * a.n_pts;
  const int ldz = a.orders * a.c_in;
  float* z = xs + (a.tb * a.n_pts * a.c_in + 3) / 4 * 4;
  const size_t row0 = static_cast<size_t>(b0) * a.n_pts;

  const float* x = a.x + row0 * a.c_in;
  for (int i = VC * tid; i < rows * a.c_in; i += VC * NARROW_THREADS) {
    float v[VC];
    ldg_v<VC>(v, x + i);
    st_v<VC>(xs + i, v);
  }
  __syncthreads();

  const int cgroups = a.c_in / VC;
  for (int it = tid; it < rows * cgroups; it += NARROW_THREADS) {
    const int r = it / cgroups, c = VC * (it % cgroups), n = r % a.n_pts;
    const float* src = xs + (r - n) * a.c_in + c;
    int e = __ldg(a.ptr + n);
    const int end = __ldg(a.ptr + n + 1);
    for (int k = 0; k < a.orders; ++k) {
      float acc[VC] = {};
      for (; e < end; ++e) {
        const int km = __ldg(a.idx + e);
        if ((km >> 8) != k) break;
        const float s = __ldg(a.val + e);
        const float* v = src + (km & 0xff) * a.c_in;
#pragma unroll
        for (int q = 0; q < VC; ++q) acc[q] = fmaf(s, v[q], acc[q]);
      }
      st_v<VC>(z + r * ldz + k * a.c_in + c, acc);
    }
  }
  __syncthreads();

  const int dgroups = a.d_out / VD;
  float* y = a.y + row0 * a.d_out;
  for (int it = tid; it < rows * dgroups; it += NARROW_THREADS) {
    const int r = it / dgroups, d = VD * (it % dgroups);
    const float* zr = z + r * ldz;
    const float* wc = a.w + d;
    float acc[VD];
    ldg_v<VD>(acc, a.bias + d);
#pragma unroll 4
    for (int j = 0; j < ldz; ++j) {
      float wv[VD];
      ldg_v<VD>(wv, wc + static_cast<size_t>(j) * a.d_out);
      const float zv = zr[j];
#pragma unroll
      for (int q = 0; q < VD; ++q) acc[q] = fmaf(zv, wv[q], acc[q]);
    }
    st_v<VD>(y + static_cast<size_t>(r) * a.d_out + d, acc);
  }
}

// Projections a pass of the proj kernel.
constexpr int PROJ_PASS = 16;

// The proj kernel's projections a row (K1 D), rounded up to whole passes.
__host__ __device__ constexpr int proj_width(int kd) { return (kd + PROJ_PASS - 1) / PROJ_PASS * PROJ_PASS; }

// P = x W_k for every row and order (kd = K1 D projections a row, j = k D +
// d; each a quad's reduction over C, PROJ_PASS of them a pass over the
// row), then y = sum_k T_k P_k + bias.  Shared memory: W as channel
// quartets, wq[c / 4][j][c % 4] for j < kdp = proj_width(kd) (zeros past kd
// and past C), quartets 4 kdp + 4 floats apart (== 4 mod 32: a quad's four
// quartets fall in distinct banks); then P [rows, kdp].  VC = 4 where
// C % 4 == 0, else 1.
template <int VC>
__global__ void __launch_bounds__(NARROW_THREADS) cheb_kernel_proj(const ChebArgs a) {
  extern __shared__ float4 smem4[];
  float* wq = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, t = tid & 3;
  const int nq = (a.c_in + 3) / 4, kd = a.orders * a.d_out, kdp = proj_width(kd), qs = 4 * kdp + 4;
  float* p = wq + nq * qs;
  const int b0 = blockIdx.x * a.tb;
  const int rows = min(a.tb, a.batch - b0) * a.n_pts;
  const size_t row0 = static_cast<size_t>(b0) * a.n_pts;

  for (int i = tid; i < nq * kdp * 4; i += NARROW_THREADS) {
    const int quartet = i / (4 * kdp), j = (i / 4) % kdp, c = 4 * quartet + (i & 3);
    wq[quartet * qs + 4 * j + (i & 3)] =
        c < a.c_in && j < kd
            ? __ldg(a.w + (static_cast<size_t>(j / a.d_out) * a.c_in + c) * a.d_out + j % a.d_out)
            : 0.f;
  }
  __syncthreads();

  for (int r0 = 0; r0 < rows; r0 += QUADS) {  // whole warps to the shuffles
    const int r = r0 + (tid >> 2);
    const float* xr = a.x + (row0 + r) * a.c_in;
    for (int j0 = 0; j0 < kdp; j0 += PROJ_PASS) {
      float acc[PROJ_PASS] = {};
#pragma unroll 8
      for (int c4 = r < rows ? t : nq; c4 < nq; c4 += 4) {
        float4 xv;
        if constexpr (VC == 4) {
          xv = ldg4(xr + 4 * c4);
        } else {
          const int c = 4 * c4;
          xv = make_float4(__ldg(xr + c), c + 1 < a.c_in ? __ldg(xr + c + 1) : 0.f,
                           c + 2 < a.c_in ? __ldg(xr + c + 2) : 0.f,
                           c + 3 < a.c_in ? __ldg(xr + c + 3) : 0.f);
        }
        const float* wr = wq + c4 * qs + 4 * j0;
#pragma unroll
        for (int j = 0; j < PROJ_PASS; ++j) {
          const float4 w4 = ld4(wr + 4 * j);
          acc[j] = fmaf(xv.x, w4.x, acc[j]);
          acc[j] = fmaf(xv.y, w4.y, acc[j]);
          acc[j] = fmaf(xv.z, w4.z, acc[j]);
          acc[j] = fmaf(xv.w, w4.w, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < PROJ_PASS; ++j) {
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 1);
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 2);
        if ((j & 3) == t && r < rows) p[r * kdp + j0 + j] = acc[j];
      }
    }
  }
  __syncthreads();

  float* y = a.y + row0 * a.d_out;
  for (int i = tid; i < rows * a.d_out; i += NARROW_THREADS) {
    const int r = i / a.d_out, d = i % a.d_out, n = r % a.n_pts;
    const float* pb = p + (r - n) * kdp + d;
    float acc = __ldg(a.bias + d);
    const int end = __ldg(a.ptr + n + 1);
    for (int e = __ldg(a.ptr + n); e < end; ++e) {
      const int km = __ldg(a.idx + e);
      acc = fmaf(__ldg(a.val + e), pb[(km & 0xff) * kdp + (km >> 8) * a.d_out], acc);
    }
    y[i] = acc;
  }
}

}  // namespace chebk
