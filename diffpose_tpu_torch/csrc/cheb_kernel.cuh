// One Chebyshev graph convolution  y[b] = sum_k T_k X[b] W_k + bias  over
// x [B, N, C] -> y [B, N, D], for any N <= 32, any C, D and up to 8 orders.
//
// Counterpart of diffpose_tpu/ops/pallas_cheb.py:_cheb_kernel.  One CTA owns
// a tile of TB whole samples (the joint mix needs every joint of a sample)
// and works in two stages, as the reference ChebGraphConv orders them
// (graph mix first, then one channel product with a K1*C reduction):
//
//   1. mix:  Z[r, k*C + c] = sum_m T_k[n, m] * x[b, m, c]   (r = b*N + n)
//      over the sparse term list of joint n, read from global memory (a few
//      KB, L1-resident); x is read from global memory too, each row about
//      nnz/N times, from L1.  Z lives in shared memory.
//   2. gemm: y[r, :] = Z[r, :] @ W + bias, W = [K1*C, D] (w is [K1, C, D]
//      contiguous), streamed from global memory (L2) with __ldg: nothing in
//      the launch writes it.  A thread holds RB rows x 4 columns (or x 1
//      where D % 4 != 0) and writes them straight to y.
//
// Bound on the H100: at C = D = 128, N = 21, K1 = 3 the channel product is
// 2 * 63 * 128 * 128 flops a sample for 2 * 21 * 128 * 4 bytes of x and y,
// about 150 flops a byte: operations (67 TFLOP/s FP32).  At C = 2 or D = 3
// the bytes bound it.  All arithmetic is f32 FMA with f32 accumulation.
//
// The term list is (ptr [N+1], idx, val) with idx = (k << 8) | m, sorted by
// order k within each joint (ops/fused_denoiser.py:sparse_terms); T_0 = I is
// in it as N terms.  The last tile of a ragged batch holds fewer samples.
#pragma once

namespace chebk {

constexpr int THREADS = 256;
constexpr int RB = 8;              // rows a thread holds in the channel product
constexpr int MAX_PTS = 32;
constexpr int MAX_ORDERS = 8;      // idx = (k << 8) | m
constexpr int TB_MAX = 8;          // samples a CTA
// Shared memory a CTA aims for: two CTAs an SM (228 KB, 1 KB reserved each).
constexpr int SMEM_TARGET = 110 * 1024;
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

template <int V>
__device__ __forceinline__ void ldg_v(float (&o)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else {
    o[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void st_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// Stage 1 over the tile's rows; VC = 4 where C % 4 == 0, else 1.
template <int VC>
__device__ __forceinline__ void mix(const ChebArgs& a, const float* __restrict__ x, float* z,
                                    int rows, int ldz, int tid) {
  const int groups = a.c_in / VC;
  for (int it = tid; it < rows * groups; it += THREADS) {
    const int r = it / groups;
    const int c = VC * (it % groups);
    const float* src = x + static_cast<size_t>(r / a.n_pts) * a.n_pts * a.c_in + c;
    const int n = r % a.n_pts;
    int e = __ldg(a.ptr + n);
    const int end = __ldg(a.ptr + n + 1);
    for (int k = 0; k < a.orders; ++k) {
      float acc[VC];
#pragma unroll
      for (int q = 0; q < VC; ++q) acc[q] = 0.f;
      for (; e < end; ++e) {
        const int km = __ldg(a.idx + e);
        if ((km >> 8) != k) break;
        const float s = __ldg(a.val + e);
        float v[VC];
        ldg_v<VC>(v, src + (km & 0xff) * a.c_in);
#pragma unroll
        for (int q = 0; q < VC; ++q) acc[q] = fmaf(s, v[q], acc[q]);
      }
      st_v<VC>(z + r * ldz + k * a.c_in + c, acc);
    }
  }
}

// Stage 2: y = Z @ W + bias for the tile's rows; VD = 4 where D % 4 == 0.
template <int VD>
__device__ __forceinline__ void gemm(const ChebArgs& a, const float* z, float* __restrict__ y,
                                     int rows, int ldz, int tid) {
  const int kc = a.orders * a.c_in;
  const int groups = a.d_out / VD;
  const int blocks = (rows + RB - 1) / RB;
  for (int it = tid; it < blocks * groups; it += THREADS) {
    const int r0 = (it / groups) * RB;
    const int d = VD * (it % groups);
    const float* wc = a.w + d;
    const float* zr[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) zr[i] = z + min(r0 + i, rows - 1) * ldz;  // rows past the tile repeat the last
    float acc[RB][VD];
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int q = 0; q < VD; ++q) acc[i][q] = 0.f;
    int j = 0;
    if (kc % 4 == 0) {  // Z rows are 16-byte aligned: four reduction steps a load
      for (; j < kc; j += 4) {
        float w0[VD], w1[VD], w2[VD], w3[VD];
        ldg_v<VD>(w0, wc + static_cast<size_t>(j + 0) * a.d_out);
        ldg_v<VD>(w1, wc + static_cast<size_t>(j + 1) * a.d_out);
        ldg_v<VD>(w2, wc + static_cast<size_t>(j + 2) * a.d_out);
        ldg_v<VD>(w3, wc + static_cast<size_t>(j + 3) * a.d_out);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float4 zv = *reinterpret_cast<const float4*>(zr[i] + j);
#pragma unroll
          for (int q = 0; q < VD; ++q) {
            acc[i][q] = fmaf(zv.x, w0[q], acc[i][q]);
            acc[i][q] = fmaf(zv.y, w1[q], acc[i][q]);
            acc[i][q] = fmaf(zv.z, w2[q], acc[i][q]);
            acc[i][q] = fmaf(zv.w, w3[q], acc[i][q]);
          }
        }
      }
    }
    for (; j < kc; ++j) {
      float wv[VD];
      ldg_v<VD>(wv, wc + static_cast<size_t>(j) * a.d_out);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const float zv = zr[i][j];
#pragma unroll
        for (int q = 0; q < VD; ++q) acc[i][q] = fmaf(zv, wv[q], acc[i][q]);
      }
    }
    float b[VD];
    ldg_v<VD>(b, a.bias + d);
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      if (r0 + i >= rows) break;
      float v[VD];
#pragma unroll
      for (int q = 0; q < VD; ++q) v[q] = acc[i][q] + b[q];
      st_v<VD>(y + static_cast<size_t>(r0 + i) * a.d_out + d, v);
    }
  }
}

template <int VC, int VD>
__global__ void __launch_bounds__(THREADS, 2) cheb_kernel(const ChebArgs a) {
  extern __shared__ float4 smem4[];
  float* z = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * a.tb;
  const int rows = min(a.tb, a.batch - b0) * a.n_pts;  // the last tile may be ragged
  const int ldz = a.orders * a.c_in;
  const size_t row0 = static_cast<size_t>(b0) * a.n_pts;
  mix<VC>(a, a.x + row0 * a.c_in, z, rows, ldz, tid);
  __syncthreads();
  gemm<VD>(a, z, a.y + row0 * a.d_out, rows, ldz, tid);
}

}  // namespace chebk
