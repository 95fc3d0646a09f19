// One body of the stopped Anderson fixed-point solve in four launches, with a
// plain C interface for ctypes.  Built by diffpose_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
//
// Replaces no TPU kernel: the JAX solver's mixing (diffpose_tpu/models/
// solvers.py:solve_anderson, its body) is jnp, which XLA fuses on the TPU.
// Run eagerly on this card, the same body in PyTorch (models/solvers.py:
// anderson_body_plain, this kernel's plain version) is some 80 launches: the
// history pushes, the differences, a float64 copy of them, a float64 GEMM with
// a 5-wide output over millions of values, GEMVs and norms, each a pass over
// memory; this chain computes the same function in four.
//
// The function (history rows X, F [m, d], slot = it mod m, count = min(it+1, m)):
//   X[slot] = z, F[slot] = r = f(z) − z;  dF_i = (F_i − r)·[i < count] (float);
//   (dF·dFᵀ + λI) w = −dF·r  in float64;  w ← w / Σw, or uniform over the
//   valid rows where |Σw| ≤ 1e-10;  z_new = Σ w_i X_i + β Σ w_i F_i, or the
//   plain step z + β r where it < 1 or ‖dF‖ < 1e-10;  z_new ← z where
//   ‖z_new − z‖ ≤ stall_tol·‖z‖;  err = ‖z_new − z‖ / (‖z‖ + 1e-8).
//
// Bound: bytes.  Pass 1 reads z, f(z) and the count − 1 other rows of F and
// writes two rows; pass 2 reads z and the count rows of X and F (z and one
// row of F for the plain step) and writes z_new; a stall rewrites z_new from z.
// At d = 4,177,920 float32 values and m = 5 that is about 0.35 GB a body, 0.1 ms
// at 3.35 TB/s.  The float64 Gram (15 products and 5 for the right-hand side
// a value) is about 84 M DFMAs, a few µs at the card's FP64 rate.
//
// Design: (a) push_gram: a grid-stride pass, each thread a few values a tile
// with their loads issued first, accumulates the Gram's upper triangle and
// the right-hand side in float64 registers (a float32 product is exact in
// float64, so only the sums' order differs from the plain version's DGEMM);
// each block writes its partial sums.  (b) solve: one block sums the
// partials over blocks in a fixed order and one thread solves the m×m system
// by Gaussian elimination with partial pivoting, normalises, and picks the
// plain step.  (c) mix: a second pass writes z_new and each block's partial
// sums of ‖z_new − z‖² and ‖z‖² (float64).  (d) finish: every block sums
// those partials in the same fixed order, so all blocks read the same stall;
// block 0 writes err and the flags; on a stall the blocks copy z into z_new.
// No atomics: the grid depends only on the card's SM count, so two runs are
// bit-equal.  Nothing synchronises with the host.
#include <cuda_runtime.h>

namespace anderson {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 2;
constexpr int MAX_M = 8;
constexpr unsigned FULL = 0xffffffffu;

// The Gram's upper triangle and the right-hand side: the sums a block writes.
__host__ __device__ constexpr int gram_terms(int m) { return m * (m + 1) / 2 + m; }
constexpr int MAX_TERMS = gram_terms(MAX_M);

// Values a thread takes a tile in the two passes, its loads issued first: four
// at float32 and m <= 5 (the published m), fewer where the history's rows
// would not fit the registers of BLOCKS_PER_SM blocks an SM.
template <typename T, int M>
__host__ __device__ constexpr int unroll() {
  return sizeof(T) * M <= 20 ? 4 : (sizeof(T) * M <= 40 ? 2 : 1);
}
template <int M>
__host__ __device__ constexpr int min_blocks() {
  return M <= 5 ? BLOCKS_PER_SM : 1;
}

__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mad(double a, double b, double c) { return fma(a, b, c); }
// Separate roundings of the product and the sum, as the plain version's two
// PyTorch operators give (no contraction into an FMA).
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Each of v[0..N) summed over the block in a fixed order (the butterfly leaves
// every lane the same bits, then warp 0's sum first); thread k < N writes sum
// k to out[k].
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N], double* out) {
  __shared__ double part[WARPS][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) part[warp][k] = v[k];
  __syncthreads();
  if (threadIdx.x < N) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// (a) The push and the block's partial sums of dF·dFᵀ (upper triangle, row by
// row) and dF·r; partials [gridDim.x, MAX_TERMS].
template <typename T, int M>
__global__ void __launch_bounds__(THREADS, min_blocks<M>())
    push_gram_kernel(const T* __restrict__ z, const T* __restrict__ fz, T* __restrict__ X,
                     T* __restrict__ F, long long d, int slot, int count,
                     double* __restrict__ partials) {
  constexpr int P = gram_terms(M), UNROLL = unroll<T, M>();
  double acc[P];
#pragma unroll
  for (int k = 0; k < P; ++k) acc[k] = 0.0;
  const long long tile = static_cast<long long>(THREADS) * UNROLL;
  for (long long base = blockIdx.x * tile + threadIdx.x; base < d; base += gridDim.x * tile) {
    T zv[UNROLL], fv[UNROLL], hv[M][UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = base + u * THREADS;
      if (e < d) {
        zv[u] = z[e];
        fv[u] = fz[e];
#pragma unroll
        for (int i = 0; i < M; ++i)
          hv[i][u] = (i != slot && i < count) ? F[i * d + e] : T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = base + u * THREADS;
      if (e >= d) break;
      const T r = fv[u] - zv[u];
      X[slot * d + e] = zv[u];
      F[slot * d + e] = r;
      double df[M];
#pragma unroll
      for (int i = 0; i < M; ++i)
        df[i] = (i != slot && i < count) ? static_cast<double>(hv[i][u] - r) : 0.0;
      const double rd = static_cast<double>(r);
      int k = 0;
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = i; j < M; ++j, ++k) acc[k] = fma(df[i], df[j], acc[k]);
#pragma unroll
      for (int i = 0; i < M; ++i, ++k) acc[k] = fma(df[i], rd, acc[k]);
    }
  }
  block_sum<P>(acc, partials + static_cast<long long>(blockIdx.x) * MAX_TERMS);
}

// (b) One block: the partials summed over `blocks` (warp k % WARPS takes sum
// k, lanes over blocks in order), then thread 0 solves (G + λI) w = −b by
// Gaussian elimination with partial pivoting, normalises, and writes the
// weights and flags[0], the plain step.
__global__ void __launch_bounds__(THREADS)
    solve_kernel(const double* __restrict__ partials, int blocks, int m, int it, int count,
                 double lam, double* __restrict__ weights, int* __restrict__ flags) {
  __shared__ double sums[MAX_TERMS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int terms = gram_terms(m);
  for (int k = warp; k < terms; k += WARPS) {
    double s = 0.0;
    for (int b = lane; b < blocks; b += 32) s += partials[static_cast<long long>(b) * MAX_TERMS + k];
    s = warp_sum(s);
    if (lane == 0) sums[k] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  double a[MAX_M][MAX_M], w[MAX_M];
  double trace = 0.0;   // ‖dF‖²
  int k = 0;
  for (int i = 0; i < m; ++i)
    for (int j = i; j < m; ++j, ++k) a[i][j] = a[j][i] = sums[k];
  for (int i = 0; i < m; ++i) {
    trace += a[i][i];
    a[i][i] += lam;
    w[i] = -sums[k++];
  }
  for (int c = 0; c < m; ++c) {
    int p = c;
    for (int r = c + 1; r < m; ++r)
      if (fabs(a[r][c]) > fabs(a[p][c])) p = r;
    if (p != c) {
      for (int j = c; j < m; ++j) {
        const double t = a[c][j];
        a[c][j] = a[p][j];
        a[p][j] = t;
      }
      const double t = w[c];
      w[c] = w[p];
      w[p] = t;
    }
    for (int r = c + 1; r < m; ++r) {
      const double f = a[r][c] / a[c][c];
      for (int j = c + 1; j < m; ++j) a[r][j] -= f * a[c][j];
      w[r] -= f * w[c];
    }
  }
  for (int i = m - 1; i >= 0; --i) {
    double s = w[i];
    for (int j = i + 1; j < m; ++j) s -= a[i][j] * w[j];
    w[i] = s / a[i][i];
  }
  double w_sum = 0.0;
  for (int i = 0; i < m; ++i) w_sum += w[i];
  const bool sum_ok = fabs(w_sum) > 1e-10;
  for (int i = 0; i < m; ++i)
    weights[i] = sum_ok ? w[i] / w_sum : (i < count ? 1.0 / count : 0.0);
  flags[0] = it < 1 || sqrt(trace) < 1e-10;
}

// (c) z_new = Σ w_i X_i + β Σ w_i F_i over the valid rows, or z + β F[slot]
// where flags[0]; the block's partial sums of ‖z_new − z‖² and ‖z‖² into
// partials [gridDim.x, 2].
template <typename T, int M>
__global__ void __launch_bounds__(THREADS, min_blocks<M>())
    mix_kernel(const T* __restrict__ z, const T* __restrict__ X, const T* __restrict__ F,
               long long d, int slot, int count, T beta, const double* __restrict__ weights,
               const int* __restrict__ flags, T* __restrict__ z_new,
               double* __restrict__ partials) {
  const bool plain = flags[0] != 0;
  T w[M];
#pragma unroll
  for (int i = 0; i < M; ++i) w[i] = i < count ? static_cast<T>(weights[i]) : T(0);
  constexpr int UNROLL = unroll<T, M>();
  double acc[2] = {0.0, 0.0};
  const long long tile = static_cast<long long>(THREADS) * UNROLL;
  for (long long base = blockIdx.x * tile + threadIdx.x; base < d; base += gridDim.x * tile) {
    T zv[UNROLL], xv[M][UNROLL], fv[M][UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = base + u * THREADS;
      if (e < d) {
        zv[u] = z[e];
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const bool row = plain ? i == slot : i < count;
          xv[i][u] = (!plain && row) ? X[i * d + e] : T(0);
          fv[i][u] = row ? F[i * d + e] : T(0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = base + u * THREADS;
      if (e >= d) break;
      T out;
      if (plain) {
        T r = T(0);
#pragma unroll
        for (int i = 0; i < M; ++i)
          if (i == slot) r = fv[i][u];
        out = add_rn(zv[u], mul_rn(beta, r));
      } else {
        T sx = T(0), sf = T(0);
#pragma unroll
        for (int i = 0; i < M; ++i) {
          sx = mad(w[i], xv[i][u], sx);
          sf = mad(w[i], fv[i][u], sf);
        }
        out = add_rn(sx, mul_rn(beta, sf));
      }
      z_new[e] = out;
      const double step = static_cast<double>(out - zv[u]), zd = static_cast<double>(zv[u]);
      acc[0] = fma(step, step, acc[0]);
      acc[1] = fma(zd, zd, acc[1]);
    }
  }
  block_sum<2>(acc, partials + 2 * static_cast<long long>(blockIdx.x));
}

// (d) Every block sums the mix's partials in the same order and decides the
// stall alike; block 0 writes err and flags[1]; on a stall z_new = z.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    finish_kernel(const T* __restrict__ z, T* __restrict__ z_new, long long d,
                  const double* __restrict__ partials, int blocks, T stall_tol,
                  T* __restrict__ err, int* __restrict__ flags) {
  __shared__ double total[2];
  double v[2] = {0.0, 0.0};
  for (int b = threadIdx.x; b < blocks; b += THREADS) {
    v[0] += partials[2 * b];
    v[1] += partials[2 * b + 1];
  }
  block_sum<2>(v, total);
  __syncthreads();
  const T step = static_cast<T>(sqrt(total[0])), norm = static_cast<T>(sqrt(total[1]));
  const bool stall = step <= mul_rn(stall_tol, norm);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *err = stall ? T(0) : step / add_rn(norm, T(1e-8));
    flags[1] = stall;
  }
  if (!stall) return;
  for (long long e = blockIdx.x * THREADS + threadIdx.x; e < d;
       e += static_cast<long long>(gridDim.x) * THREADS)
    z_new[e] = z[e];
}

cudaError_t grid_blocks(int device, int* blocks) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *blocks = sms * BLOCKS_PER_SM;
  return err;
}

template <typename T, int M>
cudaError_t body(long long d, int it, T beta, double lam, T stall_tol, const T* z, const T* fz,
                 T* X, T* F, T* z_new, T* err, int* flags, double* scratch, int blocks,
                 cudaStream_t stream) {
  const int slot = it % M, count = it + 1 < M ? it + 1 : M;
  double* gram = scratch;
  double* norms = gram + static_cast<long long>(blocks) * MAX_TERMS;
  double* weights = norms + 2 * static_cast<long long>(blocks);
  cudaError_t e;
  push_gram_kernel<T, M><<<blocks, THREADS, 0, stream>>>(z, fz, X, F, d, slot, count, gram);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  solve_kernel<<<1, THREADS, 0, stream>>>(gram, blocks, M, it, count, lam, weights, flags);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mix_kernel<T, M><<<blocks, THREADS, 0, stream>>>(z, X, F, d, slot, count, beta, weights, flags,
                                                   z_new, norms);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  finish_kernel<T><<<blocks, THREADS, 0, stream>>>(z, z_new, d, norms, blocks, stall_tol, err,
                                                   flags);
  return cudaGetLastError();
}

template <typename T>
cudaError_t body_m(int m, long long d, int it, double beta, double lam, double stall_tol,
                   const void* z, const void* fz, void* X, void* F, void* z_new, void* err,
                   int* flags, double* scratch, int blocks, cudaStream_t stream) {
  const T b = static_cast<T>(beta), tol = static_cast<T>(stall_tol);
  const T* zp = static_cast<const T*>(z);
  const T* fp = static_cast<const T*>(fz);
  T *xp = static_cast<T*>(X), *hp = static_cast<T*>(F), *np = static_cast<T*>(z_new);
  T* ep = static_cast<T*>(err);
  switch (m) {
#define ANDERSON_CASE(MM) \
  case MM:                \
    return body<T, MM>(d, it, b, lam, tol, zp, fp, xp, hp, np, ep, flags, scratch, blocks, stream);
    ANDERSON_CASE(1) ANDERSON_CASE(2) ANDERSON_CASE(3) ANDERSON_CASE(4)
    ANDERSON_CASE(5) ANDERSON_CASE(6) ANDERSON_CASE(7) ANDERSON_CASE(8)
#undef ANDERSON_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace anderson

// The scratch one body needs on `device`, in doubles: each block's Gram and
// norm partials, and the weights.  Returns 0 or a cudaError_t.
extern "C" int anderson_scratch_doubles(int device, long long* n) {
  int blocks = 0;
  const cudaError_t err = anderson::grid_blocks(device, &blocks);
  if (err != cudaSuccess) return err;
  *n = static_cast<long long>(blocks) * (anderson::MAX_TERMS + 2) + anderson::MAX_M;
  return 0;
}

// One body on `stream` of `device` over z, fz [d] and the histories X, F [m, d]
// (contiguous; float64 where is_double, else float32): X, F updated in place,
// z_new [d], err [] and flags [2] (use_plain, stall) written; scratch holds
// anderson_scratch_doubles' count.  1 <= m <= 8, it >= 0, d >= 1.  Returns 0 or
// the cudaError_t of the refused arguments or launch.
extern "C" int anderson_body(int device, int is_double, long long d, int m, int it, double beta,
                             double lam, double stall_tol, const void* z, const void* fz, void* X,
                             void* F, void* z_new, void* err, int* flags, double* scratch,
                             void* stream) {
  if (d < 1 || m < 1 || m > anderson::MAX_M || it < 0 || z == nullptr || fz == nullptr ||
      X == nullptr || F == nullptr || z_new == nullptr || err == nullptr || flags == nullptr ||
      scratch == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  if ((e = anderson::grid_blocks(device, &blocks)) != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? anderson::body_m<double>(m, d, it, beta, lam, stall_tol, z, fz, X, F, z_new,
                                              err, flags, scratch, blocks, s)
                   : anderson::body_m<float>(m, d, it, beta, lam, stall_tol, z, fz, X, F, z_new,
                                             err, flags, scratch, blocks, s);
}

extern "C" const char* anderson_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
