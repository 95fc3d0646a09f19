// Per-sample P-MPJPE (Protocol #2) of 3-D poses in one launch, with a plain C
// interface for ctypes.  Built by diffpose_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
//
// Replaces no TPU kernel: the JAX metric (diffpose_tpu/metrics.py:
// procrustes_align, _quat_rotation_and_trace) is plain jnp, which XLA fuses on
// the TPU.  Run eagerly on this card, the same elementwise chain in PyTorch
// (diffpose_tpu_torch/metrics.py, the kernel's plain version) is some 600
// launches of tiny kernels over [N, 4, 4] tensors, whose enqueue outlasts the
// eval step's network kernels; this kernel computes the same function in one.
//
// Bound: bytes, 2·N·J·3·4 in and 4·N out (0.42 MB at N = 1,024, J = 17:
// 0.13 µs at 3.35 TB/s).  The operations, about 2 kFLOP a sample, are far
// under the FP32 peak.  So the kernel is latency-bound: one wave of small
// blocks and a few dependent passes over registers; what it saves is the
// launches' host time, not device bandwidth.
//
// Design: one warp a sample, WARPS warps a block (N = 1,024 gives 128 blocks,
// one wave on 132 SMs).  Lane l holds joints l, l + 32, ...; the sums (the two
// centroids, the two Frobenius norms of the centred sets, the nine entries of
// H = X0ᵀY0 of the centred, normalised sets) are xor-butterfly shuffles, which
// leave every lane the same bits.  Every lane then solves the 4x4 quaternion
// problem redundantly in registers (no divergence, no broadcast) with the
// plain version's float32 steps and constants: K and the traces p2, p3, p4,
// Newton on the quartic from √3‖H‖_F, the adjugate of K − (λ+δ)I, the probe
// and its rescue, 4 shifted power steps, λ = qᵀKq, R from q.  Each lane then
// aligns its joints (a = λ‖X0‖/‖Y0‖, t = μx − a·μy R) and a last butterfly sums
// the joint errors.  Sums run in another order than PyTorch's.
#include <cuda_runtime.h>

namespace procrustes {

constexpr int WARPS = 8;
constexpr int NEWTON_ITERS = 20;   // metrics.py:_quat_rotation_and_trace's defaults
constexpr int POLISH_ITERS = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The k-th (k = 0..2) of the indices 0..3 other than i.
__device__ __forceinline__ int other(int i, int k) { return k + (k >= i); }

// metrics.py:_det3: the 3x3 minor of `a` without row r and column c.
__device__ __forceinline__ float minor3(const float (&a)[4][4], int r, int c) {
  const int i0 = other(r, 0), i1 = other(r, 1), i2 = other(r, 2);
  const int j0 = other(c, 0), j1 = other(c, 1), j2 = other(c, 2);
  return a[i0][j0] * (a[i1][j1] * a[i2][j2] - a[i1][j2] * a[i2][j1]) -
         a[i0][j1] * (a[i1][j0] * a[i2][j2] - a[i1][j2] * a[i2][j0]) +
         a[i0][j2] * (a[i1][j0] * a[i2][j1] - a[i1][j1] * a[i2][j0]);
}

__device__ __forceinline__ void normalize4(float (&q)[4]) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + 1e-30f;
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

// metrics.py:_quat_rotation_and_trace for b = h: the proper rotation r (row
// convention) and λ_max.
__device__ __forceinline__ float quat_rotation(const float (&b)[3][3], float (&r)[3][3]) {
  const float b11 = b[0][0], b12 = b[0][1], b13 = b[0][2];
  const float b21 = b[1][0], b22 = b[1][1], b23 = b[1][2];
  const float b31 = b[2][0], b32 = b[2][1], b33 = b[2][2];
  const float k[4][4] = {
      {b11 + b22 + b33, b23 - b32, b31 - b13, b12 - b21},
      {b23 - b32, b11 - b22 - b33, b12 + b21, b31 + b13},
      {b31 - b13, b12 + b21, -b11 + b22 - b33, b23 + b32},
      {b12 - b21, b31 + b13, b23 + b32, -b11 - b22 + b33},
  };
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) ss += b[i][j] * b[i][j];
  const float fro = sqrtf(ss) + 1e-30f;

  float k2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < 4; ++l) s += k[i][l] * k[l][j];
      k2[i][j] = s;
    }
  float p2 = 0.f, p3 = 0.f, p4 = 0.f;   // tr(K²), tr(K³), tr(K⁴)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float d3 = 0.f, d4 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      d3 += k2[i][j] * k[j][i];
      d4 += k2[i][j] * k2[j][i];
    }
    p2 += k2[i][i];
    p3 += d3;
    p4 += d4;
  }
  const float c2 = -p2 / 2.0f, c1 = -p3 / 3.0f, c0 = p2 * p2 / 8.0f - p4 / 4.0f;

  float lam = 1.7320508075688772f * fro;   // ≥ λ_max, the monotone side
  for (int it = 0; it < NEWTON_ITERS; ++it) {
    const float lam2 = lam * lam;
    const float f = lam2 * lam2 + c2 * lam2 + c1 * lam + c0;
    const float df = 4.0f * lam2 * lam + 2.0f * c2 * lam + c1;
    lam = lam - f / fmaxf(df, 1e-30f);
  }

  // one exact-shift inverse-iteration step: q ∝ adj(K − (λ+δ)I) v0
  float a[4][4];
  const float shift = lam + 1e-6f * fro;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = i == j ? k[i][j] - shift : k[i][j];
  float adj[4][4], adj_ss = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float c = minor3(a, i, j);
      adj[j][i] = (i + j) % 2 ? -c : c;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) adj_ss += adj[i][j] * adj[i][j];
  const float v0[4] = {1.0f, 0.31f, 0.17f, 0.093f};
  const float v1[4] = {0.11f, -0.93f, 0.41f, 0.27f};   // the rescue probe (v0 ⊥ eigenvector)
  float q[4], q2[4], n1 = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s += adj[i][j] * v0[j];
      s2 += adj[i][j] * v1[j];
    }
    q[i] = s;
    q2[i] = s2;
    n1 += s * s;
  }
  if (!(n1 > 1e-12f * adj_ss)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = q2[i];
  }
  normalize4(q);

  // shifted power steps (0.6‖B‖_F > σ3 keeps λ_max dominant when det(B) < 0)
  const float sh = 0.6f * fro;
#pragma unroll
  for (int it = 0; it < POLISH_ITERS; ++it) {
    float nq[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s += (i == j ? k[i][j] + sh : k[i][j]) * q[j];
      nq[i] = s;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = nq[i];
    normalize4(q);
  }
  float lam_q = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) s += k[i][j] * q[j];
    lam_q += q[i] * s;
  }

  const float w = q[0], x = q[1], y = q[2], z = q[3];
  r[0][0] = 1 - 2 * (y * y + z * z);
  r[0][1] = 2 * (x * y - w * z);
  r[0][2] = 2 * (x * z + w * y);
  r[1][0] = 2 * (x * y + w * z);
  r[1][1] = 1 - 2 * (x * x + z * z);
  r[1][2] = 2 * (y * z - w * x);
  r[2][0] = 2 * (x * z - w * y);
  r[2][1] = 2 * (y * z + w * x);
  r[2][2] = 1 - 2 * (x * x + y * y);
  return lam_q;
}

// out[s] = mean over joints of ‖a·pred[s] R + t − target[s]‖ for samples s of
// pred, target [n, joints, 3]; one warp a sample.
__global__ void __launch_bounds__(WARPS * 32)
    p_mpjpe_kernel(const float* __restrict__ pred, const float* __restrict__ target,
                   float* __restrict__ out, int n, int joints) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= n) return;   // the whole warp leaves together
  const float* p = pred + static_cast<size_t>(s) * joints * 3;
  const float* x = target + static_cast<size_t>(s) * joints * 3;
  const float jf = static_cast<float>(joints);

  float mu_y[3] = {0.f, 0.f, 0.f}, mu_x[3] = {0.f, 0.f, 0.f};
  for (int j = lane; j < joints; j += 32)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      mu_y[c] += p[3 * j + c];
      mu_x[c] += x[3 * j + c];
    }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mu_y[c] = warp_sum(mu_y[c]) / jf;
    mu_x[c] = warp_sum(mu_x[c]) / jf;
  }

  float ssx = 0.f, ssy = 0.f;
  for (int j = lane; j < joints; j += 32)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float dx = x[3 * j + c] - mu_x[c], dy = p[3 * j + c] - mu_y[c];
      ssx += dx * dx;
      ssy += dy * dy;
    }
  const float norm_x = sqrtf(warp_sum(ssx)), norm_y = sqrtf(warp_sum(ssy));

  float h[3][3] = {};   // h = x0ᵀ y0 of the centred, normalised sets
  for (int j = lane; j < joints; j += 32) {
    float x0[3], y0[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x0[c] = (x[3 * j + c] - mu_x[c]) / norm_x;
      y0[c] = (p[3 * j + c] - mu_y[c]) / norm_y;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) h[i][k] += x0[i] * y0[k];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) h[i][k] = warp_sum(h[i][k]);

  float r[3][3];
  const float tr = quat_rotation(h, r);
  const float a = tr * norm_x / norm_y;
  float t[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    t[c] = mu_x[c] - a * (mu_y[0] * r[0][c] + mu_y[1] * r[1][c] + mu_y[2] * r[2][c]);

  float err = 0.f;
  for (int j = lane; j < joints; j += 32) {
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float pr = p[3 * j] * r[0][c] + p[3 * j + 1] * r[1][c] + p[3 * j + 2] * r[2][c];
      const float d = a * pr + t[c] - x[3 * j + c];
      ss += d * d;
    }
    err += sqrtf(ss);
  }
  err = warp_sum(err);
  if (lane == 0) out[s] = err / jf;
}

}  // namespace procrustes

// out [n] = per-sample P-MPJPE of pred, target [n, joints, 3] (float32,
// contiguous), on `stream` (a cudaStream_t) of `device`.  Takes any n >= 0 and
// joints >= 1.  Returns 0 or the cudaError_t of the refused arguments or launch.
extern "C" int p_mpjpe_forward(int device, int n, int joints, const float* pred,
                               const float* target, float* out, void* stream) {
  if (n < 0 || joints < 1 || pred == nullptr || target == nullptr || out == nullptr)
    return cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int blocks = (n + procrustes::WARPS - 1) / procrustes::WARPS;
  procrustes::p_mpjpe_kernel<<<blocks, procrustes::WARPS * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(pred, target, out, n, joints);
  return cudaGetLastError();
}

extern "C" const char* p_mpjpe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
