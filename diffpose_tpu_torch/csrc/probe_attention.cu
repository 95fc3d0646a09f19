// Capability probe (kernel row 12): batched attention o[t] = softmax(q[t] k[t]^T) v[t]
// for q, k, v [T, F, 24], no 1/sqrt(dk) scale, with both products on the
// tensor cores: mma.sync.aligned.m16n8k8 TF32 in inline PTX, f32 accumulation.
// Counterpart of scripts/probe_batched_dot.py:kernel (which asked whether
// Mosaic lowers a batched dot_general); this one asks what error TF32 tensor
// cores give at the video family's temporal shapes:
//   MODE 1 (1xTF32): a * b with both operands rounded to TF32, accumulated
//                    over the whole reduction;
//   MODE 3 (3xTF32): each operand split as big = tf32(x), small = tf32(x - big),
//                    and small*big + big*small + big*big into a fresh partial
//                    each k-step of 8, added in f32 (mma_tf32.cuh: mma3;
//                    ops/tf32.py:matmul_3xtf32).
// The softmax is f32.  Nothing on a main path calls this.
//
// Bound on the H100: at T = 1088, F = 81 the bytes (q, k and v read and o
// written once, 34 MB: 0.0101 ms at 3.35 TB/s; the 3xTF32 products at the
// TF32 peak take 0.0055 ms).  Design: a persistent grid, as many CTAs as fit
// on the SMs (two an SM at F = 81); CTA c takes rows c, c + grid, ..., one
// warp a task of 16 queries of the row (F <= 96: up to 6 warps).  A row's Q,
// K and V are staged by cp.async into one of two slots in shared memory, the
// next row's while this one computes, and K and V are split into their TF32
// parts once, in place, by the threads that copied them; each warp splits
// its Q fragments once.  A warp keeps its 16 x F score strip in registers
// (accumulator layout) and takes the softmax there (a row's entries in the 4
// lanes of a quad); the unnormalised probabilities go to P V as the A
// operand straight from the accumulators: column t (t + 4) of key tile j is
// key 8 j + 2 t (+ 1), and V's B rows follow that order (mma.sync's sum does
// not depend on the order of its 8 products).  The exponentials are exp2f of
// one FMA each (accurate expf took a quarter of the time); the output is
// multiplied by the reciprocal of the row sum at the end
// (probes/batched_dot.py:attention_model is this order in plain PyTorch).  Plain C interface for ctypes, built by
// diffpose_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "mma_tf32.cuh"

namespace probe_attn {

constexpr int DK = 24;
constexpr int MAX_F = 96;
constexpr int MAX_WARPS = MAX_F / 16;        // query tiles of 16
constexpr int MAX_NT = MAX_F / 8;            // key tiles of 8
constexpr int LDQ = DK + 4;                  // row strides in shared memory, floats
constexpr int PIECES = DK / 4;               // 16-byte pieces a row
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int query_rows(int frames) { return 16 * ((frames + 15) / 16); }
__host__ __device__ constexpr int key_rows(int frames) { return 8 * ((frames + 7) / 8); }

// One slot: Q [query rows], then K and V, each as big and small parts [key rows].
__host__ __device__ constexpr int slot_floats(int frames) {
  return LDQ * (query_rows(frames) + 4 * key_rows(frames));
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// Row `row`'s q, k and v into a slot, 16 bytes a piece; the padded rows are
// never written.
__device__ __forceinline__ void stage_row(const float* __restrict__ q, const float* __restrict__ k,
                                          const float* __restrict__ v, int row, int frames,
                                          float* slot, int tid, int nthreads) {
  float* qs = slot;
  float* kb = qs + query_rows(frames) * LDQ;
  float* vb = kb + 2 * key_rows(frames) * LDQ;
  const size_t base = static_cast<size_t>(row) * frames * DK;
  for (int i = tid; i < frames * PIECES; i += nthreads) {
    const int r = i / PIECES, c = 4 * (i % PIECES);
    const size_t src = base + r * DK + c;
    tf32::cp_async16(qs + r * LDQ + c, q + src);
    tf32::cp_async16(kb + r * LDQ + c, k + src);
    tf32::cp_async16(vb + r * LDQ + c, v + src);
  }
}

// After the wait: the K and V pieces this thread copied as TF32 parts, big
// in place and (MODE 3) small key_rows further on.
template <int MODE>
__device__ __forceinline__ void split_row(int frames, float* slot, int tid, int nthreads) {
  const int krows = key_rows(frames);
  float* kb = slot + query_rows(frames) * LDQ;
  for (int i = tid; i < frames * PIECES; i += nthreads) {
    const int off = (i / PIECES) * LDQ + 4 * (i % PIECES);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float* p = kb + 2 * m * krows * LDQ + off;
      const float4 x = ld4(p);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      float big[4], small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t b, s;
        tf32::split(xs[e], b, s);
        big[e] = __uint_as_float(b);
        small[e] = __uint_as_float(s);
      }
      st4(p, make_float4(big[0], big[1], big[2], big[3]));
      if constexpr (MODE == 3) st4(p + krows * LDQ, make_float4(small[0], small[1], small[2], small[3]));
    }
  }
}

// d += A B: MODE 3 from the split parts, MODE 1 from the big parts alone.
template <int MODE>
__device__ __forceinline__ void mma_mode(float (&d)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                         const uint32_t (&bb)[2], const uint32_t (&bs)[2]) {
  if constexpr (MODE == 3)
    tf32::mma3(d, ab, as, bb, bs);
  else
    tf32::mma(d, ab, bb);
}

// One task: queries q0 .. q0 + 15 of the row in `slot`, by one warp.
template <int MODE>
__device__ __forceinline__ void attend(const float* slot, float* __restrict__ o, int row,
                                       int frames, int q0, int lane) {
  const int g = lane >> 2, t = lane & 3, ktiles = (frames + 7) / 8, krows = key_rows(frames);
  const float* qs = slot;
  const float* kb = qs + query_rows(frames) * LDQ;
  const float* ks = kb + krows * LDQ;
  const float* vb = ks + krows * LDQ;
  const float* vs = vb + krows * LDQ;

  // Q fragments (A operand, 16 queries x DK), split once
  uint32_t qb[DK / 8][4], qsm[DK / 8][4];
#pragma unroll
  for (int kk = 0; kk < DK / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tf32::split(qs[(q0 + g + 8 * (i & 1)) * LDQ + 8 * kk + t + 4 * (i >> 1)], qb[kk][i], qsm[kk][i]);

  // S = Q K^T against every key tile; B fragment i of k-step kk is K[8 j + g][8 kk + t + 4 i]
  float s[MAX_NT][4];
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    if (j >= ktiles) continue;
#pragma unroll
    for (int kk = 0; kk < DK / 8; ++kk) {
      const int off = (8 * j + g) * LDQ + 8 * kk + t;
      const uint32_t bb[2] = {__float_as_uint(kb[off]), __float_as_uint(kb[off + 4])};
      uint32_t bs[2] = {0u, 0u};
      if constexpr (MODE == 3) bs[0] = __float_as_uint(ks[off]), bs[1] = __float_as_uint(ks[off + 4]);
      mma_mode<MODE>(s[j], qb[kk], qsm[kk], bb, bs);
    }
  }
  // softmax numerators over the real keys: rows g (entries 0, 1) and g + 8
  // (2, 3), key 8 j + 2 t + (i & 1); padded keys get 0
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (j < ktiles && 8 * j + 2 * t + (i & 1) < frames) mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
  // exp(s - max) as exp2f(s log2(e) - max log2(e)): one FMA and one MUFU.EX2
  const float nm[2] = {-tf32::quad_max(mx[0]) * LOG2E, -tf32::quad_max(mx[1]) * LOG2E};
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool real = j < ktiles && 8 * j + 2 * t + (i & 1) < frames;
      s[j][i] = real ? exp2f(fmaf(s[j][i], LOG2E, nm[i >> 1])) : 0.f;
      l[i >> 1] += s[j][i];
    }
  // O = P V over the key tiles: A column t (t + 4) of tile j is key 8 j + 2 t (+ 1)
  float acc[DK / 8][4] = {};
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j) {
    if (j >= ktiles) continue;
    uint32_t pb[4], ps[4];
    tf32::split(s[j][0], pb[0], ps[0]);
    tf32::split(s[j][2], pb[1], ps[1]);
    tf32::split(s[j][1], pb[2], ps[2]);
    tf32::split(s[j][3], pb[3], ps[3]);
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      const int off = (8 * j + 2 * t) * LDQ + 8 * n + g;
      const uint32_t bb[2] = {__float_as_uint(vb[off]), __float_as_uint(vb[off + LDQ])};
      uint32_t bs[2] = {0u, 0u};
      if constexpr (MODE == 3) bs[0] = __float_as_uint(vs[off]), bs[1] = __float_as_uint(vs[off + LDQ]);
      mma_mode<MODE>(acc[n], pb, ps, bb, bs);
    }
  }
  const float inv[2] = {1.f / tf32::quad_sum(l[0]), 1.f / tf32::quad_sum(l[1])};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = q0 + g + 8 * h;
    if (qr >= frames) continue;
    float* dst = o + (static_cast<size_t>(row) * frames + qr) * DK + 2 * t;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc[n][2 * h] * inv[h], acc[n][2 * h + 1] * inv[h]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(32 * MAX_WARPS, 2) attention_kernel(const float* __restrict__ q,
                                                                       const float* __restrict__ k,
                                                                       const float* __restrict__ v,
                                                                       float* __restrict__ o,
                                                                       int rows, int frames) {
  extern __shared__ float4 smem4[];
  float* slots = reinterpret_cast<float*>(smem4);
  const int sf = slot_floats(frames), tid = threadIdx.x, nthreads = blockDim.x;
  // the padded rows of both slots stay zero
  for (int i = 4 * tid; i < 2 * sf; i += 4 * nthreads) st4(slots + i, make_float4(0.f, 0.f, 0.f, 0.f));
  __syncthreads();
  int row = blockIdx.x;
  if (row < rows) stage_row(q, k, v, row, frames, slots, tid, nthreads);
  tf32::cp_async_commit();
  for (int it = 0; row < rows; ++it, row += gridDim.x) {
    float* slot = slots + (it & 1) * sf;
    tf32::cp_async_wait<0>();            // this row has landed (this thread's pieces)
    split_row<MODE>(frames, slot, tid, nthreads);
    __syncthreads();                     // the row is split; the other slot's row is done
    if (row + gridDim.x < rows)
      stage_row(q, k, v, row + gridDim.x, frames, slots + ((it + 1) & 1) * sf, tid, nthreads);
    tf32::cp_async_commit();
    attend<MODE>(slot, o, row, frames, 16 * (tid >> 5), tid & 31);
  }
  tf32::cp_async_wait<0>();
}

struct Launch {
  int threads, smem, per_sm, grid;
};

// The persistent grid of a launch: as many CTAs as fit on every SM, at most
// one a row.
template <int MODE>
cudaError_t plan(int device, int rows, int frames, Launch& l) {
  l.threads = 32 * ((frames + 15) / 16);
  l.smem = static_cast<int>(sizeof(float)) * 2 * slot_floats(frames);
  int sms = 0;
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&l.per_sm, attention_kernel<MODE>,
                                                        l.threads, l.smem);
  l.grid = std::min(rows, std::max(1, l.per_sm) * sms);
  return err;
}

template <int MODE>
cudaError_t launch(int device, int rows, int frames, const float* q, const float* k,
                   const float* v, float* o, cudaStream_t stream) {
  Launch l;
  const cudaError_t err = plan<MODE>(device, rows, frames, l);
  if (err != cudaSuccess) return err;
  attention_kernel<MODE><<<l.grid, l.threads, l.smem, stream>>>(q, k, v, o, rows, frames);
  return cudaGetLastError();
}

}  // namespace probe_attn

// o [T, F, 24] = softmax(q k^T) v per row for q, k, v [T, F, 24], F <= 96;
// mode 1 (1xTF32) or 3 (3xTF32).  Returns 0 or the cudaError_t.
extern "C" int probe_attention(int device, int mode, int rows, int frames, int dk, const float* q,
                               const float* k, const float* v, float* o, void* stream) {
  if (rows < 1 || frames < 1 || frames > probe_attn::MAX_F || dk != probe_attn::DK ||
      q == nullptr || k == nullptr || v == nullptr || o == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == 1) return probe_attn::launch<1>(device, rows, frames, q, k, v, o, s);
  if (mode == 3) return probe_attn::launch<3>(device, rows, frames, q, k, v, o, s);
  return cudaErrorInvalidValue;
}

// CTAs an SM and CTAs of the launch probe_attention makes for `rows` x
// `frames` in `mode` on `device`, into out[0], out[1]; returns 0 or the
// cudaError_t.
extern "C" int probe_attention_grid(int device, int mode, int rows, int frames, int* out) {
  if (rows < 1 || frames < 1 || frames > probe_attn::MAX_F || out == nullptr ||
      (mode != 1 && mode != 3))
    return cudaErrorInvalidValue;
  probe_attn::Launch l;
  const cudaError_t err = mode == 1 ? probe_attn::plan<1>(device, rows, frames, l)
                                    : probe_attn::plan<3>(device, rows, frames, l);
  out[0] = l.per_sm;
  out[1] = l.grid;
  return err;
}

extern "C" const char* probe_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
