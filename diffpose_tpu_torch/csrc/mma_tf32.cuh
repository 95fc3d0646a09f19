// TF32 tensor-core products and asynchronous copies, in inline PTX, shared by
// every tensor-core kernel (tc_gemm.cuh, the ChebConv, the video kernels'
// attention and the attention probe).
//
//   to_tf32 / split : an f32 operand as TF32 parts, big = tf32(x) and
//                     small = tf32(x - big), rounded as cvt.rna.tf32.f32
//                     rounds (to nearest, ties away from zero);
//                     diffpose_tpu_torch/ops/tf32.py is the plain version;
//   to_bf16 / round_bf16 : x rounded to bf16 (to nearest, ties to even, as
//                     the TPU kernels' .astype(bfloat16) and torch's
//                     conversion round), exact in TF32;
//   operand<TIER>   : an operand of a one-pass product tier (Tier below);
//   mma             : d += A B for one m16n8k8 TF32 tile, f32 accumulation;
//   mma3            : d += A B at 3xTF32 from split operands, the three passes
//                     (small*big, big*small, big*big: the Hopper counterpart
//                     of the bf16x3 split of
//                     diffpose_tpu/ops/pallas_denoiser.py:_dot) into a fresh
//                     partial added to d in f32;
//   quad_max / quad_sum : over the 4 lanes of a quad (one accumulator row);
//   cp_async16 / cp_async_commit / cp_async_wait<N> : 16-byte global ->
//                     shared copies that bypass the registers (cp.async.cg),
//                     grouped, and the wait for this thread's older groups.
//
// Fragments of m16n8k8 .tf32 (PTX ISA), g = lane / 4, t = lane % 4:
//   a[i] at (row g + 8 * (i & 1), col t + 4 * (i >> 1)) of the 16 x 8 A;
//   b[i] at (row t + 4 * i, col g) of the 8 x 8 B;
//   d[i] at (row g + 8 * (i >> 1), col 2 * t + (i & 1)) of the 16 x 8 D.
#pragma once

#include <cstdint>

namespace tf32 {

// The arithmetic of a product, the kernels' TIER template argument (the
// counterparts of the TPU kernels' --kernel_precision, pallas_denoiser.py:_dot):
//   TIER_3XTF32  bf16x3, the parity grade: three TF32 passes on split operands;
//   TIER_BF16    bf16: operands rounded to bf16, one pass, f32 accumulation
//                (a bf16 value and the product of two are exact in TF32 and
//                f32, so the TF32 mma.sync gives bf16 mma.sync's products);
//   TIER_1XTF32  default: operands rounded to TF32, one pass.
constexpr int TIER_3XTF32 = 0, TIER_BF16 = 1, TIER_1XTF32 = 2;

// x rounded to TF32 as cvt.rna.tf32.f32 does it (round to nearest, ties away
// from zero; the same bits for every finite x), in two full-rate integer
// operations where the conversion instruction issues at a fraction of the rate.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// An operand as TF32 parts: big = tf32(x), small = tf32(x - big).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// x rounded to bf16 (to nearest, ties to even; the same bits for every finite x).
__device__ __forceinline__ uint32_t to_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}

__device__ __forceinline__ float round_bf16(float x) { return __uint_as_float(to_bf16(x)); }

// An operand of a one-pass tier's product, as the tensor cores read it.
template <int TIER>
__device__ __forceinline__ uint32_t operand(float x) {
  static_assert(TIER == TIER_BF16 || TIER == TIER_1XTF32, "a one-pass tier");
  if constexpr (TIER == TIER_BF16) return to_bf16(x);
  else return to_tf32(x);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// d += a b at 3xTF32 as a fresh partial: the small products, then the big one
// (ops/tf32.py:matmul_3xtf32's order).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma(part, as, bb);
  mma(part, ab, bs);
  mma(part, ab, bb);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += part[i];
}

// 16 bytes from global memory (16-byte aligned, read-only for the launch)
// to shared memory (16-byte aligned), asynchronously.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// All but the N most recent groups this thread committed have landed and
// are visible to it; other threads see them after a barrier.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32
