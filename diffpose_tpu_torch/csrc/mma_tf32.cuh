// TF32 tensor-core products and asynchronous copies, in inline PTX, shared by
// the attention probe (probe_attention.cu) and the train kernels
// (train_kernel.cuh).
//
//   to_tf32 / split : an f32 operand as TF32 parts, big = tf32(x) and
//                     small = tf32(x - big), rounded as cvt.rna.tf32.f32
//                     rounds (to nearest, ties away from zero);
//                     diffpose_tpu_torch/ops/tf32.py is the plain version;
//   mma             : d += A B for one m16n8k8 TF32 tile, f32 accumulation;
//   mma_f32<MODE>   : the same from f32 fragments, 1xTF32 (MODE 1) or 3xTF32
//                     (MODE 3: big*big + big*small + small*big, the Hopper
//                     counterpart of the bf16x3 split of
//                     diffpose_tpu/ops/pallas_denoiser.py:_dot);
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

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B for a 16x8 tile from f32 fragments (layouts above).
template <int MODE>
__device__ __forceinline__ void mma_f32(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  uint32_t ab[4], as[4], bb[2], bs[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ab[i], as[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split(b[i], bb[i], bs[i]);
  if constexpr (MODE == 3) {  // the small products first, then the big one
    mma(d, ab, bs);
    mma(d, as, bb);
  }
  mma(d, ab, bb);
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
