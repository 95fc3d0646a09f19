// The joint-row tile that the stack kernels share (net_kernel.cuh: rows 1-3
// and row 9's spatial phase; train_kernel.cuh: rows 5-8): hid 96, 4 heads,
// 17 joints, one CTA owning TB = 4 samples, their 68 joint rows
// sample-major and padded to 72, and the float4 helpers of their stages.
// THREADS (9 warps) is the train kernels' and row 9's CTA; rows 1-3 run 12
// warps (net_kernel.cuh: NET_THREADS).
#pragma once

namespace netk {

constexpr int N_PTS = 17;
constexpr int HID = 96;
constexpr int HEADS = 4;
constexpr int DK = HID / HEADS;
constexpr int TB = 4;                                  // samples per CTA
constexpr int THREADS = 3 * HID;                       // 288 = 9 warps
constexpr int ROWS = TB * N_PTS;                       // 68
// The tensor-core products take the rows as 9 n8 tiles: the tile is padded
// to 72 rows.
constexpr int ROWS_PAD = (ROWS + 11) / 12 * 12;        // 72
constexpr int LDH = HID + 4;                           // row strides, in floats
constexpr int LDB = 3 * HID + 4;

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ldg4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
}
__device__ __forceinline__ void fma4(float4& acc, float s, float4 v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

}  // namespace netk
