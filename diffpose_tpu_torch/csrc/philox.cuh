// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
// SC'11), written out: a counter-based generator, so a dropout decision is a
// pure function of (key, counter) and the backward kernel regenerates the
// forward's bits without any state.
//
// Dropout keying, shared by train_kernel.cuh and its plain version
// diffpose_tpu_torch/ops/philox.py (the two agree bit for bit):
//
//   key     = (step seed as uint32, layer * 8 + stream)
//   counter = (group, global sample index, 0, 0)
//
//   stream 0, attention probabilities [heads, 17 queries, 17 keys] of a sample:
//     group = ((head * 17 + query) << 3) + j, j = 0..4; word i of that call
//     decides key 4*j + i (the words past key 16 are dropped);
//   streams 1..4, the sites attn_out, gnet_out, cheb1, cheb2 [17, HID] of a
//     sample: group = joint * (HID / 4) + column / 4; word i decides column
//     4 * (column / 4) + i;
//
//   keep = (word >> 9) < thresh, thresh = ceil(keep_probability * 2^23):
//   the test (word >> 9) * 2^-23 < keep_probability in integers.
//
// Nothing depends on the tile, so any tile size and a ragged last tile draw
// the same masks.
#pragma once

namespace philox {

constexpr unsigned M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;   // round multipliers
constexpr unsigned W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;   // Weyl key increments
constexpr int STREAMS = 8;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const unsigned hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += W0;
    k1 += W1;
  }
  return c;
}

// The four keep decisions of one call as bits 0..3.
__device__ __forceinline__ unsigned keep4(uint4 w, unsigned thresh) {
  return ((w.x >> 9) < thresh ? 1u : 0u) | ((w.y >> 9) < thresh ? 2u : 0u) |
         ((w.z >> 9) < thresh ? 4u : 0u) | ((w.w >> 9) < thresh ? 8u : 0u);
}

}  // namespace philox
