// The counter-based Poisson-burst stream's device functions, shared by K1's standalone
// sampler (traffic.cu) and the fused phase kernel (ponsim_phase.cu), so that both draw the
// same bits: 20-round threefry-2x32, the per-draw Weyl key, the window burst count against
// the host-built Poisson thresholds and the burst length from the breakpoint table (never an
// in-kernel log1p: a device log1p misses the reference table at one of 2^24 inputs). Every
// function here is internal to each translation unit that includes it.
#pragma once

#include <stdint.h>

namespace {

constexpr uint32_t kC240 = 0x1BD11BDAu;
constexpr uint32_t kWeyl0 = 0x9E3779B9u;
constexpr uint32_t kWeyl1 = 0x85EBCA6Bu;
constexpr int kWindowShift = 6;  // 64 cycles a sampling window

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                             uint32_t c1, uint32_t& o0,
                                             uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kC240};
  const int rots[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl(x1, rots[block & 1][i]);
      x1 ^= x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + static_cast<uint32_t>(block + 1);
  }
  o0 = x0;
  o1 = x1;
}

// Draw d (>= 1) of the stream keyed (k0, k1) at counter (c0, c1): the key's words
// Weyl-incremented by d.
__device__ __forceinline__ void burst_draw(uint32_t k0, uint32_t k1, uint32_t d, uint32_t c0,
                                           uint32_t c1, uint32_t& o0, uint32_t& o1) {
  threefry2x32(k0 + d * kWeyl0, k1 ^ (d * kWeyl1), c0, c1, o0, o1);
}

// The window's burst count: draw 0's top 24 bits against the non-decreasing thresholds,
// #{j : u24 > thr[j]}, i.e. the first j with u24 <= thr[j].
__device__ __forceinline__ int burst_count(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                                           const int32_t* thr, int n_draws) {
  uint32_t x0, x1;
  threefry2x32(k0, k1, c0, c1, x0, x1);
  const int32_t u24 = static_cast<int32_t>(x0 >> 8);
  int count = 0;
  while (count < n_draws && u24 > thr[count]) ++count;
  return count;
}

// A burst's packet count: the run of the breakpoint table that holds the 24-bit uniform
// g24, i.e. the largest a with start[a] <= g24.
__device__ __forceinline__ int32_t burst_length(int32_t g24, const int32_t* start,
                                                const int32_t* len, int n_bp) {
  int a = 0, z = n_bp;
  while (z - a > 1) {
    const int mid = (a + z) >> 1;
    if (start[mid] <= g24) a = mid; else z = mid;
  }
  return len[a];
}

}  // namespace
