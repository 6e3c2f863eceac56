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

// The same count from draw 0's 24-bit uniform by a binary search, in log2(n_draws) steps
// whatever the count: the thresholds are non-decreasing, so the first j with u24 <= thr[j]
// (n_draws if none) is their lower bound (the plain version's searchsorted, side="left").
__device__ __forceinline__ int burst_count_of(int32_t u24, const int32_t* thr, int n_draws) {
  int a = 0, z = n_draws;
  while (a < z) {
    const int mid = (a + z) >> 1;
    if (thr[mid] < u24) a = mid + 1; else z = mid;
  }
  return a;
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

// The same packet count by a walk from a guessed run: from any a in [0, n_bp) the walk ends
// on the largest a with start[a] <= g24 (the starts increase, start[0] is 0), so the result
// is burst_length's whatever the guess. The guess inverts the geometric(1/16) CDF that the
// repo's one table holds, start[a] ~ 2^24 (1 - (15/16)^a), so the walk is a step or two where
// a binary search reads the table eight times.
__device__ __forceinline__ int32_t burst_length_walk(int32_t g24, const int32_t* start,
                                                     const int32_t* len, int n_bp) {
  constexpr float kInvLog2Q = -10.740053f;  // 1 / log2(15/16)
  const float tail = 1.0f - (static_cast<float>(g24) + 0.5f) * (1.0f / 16777216.0f);
  // clamped as a float: log2(0) is -inf, and fmaxf takes 0 over a NaN
  int a = static_cast<int>(fminf(fmaxf(__log2f(tail) * kInvLog2Q, 0.0f),
                                 static_cast<float>(n_bp - 1)));
  while (a > 0 && start[a] > g24) --a;
  while (a + 1 < n_bp && start[a + 1] <= g24) ++a;
  return len[a];
}

}  // namespace
