// K2's waterfill as device functions, shared by the standalone K2 kernel (waterfill.cu)
// and the fused phase kernel (ponsim_phase.cu), which pours the background's hard rows and
// the general path's FL grants with them. One block pours one row: a stable bitonic sort of
// (key image, index) pairs, then warp 0's serial float64 prefix in rank order, left to right
// as np.cumsum adds, so that both kernels equal the host engine's _waterfill bit for bit.
// Every function here is internal to each translation unit that includes it.
#pragma once

#include <stdint.h>

namespace {

constexpr double kCapEps = 1e-9;
constexpr size_t kPairBytes = sizeof(uint64_t) + sizeof(int);

// The order-preserving image of a float64 key (not NaN); -0.0 maps as +0.0,
// since the two compare equal.
__device__ __forceinline__ uint64_t sort_image(double key) {
  const uint64_t bits = static_cast<uint64_t>(__double_as_longlong(key + 0.0));
  return (bits >> 63) ? ~bits : bits | 0x8000000000000000ull;
}

// (image, index) pairs: a after b?
__device__ __forceinline__ bool greater(uint64_t ka, int ia, uint64_t kb, int ib) {
  return ka > kb || (ka == kb && ia > ib);
}

// One bitonic stage on an element held in registers at position p, against its
// partner at p ^ j held by lane ^ j (j < 32).
__device__ __forceinline__ void exchange_lanes(uint64_t& key, int& idx, int p, int j, int k) {
  const uint64_t pk = __shfl_xor_sync(0xffffffffu, key, j);
  const int pi = __shfl_xor_sync(0xffffffffu, idx, j);
  const bool keep_min = ((p & j) == 0) == ((p & k) == 0);
  if (greater(key, idx, pk, pi) == keep_min) {
    key = pk;
    idx = pi;
  }
}

// The merges k_lo..k_hi (powers of two, 2 <= k_lo <= k_hi <= n_pad), each only
// over its stages j <= 32, in registers: warp w takes the 64-element segments
// w, w + warps, ...; lane holds positions seg + lane and seg + lane + 32.
__device__ void sort_in_registers(uint64_t* s_key, int* s_idx, int n_pad, int k_lo, int k_hi) {
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int seg = (threadIdx.x / 32) * 64; seg < n_pad; seg += n_warps * 64) {
    const int p0 = seg + lane, p1 = p0 + 32;
    uint64_t k0 = s_key[p0], k1 = s_key[p1];
    int i0 = s_idx[p0], i1 = s_idx[p1];
    for (int k = k_lo; k <= k_hi; k <<= 1) {
      int j = k >> 1;
      if (k >= 64) {
        // the stage j == 32 pairs this lane's own two elements (a merge past
        // 64 ran its stages j >= 64 in shared memory)
        if (greater(k0, i0, k1, i1) == ((p0 & k) == 0)) {
          const uint64_t tk = k0;
          const int ti = i0;
          k0 = k1;
          i0 = i1;
          k1 = tk;
          i1 = ti;
        }
        j = 16;
      }
      for (; j > 0; j >>= 1) {
        exchange_lanes(k0, i0, p0, j, k);
        exchange_lanes(k1, i1, p1, j, k);
      }
    }
    s_key[p0] = k0;
    s_key[p1] = k1;
    s_idx[p0] = i0;
    s_idx[p1] = i1;
  }
}

// Grants of one row of n queues into g_row: stable (key(i), i) order, each queue granted
// min(backlog, room) with room = cap - (water poured ahead of it), nothing once room <= 1e-9.
// Every thread of the block calls it; `base` holds 12 * n_pad bytes (n_pad: n rounded up to
// a power of two), in shared memory or global scratch, and is free again once the block
// has passed a barrier after the call. `key(i)` returns queue i's float64 key (not NaN).
template <class Key>
__device__ __forceinline__ void waterfill_row(const double* __restrict__ b_row, Key key, double cap,
                              double* __restrict__ g_row, int n, int n_pad,
                              unsigned char* base) {
  const int tid = threadIdx.x;
  uint64_t* s_key = reinterpret_cast<uint64_t*>(base);  // images, then b and g
  int* s_idx = reinterpret_cast<int*>(s_key + n_pad);   // queue index
  for (int i = tid; i < n_pad; i += blockDim.x) {
    s_key[i] = i < n ? sort_image(key(i)) : ~0ull;
    s_idx[i] = i;
  }
  __syncthreads();
  // bitonic sort of (image, index), ascending. Stages whose pairs lie 64 or
  // more apart go through shared memory, one barrier each; the others run in
  // registers, a warp a 64-element segment (lane and lane + 32), partners by
  // shuffle, all of a merge's short stages (all merges up to 64 at once) in
  // one pass
  const bool in_regs = n_pad >= 64;
  if (in_regs) {
    sort_in_registers(s_key, s_idx, n_pad, 2, 64);
    __syncthreads();
  }
  for (int k = in_regs ? 128 : 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j >= (in_regs ? 64 : 1); j >>= 1) {
      for (int t = tid; t < n_pad / 2; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i + j;
        const uint64_t ki = s_key[i], kl = s_key[l];
        const int ii = s_idx[i], il = s_idx[l];
        if (greater(ki, ii, kl, il) == ((i & k) == 0)) {
          s_key[i] = kl;
          s_key[l] = ki;
          s_idx[i] = il;
          s_idx[l] = ii;
        }
      }
      __syncthreads();
    }
    if (in_regs) {
      sort_in_registers(s_key, s_idx, n_pad, k, k);
      __syncthreads();
    }
  }

  double* s_b = reinterpret_cast<double*>(s_key);       // backlog in rank order
  for (int q = tid; q < n; q += blockDim.x) s_b[q] = b_row[s_idx[q]];
  __syncthreads();

  if (tid < 32) {
    const double c = cap;
    double acc = -0.0;                                   // -0.0 + x == x
    for (int q0 = 0; q0 < n; q0 += 32) {
      const int m = min(32, n - q0);
      double mine = 0.0;
#pragma unroll
      for (int half = 0; half < 32; half += 16) {   // 16 loads ahead of 16 adds
        double chunk[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) chunk[j] = half + j < m ? s_b[q0 + half + j] : 0.0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {   // past m: + 0.0 after the row's last add
          acc += chunk[j];
          if (tid == half + j) mine = acc;
        }
      }
      if (tid < m) {
        const double bq = s_b[q0 + tid];
        const double room = c - (mine - bq);
        s_b[q0 + tid] = room > kCapEps ? fmin(bq, room) : 0.0;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int q = tid; q < n; q += blockDim.x) g_row[s_idx[q]] = s_b[q];
}


}  // namespace
