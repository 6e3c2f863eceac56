// K1: counter-based Poisson-burst background sampler, hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/traffic/kernel.py::sample_arrival_bits_tpu
// (body _traffic_kernel). Each (case, 64-cycle window, ONU) cell is a pure
// function of the stream key and the (window, onu) counter:
//   draw 0   threefry-2x32 -> 24-bit uniform -> burst count = #{j : u24 > T_j}
//            against the case's host-built Poisson(64*lambda) thresholds;
//   draw j   (1 <= j <= count) word 0's top 6 bits place burst j on a cycle of
//            the window, word 1 as a 24-bit uniform gives its geometric packet
//            count through the breakpoint table (never an in-kernel log1p: a
//            device log1p misses the reference table at one of 2^24 inputs).
// Output: the float64 arrival bits (B, n_cycles, n_onus), packets * packet_bits, the
// product the plain version forms, written by this kernel: a call is this one launch.
//
// What bounds it on this card: by the bound's count, writing the output once (8 bytes a
// (case, cycle, ONU)); the integer work (~120 ALU ops a threefry, one a cell and one a live
// burst, about a dozen bursts a cell at the Fig. 2b loads) at the card's 32-bit integer issue
// rate is of the same order, and at the main path's chunk shapes the launch itself is too.
// So the design keeps the device to the one launch, the output to one write and the integer
// work to the draws:
//   * a CTA owns a tile: one case, whole 64-cycle windows, an ONU span, at most kThreads
//     (window, ONU) cells. Its integer packet counts live in shared memory (64 rows a window,
//     32 KB at most) and bursts land there by shared-memory atomicAdd: the sum of integers is
//     exact in any order, so the stream stays bit-identical to the reference;
//   * bursts are spread over the CTA: a thread draws its cell's window count (draw 0), a
//     block-wide exclusive scan numbers the tile's bursts, and thread t takes bursts t,
//     t + kThreads, ..., each mapped to its (cell, j) by a binary search on the scan. Every
//     thread draws about as many threefry words, however skewed the counts are;
//   * the case's thresholds and the breakpoint table land in shared memory by cp.async while
//     the tile is zeroed and draw 0 is drawn; the count is a binary search of the thresholds,
//     a burst's length a walk of a step or two from a guessed run (threefry.cuh);
//   * once the tile is complete the CTA writes its rows inside [lo, lo + n_cycles) as float64,
//     coalesced, two values a 16-byte store where the row segments are aligned. Every output
//     element is written exactly once, zeros too, so the wrapper allocates with torch.empty
//     and launches nothing else (no memset, no cast, no multiply).
// The tiling (the span, the windows a tile, the grid, the shared bytes) is planned on the host,
// kernel.py::_launch_plan, whose tiles the CPU tests hold to cover the output exactly once; the
// layout of shared memory below follows its byte count.
// The draws themselves (threefry, burst count, burst length) live in threefry.cuh, shared
// with the fused phase kernel (ponsim_phase.cu), which samples the same stream a window at a
// time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 128;  // the most cells a tile holds: one a thread for draw 0
constexpr int kWarps = kThreads / 32;
constexpr int kSmemDefault = 48 * 1024;

// a 4-byte copy from global to shared memory that lands while the thread goes on
__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
traffic_kernel(const int64_t* __restrict__ keys, const int32_t* __restrict__ thresholds,
               const int32_t* __restrict__ bp_start, const int32_t* __restrict__ bp_len,
               double* __restrict__ out, double packet_bits, int n_draws, int n_bp,
               uint32_t win0, int lo, int n_win, int n_cycles, int n_onus, int span,
               int n_spans, int wpt, int n_wtiles) {
  // shared memory, in 4-byte words: the tile (wpt * 64 rows x span), the thresholds, the
  // breakpoint starts and lengths, each cell's first burst number and its (window, ONU) in
  // the tile, the warps' sums
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* tile = smem;
  int32_t* thr = tile + (wpt << kWindowShift) * span;
  int32_t* s_start = thr + n_draws;
  int32_t* s_len = s_start + n_bp;
  int32_t* first = s_len + n_bp;
  int32_t* cell_wo = first + kThreads;
  int32_t* warp_sum = cell_wo + kThreads;

  // tile t: ONU span fastest, then the window group, then the case (32-bit: the grid is)
  const unsigned t = blockIdx.x / static_cast<unsigned>(n_spans);
  const int si = static_cast<int>(blockIdx.x - t * static_cast<unsigned>(n_spans));
  const int b = static_cast<int>(t / static_cast<unsigned>(n_wtiles));
  const int w_first = (static_cast<int>(t) - b * n_wtiles) * wpt;
  const int n_w = min(wpt, n_win - w_first);   // windows in this tile
  const int o0 = si * span;
  const int width = min(span, n_onus - o0);    // ONUs in this tile
  const int n_cells = n_w * width;             // cell c: window c / width, ONU c % width
  const int n_words = (n_w << kWindowShift) * width;
  const int tid = threadIdx.x;

  // the tables land by cp.async while the tile is zeroed and draw 0 is drawn
  for (int i = tid; i < n_draws; i += kThreads)
    cp_async4(thr + i, thresholds + static_cast<int64_t>(b) * n_draws + i);
  for (int i = tid; i < n_bp; i += kThreads) {
    cp_async4(s_start + i, bp_start + i);
    cp_async4(s_len + i, bp_len + i);
  }
  int4* tile4 = reinterpret_cast<int4*>(tile);
  for (int i = tid; i < (n_words >> 2); i += kThreads) tile4[i] = make_int4(0, 0, 0, 0);
  for (int i = (n_words & ~3) + tid; i < n_words; i += kThreads) tile[i] = 0;

  const uint32_t k0 = static_cast<uint32_t>(keys[2 * b]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * b + 1]);
  uint32_t x0 = 0, x1;
  if (tid < n_cells) {
    const int wl = tid / width, o = tid - wl * width;
    cell_wo[tid] = (wl << 8) | o;
    threefry2x32(k0, k1, win0 + static_cast<uint32_t>(w_first + wl),
                 static_cast<uint32_t>(o0 + o), x0, x1);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int count =
      tid < n_cells ? burst_count_of(static_cast<int32_t>(x0 >> 8), thr, n_draws) : 0;

  // exclusive scan of the counts over the block: first[c] numbers cell c's first burst
  const int lane = tid & 31, warp = tid >> 5;
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int s = warp_sum[i];
    if (i < warp) base += s;
    total += s;
  }
  first[tid] = base + incl - count;
  __syncthreads();

  // burst n belongs to the last cell c with first[c] <= n (that cell's count is >= 1)
  const int r_base = (w_first << kWindowShift) - lo;  // output cycle of the tile's row 0
  for (int n = tid; n < total; n += kThreads) {
    int a = 0, z = n_cells;
    while (z - a > 1) {
      const int mid = (a + z) >> 1;
      if (first[mid] <= n) a = mid; else z = mid;
    }
    const int wl = cell_wo[a] >> 8, o = cell_wo[a] & 0xFF;
    uint32_t x0, x1;
    burst_draw(k0, k1, static_cast<uint32_t>(n - first[a] + 1),
               win0 + static_cast<uint32_t>(w_first + wl), static_cast<uint32_t>(o0 + o), x0,
               x1);
    const int row = (wl << kWindowShift) + static_cast<int>(x0 >> (32 - kWindowShift));
    const int cyc = r_base + row;
    if (cyc < 0 || cyc >= n_cycles) continue;
    atomicAdd(tile + row * width + o,
              burst_length_walk(static_cast<int32_t>(x1 >> 8), s_start, s_len, n_bp));
  }
  __syncthreads();

  // the rows inside [0, n_cycles), each to out[b, r_base + r, o0 .. o0 + width)
  const int r0 = max(0, -r_base);
  const int r1 = min(n_w << kWindowShift, n_cycles - r_base);
  const int n_el = (r1 - r0) * width;
  double* dst = out + (static_cast<int64_t>(b) * n_cycles + r_base + r0) * n_onus + o0;
  const int32_t* src = tile + r0 * width;
  // element e of the rows is (e / width, e % width); a thread steps e by a fixed stride, so
  // it divides once and then carries the row and column
  if (((n_onus | span) & 1) == 0) {
    // even rows and spans: every segment, and every pair in it, starts on 16 bytes
    const int step = 2 * kThreads, dr = step / width, dc = step - dr * width;
    int e = 2 * tid, r = e / width, c = e - r * width;
    for (; e < n_el; e += step) {
      const int2 v = *reinterpret_cast<const int2*>(src + e);
      *reinterpret_cast<double2*>(dst + static_cast<int64_t>(r) * n_onus + c) =
          make_double2(static_cast<double>(v.x) * packet_bits,
                       static_cast<double>(v.y) * packet_bits);
      r += dr;
      c += dc;
      if (c >= width) { c -= width; ++r; }
    }
  } else {
    const int dr = kThreads / width, dc = kThreads - dr * width;
    int e = tid, r = e / width, c = e - r * width;
    for (; e < n_el; e += kThreads) {
      dst[static_cast<int64_t>(r) * n_onus + c] = static_cast<double>(src[e]) * packet_bits;
      r += dr;
      c += dc;
      if (c >= width) { c -= width; ++r; }
    }
  }
}

}  // namespace

extern "C" int repro_traffic_sample(const void* keys, const void* thresholds,
                                    const void* bp_start, const void* bp_len, void* out,
                                    double packet_bits, int n_draws, int n_bp,
                                    unsigned int win0, int lo, int n_win, int n_cycles,
                                    int n_onus, int span, int n_spans, int wpt, int n_wtiles,
                                    long long n_tiles, long long smem_bytes, void* stream) {
  if (smem_bytes > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        traffic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  traffic_kernel<<<static_cast<unsigned>(n_tiles), kThreads, static_cast<size_t>(smem_bytes),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int32_t*>(thresholds),
      static_cast<const int32_t*>(bp_start), static_cast<const int32_t*>(bp_len),
      static_cast<double*>(out), packet_bits, n_draws, n_bp, win0, lo, n_win, n_cycles,
      n_onus, span, n_spans, wpt, n_wtiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
