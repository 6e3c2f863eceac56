// K6: the RG-LRU linear scan, hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rglru/kernel.py::rglru_scan_fwd (body
// _rglru_kernel). It computes what the plain rglru_scan_ref computes:
//   h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0 (or 0),
// for every batch row and channel r over t < S, in float32 from float32 or bfloat16
// inputs, and writes h (B, S, R) in float32.
//
// Design (simple and right first):
//   * the TPU grid (batch, R blocks, time chunks) runs its chunk axis in order with
//     the carry in VMEM scratch. Here one thread owns one (batch, channel) and loops
//     over time itself, the carry in a register. A block is 128 neighbouring
//     channels of one batch row, so each time step's loads and stores touch 128
//     neighbouring elements: coalesced;
//   * the loop takes 8 steps at a time: the 16 loads of a[t..t+7] and b[t..t+7] are
//     issued before their FMAs (nothing makes them wait on h), so only the FMA chain
//     is serial; the tail of S past the last multiple of 8 runs step by step;
//   * ragged S and R are masked here, with no padding: threads past R return;
//   * h = fmaf(a, h, b) rounds once where the plain version rounds the product and
//     the sum apart.
// What bounds it on this card: 2 FLOP per element against 12 bytes (a and b read, h
// written, float32), so bytes: at recurrentgemma-2b's prefill (4, 2048, 2560) that
// is 252 MB, 0.075 ms at 3.35 TB/s. But B * R = 10,240 threads are 80 blocks for 132
// SMs, and each thread runs a serial chain of 2048 dependent FMAs: it is bound by the
// latency of that chain, far from the bytes. A chunked parallel scan (chunk-local
// products and states, then a short scan over the chunk carries) is its next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels a block
constexpr int kUnroll = 8;      // time steps whose loads are issued together

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out, int S, int R) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const int row = blockIdx.y;
  const int64_t base = static_cast<int64_t>(row) * S * R + r;
  const T* ap = a + base;
  const T* bp = b + base;
  float* op = out + base;
  float h = h0 != nullptr ? h0[static_cast<int64_t>(row) * R + r] : 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t off = static_cast<int64_t>(t + k) * R;
      av[k] = to_float(ap[off]);
      bv[k] = to_float(bp[off]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      h = fmaf(av[k], h, bv[k]);
      op[static_cast<int64_t>(t + k) * R] = h;
    }
  }
  for (; t < S; ++t) {
    const int64_t off = static_cast<int64_t>(t) * R;
    h = fmaf(to_float(ap[off]), h, to_float(bp[off]));
    op[off] = h;
  }
}

template <typename T>
int launch(const void* a, const void* b, const float* h0, float* out, int B, int S, int R,
           cudaStream_t stream) {
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, out, S, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b: (B, S, R), contiguous, both float32 (bf16 = 0) or both bfloat16 (bf16 = 1);
// h0: (B, R) float32 or null (zeros); out: (B, S, R) float32. B <= 65535.
extern "C" int repro_rglru_scan_fwd(const void* a, const void* b, const void* h0, void* out,
                                    int B, int S, int R, int bf16, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(h0);
  float* o = static_cast<float*>(out);
  return bf16 ? launch<__nv_bfloat16>(a, b, h, o, B, S, R, st)
              : launch<float>(a, b, h, o, B, S, R, st);
}
