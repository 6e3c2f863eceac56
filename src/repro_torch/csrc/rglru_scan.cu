// K6: the RG-LRU linear scan, hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rglru/kernel.py::rglru_scan_fwd (body
// _rglru_kernel, kernel.py:69). It computes what the plain rglru_scan_ref computes:
//   h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0 (or 0),
// for every batch row and channel r over t < S, in float32 from float32 or bfloat16
// inputs, and writes h (B, S, R) in float32.
//
// What bounds it on this card: 2 FLOP an element against 12 bytes (a and b read, h
// written, float32), so bytes: at recurrentgemma-2b's prefill (4, 2048, 2560) that is
// 252 MB, 0.075 ms at 3.35 TB/s. To reach that rate the card needs several MB in flight;
// one thread a channel walking all of S (80 CTAs for 132 SMs, a few loads each in flight)
// is bound by the latency of memory instead.
//
// Design: a chunked scan, with a and b read once and h written once.
//   * A CTA takes one batch row and kC = 32 neighbouring channels (128 bytes of a
//     float32 time step: whole lines) and walks S in windows of kW = 64 steps. The
//     windows' a and b tiles come into a ring of kStages = 2 shared-memory stages by
//     cp.async (16 bytes a copy, zero-filled past S and R): the next window's 16 KB are
//     in flight while the CTA scans this one. At ~35 KB and 256 threads a CTA, the
//     prefill's 320 CTAs are all resident at once on 132 SMs, ~5 MB in flight in all.
//   * Within a window, thread (chunk j, channel c) takes kL = 8 steps. It forms its
//     chunk's pair (A, B) = (prod a, the scan from h = 0); warp 0 combines the pairs in
//     order, h_in(j + 1) = A_j * h_in(j) + B_j from the carry that enters the window;
//     then every chunk rescans its steps from h_in(j) with h = fmaf(a, h, b) and writes
//     h. The window's last h is the carry into the next one. So rounding differs from
//     the serial chain only where a chunk's h_in enters through a product of a's
//     (tests/test_torch_rglru.py emulates this order on the CPU: ~1e-6 of the largest
//     |h| for decays in [0.99, 0.9999] over 2048 steps).
//   * Where R * sizeof(T) is not a multiple of 16 or a or b is not 16-byte aligned, the
//     tiles are loaded element by element instead (the same scan; ragged test shapes).
//   * ragged S and R are masked here, with no padding.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;              // channels a CTA
constexpr int kL = 8;               // steps a chunk
constexpr int kNC = 8;              // chunks a window
constexpr int kW = kL * kNC;        // steps a window
constexpr int kStages = 2;          // windows in the shared-memory ring
constexpr int kThreads = kC * kNC;  // thread (chunk j, channel c) = j * kC + c

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
struct Smem {
  T a[kStages][kW][kC];
  T b[kStages][kW][kC];
  float pa[kNC][kC];   // each chunk's product of a
  float pb[kNC][kC];   // each chunk's scan from 0
  float hin[kNC][kC];  // the h entering each chunk
  float carry[kC];     // the h entering the window
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or 16 zero bytes where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// steps [t0, t0 + kW) of channels [r0, r0 + kC) of one row (at `a`, `b`) into stage s;
// zeros past S and R. kAsync: 16-byte cp.async copies (R * sizeof(T) % 16 == 0, aligned
// pointers); else element by element
template <typename T, bool kAsync>
__device__ __forceinline__ void load_window(Smem<T>& sm, int s, const T* a, const T* b, int t0,
                                            int r0, int S, int R) {
  if (kAsync) {
    constexpr int kE = 16 / sizeof(T);  // elements a copy
    constexpr int kP = kC / kE;         // copies a step
    for (int i = threadIdx.x; i < kW * kP; i += kThreads) {
      const int t = i / kP, r = (i % kP) * kE;
      const bool valid = t0 + t < S && r0 + r < R;
      const int64_t off = valid ? static_cast<int64_t>(t0 + t) * R + r0 + r : 0;
      cp_async16(&sm.a[s][t][r], a + off, valid);
      cp_async16(&sm.b[s][t][r], b + off, valid);
    }
  } else {
    const T zero = T(0.f);
    for (int i = threadIdx.x; i < kW * kC; i += kThreads) {
      const int t = i / kC, r = i % kC;
      const bool valid = t0 + t < S && r0 + r < R;
      const int64_t off = static_cast<int64_t>(t0 + t) * R + r0 + r;
      sm.a[s][t][r] = valid ? a[off] : zero;
      sm.b[s][t][r] = valid ? b[off] : zero;
    }
  }
}

template <typename T, bool kAsync>
__global__ void __launch_bounds__(kThreads)
rglru_chunked_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                          const float* __restrict__ h0, float* __restrict__ out, int S, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int c = threadIdx.x % kC, j = threadIdx.x / kC;
  const int r0 = blockIdx.x * kC, row = blockIdx.y;
  const bool live = r0 + c < R;
  const int64_t base = static_cast<int64_t>(row) * S * R;
  const T* ar = a + base;
  const T* br = b + base;
  float* outc = out + base + r0 + c;
  const int n_win = (S + kW - 1) / kW;

  if (threadIdx.x < kC)
    sm.carry[c] = h0 != nullptr && live ? h0[static_cast<int64_t>(row) * R + r0 + c] : 0.f;
#pragma unroll
  for (int w = 0; w < kStages - 1; ++w) {
    if (w < n_win) load_window<T, kAsync>(sm, w, ar, br, w * kW, r0, S, R);
    cp_async_commit();
  }
  for (int w = 0; w < n_win; ++w) {
    const int ahead = w + kStages - 1;
    if (ahead < n_win) load_window<T, kAsync>(sm, ahead % kStages, ar, br, ahead * kW, r0, S, R);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of window w have landed
    __syncthreads();               // and every thread's
    const int s = w % kStages;

    // the chunk's pair: the product of its a's and its scan from 0
    float av[kL], bv[kL];
#pragma unroll
    for (int k = 0; k < kL; ++k) {
      av[k] = to_float(sm.a[s][j * kL + k][c]);
      bv[k] = to_float(sm.b[s][j * kL + k][c]);
    }
    float pa = 1.f, pb = 0.f;
#pragma unroll
    for (int k = 0; k < kL; ++k) {
      pa *= av[k];
      pb = fmaf(av[k], pb, bv[k]);
    }
    sm.pa[j][c] = pa;
    sm.pb[j][c] = pb;
    __syncthreads();

    // warp 0: the h entering each chunk, in order from the window's carry
    if (j == 0) {
      float h = sm.carry[c];
#pragma unroll
      for (int i = 0; i < kNC; ++i) {
        sm.hin[i][c] = h;
        h = fmaf(sm.pa[i][c], h, sm.pb[i][c]);
      }
    }
    __syncthreads();

    // rescan from h_in and write h; the window's last h carries on
    float h = sm.hin[j][c];
    const int t0 = w * kW + j * kL;
#pragma unroll
    for (int k = 0; k < kL; ++k) {
      h = fmaf(av[k], h, bv[k]);
      if (live && t0 + k < S) outc[static_cast<int64_t>(t0 + k) * R] = h;
    }
    if (j == kNC - 1) sm.carry[c] = h;
    __syncthreads();  // stage s and the carry are free for the next window
  }
}

template <typename T, bool kAsync>
int launch(const void* a, const void* b, const float* h0, float* out, int B, int S, int R,
           cudaStream_t stream) {
  const auto fn = rglru_chunked_scan_kernel<T, kAsync>;
  constexpr int smem = static_cast<int>(sizeof(Smem<T>));
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((R + kC - 1) / kC, B);
  fn<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b), h0,
                                       out, S, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* a, const void* b, const float* h0, float* out, int B, int S, int R,
             cudaStream_t stream) {
  const bool aligned = (static_cast<int64_t>(R) * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  return aligned ? launch<T, true>(a, b, h0, out, B, S, R, stream)
                 : launch<T, false>(a, b, h0, out, B, S, R, stream);
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
  return bf16 ? dispatch<__nv_bfloat16>(a, b, h, o, B, S, R, st)
              : dispatch<float>(a, b, h, o, B, S, R, st);
}
