// K5: the chunked Mamba-2 SSD scan, hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::ssd_scan_fwd (body _ssd_kernel).
// It computes what the plain ssd_chunked_ref computes, in float32: for each batch b and
// head h, over chunks of Q positions with the running state h (P x N) carried across them,
//   cum_t  = sum_{u <= t in the chunk} dt_u * a_h
//   y_t    = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s  +  exp(cum_t) C_t . h
//   h     <- exp(cum_last) h + sum_s exp(cum_last - cum_s) dt_s x_s B_s^T
// starting from h0 (or zeros), and writes y (B, S, H, P) and the final state h_last.
// Beyond the TPU kernel it takes the initial state and writes the final one (the model's
// prefill fills its decode cache with it).
//
// Design (simple and right first):
//   * the TPU grid (batch, head, chunk) runs its chunk axis in order with the state in
//     VMEM scratch. Here one block owns (slab of 64 state rows p, head, batch) and loops
//     over the chunks itself, the state slab in shared memory. Rows p of the state evolve
//     apart, so the slabs are exact; at P = 64 a block holds the whole head;
//   * x, B and C are read in place in their (B, S, H, P) / (B, S, N) layouts with the
//     batch and position strides given (the model passes slices of one projection), and
//     converted to float as they are staged: float32 or bfloat16;
//   * the in-chunk decay is formed only where s <= t: the exponent is masked before exp,
//     never exp of the positive upper triangle (that overflows once a chunk's summed
//     dt |a| passes ~88.7; ROADMAP caveat C5). A ragged tail (t >= S) is masked here as
//     dt = 0, x = B = C = 0 would be, without padding on the host;
//   * B and C are staged 32 state columns at a time, so shared memory holds B, C (32
//     columns), the Q x Q score tile (which holds x * w while the state is updated), x
//     and the state slab: 165 KB at Q = 128, N = 128, opted in above 48 KB;
//   * 256 threads as 16 x 16. C . B^T (Q x Q, 8 x 8 a thread) and C . h^T (Q x 64,
//     8 x 4 a thread) accumulate in registers over the column slices; the state update
//     (64 x 32 a slice, 4 x 2 a thread) follows each slice once its old values are read.
// What bounds it on this card: at mamba2-780m's prefill (4, 2048, 48 heads of 64, N 128)
// the function needs ~20 GFLOP of products against ~0.2 GB of traffic, so the least time
// is set by bytes on the tensor cores' rate; this kernel recomputes C . B^T for every
// head (1 group), does all products on CUDA cores in fp32, and has 192 blocks for 132
// SMs, so it runs far above that bound. It takes float32 inputs and the shapes the
// tensor-core kernels (ssd_scan_tc.cu: bf16, head dim 64) do not; there C . B^T is
// shared across heads and the chunks run in parallel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 128;          // longest chunk
constexpr int kPT = 64;          // state rows (head dims) a block
constexpr int kNT = 32;          // state columns staged at a time
constexpr int kThreads = 256;    // 16 (ty) x 16 (tx)
constexpr int kTR = kQ / 16;     // chunk rows a thread: ty * kTR + i
constexpr int kTC = kQ / 16;     // score columns a thread: tx + 16 * j
constexpr int kPC = kPT / 16;    // output columns a thread: tx + 16 * j
constexpr int kCT = kQ + 4;      // row stride of the transposed C and score tiles
constexpr int kHR = kPT / 16;    // state rows a thread in the update: ty * kHR + i
constexpr int kHC = kNT / 16;    // state columns a thread in the update: tx + 16 * j

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// state columns padded to a whole number of staged slices
__host__ __device__ inline int padded_n(int N) { return (N + kNT - 1) / kNT * kNT; }

size_t smem_bytes(int N) {
  return sizeof(float) * (kQ * (kNT + 1)            // Bs  [s][n]
                          + kNT * kCT               // CsT [n][t]
                          + kQ * kCT                // ScT [s][t], or Xw [s][p]
                          + kQ * kPT                // Xs  [s][p]
                          + kPT * (padded_n(N) + 1) // Hs  [p][n]
                          + 3 * kQ);                // cum, dt, w
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ dt, const float* __restrict__ a,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_last, int S, int H, int P, int N, int Q, int64_t x_sb,
                int64_t x_ss, int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss) {
  const int NP = padded_n(N);
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                      // [kQ][kNT + 1]
  float* CsT = Bs + kQ * (kNT + 1);      // [kNT][kCT]
  float* ScT = CsT + kNT * kCT;          // [kQ][kCT]: scores, column s, row t
  float* Xw = ScT;                       // [kQ][kPT]: x_s exp(cum_last - cum_s) dt_s, in
                                         // the score tile's room until the scores
  float* Xs = ScT + kQ * kCT;            // [kQ][kPT]
  float* Hs = Xs + kQ * kPT;             // [kPT][NP + 1]
  float* cum = Hs + kPT * (NP + 1);      // [kQ]
  float* dts = cum + kQ;                 // [kQ]
  float* w = dts + kQ;                   // [kQ]

  const int n_slabs = (P + kPT - 1) / kPT;
  const int h = blockIdx.x / n_slabs;
  const int p0 = (blockIdx.x % n_slabs) * kPT;
  const int np = min(kPT, P - p0);       // live state rows of this slab
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float ah = a[h];

  const T* xb = x + b * x_sb + static_cast<int64_t>(h) * P + p0;
  const T* bb = bm + b * b_sb;
  const T* cb = cm + b * c_sb;
  const float* dtb = dt + static_cast<int64_t>(b) * S * H + h;
  const int64_t y_pos = static_cast<int64_t>(H) * P;
  float* yb = y + (static_cast<int64_t>(b) * S * H + h) * P + p0;
  const int64_t h_off = ((static_cast<int64_t>(b) * H + h) * P + p0) * N;

  for (int i = tid; i < kPT * NP; i += kThreads) {
    const int p = i / NP, n = i % NP;
    Hs[p * (NP + 1) + n] =
        (h0 != nullptr && p < np && n < N) ? h0[h_off + static_cast<int64_t>(p) * N + n] : 0.f;
  }

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int live = min(Q, S - t0);     // positions of this chunk
    __syncthreads();                     // the last chunk's readers are done

    // dt and the inclusive in-chunk cumulative decay, in warp 0: each lane sums 4
    // positions in order, then an inclusive shuffle scan over the lanes
    if (tid < 32) {
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = tid * 4 + k;
        const float d = t < live ? dtb[static_cast<int64_t>(t0 + t) * H] : 0.f;
        dts[t] = d;
        run += d * ah;
        v[k] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, tot, off);
        if (tid >= off) tot += o;
      }
      const float up = __shfl_up_sync(0xffffffffu, tot, 1);
      const float base = tid == 0 ? 0.f : up;
      const float seg = __shfl_sync(0xffffffffu, base + v[3], 31);   // cum[kQ - 1]
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = tid * 4 + k;
        cum[t] = base + v[k];
        w[t] = expf(seg - (base + v[k])) * dts[t];
      }
    }
    for (int i = tid; i < kQ * kPT; i += kThreads) {
      const int s = i / kPT, p = i % kPT;
      Xs[i] = (s < live && p < np) ? to_float(xb[(t0 + s) * x_ss + p]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kQ * kPT; i += kThreads) Xw[i] = Xs[i] * w[i / kPT];
    const float e_seg = expf(cum[kQ - 1]);

    float sacc[kTR][kTC];                // C_t . B_s
    float yacc[kTR][kPC];                // C_t . h_p (old state)
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
#pragma unroll
      for (int j = 0; j < kTC; ++j) sacc[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < kPC; ++j) yacc[i][j] = 0.f;
    }

    for (int n0 = 0; n0 < NP; n0 += kNT) {
      __syncthreads();                   // readers of the last slice (and Xw) are done
      for (int i = tid; i < kQ * kNT; i += kThreads) {
        const int s = i / kNT, n = i % kNT;
        const bool in = s < live && n0 + n < N;
        Bs[s * (kNT + 1) + n] = in ? to_float(bb[(t0 + s) * b_ss + n0 + n]) : 0.f;
        CsT[n * kCT + s] = in ? to_float(cb[(t0 + s) * c_ss + n0 + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int n = 0; n < kNT; ++n) {
        const float4 c_lo = *reinterpret_cast<const float4*>(&CsT[n * kCT + ty * kTR]);
        const float4 c_hi = *reinterpret_cast<const float4*>(&CsT[n * kCT + ty * kTR + 4]);
        const float cv[kTR] = {c_lo.x, c_lo.y, c_lo.z, c_lo.w, c_hi.x, c_hi.y, c_hi.z, c_hi.w};
        float bv[kTC], hv[kPC];
#pragma unroll
        for (int j = 0; j < kTC; ++j) bv[j] = Bs[(tx + 16 * j) * (kNT + 1) + n];
#pragma unroll
        for (int j = 0; j < kPC; ++j) hv[j] = Hs[(tx + 16 * j) * (NP + 1) + n0 + n];
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
#pragma unroll
          for (int j = 0; j < kTC; ++j) sacc[i][j] = fmaf(cv[i], bv[j], sacc[i][j]);
#pragma unroll
          for (int j = 0; j < kPC; ++j) yacc[i][j] = fmaf(cv[i], hv[j], yacc[i][j]);
        }
      }
      __syncthreads();                   // the old state of these columns is read

      // h[p, n] = exp(cum_last) h[p, n] + sum_s Xw[s, p] B[s, n] for this slice
      float hn[kHR][kHC];
#pragma unroll
      for (int i = 0; i < kHR; ++i)
#pragma unroll
        for (int j = 0; j < kHC; ++j) hn[i][j] = 0.f;
      for (int s = 0; s < live; ++s) {
        const float4 xv = *reinterpret_cast<const float4*>(&Xw[s * kPT + ty * kHR]);
        const float xa[kHR] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int j = 0; j < kHC; ++j) {
          const float bvj = Bs[s * (kNT + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kHR; ++i) hn[i][j] = fmaf(xa[i], bvj, hn[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kHR; ++i)
#pragma unroll
        for (int j = 0; j < kHC; ++j) {
          float* hp = &Hs[(ty * kHR + i) * (NP + 1) + n0 + tx + 16 * j];
          *hp = fmaf(e_seg, *hp, hn[i][j]);
        }
    }

    // scores with the masked decay, transposed for the product with x, over Xw
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int t = ty * kTR + i;
      const float ct = cum[t];
      const float et = expf(ct);
#pragma unroll
      for (int j = 0; j < kPC; ++j) yacc[i][j] *= et;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int s = tx + 16 * j;
        ScT[s * kCT + t] = s <= t ? sacc[i][j] * expf(ct - cum[s]) * dts[s] : 0.f;
      }
    }
    __syncthreads();

    // y += scores . x over the live band s <= t of this thread's rows
    const int s_hi = min(live, ty * kTR + kTR);
    for (int s = 0; s < s_hi; ++s) {
      const float4 lo = *reinterpret_cast<const float4*>(&ScT[s * kCT + ty * kTR]);
      const float4 hi = *reinterpret_cast<const float4*>(&ScT[s * kCT + ty * kTR + 4]);
      const float sv[kTR] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < kPC; ++j) {
        const float xv = Xs[s * kPT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTR; ++i) yacc[i][j] = fmaf(sv[i], xv, yacc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int t = ty * kTR + i;
      if (t >= live) continue;
#pragma unroll
      for (int j = 0; j < kPC; ++j) {
        const int p = tx + 16 * j;
        if (p < np) yb[(t0 + t) * y_pos + p] = yacc[i][j];
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < np * N; i += kThreads) {
    const int p = i / N, n = i % N;
    h_last[h_off + i] = Hs[p * (NP + 1) + n];
  }
}

template <typename T>
int launch(const void* x, const void* bm, const void* cm, const float* dt, const float* a,
           const float* h0, float* y, float* h_last, int B, int S, int H, int P, int N, int Q,
           int64_t x_sb, int64_t x_ss, int64_t b_sb, int64_t b_ss, int64_t c_sb,
           int64_t c_ss, cudaStream_t stream) {
  const size_t smem = smem_bytes(N);
  auto fn = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H * ((P + kPT - 1) / kPT), B);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm), static_cast<const T*>(cm), dt, a,
      h0, y, h_last, S, H, P, N, Q, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, S, H, P) with strides (x_sb, x_ss, P, 1); bm / cm (B, S, N) with strides
// (*_sb, *_ss, 1); x, bm, cm all float32 (bf16 = 0) or all bfloat16 (bf16 = 1).
// dt (B, S, H), a (H,), h0 (B, H, P, N) or null, y (B, S, H, P), h_last (B, H, P, N):
// contiguous float32. 1 <= Q <= 128, 1 <= N <= 256, S >= 1 (shared memory: 201 KB at
// N = 256).
extern "C" int repro_ssd_scan_fwd(const void* x, const void* bm, const void* cm,
                                  const float* dt, const float* a, const float* h0, float* y,
                                  float* h_last, int B, int S, int H, int P, int N, int Q,
                                  int64_t x_sb, int64_t x_ss, int64_t b_sb, int64_t b_ss,
                                  int64_t c_sb, int64_t c_ss, int bf16, void* stream) {
  if (Q < 1 || Q > kQ || N < 1 || N > 256 || S < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, bm, cm, dt, a, h0, y, h_last, B, S, H, P, N, Q, x_sb,
                                      x_ss, b_sb, b_ss, c_sb, c_ss, st)
              : launch<float>(x, bm, cm, dt, a, h0, y, h_last, B, S, H, P, N, Q, x_sb, x_ss,
                              b_sb, b_ss, c_sb, c_ss, st);
}
