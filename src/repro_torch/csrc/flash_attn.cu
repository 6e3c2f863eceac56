// K4: flash-attention forward (causal / sliding-window / GQA), hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/attention/kernel.py::flash_attention_fwd
// (body _flash_kernel). It computes exactly the plain attention_ref:
//   out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h / (H/K)] * D^-0.5, masked) . v[b, t, h / (H/K)]
// with the mask t < T, causal t <= s, window s - t < window, an fp32 softmax and
// fp32 accumulators, written in q's dtype (float32 or bfloat16). A row with no live
// key writes 0 (the TPU kernel's `safe` guard).
//
// Design (simple and right first):
//   * one block per (tile of 64 query rows, head, batch); the TPU kernel's sequential
//     kv grid axis becomes a loop inside the block over 32-key tiles of the live band
//     only: up to the tile's last query when causal, from q0 - window + 1 with a
//     window (the counterpart of its pl.when(live) skip). Causal tiles are scheduled
//     heaviest first;
//   * q, k and v are read in their (B, S, H, D) / (B, T, K, D) layouts as given (no
//     transpose, no padding: ragged S and T are masked here), converted to float and
//     staged in shared memory (rows padded by one float against bank conflicts);
//   * 256 threads as 16 x 16: each thread owns 4 query rows and 2 key columns of a
//     score tile, and 4 rows x D/16 columns of the output accumulator, all in
//     registers; row max and row sum are shuffle reductions over the 16 lanes of a row;
//   * masked entries get p = 0 from the mask itself (not through exp(-1e30 - -1e30)),
//     so a row whose first tiles are all masked carries m = -inf, alpha = 1, l = 0.
//   * shared memory is 4 * (64 (D + 1) + 32 (D + 1) + 32 D + 64 * 33) bytes, opted in
//     above 48 KB: at D = 256 (recurrentgemma-2b's heads) 139,904 B, one block an SM,
//     and each thread holds 4 x 16 output accumulators.
// Products run on CUDA cores in fp32 (no tensor cores: wgmma / mma.sync and TMA are
// later work). What bounds it on this card: at the olmo-1b prefill shape
// (4, 2048, 16 heads, d 128, bf16) the work is ~69 GFLOP against ~134 MB of q/k/v/o,
// above the H100's ops-per-byte balance, so it is bound by operations; on CUDA cores
// it runs at the fp32 non-tensor rate, not the 989 TFLOP/s bf16 tensor rate that
// bounds the function. The register micro-tiles (4 x 2 scores, 4 x D/16 outputs a
// thread) keep shared-memory reads below one per FMA.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // query rows a block
constexpr int kBK = 32;           // keys a kv tile
constexpr int kThreads = 256;     // 16 (ty) x 16 (tx)
constexpr int kRows = kBQ / 16;   // query rows a thread: ty * kRows + i
constexpr int kCols = kBK / 16;   // key columns a thread: tx + 16 * j

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int n_keys, int H, int KH, int causal, int window,
                 float scale) {
  constexpr int kDO = D / 16;     // output columns a thread: tx + 16 * jd
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);      // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);      // [kBK][D]
  float* Ps = Vs + kBK * D;            // [kBQ][kBK + 1]

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const int64_t q_pos_stride = static_cast<int64_t>(H) * D;   // one position of q / o
  const int64_t k_pos_stride = static_cast<int64_t>(KH) * D;  // one position of k / v
  const T* qb = q + (static_cast<int64_t>(b) * S * H + h) * D;
  const T* kb = k + (static_cast<int64_t>(b) * n_keys * KH + kh) * D;
  const T* vb = v + (static_cast<int64_t>(b) * n_keys * KH + kh) * D;
  T* ob = o + (static_cast<int64_t>(b) * S * H + h) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    Qs[r * (D + 1) + d] = s < S ? to_float(qb[s * q_pos_stride + d]) : 0.f;
  }

  // live band of keys for this query tile
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_hi = causal ? min(n_keys - 1, q_last) : n_keys - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[kRows], l[kRows], acc[kRows][kDO];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < kDO; ++jd) acc[i][jd] = 0.f;
  }

  for (int k0 = (k_lo / kBK) * kBK; k0 <= k_hi; k0 += kBK) {
    __syncthreads();  // Qs staged; the last tile's Ks / Vs / Ps reads done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int t = k0 + c;
      const bool in = t < n_keys;
      Ks[c * (D + 1) + d] = in ? to_float(kb[t * k_pos_stride + d]) : 0.f;
      Vs[c * D + d] = in ? to_float(vb[t * k_pos_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty * kRows + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty * kRows + i;
      bool live[kCols];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 16 * j;
        live[j] = kp < n_keys && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
        s[i][j] *= scale;
        if (live[j]) mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * kRows + i) * (kBK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < kDO; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * (kBK + 1) + c];
#pragma unroll
      for (int jd = 0; jd < kDO; ++jd) {
        const float vv = Vs[c * D + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][jd] = fmaf(pv[i], vv, acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= S) continue;
    const float li = l[i];
#pragma unroll
    for (int jd = 0; jd < kDO; ++jd)
      store(&ob[qp * q_pos_stride + tx + 16 * jd], li > 0.f ? acc[i][jd] / li : 0.f);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int n_keys,
           int H, int KH, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto fn = flash_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, n_keys, H, KH, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o, int B, int S,
             int n_keys, int H, int KH, int causal, int window, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16, T>(q, k, v, o, B, S, n_keys, H, KH, causal, window, scale, stream);
    case 32: return launch<32, T>(q, k, v, o, B, S, n_keys, H, KH, causal, window, scale, stream);
    case 64: return launch<64, T>(q, k, v, o, B, S, n_keys, H, KH, causal, window, scale, stream);
    case 128: return launch<128, T>(q, k, v, o, B, S, n_keys, H, KH, causal, window, scale, stream);
    case 256: return launch<256, T>(q, k, v, o, B, S, n_keys, H, KH, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (B, S, H, D); k, v: (B, T, KH, D); contiguous, all float32 (bf16 = 0) or all
// bfloat16 (bf16 = 1); H % KH == 0; D in {16, 32, 64, 128, 256}; window <= 0 means none.
extern "C" int repro_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    int B, int S, int n_keys, int H, int KH, int D,
                                    int causal, int window, float scale, int bf16,
                                    void* stream) {
  if (KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, o, B, S, n_keys, H, KH, causal, window,
                                        scale, st)
              : dispatch<float>(D, q, k, v, o, B, S, n_keys, H, KH, causal, window, scale, st);
}
