// The flash-attention backward from the saved log-sum-exp (causal / sliding-window / GQA),
// hand-written for sm_90a.
//
// Replaces the reference's XLA backward repro/models/flash_xla.py::_vjp_bwd (no Pallas
// kernel: an XLA program of (q tile x kv block) scans, as the fused phase program was). It
// computes that function, not its tiles. With P = exp(Q K^T * scale - lse) over the live band
// (key t < T, causal t <= s, window s - t < window) and 0 elsewhere:
//   delta = rowsum(dO * O),  dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dQ = dS K,  dK = dS^T Q,
// all in float32 from inputs of either type (the reference upcasts q, k, v, dO and O), the
// outputs written in the input dtype. lse is K4's (flash_attn.cu), (B, H, S) float32 in
// natural-log units; O is K4's output. Query head h reads kv head h / (H / KH), so dK and dV of
// a kv head sum over the G = H / KH query heads that read it.
//
// What bounds it on this card: operations. Five products of 2 B H D flops a live (query,
// key) pair, ten in all, against inputs read once: at olmo-1b's 2048-token step (4, 2048, 16
// heads, d 128) ~1.7e11 flops against ~0.1 GB. In float32 on CUDA cores (67 TFLOP/s) that is
// ~2.6 ms a layer at best; the float32 route needs exactly this arithmetic, and it is the
// reference's. (bf16 on the tensor cores is later work.) Design, simple and right first:
//   * three launches a call, none with atomics, each output element written once by one
//     thread, every sum taken in a fixed order: the same inputs give the same bits;
//   * flash_bwd_delta_kernel: delta, one warp a (batch, position, head) row, (B, H, S) float32
//     in a scratch buffer the wrapper allocates;
//   * flash_bwd_dkdv_kernel: one block a (tile of BK keys, kv head, batch). K and V stay in
//     shared memory; the block walks the group's G query heads in order and, for each, the
//     live band of query tiles (from the key tile's first key when causal, up to its last key
//     + window - 1 with a window). Each query tile's Q, dO, lse and delta are staged, S and dP
//     are recomputed in registers, P and dS go through shared memory, and dV += P^T dO,
//     dK += dS^T Q accumulate in registers. Key tiles with the most live queries (causal:
//     the first) are scheduled first;
//   * flash_bwd_dq_kernel: one block a (tile of BQ queries, head, batch), Q, dO, lse and delta
//     in shared memory, looping over the live band of key tiles as K4's forward does; it
//     recomputes S and dP, stages dS and accumulates dQ += dS K in registers. Causal query
//     tiles run heaviest first;
//   * 256 threads as 16 x 16: a thread owns a (BQ/16) x (BK/16) micro tile of S and dP, and
//     (BK/16 or BQ/16) rows x D/16 columns of its accumulators. Shared-memory rows are padded
//     by one float against bank conflicts. Tiles are 64 x 64 at D <= 128 and 32 x 32 at
//     D = 256, where K, V, Q and dO of 32 rows take 128 KB: shared memory is 98 KB (D 64),
//     162 KB (D 128) and 137 KB (D 256) a dK/dV block, above 48 KB by cudaFuncSetAttribute,
//     one block an SM at D >= 128.
// A query row with no live key (S >= T + window) has no log-sum-exp; the wrapper refuses such
// shapes, as it refuses T = 0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // 16 (ty) x 16 (tx)

template <int D>
struct Tile {
  static constexpr int kB = D >= 256 ? 32 : 64;    // query rows and keys a tile
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// floats of shared memory of the dK/dV block: K, V, Q, dO tiles, P and dS, lse and delta
template <int D>
constexpr size_t dkdv_smem_bytes() {
  constexpr int B = Tile<D>::kB;
  return sizeof(float) * (4 * B * (D + 1) + 2 * B * (B + 1) + 2 * B);
}

// of the dQ block: Q, dO, K, V tiles, dS, lse and delta
template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr int B = Tile<D>::kB;
  return sizeof(float) * (4 * B * (D + 1) + B * (B + 1) + 2 * B);
}

__device__ __forceinline__ bool live_key(int qp, int kp, int S, int n_keys, int causal,
                                         int window) {
  return qp < S && kp < n_keys && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// `n_rows` positions from p0 of one head of a (.., positions, heads, D) tensor (`src` points at
// the head's position 0) into a [n_rows][D + 1] float tile; rows at or past `n_pos` are zero
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int64_t pos_stride,
                                      int p0, int n_rows, int n_pos) {
  for (int i = threadIdx.x; i < n_rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int p = p0 + r;
    dst[r * (D + 1) + d] = p < n_pos ? to_float(src[p * pos_stride + d]) : 0.f;
  }
}

// delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d]: one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
                       float* __restrict__ delta, int64_t rows, int S, int H, int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                             // the whole warp
  const T* orow = o + row * D;
  const T* grow = g + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_float(grow[d]), to_float(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const int64_t bs = row / H;
    const int s = static_cast<int>(bs % S);
    const int64_t b = bs / S;
    delta[(b * H + h) * S + s] = acc;
  }
}

// S = Q K^T and dP = dO V^T on a thread's micro tile (rows ty * RQ + i, columns tx + 16 j),
// then P and dS written to shared memory (P only where Ps is not null)
template <int D, int BQ, int BK>
__device__ __forceinline__ void scores(const float* Qs, const float* Gs, const float* Ks,
                                       const float* Vs, const float* Ls, const float* Ds,
                                       float* Ps, float* dSs, int q0, int k0, int S, int n_keys,
                                       int causal, int window, float scale) {
  constexpr int RQ = BQ / 16;
  constexpr int CK = BK / 16;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float sc[RQ][CK], dp[RQ][CK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[RQ], gv[RQ], kv[CK], vv[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qv[i] = Qs[(ty * RQ + i) * (D + 1) + d];
      gv[i] = Gs[(ty * RQ + i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
      vv[j] = Vs[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i;
    const int qp = q0 + r;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int c = tx + 16 * j;
      const float p = live_key(qp, k0 + c, S, n_keys, causal, window)
                          ? expf(sc[i][j] * scale - Ls[r]) : 0.f;
      if (Ps != nullptr) Ps[r * (BK + 1) + c] = p;
      dSs[r * (BK + 1) + c] = p * (dp[i][j] - Ds[r]) * scale;
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ g, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int S, int n_keys, int H, int KH, int causal, int window, float scale) {
  constexpr int BQ = Tile<D>::kB;
  constexpr int BK = Tile<D>::kB;
  constexpr int RK = BK / 16;     // key rows a thread: ty * RK + i
  constexpr int CD = D / 16;      // columns a thread: tx + 16 * jd
  extern __shared__ float smem[];
  float* Ks = smem;                      // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);         // [BK][D + 1]
  float* Qs = Vs + BK * (D + 1);         // [BQ][D + 1]
  float* Gs = Qs + BQ * (D + 1);         // [BQ][D + 1], dO
  float* Ps = Gs + BQ * (D + 1);         // [BQ][BK + 1]
  float* dSs = Ps + BQ * (BK + 1);       // [BQ][BK + 1]
  float* Ls = dSs + BQ * (BK + 1);       // [BQ]
  float* Ds = Ls + BQ;                   // [BQ]

  const int k0 = blockIdx.x * BK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t q_pos_stride = static_cast<int64_t>(H) * D;
  const int64_t k_pos_stride = static_cast<int64_t>(KH) * D;
  const int64_t k_base = (static_cast<int64_t>(b) * n_keys * KH + kh) * D;

  stage<D>(Ks, k + k_base, k_pos_stride, k0, BK, n_keys);
  stage<D>(Vs, v + k_base, k_pos_stride, k0, BK, n_keys);

  float dk_acc[RK][CD], dv_acc[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int jd = 0; jd < CD; ++jd) dk_acc[i][jd] = dv_acc[i][jd] = 0.f;

  // the live band of queries for this key tile
  const int k_last = min(k0 + BK, n_keys) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S - 1, k_last + window - 1) : S - 1;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const int64_t q_base = (static_cast<int64_t>(b) * S * H + h) * D;
    const float* lrow = lse + (static_cast<int64_t>(b) * H + h) * S;
    const float* drow = delta + (static_cast<int64_t>(b) * H + h) * S;
    for (int q0 = (q_lo / BQ) * BQ; q0 <= q_hi; q0 += BQ) {
      __syncthreads();  // K, V staged; the last tile's reads of Q, dO, P, dS done
      stage<D>(Qs, q + q_base, q_pos_stride, q0, BQ, S);
      stage<D>(Gs, g + q_base, q_pos_stride, q0, BQ, S);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        Ls[r] = q0 + r < S ? lrow[q0 + r] : 0.f;
        Ds[r] = q0 + r < S ? drow[q0 + r] : 0.f;
      }
      __syncthreads();
      scores<D, BQ, BK>(Qs, Gs, Ks, Vs, Ls, Ds, Ps, dSs, q0, k0, S, n_keys, causal, window,
                        scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's rows in order
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[RK], sv[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = Ps[r * (BK + 1) + ty * RK + i];
          sv[i] = dSs[r * (BK + 1) + ty * RK + i];
        }
#pragma unroll
        for (int jd = 0; jd < CD; ++jd) {
          const float gv = Gs[r * (D + 1) + tx + 16 * jd];
          const float qv = Qs[r * (D + 1) + tx + 16 * jd];
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            dv_acc[i][jd] = fmaf(pv[i], gv, dv_acc[i][jd]);
            dk_acc[i][jd] = fmaf(sv[i], qv, dk_acc[i][jd]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int t = k0 + ty * RK + i;
    if (t >= n_keys) continue;
#pragma unroll
    for (int jd = 0; jd < CD; ++jd) {
      const int64_t at = k_base + t * k_pos_stride + tx + 16 * jd;
      store(&dk[at], dk_acc[i][jd]);
      store(&dv[at], dv_acc[i][jd]);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int n_keys,
                    int H, int KH, int causal, int window, float scale) {
  constexpr int BQ = Tile<D>::kB;
  constexpr int BK = Tile<D>::kB;
  constexpr int RQ = BQ / 16;     // query rows a thread: ty * RQ + i
  constexpr int CD = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [BQ][D + 1]
  float* Gs = Qs + BQ * (D + 1);         // [BQ][D + 1], dO
  float* Ks = Gs + BQ * (D + 1);         // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);         // [BK][D + 1]
  float* dSs = Vs + BK * (D + 1);        // [BQ][BK + 1]
  float* Ls = dSs + BQ * (BK + 1);       // [BQ]
  float* Ds = Ls + BQ;                   // [BQ]

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t q_pos_stride = static_cast<int64_t>(H) * D;
  const int64_t k_pos_stride = static_cast<int64_t>(KH) * D;
  const int64_t q_base = (static_cast<int64_t>(b) * S * H + h) * D;
  const int64_t k_base = (static_cast<int64_t>(b) * n_keys * KH + kh) * D;
  const float* lrow = lse + (static_cast<int64_t>(b) * H + h) * S;
  const float* drow = delta + (static_cast<int64_t>(b) * H + h) * S;

  stage<D>(Qs, q + q_base, q_pos_stride, q0, BQ, S);
  stage<D>(Gs, g + q_base, q_pos_stride, q0, BQ, S);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    Ls[r] = q0 + r < S ? lrow[q0 + r] : 0.f;
    Ds[r] = q0 + r < S ? drow[q0 + r] : 0.f;
  }

  float dq_acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int jd = 0; jd < CD; ++jd) dq_acc[i][jd] = 0.f;

  // the live band of keys for this query tile
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_hi = causal ? min(n_keys - 1, q_last) : n_keys - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_lo / BK) * BK; k0 <= k_hi; k0 += BK) {
    __syncthreads();  // Q, dO staged; the last tile's reads of K and dS done
    stage<D>(Ks, k + k_base, k_pos_stride, k0, BK, n_keys);
    stage<D>(Vs, v + k_base, k_pos_stride, k0, BK, n_keys);
    __syncthreads();
    scores<D, BQ, BK>(Qs, Gs, Ks, Vs, Ls, Ds, nullptr, dSs, q0, k0, S, n_keys, causal, window,
                      scale);
    __syncthreads();
    // dQ += dS K over the tile's keys in order
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sv[i] = dSs[(ty * RQ + i) * (BK + 1) + c];
#pragma unroll
      for (int jd = 0; jd < CD; ++jd) {
        const float kv = Ks[c * (D + 1) + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < RQ; ++i) dq_acc[i][jd] = fmaf(sv[i], kv, dq_acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int s = q0 + ty * RQ + i;
    if (s >= S) continue;
#pragma unroll
    for (int jd = 0; jd < CD; ++jd)
      store(&dq[q_base + s * q_pos_stride + tx + 16 * jd], dq_acc[i][jd]);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* g, float* delta, void* dq, void* dk, void* dv, int B, int S, int n_keys,
           int H, int KH, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int BQ = Tile<D>::kB;
  constexpr int BK = Tile<D>::kB;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);

  const int64_t rows = static_cast<int64_t>(B) * S * H;
  const int64_t warps = kThreads / 32;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + warps - 1) / warps), kThreads, 0,
                              stream>>>(static_cast<const T*>(o), gt, delta, rows, S, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t smem_kv = dkdv_smem_bytes<D>();
  auto fn_kv = flash_bwd_dkdv_kernel<D, T>;
  err = cudaFuncSetAttribute(fn_kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn_kv<<<dim3((n_keys + BK - 1) / BK, KH, B), kThreads, smem_kv, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, n_keys, H, KH,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t smem_q = dq_smem_bytes<D>();
  auto fn_q = flash_bwd_dq_kernel<D, T>;
  err = cudaFuncSetAttribute(fn_q, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn_q<<<dim3((S + BQ - 1) / BQ, H, B), kThreads, smem_q, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), S, n_keys, H, KH, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, const void* o, const float* lse,
             const void* g, float* delta, void* dq, void* dk, void* dv, int B, int S,
             int n_keys, int H, int KH, int causal, int window, float scale,
             cudaStream_t stream) {
#define REPRO_BWD_CASE(d)                                                                   \
  case d:                                                                                   \
    return launch<d, T>(q, k, v, o, lse, g, delta, dq, dk, dv, B, S, n_keys, H, KH, causal, \
                        window, scale, stream);
  switch (D) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(128)
    REPRO_BWD_CASE(256)
  }
#undef REPRO_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o, g, dq: (B, S, H, D); k, v, dk, dv: (B, T, KH, D); lse, delta: (B, H, S) float32;
// contiguous, q, k, v, o, g and the gradients all float32 (bf16 = 0) or all bfloat16
// (bf16 = 1); D in {16, 32, 64, 128, 256}; H % KH == 0; B, S, T >= 1; window <= 0 means
// none; every query row keeps a live key. delta is scratch. Three launches on `stream`.
extern "C" int repro_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                    const float* lse, const void* g, float* delta, void* dq,
                                    void* dk, void* dv, int B, int S, int n_keys, int H,
                                    int KH, int D, int causal, int window, float scale,
                                    int bf16, void* stream) {
  if (KH <= 0 || H % KH != 0 || B < 1 || S < 1 || n_keys < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, o, lse, g, delta, dq, dk, dv, B, S, n_keys,
                                        H, KH, causal, window, scale, st)
              : dispatch<float>(D, q, k, v, o, lse, g, delta, dq, dk, dv, B, S, n_keys, H, KH,
                                causal, window, scale, st);
}
