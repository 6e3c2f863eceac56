// K4: flash-attention forward (causal / sliding-window / GQA), hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/attention/kernel.py::flash_attention_fwd
// (body _flash_kernel). It computes the plain attention_ref:
//   out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h / (H/K)] * D^-0.5, masked) . v[b, t, h / (H/K)]
// with the mask t < T, causal t <= s, window s - t < window, an fp32 softmax and
// fp32 accumulators, written in q's dtype (float32 or bfloat16). A row with no live
// key writes 0 (the TPU kernel's `safe` guard). Given an `lse` pointer, both kernels also
// write each row's log-sum-exp of its masked, scaled scores, (B, H, S) float32 in natural-log
// units (the reference flash_xla's (B, K, G, S), h = k G + g), which the backward
// (flash_attn_bwd.cu) reads; with nullptr they write nothing more. Two kernels, routed by the wrapper
// (kernels/attention/kernel.py::route) on (dtype, head dim):
//
// flash_fwd_kernel_tc: bfloat16 at D in {64, 128, 256}, the serving paths. Built for
// Hopper's tensor cores. What bounds the function on this card is operations: at
// olmo-1b's prefill (4, 2048, 16 heads, d 128) ~69 GFLOP against ~134 MB, far above
// the bf16 tensor-core balance of ~295 FLOP a byte. So:
//   * one warpgroup (128 threads) a block of 64 query rows of one (head, batch);
//     S = Q.K^T runs on wgmma m64n64k16 with Q and K from shared memory, O += P.V
//     on wgmma m64nDk16 with P from registers and V from shared memory (MN-major,
//     the descriptor's transpose bit); fp32 accumulators;
//   * the online softmax (row max, exp2, row sum, the alpha rescale) runs on the
//     wgmma accumulator layout in registers. The S fragment of a 16-key step is
//     exactly the register A fragment of the P.V product, so P is rounded to bf16
//     and packed in place: no shared-memory round trip. The row sums keep P in fp32;
//   * copies are TMA: tensor maps over q (B, S, H, D) and k, v (B, T, K, D) as
//     given (4-D, no transpose, no padding copy), 128-byte swizzle, so a D-wide tile
//     arrives as D/64 column slabs of 64 bf16 a row and the wgmma descriptors walk
//     them. Q is loaded once; K and V tiles of 64 keys stream through a ring of 2
//     stages, each completed on its own mbarrier, so S = Q.K^T starts before V lands
//     and the next tile's copies overlap this tile's products. TMA's zero fill covers
//     the ragged edges of S and T; the mask still decides which scores are live;
//   * the output goes back through shared memory (Q's buffer, swizzled) and one TMA
//     store a slab, which drops the rows past S;
//   * work skipped, as the CUDA-core kernel: only the live band of key tiles is
//     visited (causal, window), causal query tiles run heaviest first, and only tiles
//     that cross the diagonal, the window's edge or T are masked.
//   Shared memory: Q 64 x D + 2 stages x (K + V) of 64 x D bf16 (+1 KB alignment):
//   40 KB at D = 64, 80 KB at D = 128 (two blocks an SM), 160 KB at D = 256 (one).
//   Registers: D/2 fp32 of O, 32 of S and 16 of packed P a thread.
//   Not yet: a producer warp with setmaxnreg, two consumer warpgroups in ping-pong,
//   several query heads of one kv head a block.
//
// flash_fwd_kernel: float32 inputs, and bfloat16 at D 16 and 32 (test head dims only),
// on CUDA cores in fp32. Tensor cores would mean TF32 for float32 inputs, about three
// decimal digits, which fails K4's 2e-5 float32 tolerance and the float32 logit gates
// of the serving paths. Design (simple and right first):
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
// What bounds it: the fp32 non-tensor rate; the register micro-tiles (4 x 2 scores,
// 4 x D/16 outputs a thread) keep shared-memory reads below one per FMA.
#include <math.h>

#include <type_traits>

#include "hopper.cuh"

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
                 T* __restrict__ o, float* __restrict__ lse, int S, int n_keys, int H, int KH,
                 int causal, int window, float scale) {
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
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + qp] = m[i] + logf(li);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
           int n_keys, int H, int KH, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto fn = flash_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, n_keys, H, KH, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o, float* lse, int B,
             int S, int n_keys, int H, int KH, int causal, int window, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16, T>(q, k, v, o, lse, B, S, n_keys, H, KH, causal, window, scale, stream);
    case 32: return launch<32, T>(q, k, v, o, lse, B, S, n_keys, H, KH, causal, window, scale, stream);
  }
  if constexpr (std::is_same<T, float>::value) {  // bf16 at D >= 64: flash_fwd_kernel_tc
    switch (D) {
      case 64:
        return launch<64, T>(q, k, v, o, lse, B, S, n_keys, H, KH, causal, window, scale, stream);
      case 128:
        return launch<128, T>(q, k, v, o, lse, B, S, n_keys, H, KH, causal, window, scale, stream);
      case 256:
        return launch<256, T>(q, k, v, o, lse, B, S, n_keys, H, KH, causal, window, scale, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------------
// flash_fwd_kernel_tc: bfloat16 on the tensor cores (wgmma), K and V through TMA.

constexpr int kTcThreads = 128;   // one warpgroup
constexpr int kTcBQ = 64;         // query rows a block (wgmma's M)
constexpr int kTcBK = 64;         // keys a kv tile
constexpr int kTcStages = 2;      // K/V ring
constexpr int kSlabRow = 128;     // bytes of one swizzled row: 64 bf16

template <int D>
struct TcLayout {
  static constexpr int kSlabs = D / 64;
  static constexpr int kQBytes = kTcBQ * D * 2;   // kSlabs slabs of 64 rows x 128 B
  static constexpr int kKVBytes = kTcBK * D * 2;  // kSlabs slabs of 64 keys x 128 B
  static constexpr int kBytes = kQBytes + 2 * kTcStages * kKVBytes;
  static constexpr int kSmem = kBytes + 1024;     // room to align the base to 1 KB
};

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (D == 64) wgmma_rs_n64(o, a, desc);
  else if constexpr (D == 128) wgmma_rs_n128(o, a, desc);
  else wgmma_rs_n256(o, a, desc);
}

// Thread t of the warpgroup owns, in every wgmma accumulator, rows
// r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8, and in each 8-column group j the two
// columns 8 j + 2 (t % 4) + {0, 1}: element 4 j + 2 half + e.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_kernel_tc(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                    float* __restrict__ lse, int S, int n_keys, int H, int KH, int causal,
                    int window, float scale_log2) {
  using L = TcLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_k[kTcStages];
  __shared__ __align__(8) uint64_t bar_v[kTcStages];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sQ = base;                                // also the output tile
  unsigned char* sK = sQ + L::kQBytes;                     // [stage][slab][64 keys][128 B]
  unsigned char* sV = sK + kTcStages * L::kKVBytes;

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * kTcBQ;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;               // and r0 + 8
  const int c0 = 2 * (lane % 4);

  // the live band of key tiles
  const int q_last = min(q0 + kTcBQ, S) - 1;
  const int k_hi = causal ? min(n_keys - 1, q_last) : n_keys - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kTcBK;
  const int n_tiles = k_hi >= k_lo ? k_hi / kTcBK - t_lo + 1 : 0;

  auto load_kv = [&](int stage, int tile) {
    const int k0 = tile * kTcBK;
    unsigned char* k_dst = sK + stage * L::kKVBytes;
    unsigned char* v_dst = sV + stage * L::kKVBytes;
    mbar_expect_tx(&bar_k[stage], L::kKVBytes);
#pragma unroll
    for (int sl = 0; sl < L::kSlabs; ++sl)
      tma_load(k_dst + sl * kTcBK * kSlabRow, &tm_k, &bar_k[stage], 64 * sl, kh, k0, b);
    mbar_expect_tx(&bar_v[stage], L::kKVBytes);
#pragma unroll
    for (int sl = 0; sl < L::kSlabs; ++sl)
      tma_load(v_dst + sl * kTcBK * kSlabRow, &tm_v, &bar_v[stage], 64 * sl, kh, k0, b);
  };

  if (tid == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_q, L::kQBytes);
#pragma unroll
    for (int sl = 0; sl < L::kSlabs; ++sl)
      tma_load(sQ + sl * kTcBQ * kSlabRow, &tm_q, &bar_q, 64 * sl, h, q0, b);
    for (int s = 0; s < kTcStages && s < n_tiles; ++s) load_kv(s, t_lo + s);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};                                 // this thread's columns only
  const uint32_t q_addr = smem_u32(sQ);
  mbar_wait(&bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i % kTcStages;
    const uint32_t parity = (i / kTcStages) & 1;
    const int k0 = (t_lo + i) * kTcBK;
    const uint32_t k_addr = smem_u32(sK + stage * L::kKVBytes);
    const uint32_t v_addr = smem_u32(sV + stage * L::kKVBytes);

    // S = Q . K^T: D/16 steps of 16; the step's 32 bytes sit inside a slab's row
    float s[kTcBK / 2];
    mbar_wait(&bar_k[stage], parity);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t q_off = (kk / 4) * kTcBQ * kSlabRow + (kk % 4) * 32;
      const uint32_t k_off = (kk / 4) * kTcBK * kSlabRow + (kk % 4) * 32;
      wgmma_ss<0, 0>(s, sw128_desc(q_addr + q_off, 16, 1024), sw128_desc(k_addr + k_off, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // mask (edge tiles only), online softmax in the log2 domain
    const bool full = k0 + kTcBK <= n_keys && (!causal || k0 + kTcBK - 1 <= q0) &&
                      (window <= 0 || q0 + kTcBQ - 1 - k0 < window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTcBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e / 2;
        float x = s[4 * j + e] * scale_log2;
        if (!full) {
          const int kp = k0 + 8 * j + c0 + (e & 1);
          const int qp = q0 + r0 + 8 * half;
          const bool live = kp < n_keys && (!causal || kp <= qp) &&
                            (window <= 0 || qp - kp < window);
          if (!live) x = -INFINITY;
        }
        s[4 * j + e] = x;
        mx[half] = fmaxf(mx[half], x);
      }
    }
    float alpha[2], base_m[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      const float m_new = fmaxf(m[half], mx[half]);
      alpha[half] = m_new == -INFINITY ? 1.f : exp2f(m[half] - m_new);
      base_m[half] = m_new == -INFINITY ? 0.f : m_new;
      m[half] = m_new;
      l[half] *= alpha[half];
    }
    uint32_t p[kTcBK / 4];
#pragma unroll
    for (int j = 0; j < kTcBK / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float p0 = exp2f(s[4 * j + 2 * half] - base_m[half]);
        const float p1 = exp2f(s[4 * j + 2 * half + 1] - base_m[half]);
        l[half] += p0 + p1;
        p[2 * j + half] = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];
    }

    // O += P . V: kTcBK/16 steps; V is MN-major (rows of keys, D contiguous):
    // 8-key groups 1 KB apart, 64-column slabs kTcBK rows apart
    mbar_wait(&bar_v[stage], parity);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      wgmma_pv<D>(o, a, sw128_desc(v_addr + kk * 16 * kSlabRow, kTcBK * kSlabRow, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(p);

    __syncthreads();                                       // this stage is free
    if (tid == 0 && i + kTcStages < n_tiles) load_kv(stage, t_lo + i + kTcStages);
  }

  // normalise, write the tile into Q's buffer in the swizzled layout, TMA-store it
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const int qp = q0 + r0 + 8 * half;
    // m and l are in base-2 units of the scaled scores: lse = (m + log2 l) ln 2
    if (lse != nullptr && lane % 4 == 0 && qp < S)
      lse[(static_cast<int64_t>(b) * H + h) * S + qp] =
          (m[half] + log2f(l[half])) * 0.6931471805599453f;
    l[half] = l[half] > 0.f ? 1.f / l[half] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      const int col = 8 * j + c0;                          // even: one 4-byte pair
      const int slab = col / 64, chunk = (col % 64) / 8;
      unsigned char* dst = sQ + slab * kTcBQ * kSlabRow + r * kSlabRow +
                           ((chunk ^ (r % 8)) * 16) + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(o[4 * j + 2 * half] * l[half], o[4 * j + 2 * half + 1] * l[half]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int sl = 0; sl < L::kSlabs; ++sl)
      tma_store(&tm_o, sQ + sl * kTcBQ * kSlabRow, 64 * sl, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}


// The 4-D map {D, heads, positions, batch} of a contiguous (batch, positions, heads, D)
// bf16 tensor, boxes of 64 columns x 1 head x `rows` positions, 128-byte swizzle.
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int n_pos, int heads,
                int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(n_pos), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(n_pos) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
              int n_keys, int H, int KH, int causal, int window, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!encode_map(encode, &tm_q, q, B, S, H, D, kTcBQ) ||
      !encode_map(encode, &tm_k, k, B, n_keys, KH, D, kTcBK) ||
      !encode_map(encode, &tm_v, v, B, n_keys, KH, D, kTcBK) ||
      !encode_map(encode, &tm_o, o, B, S, H, D, kTcBQ))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = TcLayout<D>::kSmem;
  auto fn = flash_fwd_kernel_tc<D>;
  const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTcBQ - 1) / kTcBQ, H, B);
  fn<<<grid, kTcThreads, smem, stream>>>(tm_q, tm_k, tm_v, tm_o, lse, S, n_keys, H, KH, causal,
                                         window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

// q, o: (B, S, H, D); k, v: (B, T, KH, D); contiguous, all float32 (bf16 = 0) or all
// bfloat16 (bf16 = 1); H % KH == 0; window <= 0 means none. lse: nullptr, or (B, H, S)
// float32 that gets each row's log-sum-exp (natural log) of its scaled, masked scores. tensor_cores = 1 launches
// flash_fwd_kernel_tc (bfloat16, D in {64, 128, 256}, T >= 1, 16-byte aligned
// pointers), 0 flash_fwd_kernel (float32 at D in {16, 32, 64, 128, 256}, bfloat16
// at D in {16, 32}).
extern "C" int repro_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int B, int S, int n_keys, int H, int KH, int D,
                                    int causal, int window, float scale, int bf16,
                                    int tensor_cores, void* stream) {
  if (KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (!bf16 || n_keys < 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (D) {
      case 64: return launch_tc<64>(q, k, v, o, lse, B, S, n_keys, H, KH, causal, window, scale, st);
      case 128: return launch_tc<128>(q, k, v, o, lse, B, S, n_keys, H, KH, causal, window, scale, st);
      case 256: return launch_tc<256>(q, k, v, o, lse, B, S, n_keys, H, KH, causal, window, scale, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, o, lse, B, S, n_keys, H, KH, causal, window,
                                        scale, st)
              : dispatch<float>(D, q, k, v, o, lse, B, S, n_keys, H, KH, causal, window, scale, st);
}
