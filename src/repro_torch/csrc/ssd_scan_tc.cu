// K5 on Hopper's tensor cores: the chunked Mamba-2 SSD scan for bfloat16 inputs.
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::ssd_scan_fwd (body _ssd_kernel),
// as ssd_scan.cu does, and computes the same function (the plain ssd_chunked_ref): for
// each batch b and head h, over chunks of Q positions,
//   cum_t  = sum_{u <= t in the chunk} dt_u * a_h                       (in-chunk decay)
//   y_t    = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s  +  exp(cum_t) C_t . h_in
//   h_out  = exp(cum_last) h_in + sum_s exp(cum_last - cum_s) dt_s x_s B_s^T
// from h0 (or zeros), writing y (B, S, H, P) and the final state, both float32. The
// in-chunk exponent is masked (s <= t) before exp (ROADMAP caveat C5); a ragged tail is
// zero-filled by TMA and masked, as dt = 0, x = B = C = 0 would be.
//
// What bounds it on this card: at mamba2-780m's prefill (4, 2048, 48 heads of 64, N 128,
// chunk 128) the function moves ~0.17 GB and needs ~20 GFLOP of products, so bytes bound
// it (0.05 ms). The chunked algorithm (arXiv:2405.21060 section 6) as three kernels on one
// stream, so that every chunk runs in parallel:
//   1. ssd_chunk_states, grid (head group, chunk, batch), one warpgroup: per head the
//      in-chunk cum (one warp's shuffle scan, written out for the other kernels) and the
//      chunk's own state Sc (P x N) = (x w)^T . B with w_s = exp(cum_last - cum_s) dt_s,
//      on wgmma m64nNk16, written to a float32 scratch (B, nc, H, P, N);
//   2. ssd_state_pass, elementwise over (P x N, head, batch), a loop over the chunks:
//      h <- exp(cum_last) h + Sc, each scratch slot overwritten with the state that
//      enters its chunk; the last h is h_last;
//   3. ssd_chunk_outputs, grid (head group, chunk, batch), one warpgroup for each 64
//      rows t of the chunk: C . B^T once a block, kept in registers for every head of
//      the group (B and C are shared by all heads), then per head y = C . h_in^T scaled
//      by exp(cum_t), plus scores . x with the scores formed in registers and fed to
//      wgmma as its A fragment. Rows t < 64 see only s < 64: their warpgroup skips the
//      all-zero upper 64 x 64 tile.
// Precision: x, B and C are exact bf16 operands; C . B^T is exact products in fp32. The
// other operands are fp32 values (x w, the scores C B^T exp(..) dt, the state h_in):
// each is passed as a pair hi = bf16(v), lo = bf16(v - hi) and multiplied twice, which
// keeps ~16 bits of each (one bf16 rounding alone misses K5's 1e-4 gate 12-29x).
// Copies: B, C and each head's x through TMA (3-D / 4-D maps over the tensors as given,
// so strided slices of one xBC tensor are read in place and the zero fill clips S inside
// each batch), 128-byte swizzle, completed on mbarriers; x in a ring of two stages so the
// next head's copy overlaps this head's products.
// Not yet: fusing the state pass into the output kernel (a chunk-ordered look-back), a
// producer warp, float32 inputs (they stay on ssd_scan.cu's CUDA cores).
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kP = 64;            // head dim: wgmma's M of the chunk states, N of y
constexpr int kRow = 128;         // bytes of one swizzled row: 64 bf16
constexpr int kHeads = 4;         // heads a block (kernels 1 and 3)
constexpr int kPassThreads = 256; // kernel 2: 4 state elements a thread

template <int Q, int N>
struct Layout {
  static constexpr int kSlab = Q * kRow;            // 64 columns of a chunk's Q rows
  static constexpr int kBC = N / 64 * kSlab;        // B or C of one chunk
  static constexpr int kX = kSlab;                  // x of one head and chunk
  static constexpr int kH = N / 64 * kP * kRow;     // h_in of one head, bf16, P rows
  static constexpr int kStateSmem = kBC + 4 * kX + 1024;       // B, 2 x stages, xw hi / lo
  static constexpr int kOutSmem = 2 * kBC + 2 * kX + 2 * kH + 1024;  // C, B, 2 x, h hi / lo
};

__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ void named_sync(int n_threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n_threads) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// v as hi + lo bf16 pairs: hi = bf16(v), lo = bf16(v - hi); two values a word
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// The inclusive in-chunk cumulative decay of one head in one warp, as ssd_scan.cu forms
// it: each lane sums Q / 32 positions in order, then a shuffle scan over the lanes.
template <int Q>
__device__ __forceinline__ void chunk_cum(const float* dtb, int H, int live, float ah, int lane,
                                          float* cum, float* dts) {
  constexpr int kPer = Q / 32;
  float v[kPer];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int t = lane * kPer + k;
    const float d = t < live ? dtb[static_cast<int64_t>(t) * H] : 0.f;
    dts[t] = d;
    run += d * ah;
    v[k] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += o;
  }
  const float up = __shfl_up_sync(0xffffffffu, tot, 1);
  const float base = lane == 0 ? 0.f : up;
#pragma unroll
  for (int k = 0; k < kPer; ++k) cum[lane * kPer + k] = base + v[k];
}

// 1. Chunk states: Sc[p][n] = sum_s x[s][p] w_s B[s][n], M = p, N = n, K = s. Both
// operands are MN-major in shared memory (rows s): x w as written by the threads in x's
// own swizzled layout, B as TMA wrote it (N / 64 slabs of Q rows).
template <int Q, int N>
__global__ void __launch_bounds__(128)
ssd_chunk_states(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
                 const float* __restrict__ dt, const float* __restrict__ a,
                 float* __restrict__ states, float* __restrict__ cum_out, int S, int H, int nc) {
  using L = Layout<Q, N>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_b;
  __shared__ __align__(8) uint64_t bar_x[2];
  __shared__ float cum[Q];
  __shared__ float dts[Q];
  __shared__ float w[Q];
  unsigned char* sB = align_1k(smem_raw);
  unsigned char* sX = sB + L::kBC;                  // [stage][Q rows][128 B]
  unsigned char* sHi = sX + 2 * L::kX;              // x w, hi and lo, x's layout
  unsigned char* sLo = sHi + L::kX;

  const int h_begin = blockIdx.x * kHeads;
  const int n_heads = min(kHeads, H - h_begin);
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = c * Q;
  const int live = min(Q, S - t0);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;        // accumulator rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);                    // columns 8 j + c0 + {0, 1}

  auto load_x = [&](int i) {
    const int stage = i % 2;
    mbar_expect_tx(&bar_x[stage], L::kX);
    tma_load(sX + stage * L::kX, &tm_x, &bar_x[stage], 0, h_begin + i, t0, b);
  };
  if (tid == 0) {
    mbar_init(&bar_b, 1);
    mbar_init(&bar_x[0], 1);
    mbar_init(&bar_x[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_b, L::kBC);
#pragma unroll
    for (int sl = 0; sl < N / 64; ++sl)
      tma_load_3d(sB + sl * L::kSlab, &tm_b, &bar_b, 64 * sl, t0, b);
    for (int i = 0; i < 2 && i < n_heads; ++i) load_x(i);
  }
  const uint32_t b_addr = smem_u32(sB);
  const uint32_t hi_addr = smem_u32(sHi);
  const uint32_t lo_addr = smem_u32(sLo);

  for (int i = 0; i < n_heads; ++i) {
    const int h = h_begin + i;
    const int stage = i % 2;
    const int64_t slot = (static_cast<int64_t>(b) * nc + c) * H + h;
    if (tid < 32) {
      chunk_cum<Q>(dt + (static_cast<int64_t>(b) * S + t0) * H + h, H, live, a[h], lane, cum,
                   dts);
      __syncwarp();
      const float seg = cum[Q - 1];
      for (int t = lane; t < Q; t += 32) {
        w[t] = expf(seg - cum[t]) * dts[t];
        cum_out[slot * Q + t] = cum[t];
      }
    }
    __syncthreads();                                // w ready
    mbar_wait(&bar_x[stage], (i / 2) & 1);

    // x w in fp32, split into hi / lo bf16 at x's own (swizzled) offsets: a 16-byte
    // chunk holds 8 columns p of one row s
    const unsigned char* xs = sX + stage * L::kX;
    for (int k = tid; k < L::kX / 16; k += 128) {
      const float ws = w[k / (kRow / 16)];
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + 16 * k);
      const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in[e]));
        split2(v.x * ws, v.y * ws, hi[e], lo[e]);
      }
      *reinterpret_cast<uint4*>(sHi + 16 * k) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sLo + 16 * k) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_async_smem();
    __syncthreads();
    if (i == 0) mbar_wait(&bar_b, 0);

    // Sc = (x w)^T . B: K = s in steps of 16 rows (2 KB); A is one slab (P = 64), B's
    // slabs of 64 columns n lie kSlab apart
    float acc[N / 2];
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk)
      wgmma_ss<1, 1>(acc, sw128_desc(hi_addr + kk * 16 * kRow, L::kSlab, 1024),
                     sw128_desc(b_addr + kk * 16 * kRow, L::kSlab, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk)
      wgmma_ss<1, 1>(acc, sw128_desc(lo_addr + kk * 16 * kRow, L::kSlab, 1024),
                     sw128_desc(b_addr + kk * 16 * kRow, L::kSlab, 1024), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    float* st = states + slot * (kP * N);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = r0 + 8 * half;
        *reinterpret_cast<float2*>(st + p * N + 8 * j + c0) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
    __syncthreads();                                // this stage, x w and w are free
    if (tid == 0 && i + 2 < n_heads) load_x(i + 2);
  }
}

// 2. State passing over the chunks, in float32, elementwise: 4 state elements a thread.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ cum,
               const float* __restrict__ h0, float* __restrict__ h_last, int H, int nc, int Q,
               int PN) {
  const int i4 = blockIdx.x * kPassThreads + threadIdx.x;
  if (4 * i4 >= PN) return;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  float4 hv = h0 != nullptr ? reinterpret_cast<const float4*>(h0 + bh * PN)[i4]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t slot0 = static_cast<int64_t>(b) * nc * H + h;   // slot (b, c, h)
  float4 sc = reinterpret_cast<const float4*>(states + slot0 * PN)[i4];
  for (int c = 0; c < nc; ++c) {
    const int64_t slot = slot0 + static_cast<int64_t>(c) * H;
    const float e_seg = expf(cum[slot * Q + Q - 1]);
    float4 next = sc;
    if (c + 1 < nc) next = reinterpret_cast<const float4*>(states + (slot + H) * PN)[i4];
    reinterpret_cast<float4*>(states + slot * PN)[i4] = hv;
    hv.x = fmaf(e_seg, hv.x, sc.x);
    hv.y = fmaf(e_seg, hv.y, sc.y);
    hv.z = fmaf(e_seg, hv.z, sc.z);
    hv.w = fmaf(e_seg, hv.w, sc.w);
    sc = next;
  }
  reinterpret_cast<float4*>(h_last + bh * PN)[i4] = hv;
}

// 3. Chunk outputs, one warpgroup's 64 rows t (warpgroup wg: rows 64 wg ..). NS = 64 (wg +
// 1) columns s: past them the scores are zero.
template <int Q, int N, int NS>
__device__ __forceinline__ void chunk_outputs_rows(
    const CUtensorMap* tm_x, const float* __restrict__ dt, const float* __restrict__ states,
    const float* __restrict__ cum, float* __restrict__ y, unsigned char* sX, unsigned char* sHhi,
    unsigned char* sHlo, uint32_t c_addr, uint32_t b_addr, uint64_t* bar_x, float* cum_s,
    float* dts, int S, int H, int nc, int h_begin, int n_heads, int c, int b) {
  using L = Layout<Q, N>;
  constexpr int kThreads = 2 * Q;                   // Q / 64 warpgroups
  constexpr int wg = NS / 64 - 1;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = 16 * ((tid % 128) / 32) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int t0 = c * Q;
  const int live = min(Q, S - t0);
  const int ta = 64 * wg + r0;                      // this thread's rows ta and ta + 8
  const uint32_t x_addr = smem_u32(sX);
  const uint32_t hhi_addr = smem_u32(sHhi);
  const uint32_t hlo_addr = smem_u32(sHlo);
  const uint32_t c_rows = c_addr + 64 * wg * kRow;  // this warpgroup's rows of C

  // C . B^T for rows ta: K = n in steps of 16 (32 bytes inside a slab's row)
  float cb[NS / 2];
  fence_regs(cb);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t off = (kk / 4) * L::kSlab + (kk % 4) * 32;
    wgmma_ss<0, 0>(cb, sw128_desc(c_rows + off, 16, 1024), sw128_desc(b_addr + off, 16, 1024),
                   kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(cb);

  for (int i = 0; i < n_heads; ++i) {
    const int h = h_begin + i;
    const int stage = i % 2;
    const int64_t slot = (static_cast<int64_t>(b) * nc + c) * H + h;

    // this head's cum and dt; h_in as hi / lo bf16, K-major (rows p, N / 64 slabs)
    for (int t = tid; t < Q; t += kThreads) {
      cum_s[t] = cum[slot * Q + t];
      dts[t] = t < live ? dt[(static_cast<int64_t>(b) * S + t0 + t) * H + h] : 0.f;
    }
    const float* hin = states + slot * (kP * N);
    for (int k = tid; k < kP * N / 8; k += kThreads) {
      const int p = k / (N / 8);
      const int n0 = (k % (N / 8)) * 8;
      const float4 u = *reinterpret_cast<const float4*>(hin + p * N + n0);
      const float4 v = *reinterpret_cast<const float4*>(hin + p * N + n0 + 4);
      uint32_t hi[4], lo[4];
      split2(u.x, u.y, hi[0], lo[0]);
      split2(u.z, u.w, hi[1], lo[1]);
      split2(v.x, v.y, hi[2], lo[2]);
      split2(v.z, v.w, hi[3], lo[3]);
      const int off = (n0 / 64) * kP * kRow + p * kRow + ((((n0 % 64) / 8) ^ (p % 8)) * 16);
      *reinterpret_cast<uint4*>(sHhi + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sHlo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_async_smem();
    named_sync(kThreads);

    // acc = C . h_in^T (hi, then lo), in flight while the scores form
    float acc[kP / 2];
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t c_off = (kk / 4) * L::kSlab + (kk % 4) * 32;
      const uint32_t h_off = (kk / 4) * kP * kRow + (kk % 4) * 32;
      wgmma_ss<0, 0>(acc, sw128_desc(c_rows + c_off, 16, 1024),
                     sw128_desc(hhi_addr + h_off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t c_off = (kk / 4) * L::kSlab + (kk % 4) * 32;
      const uint32_t h_off = (kk / 4) * kP * kRow + (kk % 4) * 32;
      wgmma_ss<0, 0>(acc, sw128_desc(c_rows + c_off, 16, 1024),
                     sw128_desc(hlo_addr + h_off, 16, 1024), 1);
    }
    wgmma_commit();

    // scores[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t (the exponent masked
    // before exp), as hi / lo A fragments: the accumulator's 16-column step is the A
    // fragment of a k-step
    uint32_t shi[NS / 4], slo[NS / 4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = ta + 8 * half;
      const float ct = cum_s[t];
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = 8 * j + c0 + e;
          v[e] = s <= t ? cb[4 * j + 2 * half + e] * expf(ct - cum_s[s]) * dts[s] : 0.f;
        }
        split2(v[0], v[1], shi[2 * j + half], slo[2 * j + half]);
      }
    }
    wgmma_wait_all();
    fence_regs(acc);
    const float e0 = expf(cum_s[ta]);
    const float e1 = expf(cum_s[ta + 8]);
#pragma unroll
    for (int j = 0; j < kP / 8; ++j) {
      acc[4 * j] *= e0;
      acc[4 * j + 1] *= e0;
      acc[4 * j + 2] *= e1;
      acc[4 * j + 3] *= e1;
    }

    // acc += scores . x: K = s in steps of 16 rows of x (MN-major, one slab)
    mbar_wait(&bar_x[stage], (i / 2) & 1);
    const uint32_t xs = x_addr + stage * L::kX;
    fence_regs(acc);
    fence_regs(shi);
    fence_regs(slo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk) {
      const uint32_t ah[4] = {shi[4 * kk], shi[4 * kk + 1], shi[4 * kk + 2], shi[4 * kk + 3]};
      const uint32_t al[4] = {slo[4 * kk], slo[4 * kk + 1], slo[4 * kk + 2], slo[4 * kk + 3]};
      const uint64_t desc = sw128_desc(xs + kk * 16 * kRow, L::kSlab, 1024);
      wgmma_rs_n64(acc, ah, desc);
      wgmma_rs_n64(acc, al, desc);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(shi);
    fence_regs(slo);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = ta + 8 * half;
      if (t >= live) continue;
      float* yr = y + ((static_cast<int64_t>(b) * S + t0 + t) * H + h) * kP;
#pragma unroll
      for (int j = 0; j < kP / 8; ++j)
        *reinterpret_cast<float2*>(yr + 8 * j + c0) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
    named_sync(kThreads);                           // this stage, h_in and cum are free
    if (tid == 0 && i + 2 < n_heads) {
      mbar_expect_tx(&bar_x[stage], L::kX);
      tma_load(sX + stage * L::kX, tm_x, &bar_x[stage], 0, h + 2, t0, b);
    }
  }
}

template <int Q, int N>
__global__ void __launch_bounds__(2 * Q, 1)
ssd_chunk_outputs(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ dt,
                  const float* __restrict__ states, const float* __restrict__ cum,
                  float* __restrict__ y, int S, int H, int nc) {
  using L = Layout<Q, N>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_bc;
  __shared__ __align__(8) uint64_t bar_x[2];
  __shared__ float cum_s[Q];
  __shared__ float dts[Q];
  unsigned char* sC = align_1k(smem_raw);
  unsigned char* sB = sC + L::kBC;
  unsigned char* sX = sB + L::kBC;                  // [stage][Q rows][128 B]
  unsigned char* sHhi = sX + 2 * L::kX;             // [slab][P rows][128 B]
  unsigned char* sHlo = sHhi + L::kH;

  const int h_begin = blockIdx.x * kHeads;
  const int n_heads = min(kHeads, H - h_begin);
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = c * Q;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&bar_bc, 1);
    mbar_init(&bar_x[0], 1);
    mbar_init(&bar_x[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_bc, 2 * L::kBC);
#pragma unroll
    for (int sl = 0; sl < N / 64; ++sl) {
      tma_load_3d(sC + sl * L::kSlab, &tm_c, &bar_bc, 64 * sl, t0, b);
      tma_load_3d(sB + sl * L::kSlab, &tm_b, &bar_bc, 64 * sl, t0, b);
    }
    for (int i = 0; i < 2 && i < n_heads; ++i) {
      mbar_expect_tx(&bar_x[i], L::kX);
      tma_load(sX + i * L::kX, &tm_x, &bar_x[i], 0, h_begin + i, t0, b);
    }
  }
  mbar_wait(&bar_bc, 0);
  const uint32_t c_addr = smem_u32(sC);
  const uint32_t b_addr = smem_u32(sB);
  if (tid < 128) {
    chunk_outputs_rows<Q, N, 64>(&tm_x, dt, states, cum, y, sX, sHhi, sHlo, c_addr, b_addr,
                                 bar_x, cum_s, dts, S, H, nc, h_begin, n_heads, c, b);
  } else if constexpr (Q == 128) {
    chunk_outputs_rows<Q, N, 128>(&tm_x, dt, states, cum, y, sX, sHhi, sHlo, c_addr, b_addr,
                                  bar_x, cum_s, dts, S, H, nc, h_begin, n_heads, c, b);
  }
}

// A tiled bf16 map of `rank` dims (innermost first), strides in bytes for dims 1.., boxes
// of 64 innermost elements, 128-byte swizzle.
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int Q, int N>
int launch(const void* x, const void* bm, const void* cm, const float* dt, const float* a,
           const float* h0, float* y, float* h_last, float* states, float* cum, int B, int S,
           int H, int64_t x_sb, int64_t x_ss, int64_t b_sb, int64_t b_ss, int64_t c_sb,
           int64_t c_ss, cudaStream_t stream) {
  using L = Layout<Q, N>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_x, tm_b, tm_c;
  const cuuint64_t x_dims[4] = {kP, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t x_strides[3] = {kP * 2, static_cast<cuuint64_t>(x_ss) * 2,
                                   static_cast<cuuint64_t>(x_sb) * 2};
  const cuuint32_t x_box[4] = {64, 1, Q, 1};
  const cuuint64_t bc_dims[3] = {N, static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t b_strides[2] = {static_cast<cuuint64_t>(b_ss) * 2,
                                   static_cast<cuuint64_t>(b_sb) * 2};
  const cuuint64_t c_strides[2] = {static_cast<cuuint64_t>(c_ss) * 2,
                                   static_cast<cuuint64_t>(c_sb) * 2};
  const cuuint32_t bc_box[3] = {64, Q, 1};
  if (!encode_map(encode, &tm_x, x, 4, x_dims, x_strides, x_box) ||
      !encode_map(encode, &tm_b, bm, 3, bc_dims, b_strides, bc_box) ||
      !encode_map(encode, &tm_c, cm, 3, bc_dims, c_strides, bc_box))
    return static_cast<int>(cudaErrorInvalidValue);

  const int nc = (S + Q - 1) / Q;
  const dim3 grid((H + kHeads - 1) / kHeads, nc, B);
  auto k1 = ssd_chunk_states<Q, N>;
  cudaError_t err =
      cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kStateSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k1<<<grid, 128, L::kStateSmem, stream>>>(tm_x, tm_b, dt, a, states, cum, S, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const int PN = kP * N;
  ssd_state_pass<<<dim3((PN / 4 + kPassThreads - 1) / kPassThreads, H, B), kPassThreads, 0,
                   stream>>>(states, cum, h0, h_last, H, nc, Q, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  auto k3 = ssd_chunk_outputs<Q, N>;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kOutSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k3<<<grid, 2 * Q, L::kOutSmem, stream>>>(tm_x, tm_b, tm_c, dt, states, cum, y, S, H, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, S, H, P) with strides (x_sb, x_ss, P, 1); bm / cm (B, S, N) with strides
// (*_sb, *_ss, 1); all bfloat16, 16-byte aligned, the strides multiples of 8 elements.
// dt (B, S, H), a (H,), h0 (B, H, P, N) or null, y (B, S, H, P), h_last (B, H, P, N):
// contiguous float32. Scratch from the caller: states (B, nc, H, P, N) and cum
// (B, nc, H, Q) float32, nc = ceil(S / Q). P = 64, N in {64, 128}, Q in {64, 128} (the
// chunk; S may be shorter), S >= 1. Three launches on `stream`.
extern "C" int repro_ssd_scan_tc(const void* x, const void* bm, const void* cm, const float* dt,
                                 const float* a, const float* h0, float* y, float* h_last,
                                 float* states, float* cum, int B, int S, int H, int P, int N,
                                 int Q, int64_t x_sb, int64_t x_ss, int64_t b_sb, int64_t b_ss,
                                 int64_t c_sb, int64_t c_ss, void* stream) {
  if (P != kP || S < 1 || B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_TC(QQ, NN)                                                                  \
  if (Q == QQ && N == NN)                                                                     \
    return launch<QQ, NN>(x, bm, cm, dt, a, h0, y, h_last, states, cum, B, S, H, x_sb, x_ss, \
                          b_sb, b_ss, c_sb, c_ss, st);
  REPRO_SSD_TC(64, 64)
  REPRO_SSD_TC(64, 128)
  REPRO_SSD_TC(128, 64)
  REPRO_SSD_TC(128, 128)
#undef REPRO_SSD_TC
  return static_cast<int>(cudaErrorInvalidValue);
}
