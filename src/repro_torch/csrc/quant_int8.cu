// K3 and K3': blockwise symmetric int8 quantisation and its inverse, hand-written for
// sm_90a.
//
// Replace the TPU kernels repro/kernels/quant/kernel.py::quantize_int8_fwd (body
// _quant_kernel, kernel.py:46) and ::dequantize_int8_fwd (body _dequant_kernel,
// kernel.py:69). They compute what the plain quantize_int8_ref and dequantize_int8_ref
// compute: the flat input, zero-padded to n_pad = ceil(n / block) * block, cut into
// blocks of `block` elements, and for each block
//   amax  = max |x|,   scale = amax > 0 ? amax / 127 : 1      (float32, IEEE division)
//   q     = clamp(rint(x / scale), -127, 127)                 (half to even, IEEE division)
// and back, x' = q * scale, in float32. The input is float32 or bfloat16, read in place.
//
// Design (simple and right first):
//   * a block that fits one CTA's tile (block <= 4096 elements, the default block among
//     them): one CTA a block, one pass. 256 threads hold 16 elements each in registers,
//     reduce |x| with a warp max-reduction and 8 warp partials in shared memory, form the
//     scale and write q and the scale;
//   * a larger block (the FL round quantises each model leaf as one block: the fc1
//     weight is 6.4 M elements) is spread over many CTAs of 4096 elements, in two passes.
//     The first reduces each tile's |x| and atomicMax-es the float's bits into a per-block
//     uint32 word zeroed first: the bits of non-negative floats order as their values, so
//     the max is exact and independent of the order the CTAs run in. The second reads x
//     again (from the 50 MB L2 where it still lies there), forms the scale from that word
//     and writes q; the first CTA of each block writes its scale;
//   * the pad past n reads as 0 and is written as q = 0; nothing is padded on the host;
//   * rintf and IEEE '/' throughout, built without fast math: the TPU kernel's jnp.round
//     rounds half to even, and a multiply by 1/127 or by 1/scale would round apart;
//   * dequantisation: one CTA a tile of one block, so the scale is read once a CTA; 4 int8
//     a load and a float4 a store where block % 4 == 0 and the pointers allow, else one
//     element at a time.
// What bounds them on this card: bytes. K3 reads x once (4 B an element in float32) and
// writes q (1 B) and a scale a block; K3' reads q and the scales and writes 4 B an
// element. The whole CNN update (6.6 M elements) is 33 MB either way, ~9.9 us at
// 3.35 TB/s. The two-pass path reads x a second time, from L2 where it fits; a small leaf
// (a bias, conv1) is bound by the launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                   // elements a thread
constexpr int kTile = kThreads * kPer;     // 4096 elements a CTA

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ unsigned umax(unsigned a, unsigned b) { return a > b ? a : b; }

// |v| as its bits: for non-negative floats (and +inf) the bits order as the values
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(fabsf(v)); }

__device__ __forceinline__ float scale_of(unsigned amax_bits) {
  const float amax = __uint_as_float(amax_bits);
  return amax > 0.f ? amax / 127.0f : 1.0f;
}

__device__ __forceinline__ int8_t quantize(float v, float scale) {
  const float r = fminf(fmaxf(rintf(v / scale), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// the max of m over the CTA, returned to every thread; one call a kernel
__device__ __forceinline__ unsigned cta_max(unsigned m, unsigned* partial) {
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = m;
  __syncthreads();
  m = partial[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = umax(m, partial[w]);
  return m;
}

// one CTA a block of at most kTile elements: reduce, then write
template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_tile_kernel(const T* __restrict__ x, int64_t n, int block, int8_t* __restrict__ q,
                  float* __restrict__ scales) {
  __shared__ unsigned partial[kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  float v[kPer];
  unsigned m = 0u;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    v[k] = (i < block && base + i < n) ? to_float(x[base + i]) : 0.f;
    m = umax(m, abs_bits(v[k]));
  }
  const float scale = scale_of(cta_max(m, partial));
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < block) q[base + i] = quantize(v[k], scale);
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

// CTA t of a large-block grid covers tile t % tiles of block t / tiles: elements
// [lo, hi) with lo = block_start + tile * kTile, hi at most the block's end
struct Tile {
  int64_t b, lo, hi;
  bool first;
};

__device__ __forceinline__ Tile tile_of(int64_t block, int tiles) {
  const int64_t b = blockIdx.x / tiles;
  const int k = static_cast<int>(blockIdx.x % tiles);
  const int64_t lo = b * block + static_cast<int64_t>(k) * kTile;
  return {b, lo, lmin(lo + kTile, (b + 1) * block), k == 0};
}

// pass 1: each tile's max |x| into the block's word (zeroed before)
template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_amax_kernel(const T* __restrict__ x, int64_t n, int64_t block, int tiles,
                  unsigned* __restrict__ amax_bits) {
  __shared__ unsigned partial[kWarps];
  const Tile t = tile_of(block, tiles);
  const int64_t hi = lmin(t.hi, n);
  unsigned m = 0u;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t e = t.lo + threadIdx.x + k * kThreads;
    if (e < hi) m = umax(m, abs_bits(to_float(x[e])));
  }
  m = cta_max(m, partial);
  if (threadIdx.x == 0 && m != 0u) atomicMax(amax_bits + t.b, m);
}

// pass 2: q for each element of the tile, the pad included; the block's scale
template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_write_kernel(const T* __restrict__ x, int64_t n, int64_t block, int tiles,
                   const unsigned* __restrict__ amax_bits, int8_t* __restrict__ q,
                   float* __restrict__ scales) {
  const Tile t = tile_of(block, tiles);
  const float scale = scale_of(amax_bits[t.b]);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t e = t.lo + threadIdx.x + k * kThreads;
    if (e < t.hi) q[e] = quantize(e < n ? to_float(x[e]) : 0.f, scale);
  }
  if (t.first && threadIdx.x == 0) scales[t.b] = scale;
}

// x' = q * scale over one tile of one block; kVec: 4 elements a thread-step (block % 4 == 0)
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales, int64_t block,
               int tiles, float* __restrict__ out) {
  const Tile t = tile_of(block, tiles);
  const float s = scales[t.b];
  if (kVec) {
#pragma unroll
    for (int k = 0; k < kPer / 4; ++k) {
      const int64_t e = t.lo + 4 * static_cast<int64_t>(threadIdx.x + k * kThreads);
      if (e < t.hi) {
        const char4 v = *reinterpret_cast<const char4*>(q + e);
        *reinterpret_cast<float4*>(out + e) = make_float4(
            static_cast<float>(v.x) * s, static_cast<float>(v.y) * s,
            static_cast<float>(v.z) * s, static_cast<float>(v.w) * s);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t e = t.lo + threadIdx.x + k * kThreads;
      if (e < t.hi) out[e] = static_cast<float>(q[e]) * s;
    }
  }
}

template <typename T>
int launch_quant(const void* x, int64_t n, int64_t block, int64_t n_blocks, int8_t* q,
                 float* scales, unsigned* amax_bits, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (block <= kTile) {
    quant_tile_kernel<T><<<static_cast<unsigned>(n_blocks), kThreads, 0, st>>>(
        xt, n, static_cast<int>(block), q, scales);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t tiles = (block + kTile - 1) / kTile;
  const unsigned grid = static_cast<unsigned>(n_blocks * tiles);
  const cudaError_t rc = cudaMemsetAsync(amax_bits, 0, n_blocks * sizeof(unsigned), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  quant_amax_kernel<T><<<grid, kThreads, 0, st>>>(xt, n, block, static_cast<int>(tiles),
                                                   amax_bits);
  quant_write_kernel<T><<<grid, kThreads, 0, st>>>(xt, n, block, static_cast<int>(tiles),
                                                    amax_bits, q, scales);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n elements, contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1); block >= 1;
// q: ceil(n / block) * block int8; scales: ceil(n / block) float32; amax_bits:
// ceil(n / block) uint32 of scratch where block > 4096, else unused (may be null).
extern "C" int repro_quant_int8_fwd(const void* x, int64_t n, int64_t block, int bf16,
                                    void* q, void* scales, void* amax_bits, void* stream) {
  if (n <= 0 || block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_blocks = (n + block - 1) / block;
  const int64_t tiles = (block + kTile - 1) / kTile;
  if (n_blocks * tiles > INT32_MAX || (tiles > 1 && amax_bits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scales);
  unsigned* bits = static_cast<unsigned*>(amax_bits);
  return bf16 ? launch_quant<__nv_bfloat16>(x, n, block, n_blocks, qp, sp, bits, st)
              : launch_quant<float>(x, n, block, n_blocks, qp, sp, bits, st);
}

// q: n_pad int8 with n_pad a multiple of block; scales: n_pad / block float32;
// out: n_pad float32.
extern "C" int repro_dequant_int8_fwd(const void* q, const void* scales, int64_t n_pad,
                                      int64_t block, void* out, void* stream) {
  if (n_pad <= 0 || block <= 0 || n_pad % block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (block + kTile - 1) / kTile;
  if ((n_pad / block) * tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((n_pad / block) * tiles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  const bool vec = block % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    dequant_kernel<true><<<grid, kThreads, 0, st>>>(qp, sp, block, static_cast<int>(tiles), op);
  else
    dequant_kernel<false><<<grid, kThreads, 0, st>>>(qp, sp, block, static_cast<int>(tiles), op);
  return static_cast<int>(cudaGetLastError());
}
