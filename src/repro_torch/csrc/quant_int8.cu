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
// What bounds them on this card: bytes. K3 reads x once (4 B an element in float32, 2 in
// bfloat16) and writes q (1 B) and a scale a block; K3' reads q and the scales and writes
// 4 B an element. At the FL round's fc1 weight (6,422,528 float32 elements, one block)
// K3 moves 32.1 MB, 9.6 us at 3.35 TB/s.
//
// Design:
//   * a block that fits one CTA's tile (block <= 4096 elements, the default block among
//     them): quant_tile_kernel, one CTA a block, one pass. 256 threads hold 16 elements
//     each in registers, reduce |x| with a warp max-reduction and 8 warp partials in
//     shared memory, form the scale and write q and the scale;
//   * a larger block (the FL round quantises each model leaf as one block): the TPU
//     kernel holds the whole block in VMEM, and the function needs the block's max before
//     it can write any q; no CTA here holds 25.7 MB. quant_grid_kernel is one cooperative
//     launch of one 512-thread CTA an SM (at most the SM count, at least 4096 elements a
//     CTA), all resident at once, so that a grid-wide barrier is safe:
//       1. each CTA takes a contiguous share of x in 16-byte units counted from x's first
//          16-byte aligned element (CTA 0 also takes the elements before it, the last CTA
//          those past the last whole unit) and copies as much of the share as fits
//          (kMaxResident bytes) into shared memory by 1-D TMA bulk copies of 32 KB, each
//          on its own mbarrier so that step 2 starts on the first to land;
//       2. for each block its share touches, it reduces |x| as bits (the bits of
//          non-negative floats order as their values, so the max is exact in any order)
//          and writes that partial max to slot (CTA + block) of a scratch array. The
//          (CTA, block) pairs of contiguous shares form a staircase, so their slots are
//          distinct; every slot that is read was written earlier in the same launch, so
//          nothing is zeroed before it (no memset) and nothing is left to reset;
//       3. the grid barrier (cooperative groups);
//       4. for each of its blocks a CTA takes the max of the slots of the CTAs that share
//          the block, forms the scale and writes q from shared memory, 4 (float32) or 8
//          (bfloat16) int8 a store where x is 16-byte aligned; the CTA that holds a
//          block's first element writes its scale; the pad past n is written as q = 0.
//     So x is read once, in one launch. Past the card's resident capacity, SMs x
//     kMaxResident bytes (132 x 231,424 = 30.5 MB on an H100: 7.6 M float32 or 15.3 M
//     bfloat16 elements), each CTA reads the rest of its share from global memory in
//     step 2 and again in step 4: every byte past that point is read twice, the second
//     time from L2 where it still lies there;
//   * q is rint of the IEEE quotient for every nonzero element (rintf and '/', built
//     without fast math): the TPU kernel's jnp.round rounds half to even, and a multiply
//     by 1/127 or by 1/scale would round apart; a zero is q = 0 without a division;
//   * dequantisation: one CTA a tile of one block, so the scale is read once a CTA; 4 int8
//     a load and a float4 a store where block % 4 == 0 and the pointers allow, else one
//     element at a time.
#include <cooperative_groups.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                   // elements a thread
constexpr int kTile = kThreads * kPer;     // 4096 elements a CTA

constexpr int kGridThreads = 512;          // a CTA of quant_grid_kernel, one an SM
constexpr int kGridWarps = kGridThreads / 32;
constexpr int64_t kMaxResident = 231424;   // bytes of x a CTA holds in shared memory
constexpr int kBulkUnits = 2048;           // 16-byte units a bulk copy, one mbarrier each
constexpr int kMaxBulks = static_cast<int>((kMaxResident / 16 + kBulkUnits - 1) / kBulkUnits);

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ unsigned umax(unsigned a, unsigned b) { return a > b ? a : b; }

// |v| as its bits: for non-negative floats (and +inf) the bits order as the values
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(fabsf(v)); }

__device__ __forceinline__ float scale_of(unsigned amax_bits) {
  const float amax = __uint_as_float(amax_bits);
  return amax > 0.f ? amax / 127.0f : 1.0f;
}

// q of v: rint of the IEEE quotient, clamped. A zero (of either sign) is q = 0 under every
// scale formed here (positive, finite or +inf), so its division is skipped: the division
// takes its slow path on a zero dividend, and a trained update holds whole rows of zeros
// (input features that never fired).
__device__ __forceinline__ int8_t quantize(float v, float scale) {
  if (v == 0.f) return 0;
  const float r = fminf(fmaxf(rintf(v / scale), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// the max of m over the CTA of kW warps, returned to every thread; partial is free again
// when it returns
template <int kW>
__device__ __forceinline__ unsigned cta_max(unsigned m, unsigned* partial) {
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = m;
  __syncthreads();
  m = partial[0];
#pragma unroll
  for (int w = 1; w < kW; ++w) m = umax(m, partial[w]);
  __syncthreads();
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
  const float scale = scale_of(cta_max<kWarps>(m, partial));
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < block) q[base + i] = quantize(v[k], scale);
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

// the 16 / sizeof(T) values of one 16-byte unit of x, as floats (bfloat16 -> float is a
// shift of the bits)
__device__ __forceinline__ void unpack(uint4 raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(uint4 raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the low bytes of four words in one
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// q[0 .. V) from a unit's V values, one store (q aligned to V bytes)
template <int V>
__device__ __forceinline__ void store_unit(int8_t* q, const float (&v)[V], float scale) {
  uint32_t b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) b[i] = static_cast<uint8_t>(quantize(v[i], scale));
  if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(q) = low_bytes(b[0], b[1], b[2], b[3]);
  } else {
    *reinterpret_cast<uint2*>(q) =
        make_uint2(low_bytes(b[0], b[1], b[2], b[3]), low_bytes(b[4], b[5], b[6], b[7]));
  }
}

template <typename T>
struct GridArgs {
  const T* x;
  int64_t n, block, n_pad;
  int64_t head;       // elements before x's first 16-byte aligned one (at most n)
  int64_t units;      // whole 16-byte units from there
  int64_t cap_units;  // units a CTA holds in shared memory
  int8_t* q;
  float* scales;
  unsigned* partial;  // slot (CTA + block): that CTA's max |x| bits over that block
};

// the max |x| bits over the values v of a unit whose first element is e, of those whose
// element lies in [lo, hi) (elements counted from the CTA's first unit)
template <int V>
__device__ __forceinline__ unsigned unit_max(const float (&v)[V], int e, int lo, int hi) {
  unsigned m = 0u;
  if (e >= lo && e + V <= hi) {
#pragma unroll
    for (int k = 0; k < V; ++k) m = umax(m, abs_bits(v[k]));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (e + k >= lo && e + k < hi) m = umax(m, abs_bits(v[k]));
  }
  return m;
}

// q of the same values into q[e + k]; one store for a whole unit where vec
template <int V>
__device__ __forceinline__ void unit_write(const float (&v)[V], int e, int lo, int hi,
                                           int8_t* q, float scale, bool vec) {
  if (vec && e >= lo && e + V <= hi) {
    store_unit(q + e, v, scale);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (e + k >= lo && e + k < hi) q[e + k] = quantize(v[k], scale);
  }
}

// one launch for blocks past kTile elements (design above); gridDim.x <= units
template <typename T>
__global__ void __launch_bounds__(kGridThreads, 1) quant_grid_kernel(const GridArgs<T> p) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) uint4 resident[];
  __shared__ unsigned warp_max[kGridWarps];
  __shared__ __align__(8) uint64_t bar[kMaxBulks];
  const int64_t G = gridDim.x, c = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t u_lo = p.units * c / G, u_hi = p.units * (c + 1) / G;
  const int n_units = static_cast<int>(u_hi - u_lo);           // this CTA's units
  const int n_res = static_cast<int>(lmin(n_units, p.cap_units));  // the resident ones
  const int64_t e_first = p.head + u_lo * V;  // the element of the CTA's first unit
  const int64_t lo = c == 0 ? 0 : e_first;    // this CTA's elements: [lo, hi)
  const int64_t hi = c == G - 1 ? p.n : p.head + u_hi * V;
  const int64_t tail = p.head + p.units * V;  // loose elements: [0, head) and [tail, n)
  const uint4* xs = reinterpret_cast<const uint4*>(p.x + e_first);
  int8_t* qs = p.q + e_first;
  const bool vec = p.head == 0;  // qs + a unit's first element is then aligned

  // 1. the resident units into shared memory, one mbarrier a bulk copy so that step 2
  // starts on the first copy to land
  const int n_bulks = (n_res + kBulkUnits - 1) / kBulkUnits;
  if (tid == 0) {
    for (int j = 0; j < kMaxBulks; ++j) mbar_init(&bar[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < n_bulks; ++j) {
      const uint32_t bytes = static_cast<uint32_t>(min(n_res - j * kBulkUnits, kBulkUnits)) * 16u;
      mbar_expect_tx(&bar[j], bytes);
      bulk_load(resident + j * kBulkUnits, xs + j * kBulkUnits, bytes, &bar[j]);
    }
  }
  // the pad past n is q = 0 whatever the scale; written while the copies fly
  for (int64_t e = p.n + c * kGridThreads + tid; e < p.n_pad; e += G * kGridThreads) p.q[e] = 0;

  // the units of block b's elements [s_lo, s_hi) in this share: [ua, ub), with the
  // segment's bounds counted from e_first
  const int64_t b_first = lo / p.block, b_last = (hi - 1) / p.block;
  struct Segment {
    int64_t s_lo, s_hi;
    int l_lo, l_hi, ua, ub;
  };
  const auto segment = [&](int64_t b) {
    Segment g;
    g.s_lo = lmax(lo, b * p.block);
    g.s_hi = lmin(hi, (b + 1) * p.block);
    g.l_lo = static_cast<int>(g.s_lo - e_first);  // negative in CTA 0's loose head
    g.l_hi = static_cast<int>(g.s_hi - e_first);
    g.ua = g.l_lo > 0 ? g.l_lo / V : 0;
    g.ub = g.l_hi > 0 ? min(n_units, (g.l_hi + V - 1) / V) : 0;
    return g;
  };

  // 2. each block's partial max over this share
  for (int64_t b = b_first; b <= b_last; ++b) {
    const Segment g = segment(b);
    unsigned m = 0u;
    for (int64_t e = g.s_lo + tid; e < lmin(g.s_hi, p.head); e += kGridThreads)
      m = umax(m, abs_bits(to_float(p.x[e])));
    for (int64_t e = lmax(g.s_lo, tail) + tid; e < g.s_hi; e += kGridThreads)
      m = umax(m, abs_bits(to_float(p.x[e])));
    float v[V];
    for (int i = max(g.ua, n_res) + tid; i < g.ub; i += kGridThreads) {
      unpack(__ldg(xs + i), v);
      m = umax(m, unit_max(v, i * V, g.l_lo, g.l_hi));
    }
    const int r_end = min(g.ub, n_res);
    for (int j = g.ua / kBulkUnits; j * kBulkUnits < r_end; ++j) {
      mbar_wait(&bar[j], 0);
      const int j_end = min(r_end, (j + 1) * kBulkUnits);
      for (int i = max(g.ua, j * kBulkUnits) + tid; i < j_end; i += kGridThreads) {
        unpack(resident[i], v);
        m = umax(m, unit_max(v, i * V, g.l_lo, g.l_hi));
      }
    }
    m = cta_max<kGridWarps>(m, warp_max);
    if (tid == 0) p.partial[c + b] = m;
  }

  // 3. every partial of every CTA written and visible
  cooperative_groups::this_grid().sync();

  // 4. the scale of each block from its CTAs' partials, then q
  const auto cta_of = [&](int64_t e) -> int64_t {
    if (e < p.head) return 0;
    const int64_t u = (e - p.head) / V;
    return u >= p.units ? G - 1 : ((u + 1) * G - 1) / p.units;
  };
  for (int64_t b = b_first; b <= b_last; ++b) {
    const Segment g = segment(b);
    const int64_t c_first = cta_of(b * p.block);
    const int64_t c_last = cta_of(lmin((b + 1) * p.block, p.n) - 1);
    unsigned m = 0u;
    for (int64_t i = c_first + tid; i <= c_last; i += kGridThreads)
      m = umax(m, __ldcg(p.partial + i + b));
    const float scale = scale_of(cta_max<kGridWarps>(m, warp_max));
    if (tid == 0 && b * p.block >= lo) p.scales[b] = scale;
    float v[V];
    const int r_end = min(g.ub, n_res);
    for (int i = g.ua + tid; i < r_end; i += kGridThreads) {
      unpack(resident[i], v);
      unit_write(v, i * V, g.l_lo, g.l_hi, qs, scale, vec);
    }
    for (int i = max(g.ua, n_res) + tid; i < g.ub; i += kGridThreads) {
      unpack(__ldg(xs + i), v);
      unit_write(v, i * V, g.l_lo, g.l_hi, qs, scale, vec);
    }
    for (int64_t e = g.s_lo + tid; e < lmin(g.s_hi, p.head); e += kGridThreads)
      p.q[e] = quantize(to_float(p.x[e]), scale);
    for (int64_t e = lmax(g.s_lo, tail) + tid; e < g.s_hi; e += kGridThreads)
      p.q[e] = quantize(to_float(p.x[e]), scale);
  }
}

// CTA t of a large-block grid covers tile t % tiles of block t / tiles: elements
// [lo, hi) with lo = block_start + tile * kTile, hi at most the block's end
struct Tile {
  int64_t b, lo, hi;
};

__device__ __forceinline__ Tile tile_of(int64_t block, int tiles) {
  const int64_t b = blockIdx.x / tiles;
  const int k = static_cast<int>(blockIdx.x % tiles);
  const int64_t lo = b * block + static_cast<int64_t>(k) * kTile;
  return {b, lo, lmin(lo + kTile, (b + 1) * block)};
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

// Per device, found on its first large-block call and kept: the SM count, and whether
// quant_grid_kernel<T> may take kMaxResident bytes of dynamic shared memory (the most a
// launch asks for), so that a call makes no query of the device after the first.
constexpr int kMaxDevices = 64;
std::atomic<int> g_sms[kMaxDevices];
std::atomic<bool> g_smem_set[2][kMaxDevices];  // [bfloat16][device]

template <typename T>
cudaError_t grid_setup(int* sms) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<bool>& smem_set = g_smem_set[sizeof(T) == 2][dev];
  if (!smem_set.load(std::memory_order_acquire)) {
    rc = cudaFuncSetAttribute(quant_grid_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kMaxResident));
    if (rc != cudaSuccess) return rc;
    smem_set.store(true, std::memory_order_release);
  }
  *sms = g_sms[dev].load(std::memory_order_relaxed);
  if (*sms == 0) {
    rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return rc;
    g_sms[dev].store(*sms, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

template <typename T>
int launch_grid(const void* x, int64_t n, int64_t block, int64_t n_blocks, int8_t* q,
                float* scales, unsigned* partial, int64_t partial_words, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  int sms = 0;
  cudaError_t rc = grid_setup<T>(&sms);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  GridArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.n = n;
  a.block = block;
  a.n_pad = n_blocks * block;
  const int64_t misalign = static_cast<int64_t>(reinterpret_cast<uintptr_t>(x) % 16);
  a.head = lmin(n, (16 - misalign) % 16 / static_cast<int64_t>(sizeof(T)));
  a.units = (n - a.head) / V;
  const int64_t grid = lmin(lmin(sms, (n + kTile - 1) / kTile), a.units);
  if (grid < 1 || partial == nullptr || grid + n_blocks - 1 > partial_words)
    return static_cast<int>(cudaErrorInvalidValue);
  a.cap_units = lmin((a.units + grid - 1) / grid, kMaxResident / 16);
  a.q = q;
  a.scales = scales;
  a.partial = partial;
  const int smem = static_cast<int>(a.cap_units * 16);
  void* args[] = {&a};
  rc = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(quant_grid_kernel<T>),
                                   dim3(static_cast<unsigned>(grid)), dim3(kGridThreads), args,
                                   static_cast<size_t>(smem), st);
  if (rc != cudaSuccess) cudaGetLastError();  // clear it: it is returned
  return static_cast<int>(rc);
}

template <typename T>
int launch_quant(const void* x, int64_t n, int64_t block, int64_t n_blocks, int8_t* q,
                 float* scales, unsigned* partial, int64_t partial_words, cudaStream_t st) {
  if (block > kTile)
    return launch_grid<T>(x, n, block, n_blocks, q, scales, partial, partial_words, st);
  quant_tile_kernel<T><<<static_cast<unsigned>(n_blocks), kThreads, 0, st>>>(
      static_cast<const T*>(x), n, static_cast<int>(block), q, scales);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n elements, contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1); block >= 1;
// q: ceil(n / block) * block int8; scales: ceil(n / block) float32. Where block > 4096:
// partial, partial_words uint32 of scratch, at least the SM count + ceil(n / block) - 1
// words, used by one launch at a time (it needs no initial value and keeps none);
// otherwise unused (may be null). One kernel launch at every block size.
extern "C" int repro_quant_int8_fwd(const void* x, int64_t n, int64_t block, int bf16, void* q,
                                    void* scales, void* partial, int64_t partial_words,
                                    void* stream) {
  if (n <= 0 || block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_blocks = (n + block - 1) / block;
  if (n_blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scales);
  unsigned* pp = static_cast<unsigned*>(partial);
  return bf16 ? launch_quant<__nv_bfloat16>(x, n, block, n_blocks, qp, sp, pp, partial_words, st)
              : launch_quant<float>(x, n, block, n_blocks, qp, sp, pp, partial_words, st);
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
