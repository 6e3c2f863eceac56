// K2: oldest-first waterfill grant, hand-written for sm_90a, in float64.
//
// Replaces the TPU kernel repro/kernels/ponsim/kernel.py::waterfill_grants_pallas
// (body _waterfill_kernel). Per row: serve queues in stable (key, index) order,
// granting each min(backlog, room) with room = cap - (water poured ahead of it),
// and nothing once room <= 1e-9. Rows the caller marks not `hard` (total demand
// at least one bit under capacity) get their backlog back unchanged.
//
// This is not the TPU kernel's float32 rank-sum. It must equal the host engine
// (repro/net/engine.py::_waterfill: stable argsort + np.cumsum) bit for bit in
// float64, because the queue serve step detects full drains by float equality
// and one ulp in the marginal queue's room can move a completion by a cycle.
// One block a row, at any row width:
//   * rank by sorting: the row's (key, index) pairs, keys mapped to their
//     order-preserving 64-bit image, are bitonic-sorted over the row padded to
//     a power of two (padding: the largest image, indices past N, so it sorts
//     last). Indices are unique, so the order is np.argsort(kind="stable")'s;
//     the work is O(N log^2 N / threads). Stages whose pairs lie 64 or more
//     apart take one barrier each through shared memory; the shorter ones run
//     in registers and shuffles, a warp a 64-element segment, all of a merge's
//     short stages in one pass (at 2,048 queues: 21 barriers, not 66);
//   * the prefix stays sequential, left to right, as np.cumsum adds: warp 0
//     walks the backlog in rank order 32 at a time. Each lane reads the 32
//     values by broadcast loads, 16 issued ahead of 16 adds (1,024 threads a
//     block leave 64 registers a thread), every lane runs the same dependent
//     float64 chain, and lane j keeps the prefix of the j-th queue; room = cap - (prefix - b) is then formed per lane, exactly as the
//     reference writes it, and the grant is written back in place;
//   * the grants are scattered to the queues' own places.
// The pairs take 12 bytes a padded queue. Up to the card's opt-in shared memory
// (227 KB: 16,384 queues) they live in shared memory; past it the wrapper
// passes a global scratch buffer and the same kernel runs over it.
// What bounds it on this card: the serial prefix, N dependent float64 adds (a
// few cycles each) on one warp; the sort's log^2 N barriers come next. A row
// of the engine holds a few kilobytes, so launch latency dominates below ~1,000
// queues.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kCapEps = 1e-9;
constexpr int kMaxThreads = 1024;
constexpr size_t kPairBytes = sizeof(uint64_t) + sizeof(int);

// The order-preserving image of a float64 key (not NaN); -0.0 maps as +0.0,
// since the two compare equal.
__device__ __forceinline__ uint64_t sort_image(double key) {
  const uint64_t bits = static_cast<uint64_t>(__double_as_longlong(key + 0.0));
  return (bits >> 63) ? ~bits : bits | 0x8000000000000000ull;
}

// (image, index) pairs: a after b?
__device__ __forceinline__ bool greater(uint64_t ka, int ia, uint64_t kb, int ib) {
  return ka > kb || (ka == kb && ia > ib);
}

// One bitonic stage on an element held in registers at position p, against its
// partner at p ^ j held by lane ^ j (j < 32).
__device__ __forceinline__ void exchange_lanes(uint64_t& key, int& idx, int p, int j, int k) {
  const uint64_t pk = __shfl_xor_sync(0xffffffffu, key, j);
  const int pi = __shfl_xor_sync(0xffffffffu, idx, j);
  const bool keep_min = ((p & j) == 0) == ((p & k) == 0);
  if (greater(key, idx, pk, pi) == keep_min) {
    key = pk;
    idx = pi;
  }
}

// The merges k_lo..k_hi (powers of two, 2 <= k_lo <= k_hi <= n_pad), each only
// over its stages j <= 32, in registers: warp w takes the 64-element segments
// w, w + warps, ...; lane holds positions seg + lane and seg + lane + 32.
__device__ void sort_in_registers(uint64_t* s_key, int* s_idx, int n_pad, int k_lo, int k_hi) {
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int seg = (threadIdx.x / 32) * 64; seg < n_pad; seg += n_warps * 64) {
    const int p0 = seg + lane, p1 = p0 + 32;
    uint64_t k0 = s_key[p0], k1 = s_key[p1];
    int i0 = s_idx[p0], i1 = s_idx[p1];
    for (int k = k_lo; k <= k_hi; k <<= 1) {
      int j = k >> 1;
      if (k >= 64) {
        // the stage j == 32 pairs this lane's own two elements (a merge past
        // 64 ran its stages j >= 64 in shared memory)
        if (greater(k0, i0, k1, i1) == ((p0 & k) == 0)) {
          const uint64_t tk = k0;
          const int ti = i0;
          k0 = k1;
          i0 = i1;
          k1 = tk;
          i1 = ti;
        }
        j = 16;
      }
      for (; j > 0; j >>= 1) {
        exchange_lanes(k0, i0, p0, j, k);
        exchange_lanes(k1, i1, p1, j, k);
      }
    }
    s_key[p0] = k0;
    s_key[p1] = k1;
    s_idx[p0] = i0;
    s_idx[p1] = i1;
  }
}

int padded(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// `scratch` is null for a row in shared memory, else this launch's global
// buffer of 12 * n_pad bytes a row.
__global__ void __launch_bounds__(kMaxThreads)
waterfill_kernel(const double* __restrict__ backlog, const double* __restrict__ key,
                 const double* __restrict__ cap, const uint8_t* __restrict__ hard,
                 double* __restrict__ grants, int n, int n_pad,
                 unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n;
  const double* b_row = backlog + row;
  double* g_row = grants + row;
  const int tid = threadIdx.x;
  if (!hard[blockIdx.x]) {
    for (int i = tid; i < n; i += blockDim.x) g_row[i] = b_row[i];
    return;
  }
  unsigned char* base = scratch == nullptr
      ? smem_raw
      : scratch + static_cast<int64_t>(blockIdx.x) * n_pad * kPairBytes;
  uint64_t* s_key = reinterpret_cast<uint64_t*>(base);  // images, then b and g
  int* s_idx = reinterpret_cast<int*>(s_key + n_pad);   // queue index
  for (int i = tid; i < n_pad; i += blockDim.x) {
    s_key[i] = i < n ? sort_image(key[row + i]) : ~0ull;
    s_idx[i] = i;
  }
  __syncthreads();

  // bitonic sort of (image, index), ascending. Stages whose pairs lie 64 or
  // more apart go through shared memory, one barrier each; the others run in
  // registers, a warp a 64-element segment (lane and lane + 32), partners by
  // shuffle, all of a merge's short stages (all merges up to 64 at once) in
  // one pass
  const bool in_regs = n_pad >= 64;
  if (in_regs) {
    sort_in_registers(s_key, s_idx, n_pad, 2, 64);
    __syncthreads();
  }
  for (int k = in_regs ? 128 : 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j >= (in_regs ? 64 : 1); j >>= 1) {
      for (int t = tid; t < n_pad / 2; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i + j;
        const uint64_t ki = s_key[i], kl = s_key[l];
        const int ii = s_idx[i], il = s_idx[l];
        if (greater(ki, ii, kl, il) == ((i & k) == 0)) {
          s_key[i] = kl;
          s_key[l] = ki;
          s_idx[i] = il;
          s_idx[l] = ii;
        }
      }
      __syncthreads();
    }
    if (in_regs) {
      sort_in_registers(s_key, s_idx, n_pad, k, k);
      __syncthreads();
    }
  }

  double* s_b = reinterpret_cast<double*>(s_key);       // backlog in rank order
  for (int q = tid; q < n; q += blockDim.x) s_b[q] = b_row[s_idx[q]];
  __syncthreads();

  if (tid < 32) {
    const double c = cap[blockIdx.x];
    double acc = -0.0;                                   // -0.0 + x == x
    for (int q0 = 0; q0 < n; q0 += 32) {
      const int m = min(32, n - q0);
      double mine = 0.0;
#pragma unroll
      for (int half = 0; half < 32; half += 16) {   // 16 loads ahead of 16 adds
        double chunk[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) chunk[j] = half + j < m ? s_b[q0 + half + j] : 0.0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {   // past m: + 0.0 after the row's last add
          acc += chunk[j];
          if (tid == half + j) mine = acc;
        }
      }
      if (tid < m) {
        const double bq = s_b[q0 + tid];
        const double room = c - (mine - bq);
        s_b[q0 + tid] = room > kCapEps ? fmin(bq, room) : 0.0;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int q = tid; q < n; q += blockDim.x) g_row[s_idx[q]] = s_b[q];
}

int threads_for(int n_pad) {
  const int half = n_pad / 2;
  return half >= kMaxThreads ? kMaxThreads : (half < 32 ? 32 : half);
}

int smem_optin(size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *bytes = static_cast<size_t>(optin);
  return static_cast<int>(err);
}

}  // namespace

// Bytes of global scratch a row needs: 0 when a row of n queues fits in the
// card's shared memory, else 12 * n_pad. -1 if the device cannot be queried.
extern "C" long long repro_waterfill_scratch_bytes(int n) {
  size_t optin = 0;
  if (smem_optin(&optin)) return -1;
  const size_t need = static_cast<size_t>(padded(n)) * kPairBytes;
  return need <= optin ? 0 : static_cast<long long>(need);
}

// scratch: null, or n_rows * repro_waterfill_scratch_bytes(n) bytes.
extern "C" int repro_waterfill_grants(const void* backlog, const void* key,
                                      const void* cap, const void* hard,
                                      void* grants, int n_rows, int n,
                                      void* scratch, void* stream) {
  const int n_pad = padded(n);
  const size_t smem = scratch ? 0 : static_cast<size_t>(n_pad) * kPairBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        waterfill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  waterfill_kernel<<<n_rows, threads_for(n_pad), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(backlog), static_cast<const double*>(key),
      static_cast<const double*>(cap), static_cast<const uint8_t*>(hard),
      static_cast<double*>(grants), n, n_pad, static_cast<unsigned char*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
