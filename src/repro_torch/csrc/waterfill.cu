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
// The sort and the prefix are waterfill_row in waterfill.cuh, shared with the fused phase
// kernel (ponsim_phase.cu); this kernel pours one row a block with it.
// What bounds it on this card: the serial prefix, N dependent float64 adds (a
// few cycles each) on one warp; the sort's log^2 N barriers come next. A row
// of the engine holds a few kilobytes, so launch latency dominates below ~1,000
// queues.
#include <cuda_runtime.h>
#include <stdint.h>

#include "waterfill.cuh"

namespace {

constexpr int kMaxThreads = 1024;

int padded(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Queue i's key of one row, as the caller gave it.
struct RowKey {
  const double* key;
  __device__ double operator()(int i) const { return key[i]; }
};

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
  if (!hard[blockIdx.x]) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) g_row[i] = b_row[i];
    return;
  }
  unsigned char* base = scratch == nullptr
      ? smem_raw
      : scratch + static_cast<int64_t>(blockIdx.x) * n_pad * kPairBytes;
  waterfill_row(b_row, RowKey{key + row}, cap[blockIdx.x], g_row, n, n_pad, base);
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
