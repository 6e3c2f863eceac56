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
// Hence:
//   * each thread computes the stable rank of its queues by an O(N^2) count
//     over keys staged in shared memory (simple, and exact for N <= 2048);
//   * the backlog is scattered into shared memory in rank order and the
//     inclusive prefix is formed sequentially, left to right, as np.cumsum does;
//   * room is computed exactly as the reference writes it: cap - (prefix - b).
// What bounds it on this card: launch latency at the engine's widths (a few
// kilobytes a row); within a row the sequential prefix (N dependent float64
// adds from shared memory) is the critical path, the rank count is N^2/threads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kCapEps = 1e-9;

__global__ void waterfill_kernel(const double* __restrict__ backlog,
                                 const double* __restrict__ key,
                                 const double* __restrict__ cap,
                                 const uint8_t* __restrict__ hard,
                                 double* __restrict__ grants, int n) {
  extern __shared__ unsigned char smem_raw[];
  double* s_key = reinterpret_cast<double*>(smem_raw);  // keys, then the prefix
  double* s_b = s_key + n;                               // backlog in rank order
  int* s_idx = reinterpret_cast<int*>(s_b + n);          // queue index in rank order
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n;
  const double* b_row = backlog + row;
  double* g_row = grants + row;
  if (!hard[blockIdx.x]) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) g_row[i] = b_row[i];
    return;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_key[i] = key[row + i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const double ki = s_key[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const double kj = s_key[j];
      rank += (kj < ki) || (kj == ki && j < i);
    }
    s_b[rank] = b_row[i];
    s_idx[rank] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double acc = s_b[0];
    s_key[0] = acc;
    for (int q = 1; q < n; ++q) {
      acc += s_b[q];
      s_key[q] = acc;
    }
  }
  __syncthreads();
  const double c = cap[blockIdx.x];
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const double bq = s_b[q];
    const double room = c - (s_key[q] - bq);
    g_row[s_idx[q]] = room > kCapEps ? fmin(bq, room) : 0.0;
  }
}

}  // namespace

extern "C" int repro_waterfill_grants(const void* backlog, const void* key,
                                      const void* cap, const void* hard,
                                      void* grants, int n_rows, int n, void* stream) {
  const int threads = n >= 1024 ? 1024 : ((n + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(n) * (2 * sizeof(double) + sizeof(int));
  waterfill_kernel<<<n_rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(backlog), static_cast<const double*>(key),
      static_cast<const double*>(cap), static_cast<const uint8_t*>(hard),
      static_cast<double*>(grants), n);
  return static_cast<int>(cudaGetLastError());
}
