// The fused device phase: a whole transfer phase of the PON round engine in one launch,
// hand-written for sm_90a, in float64.
//
// Replaces the JAX package's device phase program repro/kernels/ponsim/ops.py::
// run_phase_device (_build_program's `program`, an XLA while loop, not a Pallas kernel) and
// carries two TPU kernels inside it:
//   * K1, repro/kernels/traffic/kernel.py::sample_arrival_bits_tpu: the arrival stream is
//     sampled one 64-cycle window at a time inside the loop (threefry.cuh, the same draws
//     as csrc/traffic.cu), into integer packet counts that never leave the card;
//   * K2, repro/kernels/ponsim/kernel.py::waterfill_grants_pallas: the background's hard
//     rows and the general path's FL grants are poured by waterfill_row (waterfill.cuh, the
//     same sort and serial prefix as csrc/waterfill.cu).
// The plain version is kernels/ponsim/ref.py::run_phase_ref; on the same inputs this kernel
// gives the same done_t bit for bit, the same rem and the same exact flag.
//
// One CTA a case (the P rows of one case: the CPS split couples a case's PONs and nothing
// else couples rows). Each CTA runs the cycle loop itself until none of its rows holds a
// live client, or t >= tmax, or k >= k_max, accumulating t = t + cyc in float64 as the
// reference does. That stop is exact: done is monotone and cases never interact, so after
// a case's last live client the global loop would change none of its outputs; and every
// stop test is monotone in k, so the global loop's last cycle is the largest of the CTAs'.
// Each CTA writes its stop k and t; the wrapper takes the largest k and fills the clients
// left unfinished from that CTA's t (+ propagation), as the global loop's final clock. A
// case's ring walk counts towards `exact` only while its CTA runs.
//
// Each cycle, in the JAX program's order, with barriers between steps:
//   capacity masks (deadline, outage) and the stop test, on one thread;
//   a new window of arrivals every 64 cycles (integer atomicAdd: exact in any order), then
//   bits = f32(count) * f32(packet_bits) into the FIFO prefix (cum, backlog, head cycle
//   ptr) and the 128-cycle prefix ring;
//   the FL push (scalar-S: a binary search of the host's push table; general: per column);
//   the per-ONU FL backlog and head-of-line time (general path);
//   row sums, each in one fixed order (32 lanes add contiguous chunks left to right, then
//   the 32 partials in order; ref.row_sum takes the same order);
//   the CPS split on one thread (the P wants sorted, the closed-form level);
//   the background's hard rows (demand above capacity - 1) poured oldest first by
//   waterfill_row over ptr keys; easy rows are granted their backlog without a sort;
//   the FL grants: the waterfill (fcfs, general) or the slot grants, each row's slots
//   added in order on one thread (bs), recomputed at the CPS level when there is one;
//   the background serve: full drains, then the one marginal queue a row walked over the
//   ring by one warp (a head older than the ring clears `exact`);
//   the FL serve (scalar-S: binary searches of the demand boundaries; one client an ONU:
//   per column; several: a thread a segment, head by head) and the completion credit.
// No product meets a sum in one expression, so no FMA contraction changes a rounding.
//
// State lives in global scratch from the wrapper (a case's rows stay in L1/L2): the FIFO
// prefix per queue, the ring (128 float64 a queue, 4 MB a row at 4,096 ONUs), the window's
// packet counts, the FL columns. Shared memory holds the sort's (key, index) pairs (12
// bytes a queue padded to a power of two, so rows up to 16,384 queues), the thresholds, the
// breakpoint table and the per-row scalars. What bounds it on this card: the chain of
// dependent steps and barriers a cycle (one CTA a case leaves most SMs idle); on hard
// cycles the sort's barriers and the serial float64 prefix.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "threefry.cuh"
#include "waterfill.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxP = 32;          // PONs a case (the per-row shared arrays)
constexpr int kMaxClients = 32;    // clients an ONU (the multi-client serve's q_old)
constexpr int kRing = 128;         // ref.HISTORY_CYCLES
constexpr int kWin = 1 << kWindowShift;
constexpr double kSegEps = 1.0;
constexpr double kEpsBits = 1.0;
constexpr int64_t kIKeyInf = 0x7FFFFFFFFFFFFFFFLL / 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoQueue = 0x7FFFFFFF;

// Every field 8 bytes, in the order of kernel.py's _PhaseArgs.
struct PhaseArgs {
  long long R, U, N, S, P, Sg, max_slots, n_draws, n_bp, k_max, n_pad, smem_pairs;
  long long fast, single, identity, fcfs, has_bg, has_cps, has_deadline, has_outage;
  double cyc, prop, tmax, cps_cap, packet_bits;
  const uint8_t* part;
  const double* rem0;
  const double* ready;
  const int64_t* list_pos;
  const double* cap_col;
  const int64_t* lay_onu;
  const int32_t* onu_map;
  const int64_t* seg_starts;
  const int64_t* seg_len;
  const int64_t* seg_onus;
  const int32_t* kp_rank;
  const double* p_incl;
  const double* q_bound;
  const int32_t* rank_u;
  const double* q_col;
  const uint8_t* pushes;
  const int32_t* m_live;
  const double* cap_t;
  const double* out0;
  const double* out1;
  const int64_t* keys;
  const int32_t* thr;
  const int32_t* bp_start;
  const int32_t* bp_len;
  const double* ts;
  const double* te_g;
  const int64_t* sonu;
  const double* srate;
  const uint8_t* svalid;
  double* cum;
  double* drained;
  double* backlog;
  int32_t* ptr;
  double* ring;
  int32_t* win;
  double* bg_grants;
  double* qb;
  int64_t* push_key;
  double* push_time;
  uint8_t* waiting;
  double* backlog_onu;
  double* hol;
  double* fl_grants;
  double* slot_want;
  double* done_t;
  double* rem;
  uint8_t* done;
  int32_t* k_stop;
  double* t_stop;
  uint8_t* exact;
};

// Sort key of a background queue: its head's arrival cycle, +inf when empty.
struct BgKey {
  const double* backlog;
  const int32_t* ptr;
  __device__ double operator()(int i) const {
    return backlog[i] > 0.0 ? static_cast<double>(ptr[i]) : CUDART_INF;
  }
};

struct ArrayKey {
  const double* key;
  __device__ double operator()(int i) const { return key[i]; }
};

// The row sum in ref.row_sum's order; every lane of the warp calls it and gets the sum.
__device__ double warp_row_sum(const double* __restrict__ x, int n) {
  const int lane = threadIdx.x & 31;
  const int c = (n + 31) / 32;
  const int lo = min(lane * c, n), hi = min(lo + c, n);
  double acc = 0.0;
  for (int i = lo; i < hi; ++i) acc += x[i];
  double total = 0.0;
  for (int l = 0; l < 32; ++l) total += __shfl_sync(kFull, acc, l);
  return total;
}

// #{j < n : a[j] <= v} for non-decreasing a (searchsorted, right).
template <class T>
__device__ int count_le(const T* a, int n, T v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{j < n : a[j] < v}: the first j with a[j] >= v (searchsorted, left).
__device__ int count_lt(const double* a, int n, double v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The max-min CPS split of `cap` over one case's wants w[0..P) in place (one thread).
__device__ void cps_split(double* w, int P, double cap) {
  double total = 0.0;
  for (int p = 0; p < P; ++p) total += w[p];
  if (!(total > cap + kCapEps)) return;
  double ws[kMaxP];
  for (int p = 0; p < P; ++p) {
    int j = p;
    for (; j > 0 && ws[j - 1] > w[p]; --j) ws[j] = ws[j - 1];
    ws[j] = w[p];
  }
  // after the j smallest wants in full, the rest split the residual evenly; the level is
  // the first feasible mu_j (mu_0 when none is)
  double cum = 0.0, mu = 0.0;
  bool found = false;
  for (int j = 0; j < P; ++j) {
    cum += ws[j];
    const double mu_j = (cap - (cum - ws[j])) / static_cast<double>(P - j);
    if (j == 0) mu = mu_j;
    if (!found && mu_j <= ws[j]) {
      mu = mu_j;
      found = true;
    }
  }
  for (int p = 0; p < P; ++p) w[p] = fmin(w[p], mu);
}

// Completion credit of one FL column whose queue went from q_old to q_new this cycle.
__device__ void credit(const PhaseArgs& a, int64_t c, double q_old, double q_new,
                       double t_done, int* n_live) {
  const double drained = q_old - q_new;
  const double new_rem = a.rem[c] - drained;
  const bool newly = !a.done[c] && drained > 0.0 && new_rem <= kEpsBits;
  a.rem[c] = newly ? 0.0 : fmax(new_rem, 0.0);
  if (newly) {
    a.done[c] = 1;
    a.done_t[c] = t_done;
    atomicSub(n_live, 1);
  }
}

// The one partially granted background queue `jm` of row r: its new drained offset and
// head, found on the prefix ring (one warp, 4 ring slots a lane, oldest first).
__device__ void ring_walk(const PhaseArgs& a, int r, int k, int jm, int* exact) {
  const int lane = threadIdx.x & 31;
  const int64_t q = static_cast<int64_t>(r) * a.N + jm;
  const double tgt = a.drained[q] + a.bg_grants[q];
  const double cum_q = a.cum[q];
  const double* ring = a.ring + static_cast<int64_t>(r) * kRing * a.N + jm;
  double pref[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int slot = (k - (kRing - 1) + lane + 32 * m) & (kRing - 1);
    pref[m] = ring[static_cast<int64_t>(slot) * a.N];
  }
  // first cycle of the window whose prefix exceeds the target (0 if none)
  int j1 = -1;
  unsigned first = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const unsigned bal = __ballot_sync(kFull, pref[m] > tgt);
    if (m == 0) first = bal & 1u;
    if (j1 < 0 && bal) j1 = 32 * m + __ffs(bal) - 1;
  }
  if (j1 < 0) j1 = 0;
  double mine = pref[0];
#pragma unroll
  for (int m = 1; m < 4; ++m)
    if (m == (j1 >> 5)) mine = pref[m];
  const double seg_end = __shfl_sync(kFull, mine, j1 & 31);
  const bool snap = seg_end - tgt <= kSegEps;
  const double dr1 = snap ? seg_end : tgt;
  const double bklg = cum_q - dr1;
  const bool low = bklg < 0.5;
  // the snap consumed through j1: the next head is the first later cycle above dr1
  int j2 = -1;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const unsigned bal = __ballot_sync(kFull, pref[m] > dr1 && lane + 32 * m > j1);
    if (j2 < 0 && bal) j2 = 32 * m + __ffs(bal) - 1;
  }
  if (j2 < 0) j2 = 0;
  if (lane == 0) {
    // exact unless the head had aged out of the ring and the window starts past the target
    if (first && a.ptr[q] < k - (kRing - 1)) *exact = 0;
    a.drained[q] = low ? cum_q : dr1;
    a.backlog[q] = low ? 0.0 : bklg;
    a.ptr[q] = low ? k + 1 : k - (kRing - 1) + (snap ? j2 : j1);
  }
}

// Slot grants of row p of the case into fl_grants (zeroed), the slots' wants added in slot
// order against `cap` (one thread).
__device__ void slot_prefix(const PhaseArgs& a, int r, double cap) {
  const int S = static_cast<int>(a.S);
  const double* want = a.slot_want + static_cast<int64_t>(r) * S;
  const int64_t* onu = a.sonu + static_cast<int64_t>(r) * S;
  double* g = a.fl_grants + static_cast<int64_t>(r) * a.N;
  double prefix = 0.0;
  for (int s = 0; s < S; ++s) {
    const double w = want[s];
    prefix += w;
    g[onu[s]] += fmin(w, fmax(cap - (prefix - w), 0.0));
  }
}

__global__ void __launch_bounds__(kMaxThreads) ponsim_phase_kernel(const PhaseArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_cap[kMaxP], s_eff[kMaxP], s_bgsum[kMaxP], s_flwant[kMaxP];
  __shared__ double s_capfl[kMaxP], s_fltot[kMaxP], s_tk[kMaxP], s_fls[kMaxP];
  __shared__ int s_cdone[kMaxP], s_cnew[kMaxP], s_jm[kMaxP], s_nlive[kMaxP], s_easy[kMaxP];
  __shared__ int s_run, s_exact;

  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, n_warps = T >> 5;
  const int P = static_cast<int>(a.P), N = static_cast<int>(a.N), U = static_cast<int>(a.U);
  const int S = static_cast<int>(a.S), Sg = static_cast<int>(a.Sg);
  const int n_draws = static_cast<int>(a.n_draws), n_bp = static_cast<int>(a.n_bp);
  const int n_pad = static_cast<int>(a.n_pad);
  const bool fast = a.fast, fcfs = a.fcfs, has_bg = a.has_bg;
  const int r0 = blockIdx.x * P;
  const int PN = P * N, PU = P * U;
  const int64_t rowN = static_cast<int64_t>(r0) * N, rowU = static_cast<int64_t>(r0) * U;
  unsigned char* pairs = smem;
  int32_t* s_thr = reinterpret_cast<int32_t*>(smem + a.smem_pairs);
  int32_t* s_bps = s_thr + P * n_draws;
  int32_t* s_bpl = s_bps + n_bp;
  int32_t* win = has_bg ? a.win + static_cast<int64_t>(r0) * kWin * N : nullptr;
  const float packet_bits = static_cast<float>(a.packet_bits);

  // ---- state at cycle 0
  if (has_bg) {
    for (int i = tid; i < PN; i += T) {
      a.cum[rowN + i] = 0.0;
      a.drained[rowN + i] = 0.0;
      a.backlog[rowN + i] = 0.0;
      a.ptr[rowN + i] = 0;
    }
    double* ring = a.ring + static_cast<int64_t>(r0) * kRing * N;
    for (int64_t i = tid; i < static_cast<int64_t>(kRing) * PN; i += T) ring[i] = 0.0;
    for (int i = tid; i < P * n_draws; i += T)
      s_thr[i] = a.thr[static_cast<int64_t>(r0) * n_draws + i];
    for (int i = tid; i < n_bp; i += T) {
      s_bps[i] = a.bp_start[i];
      s_bpl[i] = a.bp_len[i];
    }
  }
  for (int i = tid; i < PU; i += T) {
    const int64_t c = rowU + i;
    a.done_t[c] = CUDART_NAN;
    if (!fast) {
      const bool d = !a.part[c] || a.rem0[c] <= 0.0;
      a.rem[c] = a.rem0[c];
      a.done[c] = d;
      a.waiting[c] = a.part[c] && !d;
      a.qb[c] = 0.0;
      a.push_key[c] = kIKeyInf;
      a.push_time[c] = 0.0;
    }
  }
  if (tid < P) {
    s_fls[tid] = 0.0;
    s_cdone[tid] = 0;
    s_cnew[tid] = 0;
    s_nlive[tid] = 0;
  }
  if (tid == 0) s_exact = 1;
  __syncthreads();
  if (!fast)
    for (int i = tid; i < PU; i += T)
      if (a.part[rowU + i] && !(a.rem0[rowU + i] <= 0.0)) atomicAdd(&s_nlive[i / U], 1);

  int k = 0;
  double t = 0.0;
  for (;;) {
    __syncthreads();
    // ---- stop test and capacity masks
    if (tid == 0) {
      bool any = false;
      for (int p = 0; p < P; ++p) {
        const int r = r0 + p;
        if (fast) s_cdone[p] = s_cnew[p];
        bool live = fast ? a.m_live[r] > s_cdone[p] : s_nlive[p] > 0;
        double c = a.cap_col[r];
        if (a.has_deadline && !(a.cap_t[r] > t)) {
          live = false;
          c = 0.0;
        }
        if (a.has_outage && a.out0[r] <= t && t < a.out1[r]) c = 0.0;
        any = any || live;
        s_cap[p] = c;
        s_jm[p] = kNoQueue;
      }
      s_run = t < a.tmax && k < a.k_max && any;
    }
    __syncthreads();
    if (!s_run) break;
    const int kw = k & (kWin - 1);

    // ---- arrivals: a new window every 64 cycles, then this cycle's bits into the FIFOs
    if (has_bg) {
      if (kw == 0) {
        for (int64_t i = tid; i < static_cast<int64_t>(kWin) * PN; i += T) win[i] = 0;
        __syncthreads();
        const uint32_t c0 = static_cast<uint32_t>(k >> kWindowShift);
        for (int i = tid; i < PN; i += T) {
          const int p = i / N, n = i - p * N, r = r0 + p;
          const uint32_t k0 = static_cast<uint32_t>(a.keys[2 * r]);
          const uint32_t k1 = static_cast<uint32_t>(a.keys[2 * r + 1]);
          const uint32_t c1 = static_cast<uint32_t>(n);
          const int count = burst_count(k0, k1, c0, c1, s_thr + p * n_draws, n_draws);
          for (int j = 1; j <= count; ++j) {
            uint32_t x0, x1;
            burst_draw(k0, k1, static_cast<uint32_t>(j), c0, c1, x0, x1);
            const int place = static_cast<int>(x0 >> (32 - kWindowShift));
            atomicAdd(win + (static_cast<int64_t>(p) * kWin + place) * N + n,
                      burst_length(static_cast<int32_t>(x1 >> 8), s_bps, s_bpl, n_bp));
          }
        }
        __syncthreads();
      }
      const int slot = k & (kRing - 1);
      for (int i = tid; i < PN; i += T) {
        const int p = i / N, n = i - p * N;
        const int64_t q = rowN + i;
        const int count = win[(static_cast<int64_t>(p) * kWin + kw) * N + n];
        const double bits = static_cast<double>(__fmul_rn(static_cast<float>(count), packet_bits));
        const double cm = a.cum[q] + bits;
        if (a.backlog[q] <= 0.0 && bits > 0.0) a.ptr[q] = k;
        a.cum[q] = cm;
        a.backlog[q] = cm - a.drained[q];
        a.ring[(static_cast<int64_t>(r0 + p) * kRing + slot) * N + n] = cm;
      }
    }

    // ---- FL push
    if (fast) {
      if (tid < P) {
        const int r = r0 + tid;
        const int npk = count_le(a.kp_rank + static_cast<int64_t>(r) * U, U,
                                 static_cast<int32_t>(k));
        const double tk = a.p_incl[static_cast<int64_t>(r) * (U + 1) + npk];
        s_tk[tid] = tk;
        s_fltot[tid] = tk - s_fls[tid];
      }
    } else {
      const double t_end = t + a.cyc;
      for (int i = tid; i < PU; i += T) {
        const int64_t c = rowU + i;
        if (a.waiting[c] && a.ready[c] <= t_end) {
          a.qb[c] = a.rem[c];
          a.push_key[c] = static_cast<int64_t>(k) * (U + 1) + a.list_pos[c];
          a.push_time[c] = fmax(a.ready[c], t);
          a.waiting[c] = 0;
        }
      }
      __syncthreads();
      // per-ONU FL backlog (members added left to right) and head-of-line push time
      for (int i = tid; i < PN; i += T) {
        const int p = i / N, n = i - p * N;
        const int64_t base = static_cast<int64_t>(r0 + p) * U;
        const int m = a.onu_map[n];
        double bo = 0.0, h = CUDART_INF;
        if (m >= 0 && a.single) {
          bo = a.qb[base + m];
          if (bo > 0.0) h = a.push_time[base + m];
        } else if (m >= 0) {
          const int c0 = static_cast<int>(a.seg_starts[m]);
          const int len = static_cast<int>(a.seg_len[m]);
          int64_t best = kIKeyInf;
          int head = -1;
          for (int j = 0; j < len; ++j) {
            const double q = a.qb[base + c0 + j];
            bo = j ? bo + q : q;
            if (q > 0.0) {
              const int64_t comb = a.push_key[base + c0 + j] * U + (c0 + j);
              if (comb < best) {
                best = comb;
                head = c0 + j;
              }
            }
          }
          if (head >= 0) h = a.push_time[base + head];
        }
        a.backlog_onu[rowN + i] = bo;
        if (fcfs) a.hol[rowN + i] = h;
      }
    }
    __syncthreads();

    // ---- grants
    if (fcfs) {
      for (int p = warp; p < P; p += n_warps) {
        const int64_t off = static_cast<int64_t>(r0 + p) * N;
        const double bs = has_bg ? warp_row_sum(a.backlog + off, N) : 0.0;
        const double fw = fast ? 0.0 : warp_row_sum(a.backlog_onu + off, N);
        if (lane == 0) {
          s_bgsum[p] = bs;
          s_flwant[p] = fw;
        }
      }
      __syncthreads();
      if (tid == 0) {
        for (int p = 0; p < P; ++p)
          s_eff[p] = a.has_cps
              ? fmin(s_bgsum[p] + (fast ? s_fltot[p] : s_flwant[p]), s_cap[p])
              : s_cap[p];
        if (a.has_cps) cps_split(s_eff, P, a.cps_cap);
        for (int p = 0; p < P; ++p) s_easy[p] = s_bgsum[p] <= s_eff[p] - 1.0;
      }
      __syncthreads();
      if (has_bg) {
        // hard rows (demand past capacity - 1) poured oldest first; easy rows keep their
        // backlog as the grant, bitwise, with no sort
        for (int p = 0; p < P; ++p) {
          if (s_easy[p]) continue;
          const int64_t off = static_cast<int64_t>(r0 + p) * N;
          waterfill_row(a.backlog + off, BgKey{a.backlog + off, a.ptr + off}, s_eff[p],
                        a.bg_grants + off, N, n_pad, pairs);
          __syncthreads();
        }
        for (int p = warp; p < P; p += n_warps) {
          const int64_t off = static_cast<int64_t>(r0 + p) * N;
          const double gs = s_easy[p] ? s_bgsum[p] : warp_row_sum(a.bg_grants + off, N);
          if (lane == 0) s_capfl[p] = s_eff[p] - gs;
        }
      } else if (tid < P) {
        s_capfl[tid] = s_eff[tid];
      }
      __syncthreads();
      if (!fast) {
        for (int p = 0; p < P; ++p) {
          const int64_t off = static_cast<int64_t>(r0 + p) * N;
          if (s_flwant[p] > s_capfl[p] - 1.0) {
            waterfill_row(a.backlog_onu + off, ArrayKey{a.hol + off}, s_capfl[p],
                          a.fl_grants + off, N, n_pad, pairs);
            __syncthreads();
          } else {
            for (int n = tid; n < N; n += T) a.fl_grants[off + n] = a.backlog_onu[off + n];
          }
        }
        __syncthreads();
      }
    } else {
      // slot grants: the wants in parallel, each row's prefix in slot order on one thread
      const double t_end = t + a.cyc;
      for (int i = tid; i < P * S; i += T) {
        const int p = i / S;
        const int64_t c = static_cast<int64_t>(r0) * S + i;
        const bool active = a.svalid[c] && a.ts[c] < t_end && a.te_g[c] > t;
        const double overlap = fmin(a.te_g[c], t_end) - fmax(a.ts[c], t);
        double want = a.srate[r0 + p] * fmax(overlap, 0.0);
        want = fmin(want, a.backlog_onu[static_cast<int64_t>(r0 + p) * N + a.sonu[c]]);
        a.slot_want[c] = active && want > 0.0 ? want : 0.0;
      }
      for (int i = tid; i < PN; i += T) a.fl_grants[rowN + i] = 0.0;
      __syncthreads();
      if (tid < P) slot_prefix(a, r0 + tid, s_cap[tid]);
      __syncthreads();
      if (a.has_cps) {
        for (int p = warp; p < P; p += n_warps) {
          const double w = warp_row_sum(a.fl_grants + static_cast<int64_t>(r0 + p) * N, N);
          if (lane == 0) s_eff[p] = w;
        }
        __syncthreads();
        if (tid == 0) cps_split(s_eff, P, a.cps_cap);
        for (int i = tid; i < PN; i += T) a.fl_grants[rowN + i] = 0.0;
        __syncthreads();
        if (tid < P) slot_prefix(a, r0 + tid, s_eff[tid]);
        __syncthreads();
      }
    }

    // ---- background serve: full drains, then the one marginal queue a row
    if (has_bg) {
      for (int i = tid; i < PN; i += T) {
        const int p = i / N;
        const int64_t q = rowN + i;
        const double bl = a.backlog[q];
        const double g = s_easy[p] ? bl : a.bg_grants[q];
        if (g > 0.0 && g == bl) {
          a.drained[q] = a.cum[q];
          a.backlog[q] = 0.0;
          a.ptr[q] = k + 1;
        } else if (g > kCapEps) {
          atomicMin(&s_jm[p], i - p * N);
        }
      }
      __syncthreads();
      for (int p = warp; p < P; p += n_warps)
        if (s_jm[p] != kNoQueue) ring_walk(a, r0 + p, k, s_jm[p], &s_exact);
    }

    // ---- FL serve and completion credit
    const double t_done = (t + a.cyc) + a.prop;
    if (fast) {
      if (tid < P) {
        const int r = r0 + tid;
        const double* qbnd = a.q_bound + static_cast<int64_t>(r) * U;
        const double cap_fl = s_capfl[tid], s_pre = s_fls[tid];
        const double capx = fmax(cap_fl, 0.0);
        const double s1 = cap_fl > kCapEps ? (s_fltot[tid] <= capx ? s_tk[tid] : s_pre + capx)
                                           : s_pre;
        // a client's last sub-SEG_EPS residual is dropped: snap S to the next boundary
        const int rkx = count_lt(qbnd, U, s1);
        const double qv = rkx < U ? qbnd[rkx] : CUDART_INF;
        const double s2 = s1 > s_pre && qv - s1 <= kSegEps ? qv : s1;
        s_cnew[tid] = count_le(qbnd, U, s2);
        s_fls[tid] = s2;
      }
      __syncthreads();
      for (int i = tid; i < PU; i += T) {
        const int p = i / U;
        const int rk = a.rank_u[rowU + i];
        if (rk >= s_cdone[p] && rk < s_cnew[p]) a.done_t[rowU + i] = t_done;
      }
    } else if (a.single) {
      for (int i = tid; i < PU; i += T) {
        const int p = i / U, u = i - p * U;
        const int64_t c = rowU + i;
        const double bud = a.fl_grants[static_cast<int64_t>(r0 + p) * N
                                       + (a.identity ? u : a.lay_onu[u])];
        const double q = a.qb[c];
        const bool act = bud > kCapEps && q > 0.0;
        const double take = act ? fmin(bud, q) : 0.0;
        const double q2 = act && q - take <= kSegEps ? 0.0 : q - take;
        a.qb[c] = q2;
        credit(a, c, q, q2, t_done, &s_nlive[p]);
      }
    } else {
      // a thread a segment: a granted-in-full ONU empties every member, the rest is served
      // head by head (oldest push first), each drop of a sub-SEG_EPS residual charged
      for (int i = tid; i < P * Sg; i += T) {
        const int p = i / Sg, s = i - p * Sg;
        const int64_t base = static_cast<int64_t>(r0 + p) * U;
        const int64_t o = static_cast<int64_t>(r0 + p) * N + a.seg_onus[s];
        const int c0 = static_cast<int>(a.seg_starts[s]), len = static_cast<int>(a.seg_len[s]);
        const double g = a.fl_grants[o];
        const bool full = g > 0.0 && g == a.backlog_onu[o];
        double budget = full ? 0.0 : g;
        double q_old[kMaxClients];
        for (int j = 0; j < len; ++j) {
          q_old[j] = a.qb[base + c0 + j];
          if (full) a.qb[base + c0 + j] = 0.0;
        }
        for (int pass = 0; pass < a.max_slots; ++pass) {
          int64_t best = kIKeyInf;
          int head = -1;
          for (int j = 0; j < len; ++j) {
            if (a.qb[base + c0 + j] > 0.0) {
              const int64_t comb = a.push_key[base + c0 + j] * U + (c0 + j);
              if (comb < best) {
                best = comb;
                head = c0 + j;
              }
            }
          }
          if (head < 0 || !(budget > kCapEps)) break;
          const double hq = a.qb[base + head];
          const double take = fmin(budget, hq);
          const double resid = hq - take;
          const bool drop = resid <= kSegEps;
          a.qb[base + head] = drop ? 0.0 : hq - take;
          budget = fmax(budget - take - (drop ? resid : 0.0), 0.0);
        }
        for (int j = 0; j < len; ++j)
          credit(a, base + c0 + j, q_old[j], a.qb[base + c0 + j], t_done, &s_nlive[p]);
      }
    }
    ++k;
    t += a.cyc;
  }

  // ---- outputs: the scalar-S path's per-column rem and done from its final S
  if (fast) {
    for (int i = tid; i < PU; i += T) {
      const int64_t c = rowU + i;
      const double scol = s_fls[i / U], r0v = a.rem0[c];
      const bool push = a.pushes[c];
      a.done[c] = !a.part[c] || r0v <= 0.0 || (push && a.q_col[c] <= scol);
      a.rem[c] = push ? fmin(fmax(a.q_col[c] - scol, 0.0), r0v) : r0v;
    }
  }
  if (tid == 0) {
    a.k_stop[blockIdx.x] = k;
    a.t_stop[blockIdx.x] = t;
    a.exact[blockIdx.x] = static_cast<uint8_t>(s_exact);
  }
}

int smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

}  // namespace

extern "C" long long repro_phase_args_bytes() { return sizeof(PhaseArgs); }

// The most PONs a case and clients an ONU (max_slots) a launch may hold: the only
// definition of these limits; the wrapper reads them from here.
extern "C" long long repro_phase_max_pons() { return kMaxP; }
extern "C" long long repro_phase_max_clients() { return kMaxClients; }

// Dynamic shared memory a launch may take (the card's opt-in less the kernel's static
// arrays); -1 if the device cannot be queried.
extern "C" long long repro_phase_smem_limit() {
  int optin = 0;
  cudaFuncAttributes attr;
  if (smem_optin(&optin) || cudaFuncGetAttributes(&attr, ponsim_phase_kernel) != cudaSuccess)
    return -1;
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

extern "C" int repro_ponsim_phase(const void* args, int n_cases, int threads,
                                  long long smem_bytes, void* stream) {
  const PhaseArgs& a = *static_cast<const PhaseArgs*>(args);
  if (a.P < 1 || a.P > kMaxP || a.max_slots > kMaxClients)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ponsim_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ponsim_phase_kernel<<<n_cases, threads, static_cast<size_t>(smem_bytes),
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
