// The fused device phase: a whole transfer phase of the PON round engine in one launch,
// hand-written for sm_90a, in float64.
//
// Replaces the JAX package's device phase program repro/kernels/ponsim/ops.py::
// run_phase_device (_build_program's `program`, an XLA while loop, not a Pallas kernel) and
// carries two TPU kernels inside it:
//   * K1, repro/kernels/traffic/kernel.py::sample_arrival_bits_tpu: the arrival stream is
//     sampled one 64-cycle window at a time inside the loop (threefry.cuh, the same draws
//     as csrc/traffic.cu), into integer packet counts that never leave the chip;
//   * K2, repro/kernels/ponsim/kernel.py::waterfill_grants_pallas: the background's hard
//     rows and the general path's FL grants are poured by waterfill_row (waterfill.cuh, the
//     same sort and serial prefix as csrc/waterfill.cu).
// The plain version is kernels/ponsim/ref.py::run_phase_ref; on the same inputs this kernel
// gives the same done_t bit for bit, the same rem and the same exact flag.
//
// One CTA a case (the P rows of one case: the CPS split couples a case's PONs and nothing
// else couples rows), at any P, any row width and any number of clients an ONU. Each CTA
// runs the cycle loop itself until none of its rows holds a live client, or t >= tmax, or
// k >= k_max, accumulating t = t + cyc in float64 as the reference does. That stop is
// exact: done is monotone and cases never interact, so after a case's last live client the
// global loop would change none of its outputs; and every stop test is monotone in k, so
// the global loop's last cycle is the largest of the CTAs'. Each CTA writes its stop k and
// t and a per-client `left` flag; the wrapper fills the clients left unfinished from the
// latest CTA's t (+ propagation), as the global loop's final clock. A case's ring walk
// counts towards `exact` only while its CTA runs.
//
// What bounds it on this card is latency: the cycles of a phase run in series, each a
// chain of dependent steps between barriers, in one CTA a case. The design keeps that
// chain on chip and short:
//   * ownership: each thread owns fixed background queues (i = tid + j*T), fixed ONU
//     segments (an ONU's clients: push, per-ONU backlog, slot wants, grant, serve, credit
//     all on one thread) and each row belongs to one warp, from the last warp down; the
//     launch adds a warp whose threads own no queue where the width leaves room, so that
//     the rows' work (the scalar-S searches, 32-way over the warp; the row sums; the
//     scalar-S serve; the bs prefix) runs beside the queues' (arrivals, serves). A thread
//     reads what another wrote only across a barrier, so the barriers a cycle are: the
//     cycle's start; the stop test (__syncthreads_or, after the arrivals and the FL push);
//     the grants; on a cycle with a hard background row, the marginal queues: 3 a cycle
//     (4 on a hard one), against about ten before;
//   * state on chip: the case's state lives in regions carved from dynamic shared memory
//     in a fixed order of priority (make_plan); a region that does not fit goes to this
//     CTA's slice of a global scratch buffer, through the same pointers, so nothing limits
//     the width. At 128 ONUs every region fits, the 128-cycle prefix ring and the window's
//     packet counts included; per-row constants and the slot and search tables are copied
//     in once, at phase start;
//   * the window's packet counts are private to the thread that owns the queue (it draws
//     them and reads them), so sampling takes no atomic and no barrier;
//   * the bs slot grants: the wants are computed per ONU by the segment's thread; the
//     row's warp walks them in slot order, 32 at a time, adding only the nonzero ones (a
//     zero want is an exact identity) in a chain as long as the cycle's active slots,
//     and writes each slot's inclusive prefix; each ONU's thread then forms its valid
//     slots' grants min(w, max(cap - (prefix - w), 0)) and adds them in slot order (the
//     host's slots-by-ONU table), which is exactly the per-target order of the plain
//     version's scatter_add_ (an invalid slot's grant is a zero);
//   * the CPS split runs on warp 0 alone: ranks in parallel, the total and the level in
//     ref._cps_split's sequential order on lane 0.
// Row sums are taken in one fixed order (32 lanes add contiguous chunks left to right,
// then the 32 partials in order; ref.row_sum takes the same order). No product meets a sum
// in one expression, so no FMA contraction changes a rounding.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "threefry.cuh"
#include "waterfill.cuh"

// Section timers (scripts/profile_port_phase.py builds a copy with REPRO_PHASE_SECTIONS
// defined; otherwise they are empty): clock64 on thread 0 splits each loop iteration at
// the SECTION marks, and each CTA prints the SM clocks an iteration of each section.
#ifdef REPRO_PHASE_SECTIONS
#include <cstdio>
#define SECTIONS_BEGIN                 \
  unsigned long long tsec[9] = {};     \
  long long tc0 = clock64();
#define SECTION(i)                     \
  if (tid == 0) {                      \
    const long long now = clock64();   \
    tsec[i] += now - tc0;              \
    tc0 = now;                         \
  }
#define SECTIONS_REPORT                                                                    \
  if (tid == 0) {                                                                          \
    double tot = 0.0;                                                                      \
    for (int i = 0; i < 9; ++i) tot += tsec[i];                                            \
    printf("sections fcfs=%d k=%d block=%d total=%.0f cycles/iteration: start %.0f "       \
           "rows+arrivals+push %.0f stop_test %.0f sums+finish %.0f grants_barrier %.0f "  \
           "hard_rows %.0f serves %.0f marginal_barrier %.0f ring_walk+end %.0f\n",       \
           static_cast<int>(fcfs), k, static_cast<int>(blockIdx.x), tot / k,               \
           tsec[0] / (double)k, tsec[1] / (double)k, tsec[2] / (double)k,                  \
           tsec[3] / (double)k, tsec[4] / (double)k, tsec[5] / (double)k,                  \
           tsec[6] / (double)k, tsec[7] / (double)k, tsec[8] / (double)k);                 \
  }
#else
#define SECTIONS_BEGIN
#define SECTION(i)
#define SECTIONS_REPORT
#endif

namespace {

constexpr int kMaxThreads = 256;   // at 512 the kernel spills (128 registers a thread)
constexpr int kRing = 128;         // ref.HISTORY_CYCLES
constexpr int kWin = 1 << kWindowShift;
constexpr double kSegEps = 1.0;
constexpr double kEpsBits = 1.0;
constexpr int64_t kIKeyInf = 0x7FFFFFFFFFFFFFFFLL / 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoQueue = 0x7FFFFFFF;

// Every field 8 bytes, in the order of kernel.py's _PhaseArgs.
struct PhaseArgs {
  long long R, U, N, S, P, Sg, max_slots, n_draws, n_bp, k_max, n_pad;
  long long fast, single, fcfs, has_bg, has_cps, has_deadline, has_outage;
  double cyc, prop, tmax, cps_cap, packet_bits;
  const uint8_t* part;
  const double* rem0;
  const double* ready;
  const int64_t* list_pos;
  const double* cap_col;
  const int64_t* seg_starts;
  const int64_t* seg_len;
  const int64_t* seg_onus;
  const int32_t* kp_rank;
  const double* p_incl;
  const double* q_bound;
  const int32_t* rank_col;
  const double* q_col;
  const uint8_t* pushes;
  const int32_t* m_live;
  const double* cap_t;
  const uint8_t* finite_dl;
  const double* out0;
  const double* out1;
  const int64_t* keys;
  const int32_t* thr;
  const int32_t* bp_start;
  const int32_t* bp_len;
  const double* ts;
  const double* te_g;
  const int32_t* sorder;
  const int32_t* ostart;
  const double* srate;
  const uint8_t* svalid;
  double* done_t;
  double* rem;
  double* t_stop;
  int32_t* k_stop;
  uint8_t* exact;
  uint8_t* left;
  unsigned char* scratch;
};

// A case's state, by region. Pointers are generic: a region lies in shared memory or in
// the CTA's slice of the global scratch, as the plan says.
struct State {
  // rows: per-row scalars and constants
  double *cap, *eff, *bgsum, *flwant, *capfl, *fltot, *tk, *fls, *ws;
  double *cap_col, *cap_t, *out0, *out1, *srate;
  int *cdone, *cnew, *jm, *nlive, *easy, *easyfl, *m_live, *hard, *hardfl;
  int *thr, *bps, *bpl;
  uint32_t* key;
  // background queues
  double *cum, *drained, *backlog, *bgg;
  int* ptr;
  // the sort's (key, index) pairs, one row at a time
  unsigned char* pairs;
  // FL clients (general path)
  double *rem, *qb, *push_time, *ready, *qold;
  int64_t* push_key;
  uint8_t *waiting, *done;
  // per-ONU FL backlog, head-of-line time and grant (general path)
  double *bonu, *hol, *flg;
  // bs slots: wants, inclusive prefixes, windows, the slots-by-ONU table
  double *want, *incl, *ts, *te;
  int *sorder, *ostart;
  uint8_t* svalid;
  // scalar-S search tables
  int *kp, *rcol;
  double *qbnd, *pincl;
  // the window's packet counts and the 128-cycle prefix ring
  int* win;
  double* ring;
};

enum Region { rRows, rBg, rSort, rCli, rOnu, rSlot, rFast, rWin, rRing, kRegions };
// Each region's name, in the enum's order (repro_phase_region_name).
constexpr const char* kRegionName[] = {"rows",  "background", "sort",   "clients", "onus",
                                       "slots", "scalar-S",   "window", "ring"};
static_assert(sizeof(kRegionName) / sizeof(kRegionName[0]) == kRegions, "a name a region");

// Shared-memory bytes and global bytes a CTA, each region's offset, and which regions lie
// in shared memory (bit r of mask).
struct Plan {
  long long smem, gmem;
  long long off[kRegions];
  unsigned mask;
  int threads;
};
// A plan as repro_phase_plan hands it out: smem, gmem, mask, threads, then off[].
constexpr int kPlanWords = 4 + kRegions;

struct Carver {
  unsigned char* base;
  long long used;
  template <class T>
  __host__ __device__ T* take(long long n) {
    T* p = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += (n * static_cast<long long>(sizeof(T)) + 15) & ~15LL;
    return p;
  }
};

// Carve region `reg` of one case from `base` (null: only count its bytes).
__host__ __device__ long long carve(const PhaseArgs& a, int reg, unsigned char* base,
                                    State& s) {
  const long long P = a.P, N = a.N, U = a.U, S = a.S;
  const long long PN = P * N, PU = P * U, PS = P * S;
  const bool general = !a.fast, bs = !a.fcfs;
  Carver c{base, 0};
  switch (reg) {
    case rRows:
      s.cap = c.take<double>(P);
      s.eff = c.take<double>(P);
      s.bgsum = c.take<double>(P);
      s.flwant = c.take<double>(P);
      s.capfl = c.take<double>(P);
      s.fltot = c.take<double>(P);
      s.tk = c.take<double>(P);
      s.fls = c.take<double>(P);
      s.ws = c.take<double>(P);
      s.cap_col = c.take<double>(P);
      s.cap_t = c.take<double>(P);
      s.out0 = c.take<double>(P);
      s.out1 = c.take<double>(P);
      s.srate = c.take<double>(P);
      s.cdone = c.take<int>(P);
      s.cnew = c.take<int>(P);
      s.jm = c.take<int>(P);
      s.nlive = c.take<int>(P);
      s.easy = c.take<int>(P);
      s.easyfl = c.take<int>(P);
      s.m_live = c.take<int>(P);
      s.hard = c.take<int>(P);
      s.hardfl = c.take<int>(P);
      s.key = c.take<uint32_t>(2 * P);
      s.thr = c.take<int>(a.has_bg ? P * a.n_draws : 0);
      s.bps = c.take<int>(a.has_bg ? a.n_bp : 0);
      s.bpl = c.take<int>(a.has_bg ? a.n_bp : 0);
      break;
    case rBg:
      if (a.has_bg) {
        s.cum = c.take<double>(PN);
        s.drained = c.take<double>(PN);
        s.backlog = c.take<double>(PN);
        s.bgg = c.take<double>(PN);
        s.ptr = c.take<int>(PN);
      }
      break;
    case rSort:
      if (a.has_bg || (a.fcfs && general))
        s.pairs = c.take<unsigned char>(a.n_pad * static_cast<long long>(kPairBytes));
      break;
    case rCli:
      if (general) {
        s.rem = c.take<double>(PU);
        s.qb = c.take<double>(PU);
        s.push_time = c.take<double>(PU);
        s.ready = c.take<double>(PU);
        s.qold = c.take<double>(PU);
        s.push_key = c.take<int64_t>(PU);
        s.waiting = c.take<uint8_t>(PU);
        s.done = c.take<uint8_t>(PU);
      }
      break;
    case rOnu:
      if (general) {
        s.bonu = c.take<double>(PN);
        s.hol = c.take<double>(a.fcfs ? PN : 0);
        s.flg = c.take<double>(PN);
      }
      break;
    case rSlot:
      if (bs) {
        s.want = c.take<double>(PS);
        s.incl = c.take<double>(PS);
        s.ts = c.take<double>(PS);
        s.te = c.take<double>(PS);
        s.sorder = c.take<int>(PS);
        s.ostart = c.take<int>(P * (N + 1));
        s.svalid = c.take<uint8_t>(PS);
      }
      break;
    case rFast:
      if (a.fast) {
        s.kp = c.take<int>(PU);
        s.rcol = c.take<int>(PU);
        s.qbnd = c.take<double>(PU);
        s.pincl = c.take<double>(P * (U + 1));
      }
      break;
    case rWin:
      if (a.has_bg) s.win = c.take<int>(static_cast<long long>(kWin) * PN);
      break;
    case rRing:
      if (a.has_bg) s.ring = c.take<double>(static_cast<long long>(kRing) * PN);
      break;
    default:
      break;
  }
  return c.used;
}

// Regions in order of priority go to shared memory while they fit in `cap` bytes, the rest
// to global scratch; threads from the widest per-thread step.
Plan make_plan(const PhaseArgs& a, long long cap) {
  Plan pl{};
  State dummy;
  for (int reg = 0; reg < kRegions; ++reg) {
    const long long b = carve(a, reg, nullptr, dummy);
    if (b && pl.smem + b <= cap) {
      pl.off[reg] = pl.smem;
      pl.smem += b;
      pl.mask |= 1u << reg;
    } else {
      pl.off[reg] = pl.gmem;
      pl.gmem += b;
    }
  }
  long long w = a.P * a.N;
  if (!a.fast && a.P * a.Sg > w) w = a.P * a.Sg;
  if (a.n_pad / 2 > w) w = a.n_pad / 2;
  if (32 * a.P > w) w = 32 * a.P;
  w = (w + 31) / 32 * 32;
  if (w + 32 <= kMaxThreads) w += 32;   // a warp whose threads own no queue, for the rows
  pl.threads = static_cast<int>(w < 128 ? 128 : (w > kMaxThreads ? kMaxThreads : w));
  return pl;
}

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
__device__ double warp_row_sum(const double* x, int n) {
  const int lane = threadIdx.x & 31;
  const int c = (n + 31) / 32;
  const int lo = min(lane * c, n), hi = min(lo + c, n);
  double acc = 0.0;
  for (int i = lo; i < hi; ++i) acc += x[i];
  double part[32];   // the shuffles ahead of the chain of adds
#pragma unroll
  for (int l = 0; l < 32; ++l) part[l] = __shfl_sync(kFull, acc, l);
  double total = 0.0;
#pragma unroll
  for (int l = 0; l < 32; ++l) total += part[l];
  return total;
}

// For non-decreasing a: #{j < n : a[j] <= v} (kLe, searchsorted right) or #{j < n :
// a[j] < v} (searchsorted left), by the whole warp (every lane calls it and gets the
// count): 32 pivots a round split the open range into 32 blocks, a ballot finds the block
// that holds the boundary (log32 n rounds, 2 at 1,024 entries), then its elements.
template <bool kLe, class T>
__device__ int warp_count(const T* a, int n, T v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;   // a[j] passes for j < lo and fails for j >= hi
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int idx = lo + (lane + 1) * step - 1;   // the last element of lane's block
    const bool pass = idx < hi && (kLe ? a[idx] <= v : a[idx] < v);
    const int c = __popc(__ballot_sync(kFull, pass));
    lo += c * step;   // blocks 0..c-1 pass whole; block c's last element fails
    hi = min(hi, lo + step - 1);
  }
  const int idx = lo + lane;
  const bool pass = idx < hi && (kLe ? a[idx] <= v : a[idx] < v);
  return lo + __popc(__ballot_sync(kFull, pass));
}

// The max-min CPS split of `cap` over one case's wants w[0..P) in place, by one warp
// (every lane calls it): the ranks in parallel into ws (equal wants take distinct places,
// so ws is the sorted wants), then on lane 0 the total and the level in ref._cps_split's
// order: the wants added left to right; after the j smallest wants in full the rest split
// the residual evenly, the level is the first feasible mu_j (mu_0 when none is).
__device__ void cps_split_warp(double* w, double* ws, int P, double cap) {
  const int lane = threadIdx.x & 31;
  for (int p = lane; p < P; p += 32) {
    const double v = w[p];
    int r = 0;
    for (int q = 0; q < P; ++q) {
      const double u = w[q];
      r += u < v || (u == v && q < p);
    }
    ws[r] = v;
  }
  __syncwarp();
  double mu = 0.0;
  int over = 0;
  if (lane == 0) {
    double total = 0.0;
    for (int p = 0; p < P; ++p) total += w[p];
    over = total > cap + kCapEps;
    if (over) {
      double cum = 0.0;
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
    }
  }
  over = __shfl_sync(kFull, over, 0);
  mu = __shfl_sync(kFull, mu, 0);
  if (over)
    for (int p = lane; p < P; p += 32) w[p] = fmin(w[p], mu);
  __syncwarp();
}

// The one partially granted background queue q (= p * N + jm) of a row: its new drained
// offset and head, found on the prefix ring (one warp, 4 ring slots a lane, oldest first).
__device__ void ring_walk(const State& st, long long PN, int q, int k, int* exact) {
  const int lane = threadIdx.x & 31;
  const double tgt = st.drained[q] + st.bgg[q];
  const double cum_q = st.cum[q];
  double pref[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int slot = (k - (kRing - 1) + lane + 32 * m) & (kRing - 1);
    pref[m] = st.ring[static_cast<long long>(slot) * PN + q];
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
    if (first && st.ptr[q] < k - (kRing - 1)) *exact = 0;
    st.drained[q] = low ? cum_q : dr1;
    st.backlog[q] = low ? 0.0 : bklg;
    st.ptr[q] = low ? k + 1 : k - (kRing - 1) + (snap ? j2 : j1);
  }
}

__global__ void __launch_bounds__(kMaxThreads) ponsim_phase_kernel(const PhaseArgs a,
                                                                    const Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_exact, s_nhard, s_nhardfl;

  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, n_warps = T >> 5;
  const int P = static_cast<int>(a.P), N = static_cast<int>(a.N), U = static_cast<int>(a.U);
  const int S = static_cast<int>(a.S), Sg = static_cast<int>(a.Sg);
  const int n_draws = static_cast<int>(a.n_draws), n_bp = static_cast<int>(a.n_bp);
  const int n_pad = static_cast<int>(a.n_pad), max_slots = static_cast<int>(a.max_slots);
  const bool fast = a.fast, fcfs = a.fcfs, has_bg = a.has_bg, has_cps = a.has_cps;
  const bool single = a.single, has_deadline = a.has_deadline, has_outage = a.has_outage;
  const int r0 = blockIdx.x * P;
  const int PN = P * N, PU = P * U, PS = P * S, PSg = P * Sg;
  const long long PNl = PN;
  const int64_t rowU = static_cast<int64_t>(r0) * U, rowS = static_cast<int64_t>(r0) * S;
  const float packet_bits = static_cast<float>(a.packet_bits);

  State st;
  unsigned char* gbase = a.scratch ? a.scratch + static_cast<long long>(blockIdx.x) * pl.gmem
                                   : nullptr;
#pragma unroll
  for (int reg = 0; reg < kRegions; ++reg)
    carve(a, reg, ((pl.mask >> reg) & 1u) ? smem + pl.off[reg] : gbase + pl.off[reg], st);

  // ---- constants and state at cycle 0
  for (int p = tid; p < P; p += T) {
    const int r = r0 + p;
    st.cap_col[p] = a.cap_col[r];
    if (has_deadline) st.cap_t[p] = a.cap_t[r];
    if (has_outage) {
      st.out0[p] = a.out0[r];
      st.out1[p] = a.out1[r];
    }
    if (fast) st.m_live[p] = a.m_live[r];
    if (!fcfs) st.srate[p] = a.srate[r];
    if (has_bg) {
      st.key[2 * p] = static_cast<uint32_t>(a.keys[2 * r]);
      st.key[2 * p + 1] = static_cast<uint32_t>(a.keys[2 * r + 1]);
    }
    st.fls[p] = 0.0;
    st.cdone[p] = 0;
    st.cnew[p] = 0;
    st.nlive[p] = 0;
  }
  if (has_bg) {
    for (int i = tid; i < P * n_draws; i += T)
      st.thr[i] = a.thr[static_cast<int64_t>(r0) * n_draws + i];
    for (int i = tid; i < n_bp; i += T) {
      st.bps[i] = a.bp_start[i];
      st.bpl[i] = a.bp_len[i];
    }
    for (int i = tid; i < PN; i += T) {
      st.cum[i] = 0.0;
      st.drained[i] = 0.0;
      st.backlog[i] = 0.0;
      st.ptr[i] = 0;
    }
    for (long long i = tid; i < kRing * PNl; i += T) st.ring[i] = 0.0;
  }
  for (int i = tid; i < PU; i += T) a.done_t[rowU + i] = CUDART_NAN;
  if (!fast) {
    for (int i = tid; i < PU; i += T) {
      const int64_t c = rowU + i;
      const bool d = !a.part[c] || a.rem0[c] <= 0.0;
      st.rem[i] = a.rem0[c];
      st.done[i] = d;
      st.waiting[i] = a.part[c] && !d;
      st.qb[i] = 0.0;
      st.push_key[i] = kIKeyInf;
      st.push_time[i] = 0.0;
      st.ready[i] = a.ready[c];
    }
    for (int i = tid; i < PN; i += T) {
      st.bonu[i] = 0.0;
      if (fcfs) st.hol[i] = CUDART_INF;
      st.flg[i] = 0.0;
    }
  }
  if (!fcfs) {
    for (int i = tid; i < PS; i += T) {
      st.want[i] = 0.0;
      st.ts[i] = a.ts[rowS + i];
      st.te[i] = a.te_g[rowS + i];
      st.sorder[i] = a.sorder[rowS + i];
      st.svalid[i] = a.svalid[rowS + i];
    }
    for (int i = tid; i < P * (N + 1); i += T)
      st.ostart[i] = a.ostart[static_cast<int64_t>(r0) * (N + 1) + i];
  }
  if (fast) {
    for (int i = tid; i < PU; i += T) {
      st.kp[i] = a.kp_rank[rowU + i];
      st.rcol[i] = a.rank_col[rowU + i];
      st.qbnd[i] = a.q_bound[rowU + i];
    }
    for (int i = tid; i < P * (U + 1); i += T)
      st.pincl[i] = a.p_incl[static_cast<int64_t>(r0) * (U + 1) + i];
  }
  if (tid == 0) s_exact = 1;
  __syncthreads();
  if (!fast)
    for (int i = tid; i < PU; i += T)
      if (a.part[rowU + i] && !(a.rem0[rowU + i] <= 0.0)) atomicAdd(&st.nlive[i / U], 1);

  int k = 0;
  double t = 0.0;
  SECTIONS_BEGIN

  // ---- the cycle's steps that more than one place runs
  // completion credit of client c (index within the case) whose queue went q_old -> q_new
  auto credit = [&](int p, int c, double q_old, double q_new, double t_done) {
    const double drained = q_old - q_new;
    const double new_rem = st.rem[c] - drained;
    const bool newly = !st.done[c] && drained > 0.0 && new_rem <= kEpsBits;
    st.rem[c] = newly ? 0.0 : fmax(new_rem, 0.0);
    if (newly) {
      st.done[c] = 1;
      a.done_t[rowU + c] = t_done;
      atomicSub(&st.nlive[p], 1);
    }
  };
  // the FL serve of ONU segment s of row p with grant g, then its clients' credit
  auto serve_segment = [&](int p, int s, double g, double t_done) {
    const int c0 = static_cast<int>(a.seg_starts[s]);
    const int base = p * U + c0;
    if (single) {
      const double q = st.qb[base];
      const bool act = g > kCapEps && q > 0.0;
      const double take = act ? fmin(g, q) : 0.0;
      const double q2 = act && q - take <= kSegEps ? 0.0 : q - take;
      st.qb[base] = q2;
      credit(p, base, q, q2, t_done);
      return;
    }
    // a granted-in-full ONU empties every member, the rest is served head by head (oldest
    // push first), each drop of a sub-SEG_EPS residual charged
    const int len = static_cast<int>(a.seg_len[s]);
    const bool full = g > 0.0 && g == st.bonu[p * N + static_cast<int>(a.seg_onus[s])];
    double budget = full ? 0.0 : g;
    for (int j = 0; j < len; ++j) {
      st.qold[base + j] = st.qb[base + j];
      if (full) st.qb[base + j] = 0.0;
    }
    for (int pass = 0; pass < max_slots; ++pass) {
      int64_t best = kIKeyInf;
      int head = -1;
      for (int j = 0; j < len; ++j) {
        if (st.qb[base + j] > 0.0) {
          const int64_t comb = st.push_key[base + j] * U + (c0 + j);
          if (comb < best) {
            best = comb;
            head = j;
          }
        }
      }
      if (head < 0 || !(budget > kCapEps)) break;
      const double hq = st.qb[base + head];
      const double take = fmin(budget, hq);
      const double resid = hq - take;
      const bool drop = resid <= kSegEps;
      st.qb[base + head] = drop ? 0.0 : hq - take;
      budget = fmax(budget - take - (drop ? resid : 0.0), 0.0);
    }
    for (int j = 0; j < len; ++j)
      credit(p, base + j, st.qold[base + j], st.qb[base + j], t_done);
  };
  // the slot grants of ONU n of row p against cap, added in slot order
  auto slot_sum = [&](int p, int n, double cap) {
    const int* os = st.ostart + p * (N + 1);
    const int* so = st.sorder + p * S;
    const double* w = st.want + p * S;
    const double* inc = st.incl + p * S;
    double g = 0.0;
    for (int j = os[n]; j < os[n + 1]; ++j) {
      const int s = so[j];
      const double wv = w[s];
      g += fmin(wv, fmax(cap - (inc[s] - wv), 0.0));
    }
    return g;
  };
  // row p's FL capacity is known (one thread): the general path's FL row hardness
  auto finish_fl = [&](int p, double cfl) {
    st.capfl[p] = cfl;
    if (!fast) {
      const bool hard = st.flwant[p] > cfl - 1.0;
      st.easyfl[p] = !hard;
      if (hard) st.hardfl[atomicAdd(&s_nhardfl, 1)] = p;
    }
  };
  // row p's effective capacity is known (one thread): easy or hard background, then the
  // FL capacity
  auto finish_row = [&](int p) {
    const double e = st.eff[p];
    if (has_bg) {
      const bool easy = st.bgsum[p] <= e - 1.0;
      st.easy[p] = easy;
      if (!easy) {
        st.hard[atomicAdd(&s_nhard, 1)] = p;
        return;
      }
      finish_fl(p, e - st.bgsum[p]);
    } else {
      finish_fl(p, e);
    }
  };
  // the scalar-S FL serve of row p and its completions (the whole warp; lane 0 writes)
  auto fast_serve = [&](int p, double t_done) {
    const double* qbnd = st.qbnd + p * U;
    const double cfl = st.capfl[p], s_pre = st.fls[p];
    const double capx = fmax(cfl, 0.0);
    const double s1 = cfl > kCapEps ? (st.fltot[p] <= capx ? st.tk[p] : s_pre + capx) : s_pre;
    // a client's last sub-SEG_EPS residual is dropped: snap S to the next boundary
    const int rkx = warp_count<false>(qbnd, U, s1);
    const double qv = rkx < U ? qbnd[rkx] : CUDART_INF;
    const double s2 = s1 > s_pre && qv - s1 <= kSegEps ? qv : s1;
    const int c_new = warp_count<true>(qbnd, U, s2);
    for (int j = st.cdone[p] + lane; j < c_new; j += 32)
      a.done_t[rowU + p * U + st.rcol[p * U + j]] = t_done;
    if (lane == 0) {
      st.cnew[p] = c_new;
      st.fls[p] = s2;
    }
  };
  // rows belong to warps from the last one down (when the queues leave a warp free, it
  // holds the rows alone)
  const int row0 = n_warps - 1 - warp;

  for (;;) {
    __syncthreads();   // the last cycle's serves, credits and ring walks are in
    SECTION(0)
    const double t_end = t + a.cyc;
    const double t_done = t_end + a.prop;
    if (tid == 0) {
      s_nhard = 0;
      s_nhardfl = 0;
    }

    // ---- per row (its warp; lane 0 writes): capacity masks, liveness, the scalar-S FL
    // push
    int live = 0;
    for (int p = row0; p < P; p += n_warps) {
      const int cdone = fast ? st.cnew[p] : 0;
      bool lv = fast ? st.m_live[p] > cdone : st.nlive[p] > 0;
      double c = st.cap_col[p];
      if (has_deadline && !(st.cap_t[p] > t)) {
        lv = false;
        c = 0.0;
      }
      if (has_outage && st.out0[p] <= t && t < st.out1[p]) c = 0.0;
      live |= lv;
      double tk = 0.0;
      if (fast) tk = st.pincl[p * (U + 1) + warp_count<true>(st.kp + p * U, U,
                                                             static_cast<int>(k))];
      if (lane == 0) {
        st.cdone[p] = cdone;
        st.cap[p] = c;
        st.jm[p] = kNoQueue;
        if (fast) {
          st.tk[p] = tk;
          st.fltot[p] = tk - st.fls[p];
        }
      }
    }

    // ---- arrivals: each thread its own queues (a new window every 64 cycles, then this
    // cycle's bits into the FIFO prefix and the ring); the counts are the thread's own
    if (has_bg) {
      const int kw = k & (kWin - 1);
      const long long slot = k & (kRing - 1);
      const uint32_t c0 = static_cast<uint32_t>(k >> kWindowShift);
      for (int i = tid; i < PN; i += T) {
        int* wq = st.win + i;
        if (kw == 0) {
          const int p = i / N;
          for (int m = 0; m < kWin; ++m) wq[m * PNl] = 0;
          const uint32_t k0 = st.key[2 * p], k1 = st.key[2 * p + 1];
          const uint32_t c1 = static_cast<uint32_t>(i - p * N);
          const int count = burst_count(k0, k1, c0, c1, st.thr + p * n_draws, n_draws);
          for (int j = 1; j <= count; ++j) {
            uint32_t x0, x1;
            burst_draw(k0, k1, static_cast<uint32_t>(j), c0, c1, x0, x1);
            const int place = static_cast<int>(x0 >> (32 - kWindowShift));
            wq[place * PNl] += burst_length(static_cast<int32_t>(x1 >> 8), st.bps, st.bpl, n_bp);
          }
        }
        const int count = wq[kw * PNl];
        const double bits = static_cast<double>(__fmul_rn(static_cast<float>(count), packet_bits));
        const double cm = st.cum[i] + bits;
        if (st.backlog[i] <= 0.0 && bits > 0.0) st.ptr[i] = k;
        st.cum[i] = cm;
        st.backlog[i] = cm - st.drained[i];
        st.ring[slot * PNl + i] = cm;
      }
    }

    // ---- general path, a thread an ONU segment: FL push, the ONU's FL backlog (members
    // added left to right) and head-of-line push time, its slots' wants (bs)
    if (!fast) {
      for (int si = tid; si < PSg; si += T) {
        const int p = si / Sg, s = si - p * Sg;
        const int c0 = static_cast<int>(a.seg_starts[s]), len = static_cast<int>(a.seg_len[s]);
        const int n = static_cast<int>(a.seg_onus[s]);
        const int base = p * U + c0;
        double bo = 0.0;
        int64_t best = kIKeyInf;
        int head = -1;
        for (int j = 0; j < len; ++j) {
          const int c = base + j;
          if (st.waiting[c] && st.ready[c] <= t_end) {
            st.qb[c] = st.rem[c];
            st.push_key[c] = static_cast<int64_t>(k) * (U + 1) + a.list_pos[rowU + c];
            st.push_time[c] = fmax(st.ready[c], t);
            st.waiting[c] = 0;
          }
          const double q = st.qb[c];
          bo = j ? bo + q : q;
          if (q > 0.0) {
            const int64_t comb = st.push_key[c] * U + (c0 + j);
            if (comb < best) {
              best = comb;
              head = j;
            }
          }
        }
        st.bonu[p * N + n] = bo;
        if (fcfs) st.hol[p * N + n] = head >= 0 ? st.push_time[base + head] : CUDART_INF;
        if (!fcfs) {
          const int* os = st.ostart + p * (N + 1);
          const double rate = st.srate[p];
          for (int j = os[n]; j < os[n + 1]; ++j) {
            const int sl = p * S + st.sorder[p * S + j];
            const bool active = st.svalid[sl] && st.ts[sl] < t_end && st.te[sl] > t;
            const double overlap = fmin(st.te[sl], t_end) - fmax(st.ts[sl], t);
            double w = rate * fmax(overlap, 0.0);
            w = fmin(w, bo);
            st.want[sl] = active && w > 0.0 ? w : 0.0;
          }
        }
      }
    }

    SECTION(1)
    // ---- the stop test
    if (!__syncthreads_or(live) || !(t < a.tmax && k < a.k_max)) break;
    SECTION(2)

    if (fcfs) {
      // ---- row sums (a warp a row); with no CPS the row's lane 0 goes on to its grants
      for (int p = row0; p < P; p += n_warps) {
        const double bsum = has_bg ? warp_row_sum(st.backlog + p * N, N) : 0.0;
        const double fw = fast ? 0.0 : warp_row_sum(st.bonu + p * N, N);
        if (lane == 0) {
          st.bgsum[p] = bsum;
          st.flwant[p] = fw;
          if (has_cps) {
            st.eff[p] = fmin(bsum + (fast ? st.fltot[p] : fw), st.cap[p]);
          } else {
            st.eff[p] = st.cap[p];
            finish_row(p);
          }
        }
      }
      if (has_cps) {
        __syncthreads();
        if (warp == 0) {
          cps_split_warp(st.eff, st.ws, P, a.cps_cap);
          for (int p = lane; p < P; p += 32) finish_row(p);
        }
      }
      SECTION(3)
      __syncthreads();
      SECTION(4)
      // ---- hard background rows (demand past capacity - 1) poured oldest first; easy
      // rows keep their backlog as the grant, bitwise, with no sort
      const int nhard = has_bg ? s_nhard : 0;
      if (nhard) {
        for (int h = 0; h < nhard; ++h) {
          const int p = st.hard[h];
          waterfill_row(st.backlog + p * N, BgKey{st.backlog + p * N, st.ptr + p * N},
                        st.eff[p], st.bgg + p * N, N, n_pad, st.pairs);
          __syncthreads();
        }
        for (int h = warp; h < nhard; h += n_warps) {
          const int p = st.hard[h];
          const double gs = warp_row_sum(st.bgg + p * N, N);
          if (lane == 0) finish_fl(p, st.eff[p] - gs);
        }
        __syncthreads();
      }
      // ---- hard FL rows (general path) poured by head-of-line push time
      const int nhardfl = fast ? 0 : s_nhardfl;
      for (int h = 0; h < nhardfl; ++h) {
        const int p = st.hardfl[h];
        waterfill_row(st.bonu + p * N, ArrayKey{st.hol + p * N}, st.capfl[p],
                      st.flg + p * N, N, n_pad, st.pairs);
        __syncthreads();
      }
      SECTION(5)
      // ---- FL serve and credit: the scalar-S path a warp a row, beside the background
      // serve; the general path a thread a segment
      if (fast)
        for (int p = row0; p < P; p += n_warps) fast_serve(p, t_done);
      if (!fast) {
        for (int si = tid; si < PSg; si += T) {
          const int p = si / Sg, s = si - p * Sg;
          const int o = p * N + static_cast<int>(a.seg_onus[s]);
          serve_segment(p, s, st.easyfl[p] ? st.bonu[o] : st.flg[o], t_done);
        }
      }
      // ---- background serve: full drains, then the one marginal queue a row (a hard
      // row's; an easy row's grants are its backlogs, all drained in full)
      if (has_bg) {
        for (int i = tid; i < PN; i += T) {
          const int p = i / N;
          const double bl = st.backlog[i];
          const double g = st.easy[p] ? bl : st.bgg[i];
          if (g > 0.0 && g == bl) {
            st.drained[i] = st.cum[i];
            st.backlog[i] = 0.0;
            st.ptr[i] = k + 1;
          } else if (g > kCapEps) {
            atomicMin(&st.jm[p], i - p * N);
          }
        }
        SECTION(6)
        if (nhard) {
          __syncthreads();
          SECTION(7)
          for (int p = warp; p < P; p += n_warps)
            if (st.jm[p] != kNoQueue) ring_walk(st, PNl, p * N + st.jm[p], k, &s_exact);
        }
      }
    } else {
      // ---- bs slot grants: each row's inclusive prefix of the wants in slot order, by the
      // row's warp, 32 slots a step (a want a lane). A zero want adds nothing (acc + 0.0 ==
      // acc, acc never -0.0), so the chain is the step's nonzero wants in slot order, on
      // every lane, each lane keeping the sum through its own slot: the sequential prefix,
      // bit for bit, in as many dependent adds as the cycle has active slots
      for (int p = row0; p < P; p += n_warps) {
        const double* w = st.want + p * S;
        double* inc = st.incl + p * S;
        double acc = 0.0;
        for (int s0 = 0; s0 < S; s0 += 32) {
          const int s = s0 + lane;
          const double wl = s < S ? w[s] : 0.0;
          unsigned nz = __ballot_sync(kFull, wl != 0.0);
          double mine = acc;
          while (nz) {
            const int j = __ffs(nz) - 1;
            nz &= nz - 1;
            acc += __shfl_sync(kFull, wl, j);
            if (lane >= j) mine = acc;
          }
          if (s < S) inc[s] = mine;
        }
      }
      __syncthreads();
      SECTION(4)
      if (has_cps) {
        // the grants at each PON's capacity, their row sums, the split, then the grants
        // again at the CPS level
        for (int si = tid; si < PSg; si += T) {
          const int p = si / Sg, n = static_cast<int>(a.seg_onus[si - p * Sg]);
          st.flg[p * N + n] = slot_sum(p, n, st.cap[p]);
        }
        __syncthreads();
        for (int p = row0; p < P; p += n_warps) {
          const double w = warp_row_sum(st.flg + p * N, N);
          if (lane == 0) st.eff[p] = w;
        }
        __syncthreads();
        if (warp == 0) cps_split_warp(st.eff, st.ws, P, a.cps_cap);
        __syncthreads();
      }
      for (int si = tid; si < PSg; si += T) {
        const int p = si / Sg, s = si - p * Sg;
        const int n = static_cast<int>(a.seg_onus[s]);
        serve_segment(p, s, slot_sum(p, n, has_cps ? st.eff[p] : st.cap[p]), t_done);
      }
    }
    SECTION(8)
    ++k;
    t += a.cyc;
  }
  SECTIONS_REPORT

  // ---- outputs: rem, and whether each client is left for the wrapper's final clock (the
  // scalar-S path's rem and done from its final S)
  for (int i = tid; i < PU; i += T) {
    const int64_t c = rowU + i;
    const int p = i / U;
    double rv;
    bool dn;
    if (fast) {
      const double scol = st.fls[p], r0v = a.rem0[c];
      const bool push = a.pushes[c];
      dn = !a.part[c] || r0v <= 0.0 || (push && a.q_col[c] <= scol);
      rv = push ? fmin(fmax(a.q_col[c] - scol, 0.0), r0v) : r0v;
    } else {
      rv = st.rem[i];
      dn = st.done[i];
    }
    a.rem[c] = rv;
    a.left[c] = a.part[c] && !dn && !(has_deadline && a.finite_dl[r0 + p]);
  }
  if (tid == 0) {
    a.k_stop[blockIdx.x] = k;
    a.t_stop[blockIdx.x] = t;
    a.exact[blockIdx.x] = static_cast<uint8_t>(s_exact);
  }
}

// The dynamic shared memory a launch may take on the current device (the card's opt-in
// less the kernel's static arrays), queried once a device.
int smem_limit(long long* bytes) {
  static long long cache[64];
  static bool known[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && known[dev]) {
    *bytes = cache[dev];
    return 0;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, ponsim_phase_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bytes = static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
  if (dev < 64) {
    cache[dev] = *bytes;
    known[dev] = true;
  }
  return 0;
}

}  // namespace

extern "C" long long repro_phase_args_bytes() { return sizeof(PhaseArgs); }

// Each region's name, null past the last (bit r of repro_phase_plan's out[2] is region r).
extern "C" const char* repro_phase_region_name(int r) {
  return r >= 0 && r < kRegions ? kRegionName[r] : nullptr;
}

extern "C" int repro_phase_plan_words() { return kPlanWords; }

// The launch's plan on the current device, kPlanWords words: out[0] shared-memory bytes,
// out[1] global scratch bytes a case (the wrapper allocates n_cases times that), out[2]
// the regions in shared memory (bit r: region r), out[3] threads a CTA, then each region's
// offset. Returns a CUDA error code.
extern "C" int repro_phase_plan(const void* args, long long* out) {
  long long cap = 0;
  const int err = smem_limit(&cap);
  if (err) return err;
  const Plan pl = make_plan(*static_cast<const PhaseArgs*>(args), cap);
  out[0] = pl.smem;
  out[1] = pl.gmem;
  out[2] = pl.mask;
  out[3] = pl.threads;
  for (int r = 0; r < kRegions; ++r) out[4 + r] = pl.off[r];
  return 0;
}

// plan: repro_phase_plan's out for these args on this device; args.scratch: null, or
// n_cases times plan[1] bytes.
extern "C" int repro_ponsim_phase(const void* args, int n_cases, const long long* plan,
                                  void* stream) {
  const PhaseArgs& a = *static_cast<const PhaseArgs*>(args);
  Plan pl{};
  pl.smem = plan[0];
  pl.gmem = plan[1];
  pl.mask = static_cast<unsigned>(plan[2]);
  pl.threads = static_cast<int>(plan[3]);
  for (int r = 0; r < kRegions; ++r) pl.off[r] = plan[4 + r];
  if (pl.gmem && !a.scratch) return static_cast<int>(cudaErrorInvalidValue);
  if (pl.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ponsim_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(pl.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ponsim_phase_kernel<<<n_cases, pl.threads, static_cast<size_t>(pl.smem),
                        static_cast<cudaStream_t>(stream)>>>(a, pl);
  return static_cast<int>(cudaGetLastError());
}
