#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (sm_90a).

    python3 chip_smoke.py

The port has sixteen paths, each driven through its user entry point with
the kernel counts set to 0 just before and read just after (the model
zoo's serving once a config):

* the Fig. 2b round engine (``repro_torch.net.simulate``), through K1
  (traffic sampler) and K2 (waterfill grant);
* the same engine with ``backend="jit"``: each transfer phase one launch
  of the fused phase kernel (``ponsim_phase``), which samples the
  arrivals (K1's function) and pours the waterfill (K2's) inside itself;
* olmo-1b serving (``repro_torch.launch.serve``: prefill, then greedy
  decode), through K4 (flash attention) in every layer of the prefill;
* mamba2-780m serving (the same entry point), through K5 (the chunked
  SSD scan) in every layer of the prefill;
* recurrentgemma-2b serving (the same entry point), through K6 (the
  RG-LRU linear scan) in every recurrent layer and K4 at head dim 256 in
  every attention layer of the prefill;
* the Fig. 2a FL round (``repro_torch.fl.CPSServer.run_round``: LEAF
  CNN clients' local SGD, int8 update compression with error feedback,
  FedAvg), through K3 and K3' (int8 quantise, dequantise) on every leaf
  of every arrived update;
* the multi-round timeline (``simulate`` with a ``TimelineSchedule``:
  folded, sequential and async rounds), through the phase kernel with
  ``backend="jit"`` and through K1 and K2 on the per-cycle loop;
* the FL × PON co-simulation (``repro_torch.fl.FLNetworkCoSim``), whose
  int8 updates run through K3 and K3';
* fault injection on the timeline (``TimelineSchedule.faults``), through
  the phase kernel with ``backend="jit"`` (outage windows as its outage
  rows), and through K1 and K2 where a phase falls back to the per-cycle
  loop;
* multi-tenant jobs (``SweepCase.jobs``), through K1 and K2 on the
  per-cycle loop, which a multi-job sweep runs with ``backend="jit"``
  too;
* the collector (``repro_torch.obs``) on the per-cycle loop of the round
  engine and the timeline, through K1 and K2;
* the single-round API (``repro_torch.net.simulate_round``) on both
  engines, and the cycle-level oracles on the engine's counter streams,
  through K1, K2 and the phase kernel;
* olmo-1b training on one pod (``repro_torch.launch.train``: AdamW
  steps, the round's sync from the timeline, checkpoints), through K4
  in every layer's forward and its recompute, K4 as an autograd
  Function whose backward recomputes the plain version;
* the seven other configs served (``serve()``'s step functions):
  llama3-8b, qwen3-14b, gemma3-12b, mixtral-8x22b and arctic-480b
  (Mixture-of-Experts; arctic with its int8 KV cache), pixtral-12b and
  musicgen-large (stub frontends), through K4 in every attention layer
  of the prefill;
* olmo-1b federated training on two pods (``repro_torch.launch.train``
  where it sees two devices: each pod's AdamW steps, an int8 FedAvg
  round a round), through K4 in every pod's step and K3 and K3' on
  every stacked leaf of every round;
* its coupled FedBuff branch (a deadline, fault injection and a
  quorum: each round's arrivals, staleness, drops and retries from the
  timeline drive the async round step), through the same kernels;
* olmo-1b training on a ``DeviceMesh`` (the train step on a state and
  batches that are DTensors placed by ``launch/specs.py``'s specs, on a
  one-rank NCCL group), through K4 on each rank's local heads.

The training phases share one one-rank NCCL process group on an
in-process ``HashStore`` (``_process_group``), ended before the last
line. ``train()`` takes its mesh path over more than one rank only; on
one rank it runs the same steps on plain tensors.

Phases, each printing its own line with its seconds; any failure exits
nonzero. ``wide_pons`` (7a) runs right after ``build``, so that its
plain runs go on beside every later phase:

1. ``build``: the Hopper kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once); prints the card's name and power
   limit and ptxas' register counts;
2. ``k1``: the traffic sampler against its plain PyTorch version on the
   card, bit for bit: the sampler parity shapes, the engine's chunk
   shapes, the tiling's edges (n_cycles under a window, spans cut
   short, lo > 0, a rate-0 row beside draw budgets in the hundreds,
   thresholds past 48 KB of shared memory) and two pinned stream
   fingerprints; timed at 8 x 1024 x 128 and 1 x 1024 x 2048, each with
   its bound and the device operations a call (one, by torch.profiler);
3. ``k2``: the waterfill grant against its plain version run on CPU
   copies of the same inputs, bit for bit, at the engine's rows (128,
   2048 and 4096 queues), at the widest row held in shared memory
   (16,384) and at one past it (20,000, through the wrapper's global
   scratch); timed at 8 x 128, 1 x 2048, 1 x 4096 and 1 x 20,000;
3a. ``k_phase``: the fused phase kernel against its plain version
   (``run_phase_ref``, on CPU copies of the same inputs, in worker
   processes) on every phase of four short sweeps at 128 ONUs
   (``phase_check_sweeps``): ``done_t`` bit for bit, ``rem`` within
   ``PHASE_RTOL``, the same exact flag; they must cover
   ``PHASE_COVER`` (the scalar-S path with background, several
   clients an ONU, bs slots, 3-PON CPS with deadline and outage, an
   inexact ring walk); then on the three phases of the fig2b-16 sweep
   (the main path's shapes: up to 128 clients at 10 Gb/s, 1,774 to 6,312
   cycles) the same way, every client's ``done_t`` and ``rem``. Timed on
   those three (µs a cycle), beside the plain version on the card; the
   bound counts the phase's inputs read once, its outputs written once,
   the threefry draws and float64 adds its data needs (the kernel is
   bound by latency, the serial chain of cycles and barriers, far above
   that bound). Then past the widths the kernel once refused
   (``wide_check_sweeps``, ``WIDE_COVER``): 33 and 100 PONs a case, an
   ONU of 33 clients, bs slots piled 3 to an ONU under CPS, a row of
   16,385 queues (its sort in global scratch), each held the same way
   and timed;
3b. ``k3``: int8 quantise (K3) and dequantise (K3') against their plain
   versions on the card, bit for bit (q, scales, dequantised values):
   ``K3_GRID`` in float32 and bfloat16, as drawn, half zero and on exact
   .5 ties; every CNN leaf at block = n; the whole 6,603,710-element
   update at block 4096; K3' against its library call (one ``torch.mul``
   of q by the scales) too; K3 at block = n past the card's on-chip
   capacity (``K3_PAST_CAPACITY``). ``torch.profiler`` counts the device
   operations of one K3 call at fc1 (kernels, memsets, copies): it must
   be 1. Timed on the fc1 weight at block = n and on
   the update at block 4096, each from HBM (``COLD_COPIES`` copies in
   turn) and warm in L2, beside the plain versions, the library call for
   K3' and the bound (no single PyTorch call computes amax-scaled
   symmetric int8);
4. ``k4``: flash attention against its plain version on the card over
   the test grid (float32 within 2e-5, bfloat16 within 2e-2; head dims
   16 to 256), each call through the kernel ``route`` names (bf16 at
   head dims 64, 128 and 256 on the tensor-core kernel, the rest on the
   CUDA-core one), over bf16 shapes at the tensor-core kernel's tile
   edges (``K4_TC_EDGES``), and at olmo-1b's prefill shape
   (4, 2048, 16, 16, 128) bf16 causal, timed there beside its plain
   version and ``scaled_dot_product_attention`` (a yardstick only: the
   port never calls it); the same at recurrentgemma-2b's prefill shape
   (4, 2048, 10 heads, 1 kv head, 256) bf16 with window 2048 (SDPA given
   k/v for all 10 heads), and held at (4, 4096, 10, 1, 256) with window
   2048, where the window cuts;
5. ``k5``: the SSD scan against its plain chunked version on the card
   over a grid (float32 and bf16 inputs, whole and ragged lengths, S
   below one chunk, with and without an initial state, mamba2 widths
   and small ones, chunk sums past the point where the unmasked product
   form overflows), y and the final state within ``K5_TOL`` of the
   plain version's largest value; every bf16 shape the tensor-core
   route takes is held on both routes (the tensor-core kernels and the
   CUDA-core kernel). At mamba2-780m's prefill shape (4, 2048, 48, 64),
   N 128, chunk 128, bf16, both routes are held and timed, beside the
   plain version (no single PyTorch call computes the scan);
5b. ``k6``: the RG-LRU scan against its plain version on the card over a
   grid (float32 and bf16 inputs, with and without h0, ragged S and R,
   recurrentgemma's width, decays near 1 and near 0, S off K6's chunks
   and windows) within ``K6_TOL``
   of the plain version's largest value; timed at recurrentgemma-2b's
   prefill shape (4, 2048, 2560) float32 beside its plain version (no
   single PyTorch call computes the recurrence);
6. ``main``: the 16-case Fig. 2b sweep (128 ONUs, {fcfs, bs} x load
   {0.3, 0.8} x involvement {0.1, 0.4, 0.7, 1.0}) on the card; every sync
   time must match the JAX engine's value within 1e-9 s and both kernels
   must have been launched; one warm-up run, then the median wall time
   of 3;
6b. ``main_jit``: the same sweep through ``backend="jit"``: every sync
   within 1e-9 s of the JAX engine's, at least 3 phase launches, no
   standalone K1 or K2 launch and no re-run on the per-cycle loop; one
   warm-up run, then the median wall time of 3 beside ``main``'s;
6c. ``oracle``: (a) ``simulate_round`` at the Fig. 2b point (12
   clients, load 0.8, fcfs, seed 1) on the per-cycle loop (K1 and K2
   launched) and with ``backend="jit"`` (the phase kernel only), both at
   the pinned sync; (b) ``ORACLE_CASES`` on the cycle-level simulator
   fed the engine's counter streams (their chunks drawn by K1 on the
   card, one host copy each) held to the card engine's rounds within
   ``ORACLE_RTOL`` and to the pinned syncs; (c) the multi-PON oracle,
   4 PONs x 128 ONUs under a CPS uplink that binds, held to the engine
   the same way, then under a collector: the same round bit for bit,
   its ``multi_pon.*`` CPS counters and gauge recorded;
7. ``full_width``: one FCFS load-0.8 round at 2048 ONUs, then at 4096
   (line rate scaled 10 Gb/s * n / 128; one PON, so K2 rows of 2048 and
   4096 queues), each held against the JAX engine's sync time, on the
   per-cycle loop and through ``backend="jit"`` (phase kernel only);
7a. ``wide_pons``: one FCFS load-0.8 round on 100 PONs x 1,024 ONUs in
   one case (``benchmarks/timeline.py::stacked_run``'s deployment)
   through ``backend="jit"``: its sync within ``SYNC_TOL`` of the
   per-cycle loop's on the same card and every client's times and
   left-over bits within ``ROUND_RTOL`` of the loop's; its two phases,
   recorded, each held in full, at its full widths, to the plain version
   on CPU copies (``done_t`` bit for bit, ``rem`` within ``PHASE_RTOL``,
   the same exact flag; the plain runs in two worker processes that go on
   beside the later phases, their arrival windows drawn on the card by
   the same plain code, checked in ``wide_pons_hold`` once the last
   phase is done); prints the wall, each phase's device ms and µs a cycle
   and the device's busy share. Nothing is cut;
7b. ``timeline``: (a) ``benchmarks/timeline.py``'s Fig. 3 grid (128
   ONUs, 10 Gb/s, 26.416 Mbit updates, {fcfs, bs} x load {0.3, 0.8},
   seed 0, 24 rounds of elastic membership 0.8, membership seed 7)
   folded into one stacked simulation of 96 rows, through
   ``backend="jit"`` and through the per-cycle loop, every round's sync
   within ``SYNC_TOL`` of ``FIG3_SYNC``, and every round's arrivals and
   every client's times and left-over bits of the jit run held to the
   per-cycle loop's (``_hold_round``); (b)
   ``benchmarks/training_time_saving.py``'s 8-round timeline (load 0.8,
   seeds {0, 1}) through jit, each round held to ``SAVING_SYNC`` and
   ``fcfs_total_s``, ``bs_total_s``, ``saving_pct`` and the analytic BS
   round time (``core.round_model.bs_round_time``) to ``SAVING_TOTALS``;
   (c) the op point of ``benchmarks/async_timeline.py`` (12 clients,
   FCFS and BS, load 0.8, seed 1, 6 rounds) under deadline 4 s with
   defer, drop and partial, and async with a buffer of 6, through jit,
   every round held to ``OP_SYNC``; (d) ``stacked_run``'s timeline
   (100 PONs x 1,024 ONUs, 2 elastic rounds, load 0.05) through jit,
   every round and client within ``ROUND_RTOL`` of the per-cycle loop
   on the card; (e) the same schedules at 16 ONUs and 3 rounds. Every
   phase of (a), (b), (c) and (e) is recorded and held to the plain
   version on CPU copies (``_PhaseHolds``: ``done_t`` bit for bit,
   ``rem`` within ``PHASE_RTOL``, the same exact flag; the plain runs in
   worker processes, one a core but one, started as each run is
   recorded); (e)'s must cover
   ``TIMELINE_COVER`` (folded rows with dead columns, carriers with no
   download, a deadlined BS row, both passes of an async round). Prints,
   for each run, the wall, phase
   launches, ``phase_fallbacks``, K1/K2 launches, the device's busy
   share, each phase's ms, CTAs and µs a cycle and the host's ms for
   the phases' tables;
7c. ``cosim``: ``benchmarks/async_timeline.py::accuracy_part``'s
   co-simulation (8 clients x 64 samples, LEAF CNN, lr 0.04, batch 16,
   2 local epochs; BS, load 0.8, model 2e6 bits, uploads 3e8 bits, 8
   ONUs at 1 Gb/s; int8 updates) on the card for 4 rounds in each of
   sync, defer, drop and partial (deadline 3.5 s), async (buffer 4) and
   the benchmark's faulty modes (``benchmarks/faults.py::accuracy_part``:
   dropout 0.2, loss 0.1, outage 0.5 under a 3.5 s drop deadline, with and
   without quorum 0.5; arrivals, failed and lost clients a round held to
   ``COSIM_FAULT_COUNTS``), the network through ``backend="jit"`` (the
   run's template ``spec``):
   every round's sync within ``SYNC_TOL`` of ``COSIM_SYNC``, K3 and K3'
   8 launches an update; and the same on the CPU from the same initial
   weights (its network on the per-cycle loop; one mode a worker
   process, beside the card's runs): syncs within
   ``SYNC_TOL`` of ``COSIM_SYNC``, arrivals and staleness identical,
   every round's accuracy
   within ``FL_REF_GAP`` and its mean loss within ``FL_REF_GAP`` of
   itself. Prints ``time_to_metric`` for each mode;
7e. ``faults``: ``benchmarks/faults.py``'s grid (the op point, 6 rounds,
   dropout {0, 0.2} x outage {0, 0.5}, modes sync (deadline 4 s, defer),
   async (buffer 6) and quorum (drop, 0.75); a cell with outages over its
   mode's first ``FAULT_OUTAGE_ROUNDS`` rounds) through ``backend="jit"``,
   every round's sync, failed clients, losses, retry rounds, give-ups and
   extensions held to ``FAULT_PINS``; every phase of the three dropout
   0.2 x outage 0.5 cells held to the plain version; the all-zero
   schedule bit for bit ``faults=None``; one cell on the per-cycle loop
   held to jit client by client. A phase whose background outgrows the
   phase kernel's 128-cycle ring (a 0.5 s outage at load 0.8) re-runs on
   the per-cycle loop, as the JAX engine's does: each cell must re-run
   exactly ``FAULT_OUTAGE_FALLBACKS`` such upload phases (none without
   outages), and the line counts those ``phase_fallbacks``; the loop
   cell runs under a collector, its fault events by kind and its round
   records held to ``OBS_PINS["faults"]``;
7f. ``jobs``: ``benchmarks/jobs.py``'s grid (one BS round at 2048 ONUs,
   load 0.8, jobs {1, 2, 4, 8} x fairness {maxmin, weighted}), an FCFS
   case of 4 jobs under deadline fairness, a 4-PON case under a binding
   CPS and a cadenced 4-round timeline, on the per-cycle loop and with
   ``backend="jit"``: every sync and job sync held to ``JOBS_PINS``, the
   two runs equal, K2 launched by the FCFS case; the loop runs under a
   collector, each job's upload-delay p95 (``benchmarks/jobs.py``'s) held
   to ``OBS_PINS["jobs"]``;
7g. ``obs``: the collector on the per-cycle loop. (a)
   ``benchmarks/obs_overhead.py``'s measurement (the Fig. 3 grid, 6
   elastic rounds folded into 24 rows, 128 ONUs): a warm-up, then the
   collector off and on (with a span tracer) in turns, ``OBS_REPEATS``
   times each: every run's syncs bit for bit the first's and within
   ``SYNC_TOL`` of ``FIG3_SYNC``, K1 and K2 launched; the report held to
   ``OBS_PINS["overhead"]`` (each phase's rows, cycles and utilisation
   n exactly, bit totals and ``grant_utilization`` within
   ``OBS_SUM_RTOL``, p50/p95/p99 within ``OBS_PCT_TOL``, spans by name);
   the trace saved, loaded and validated; the overhead (the better on
   run over the better off run, less 1) printed, not gated. (b) The
   Fig. 2b sweep under ``Collector(keep_phases=False)``: syncs held,
   upload-delay percentiles held to ``OBS_PINS["fig2b"]``. (f) A
   collector on ``backend="jit"`` raises ``ValueError``;
7d. ``fl_fig2a``: ``benchmarks/fig2a_accuracy.py``'s settings (16
   clients x 64 samples, lr 0.04, batch 16, 2 local epochs, data seed 0,
   server seed 1, 10 rounds, fractions {0.25, 0.5, 1.0}, 512 test images)
   through the port's ``CPSServer``, the CNN at width 1 from a torch
   seed, once with int8 compression (error feedback on) and once
   uncompressed. First one batch's loss and gradients on the card
   against the port's CPU run (``CNN_CARD_TOL``, ``CNN_WGRAD_TOL``),
   which the same batch with TF32 on must fail; every client step of
   the runs, forward and backward, must run with TF32 off. K3 and K3' must each
   run 8 times an arrived update in the int8 run and never in the other;
   ``update_bits`` must be exactly the arrived count times 52,829,936
   (int8) or 211,318,720 (none) bits; in the first round of each
   fraction every K3/K3' call is held to its plain version on the same
   input, bit for bit; the final accuracies are gated (``FL_ACC_MIN``,
   ``FL_REF_GAP`` to the JAX package's own run, ``FL_INT8_GAP``).
   Prints the accuracy curves, ms a round and the bits;
8. ``serve``: olmo-1b at full width and depth (16 layers, float32
   parameters, bfloat16 compute, random weights from a seed), batch 4,
   2048-token prompts (OLMo-1B's context length), 32 greedy new tokens,
   through ``serve()``, which writes its ``--log-jsonl`` to a temporary
   file (one ``serve`` event with ``prefill_ms``, ``decode_ms`` and
   ``tps``, read back); K4 must run 16 times (one a layer) in the
   prefill, all on the tensor-core kernel, and never in decode. The
   same weights and prompts then run through the step functions with
   the plain attention (``attn_impl="reference"``) and with the plain
   attention in float32 compute: the last position's prefill logits and 8 teacher-forced
   decode steps of the two bf16 paths must agree within ``LOGIT_TOL``,
   and the kernel path may stand no farther from the float32 path than
   ``F32_RATIO`` times the plain path does. Decode never runs K4. JAX
   is not installed beside the card, so parity with the JAX package is
   carried by the CPU tests at smoke size (``tests/test_torch_lm.py``,
   ``tests/test_torch_serve.py``);
9. ``serve_mamba2``: mamba2-780m at full width and depth (48 layers,
   d_model 1536, float32 parameters, bfloat16 compute, random weights
   from a seed), batch 4, 2048-token prompts, 32 greedy new tokens,
   through ``serve()``; K5 must run 48 times (one a layer) in the
   prefill, all on the tensor-core route, and never in decode, and
   every logit must be finite. The
   same weights then run with the plain scan swapped in for the
   dispatch (here only, by patching ``kernels.ssd.ops.ssd_scan``; no
   user reaches it) in bf16 and in float32 compute, held as in
   ``serve`` with ``MAMBA_LOGIT_TOL`` and ``MAMBA_F32_RATIO``; the
   kernel path in float32 compute must agree with the plain scan's
   within ``MAMBA_F32_TOL``. Parity with the JAX package is carried by
   ``tests/test_torch_lm.py`` and ``tests/test_torch_serve.py`` at smoke
   size on the CPU;
10. ``serve_recurrentgemma``: recurrentgemma-2b at full width and depth
   (26 layers: 8 units of (RG-LRU, RG-LRU, local attention with window
   2048) and a remainder of two RG-LRU layers; float32 parameters, bf16
   compute, random weights from a seed), the same traffic, through
   ``serve()``; K6 must run 18 times and K4 8 times (all on the
   tensor-core kernel) in the prefill and neither in decode, and every
   logit must be finite. The same weights then run with the plain scan
   (patching
   ``kernels.rglru.ops.rglru_scan``, here only) and the plain attention
   (``attn_impl="reference"``) in bf16 and in float32 compute, held
   with ``RG_LOGIT_TOL``, ``RG_F32_RATIO`` and ``RG_F32_TOL`` as in
   ``serve_mamba2``;
10b. ``serve_zoo``: each of ``ZOO`` at its published width (mixtral-8x22b
   and arctic-480b cut in depth to ``ZOO_LAYERS``, printed as
   ``reduced`` lines), random weights from seed 0 and frontend
   embeddings drawn as ``serve()`` draws them, batch 4, 2048-token
   prompts, ``ZOO_NEW`` greedy tokens, through the step functions as
   ``serve()`` drives them, its cache sized with the frontend tokens.
   First K4 alone at the config's prefill shape, held to its plain
   version and timed beside it and SDPA. Held: (a) K4 runs once an
   attention layer in the prefill, all on the tensor-core kernel, never
   in decode; (b) the prefill's last-position logits within
   ``ZOO_LOGIT_RTOL`` (of the largest) of the same prefill with the
   plain attention; (c) every logit finite, tokens ``(4, ZOO_NEW)``;
   for arctic's int8 cache (d) its bytes half the bf16 cache's plus the
   scales and (e) its decode logits against a bf16 cache's with the
   same experts within ``ZOO_KV_FACTOR`` x layers x the cache's largest
   half step. Prints prefill and decode ms, peak memory, K4's times, and
   the MoE experts' loads and dropped share;
11. ``train``: (a) ``train()`` at olmo-1b's full width (16 layers,
   float32 parameters, bf16 compute, random weights from a seed), one
   pod, batch 8 x 64 tokens, 2 rounds x 4 AdamW steps, its
   ``--log-jsonl`` read back: every step's loss finite, each round's
   sync within ``SYNC_TOL`` of ``TRAIN_SYNC_PINS``, K4 with its
   log-sum-exp ``TRAIN_K4_A_STEP`` times a step (the forward and the
   ``remat`` recompute of each layer, ``attn_impl="chunked"``), all on
   the tensor-core kernel, and the backward from it
   ``TRAIN_K4_BWD_A_STEP`` times (once a layer,
   ``K4_BWD_LAUNCHES_A_CALL`` launches each); prints the
   step ms, peak memory, and the device ms of one more step under
   ``torch.profiler`` (its kernels' time, the largest named) over the
   wall of one unprofiled step (the busy share); then one step at
   olmo-1b's published 2048-token context (batch ``TRAIN_LONG[0]``):
   its loss finite, K4 ``TRAIN_K4_A_STEP`` times on the tensor cores
   and its backward ``TRAIN_K4_BWD_A_STEP`` times, its ms, peak memory
   and busy share, and the same of that step through
   ``attn_impl="pallas"`` (the plain recompute in the backward). (b) One full-width state and batch through one AdamW
   step with K4 in bf16, the plain attention in bf16 and in float32
   compute: the kernel run's loss, gradient norm and parameter change
   no farther from the float32 run than ``TRAIN_F32_RATIO`` times the
   plain run's plus a floor. (c) K4's autograd Function's forward at
   the train steps' shapes (the one-pod step's, a pod's of the fed step
   in ``fed_train``, the long step's) within ``K4_TOL`` of the plain
   version; K4's,
   K5's and K6's Functions at the serving shapes with S cut to
   ``TRAIN_BWD_S``: every input gradient bit for bit autograd of the
   plain version on the same inputs; each backward's ms. The backward
   from the log-sum-exp at the two S-512 shapes and the long step's:
   K4's lse within ``XLA_LSE_TOL``, dq, dk, dv within ``XLA_BWD_RTOL``
   of the plain versions on the same inputs, ``XLA_REPEATS`` calls bit
   for bit, its ms beside the plain version's, the bound, the recompute
   Function's backward and SDPA's. (d) 2 layers, 3 rounds x 2 steps with a
   checkpoint a round; only round 2's copied into a fresh directory and
   resumed: the final state (params, moments, step) bit for bit the
   uninterrupted run's; (c) also times SDPA's forward and backward
   under autograd on the K4 checks' inputs (a yardstick only);
12. ``fed_train``: (a) ``train()``'s federated branch (``FED_RUNS``
   "fed") at olmo-1b's published width cut to ``FED_LAYERS`` of 16
   layers (memory), ``FED_PODS`` pods on the card (``train()`` sees that
   many devices through its ``device_count`` seam), batch 8 x 64 (4 a
   pod), 2 rounds x 4 steps, int8 FedAvg rounds, its ``--log-jsonl``
   read back: every loss finite, the mesh event's pod axis, each
   round's sync within ``SYNC_TOL`` of ``FED_SYNC_PINS``, K4 twice a
   layer a pod a step, all on the tensor-core kernel, the backward from
   its lse once a layer a pod a step, K3 and K3' once a
   stacked leaf a round; a fed step and an int8 round timed, each
   profiled for its busy share; (b) the coupled FedBuff branch
   ("fed_async": 2 s deadline, defer, faults of seed 3, quorum 0.5), 3
   rounds x 2 steps, held the same way; (c) one fed step bit for bit the
   single-pod step on each pod's slice (deterministic algorithms), the
   int8 FedAvg round with and without error feedback and the int8
   FedBuff round bit for bit the same calls through the plain quantiser,
   and K3/K3' alone at the largest stacked leaf (the embedding, one block
   a pod) bit for bit their plain versions, timed beside them and the
   bound; (d) a coupled run of 3 rounds with a checkpoint a round (both
   pods' train and async states), only round 2's copied into a fresh
   directory and resumed: the final state bit for bit the uninterrupted
   run's (1 layer at the published width, for the checkpoints' I/O).
   Prints the peak memory. (c)'s fed step runs on the pod-sharded
   DTensor state (a ``("pod", "data", "model")`` mesh of one rank, both
   pods on it) against the no-mesh single-pod step on each pod's slice;
13. ``mesh``: (a) olmo-1b at its published width and depth (16 layers),
   one pod, batch 8 x 64, two AdamW steps (``MESH_STEPS``) through the
   mesh step (``make_train_step`` with ``grad_shardings`` on the state
   placed by ``launch/specs.py``, batches by ``shard_batch``, on a
   one-rank mesh): every step's loss and gradient norm and every
   parameter and moment bit for bit the same steps through
   ``make_train_step`` on plain tensors with no mesh (deterministic
   algorithms), K4 and the backward from its lse the same launches in
   each, K4 all on the tensor cores;
   a mesh step and a no-mesh step timed, each profiled for its busy
   share (DTensor's dispatch is host time). (b) the partition specs of
   all ten configs on the two production meshes
   (``make_production_mesh``: 16 x 16,
   2 x 16 x 16 fed) from their meta-device shapes, printed as each
   device's parameter and moment bytes (host only).

Before the last line it prints one JSON object with each kernel's
launches on its path (K4's and K5's ``launches_tc`` of them on the
tensor-core kernels; ``launches_by_path`` for the kernels several paths
run; K4's, K5's and K6's ``backward_ms``, ``backward_plain_ms`` and
``backward_bound_ms`` from ``train`` (c), K4's ``backward_library_ms``;
the backward from K4's lse, ``flash_attention_bwd``, at the long train
step's shape and ``*_by_shape`` at the S-512 ones;
K3's and K3''s times at the fed leaf from ``fed_train`` (c)), its error
against the plain version, its time, the plain
version's time, a library call's time where one computes the same
function, and the least time the card could take (``bound_ms``). Every
time is ``_device_ms``'s: launches queued back to back behind a sleep
kernel, between CUDA events.
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Fig. 2b sync times (s) of the JAX package's numpy engine for the cases
# of fig2b_cases(), and of its 2048- and 4096-ONU FCFS load-0.8 rounds
# (seed 0); tests/test_torch_engine.py recomputes them from the JAX
# package
SYNC_TABLE = {
    "fcfs_load0.3_n12": 4.933099999999982,
    "fcfs_load0.3_n51": 5.005100000000006,
    "fcfs_load0.3_n89": 5.000100000000004,
    "fcfs_load0.3_n128": 5.280100000000098,
    "fcfs_load0.8_n12": 5.058100000000024,
    "fcfs_load0.8_n51": 5.4651000000001595,
    "fcfs_load0.8_n89": 5.55610000000019,
    "fcfs_load0.8_n128": 6.312100000000442,
    "bs_load0.3_n12": 4.909099999999974,
    "bs_load0.3_n51": 4.909099999999974,
    "bs_load0.3_n89": 4.909099999999974,
    "bs_load0.3_n128": 4.909099999999974,
    "bs_load0.8_n12": 4.909099999999974,
    "bs_load0.8_n51": 4.909099999999974,
    "bs_load0.8_n89": 4.909099999999974,
    "bs_load0.8_n128": 4.909099999999974,
}
SYNC_2048 = 6.735100000000584
# the same round on one PON of 4096 ONUs (line rate 320 Gb/s): K2 at
# 4096 queues a row
SYNC_4096 = 6.750100000000589
SYNC_TOL = 1e-9

M_BITS = 26.416e6
N_ONUS = 128
# K2 rows: the widest held in shared memory (12 bytes a queue, padded to
# a power of two, in 227 KB) and one past it
K2_SMEM_QUEUES = 16_384
K2_PAST_SMEM = 20_000
FRACTIONS = (0.1, 0.4, 0.7, 1.0)
GRID = (("fcfs", 0.3), ("fcfs", 0.8), ("bs", 0.3), ("bs", 0.8))

# peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s; the
# non-tensor 32-bit rate, applied to the sampler's integer ops; the
# non-tensor float64 rate
HBM_BYTES_S = 3.35e12
OPS32_S = 67e12
FP64_S = 34e12
THREEFRY_OPS = 120        # 32-bit ALU ops of one threefry-2x32 draw
BF16_S = 989e12           # dense bf16 tensor-core rate
TF32_S = 495e12           # dense TF32 tensor-core rate (float32 operands)

# K4 parity grid (B, S, T, H, K, D, causal, window), as
# tests/test_torch_cuda.py; float32 within 2e-5 (summation order), bf16
# within 2e-2 (both outputs rounded to bf16)
K4_GRID = [
    (2, 256, 256, 4, 2, 64, True, None),
    (1, 128, 128, 8, 8, 32, True, None),
    (1, 333, 333, 4, 1, 64, True, None),
    (2, 256, 256, 4, 2, 64, True, 64),
    (1, 192, 192, 2, 2, 128, False, None),
    (1, 96, 96, 4, 4, 64, True, 8),
    (2, 40, 40, 4, 2, 16, True, 8),
    (1, 50, 70, 4, 2, 32, True, None),
    (1, 70, 50, 2, 1, 16, False, 24),
    (1, 300, 300, 10, 1, 256, True, 64),
    (2, 128, 128, 4, 1, 256, True, None),
    (1, 100, 100, 2, 2, 256, False, None),
    (1, 200, 200, 10, 1, 256, True, 8),
]
K4_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 shapes at the tensor-core kernel's tile edges (64 query rows, 64
# keys): one row, rows either side of a tile, T != S both ways, window 1,
# windows that cut inside a tile, MQA 10:1 at D 256. No row is left
# without a live key (S < T + window), where the kernel writes 0 and the
# plain version averages v
K4_TC_EDGES = [
    (1, 1, 1, 2, 1, 64, True, None),
    (2, 63, 63, 4, 2, 128, True, None),
    (1, 65, 65, 4, 4, 128, False, None),
    (1, 129, 129, 10, 1, 256, True, None),
    (1, 65, 100, 4, 2, 64, True, None),
    (1, 129, 70, 4, 2, 128, True, None),
    (2, 129, 129, 4, 2, 64, True, 1),
    (1, 63, 90, 2, 1, 64, False, 30),
    (1, 200, 200, 10, 1, 256, True, 37),
    (2, 300, 300, 10, 1, 256, True, 100),
]
OLMO_PREFILL = (4, 2048, 2048, 16, 16, 128)   # B, S, T, H, K, D
RG_PREFILL = (4, 2048, 2048, 10, 1, 256)      # recurrentgemma-2b, MQA
RG_WINDOW = 2048
RG_WINDOW_CUT = (4, 4096, 4096, 10, 1, 256)   # the window cuts here

# serve phase: olmo-1b, batch 4, 2048-token prompts, 32 greedy tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
SERVE_FORCED = 8          # teacher-forced decode steps held to the plain path
# kernel path vs plain attention, both in bf16 compute, on logits whose
# spread is about 1 (random weights, std-0.02 embeddings over d_model
# 2048). The plain path rounds the softmax weights to bf16 before the
# value product where the kernel keeps them in fp32, and each of the 16
# layers rounds to bf16 at other places in the two paths; the roundings
# compound through the residual stream. Measured on an NVIDIA H100 80GB
# HBM3 (700 W): the two paths 0.0703 apart, each 0.104 from the same
# weights run in float32 compute. So: the paths agree within LOGIT_TOL,
# and the kernel path is no farther from the float32 path than
# F32_RATIO times the plain path is (the kernel adds no error of its own).
LOGIT_TOL = 0.15
F32_RATIO = 1.5

# K5 grid (B, S, H, P, N, chunk): mamba2 widths whole and ragged, the
# smoke widths, widths off the kernel's tiles, S below one chunk, S = 64
# in one chunk of 64, five heads over the tensor-core kernels' groups of
# four. The step sizes rise across heads so that some heads keep their
# state over many chunks and others sum dt |a| past 88.7 in a chunk.
# Both versions compute in float32 from the same (upcast) inputs and
# differ only in summation order: within 1e-4 of the largest value, the
# reference package's own kernel test measure (tests/test_kernels.py).
# The bf16 shapes at head dim 64 run on both routes; on the tensor-core
# one the fp32 operands go as hi + lo bf16 pairs, held to the same K5_TOL
K5_GRID = [
    (2, 2048, 4, 64, 128, 128),
    (2, 2000, 4, 64, 128, 128),
    (2, 200, 3, 16, 16, 8),
    (1, 333, 2, 24, 48, 64),
    (1, 120, 3, 16, 32, 128),
    (1, 100, 4, 64, 128, 128),
    (1, 64, 2, 64, 64, 64),
    (1, 300, 5, 64, 128, 64),
]
K5_TOL = 1e-4
MAMBA_PREFILL = (4, 2048, 48, 64, 128, 128)   # B, S, H, P, N, chunk
# serve_mamba2 phase: mamba2-780m, batch 4, 2048-token prompts, 32 tokens.
# Logits spread ~0.78. bf16 rounding compounds through 48 random-weight
# SSD layers far more than through olmo's 16: on the CPU the JAX package
# and the port drift alike from their own float32 runs (0.05 at 2
# layers, 0.17 at 8, full width, 64 tokens), and on an NVIDIA H100 80GB
# HBM3 (700 W) the kernel and plain-scan paths were 0.576 apart in bf16
# compute, each 1.1-1.3 from the float32 path. So the bf16 paths agree
# within MAMBA_LOGIT_TOL, and the kernel path is no farther from the
# float32 path than MAMBA_F32_RATIO times the plain path is. Where the
# kernel's own error shows, in float32 compute, the kernel path and the
# plain scan were 0.000427 apart on the same card (float32 rounding
# through the same 48 layers): they must agree within MAMBA_F32_TOL,
# far below what a wrong scan gives (errors of the logits' own size)
MAMBA_LOGIT_TOL = 1.0
MAMBA_F32_RATIO = 1.5
MAMBA_F32_TOL = 5e-3

# K6 grid (B, S, R, a_lo, a_hi): ragged S and R, recurrentgemma's width,
# slow decay (long memory) and fast, one step, one channel; a drawn
# uniform in [a_lo, a_hi], b ~ 0.1 N(0, 1). Both versions compute in
# float32 from the same (upcast) inputs; the kernel fuses each multiply
# and add: within K6_TOL of the plain version's largest value
K6_GRID = [
    (1, 333, 200, 0.0, 1.0),
    (2, 300, 96, 0.2, 0.8),
    (4, 2048, 2560, 0.99, 0.9999),
    (4, 2048, 2560, 0.0, 0.05),
    (3, 17, 33, 0.0, 1.0),
    (1, 1, 5, 0.5, 0.5),
    (2, 9, 1, 0.9, 1.0),
    (1, 1037, 160, 0.99, 0.9999),
    (2, 2000, 2560, 0.99, 0.9999),
]
K6_TOL = 1e-5
RG_SCAN = (4, 2048, 2560)                     # B, S, R of the prefill
# serve_recurrentgemma phase: the same traffic as serve and serve_mamba2.
# Logits spread ~1.01. Set from the first reading on an NVIDIA H100 80GB
# HBM3 (700 W): in bf16 compute the kernel path (K6, K4) and the plain
# path (plain scan, plain attention) were 0.147 apart, each 0.166-0.171
# from the float32 path (bf16 rounding through 26 random-weight layers);
# in float32 compute the two paths were 2.8e-5 apart. So the bf16 paths
# agree within RG_LOGIT_TOL, the kernel path is no farther from the
# float32 path than RG_F32_RATIO times the plain path is, and in float32
# compute they agree within RG_F32_TOL, far below what a wrong scan or
# attention gives (errors of the logits' own size)
RG_LOGIT_TOL = 0.3
RG_F32_RATIO = 1.5
RG_F32_TOL = 5e-4

# serve_zoo phase: the seven other configs at their published widths,
# batch 4 x 2048-token prompts (after the frontend's tokens for pixtral
# and musicgen), ZOO_NEW greedy tokens, random weights from seed 0, as
# serve() draws them. Run in this order; if the phase runs over its
# time, configs come off the card from the end (llama3-8b, qwen3-14b,
# then pixtral-12b), and stay held on the CPU (tests/test_torch_zoo.py).
ZOO = ("musicgen-large", "gemma3-12b", "mixtral-8x22b", "arctic-480b",
       "pixtral-12b", "qwen3-14b", "llama3-8b")
ZOO_NEW = 16
# depth cuts (layers kept): arctic's bf16 layer is ~27 GB (128 experts of
# 3 x 7168 x 4864), mixtral's float32 layer ~10 GB (8 of 3 x 6144 x 16384)
ZOO_LAYERS = {"arctic-480b": 2, "mixtral-8x22b": 4}
# (b) the K4 prefill against the plain attention's, both in bf16 compute:
# the largest logit difference over the largest plain logit. On olmo-1b
# (16 layers) the two paths were 0.0703 apart on logits of spread ~1
# (serve, NVIDIA H100 80GB HBM3, 700 W), about 0.016 of the largest
# logit. The two paths round to bf16 at other places in every layer and
# the differences add through the residual stream; if they grew linearly
# with depth, 48 layers would give ~0.05. ZOO_LOGIT_RTOL is twice that.
# A wrong attention layer moves the logits by their own size (~1).
ZOO_LOGIT_RTOL = 0.1
# (e) arctic's decode logits with the int8 cache against the same decode
# with a bf16 cache: the same tokens fed and the same experts chosen (the
# bf16 run replays the int8 run's top-k, ``_TopK``). A cached element of
# a row with largest magnitude amax is off by at most amax/254 (half of
# the step amax/127). Relative to the row's RMS that is q = max amax/(254
# rms) over the cache's rows. Each of the L attention layers reads its k
# and v once per step: v's error enters its output directly, k's
# through the scores, each at most ~q of that layer's output; the
# residual stream adds them, and the MoE's experts (held fixed), the
# final norm and the head pass them on to first order. So the logits'
# RMS error over their RMS stays below ZOO_KV_FACTOR = 2 per layer times
# q (q ~ 0.014 for Gaussian rows of 1,024: amax ~ 3.5 rms), plus bf16's
# own rounding of the compared cache (2^-9), which the bound absorbs.
# The router's choice is discrete and has no such bound: where the int8
# rounding moves a near tie, a token takes another expert and its logits
# move by their own size. The same decode with the bf16 run's own
# choices is printed, with the count of choices that moved, not held.
ZOO_KV_FACTOR = 2

# train phase. train() at olmo-1b's full width (16 layers, d_model 2048,
# vocab 50304, float32 parameters, bf16 compute), one pod, batch 8 x 64
# tokens, AdamW under warmup_cosine(3e-3, 20, steps x rounds), the
# reference's defaults otherwise (bs, load 0.8, int8 payload bits). Each
# run: config_overrides, rounds, steps a round. (a) "full"; (d) "resume",
# 2 layers so that a checkpoint (params, mu, nu) stays under 3 GB
TRAIN_RUNS = {"full": (None, 2), "resume": ({"n_layers": 2}, 3)}
TRAIN_STEPS = {"full": 4, "resume": 2}
TRAIN_BATCH, TRAIN_SEQ = 8, 64
# (a) one more step at olmo-1b's published context, 2048 tokens, of the
# full run's state: (batch, seq) at olmo-1b's batch of 8 (it was cut to
# 4 for the plain attention's recompute, B H S^2 float32 scores a layer;
# with the backward from the log-sum-exp an NVIDIA H100 80GB HBM3
# (700 W) measured a peak of 42.0 GB at 8 x 2048, as at 4 x 2048;
# train (a) prints it beside the "pallas" route's)
TRAIN_LONG = (8, 2048)
# each round's sync (s) of those runs' timelines on the JAX package's
# engine; tests/test_torch_train.py::test_chip_smoke_train_sync_pins
# recomputes them
TRAIN_SYNC_PINS = {"full": (8.665100000000637, 8.665100000000637),
                   "resume": (4.580099999999864, 4.580099999999864,
                              4.580099999999864)}
# K4 launches a step under remat="full" (olmo-1b's default) at
# grad_accum 1, through attn_impl="chunked" (FlashAttentionLSE): each of
# the 16 layers' forward with its log-sum-exp, then its recompute in the
# backward; and the backward from the log-sum-exp once a layer (its
# operator's count in a trace), three launches a call (delta, dK/dV, dQ)
TRAIN_K4_A_STEP = 32
TRAIN_K4_BWD_A_STEP = 16
K4_BWD_LAUNCHES_A_CALL = 3
TRAIN_K4_BWD_LAUNCHES_A_STEP = TRAIN_K4_BWD_A_STEP * K4_BWD_LAUNCHES_A_CALL
# (b) one AdamW step (lr 3e-3) of one full-width state on one batch, with
# K4 in bf16, the plain attention in bf16 and in float32 compute: the
# kernel run's distance from the float32 run (the loss; the gradient norm
# relative; the parameter change in relative L2 over every parameter) at
# most TRAIN_F32_RATIO times the plain run's plus a floor. Set from the
# first reading on an NVIDIA H100 80GB HBM3 (700 W): loss 11.2789 with
# the kernel 4.1e-5 and the plain path 1.55e-4 from float32; grad norm
# 12.02, 1.57e-4 and 6.5e-5 relative; the change 0.1587 and 0.1591 (a
# first Adam step is about lr times a gradient's sign, so a gradient
# near 0 that flips sign in bf16 moves its parameter by ~2 lr). The
# floors sit 1.3-5x above those readings
TRAIN_F32_RATIO = 1.5
TRAIN_LOSS_FLOOR = 2e-4
TRAIN_GNORM_FLOOR = 2e-4
TRAIN_DELTA_FLOOR = 1e-2
# (c) the backwards at PERF.md's serving shapes, S cut to 512: the K4
# Function at olmo-1b's (B, S, T, H, K, D) and recurrentgemma-2b's
# (window 2048), K5's at mamba2-780m's (B, S, H, P, N, chunk), K6's at
# recurrentgemma-2b's (B, S, R); each autograd Function's input
# gradients must equal autograd of the plain version on the same inputs
# bit for bit: the backward recomputes the same operations
TRAIN_BWD_S = 512
# (c) the backward from the log-sum-exp (csrc/flash_attn_bwd.cu) at the
# two S-512 shapes and the long step's: K4's lse within XLA_LSE_TOL of
# the plain version's (float32 results of the same bf16 inputs, summed in
# another order, K4's tensor-core route in base 2); dq, dk, dv within
# XLA_BWD_RTOL of the largest magnitude of flash_attention_bwd_ref's on
# the same (q, k, v, out, lse, g): both compute in float32 from the same
# bf16 inputs and round each result to bf16 once (one ulp, 2^-8 of a
# value); XLA_REPEATS calls the same bits
XLA_LSE_TOL = 2e-5
XLA_BWD_RTOL = 2.0 ** -7
XLA_REPEATS = 10

# fed_train phase. train()'s federated branch at olmo-1b's published
# width (d_model 2048, 16 heads of 128, d_ff 8192, vocab 50304), float32
# parameters, bf16 compute, FED_PODS pods on the card (train() sees that
# many devices through its device_count seam; the reference would give
# each pod its own), batch 8 x 64 (4 a pod), AdamW under warmup_cosine,
# BS at load 0.8, int8 rounds. Cut to FED_LAYERS of 16 layers: two pods'
# (params, mu, nu) take ~28 GB at 16 layers and the async state
# (global, refs, pending) as much again, past the card's 80 GB with a
# step's new state beside them. At 4 layers (~0.37 B parameters a pod)
# an NVIDIA H100 80GB HBM3 (700 W) measured a peak of 44.2 GB in (a)
# and (b) and 49.3 GB in (c); the deepest depth that fits was not
# measured. Each run: config_overrides, rounds, train()'s arguments;
# FED_STEPS steps a round. (a) "fed": int8 FedAvg rounds; (b)
# "fed_async": the coupled FedBuff rounds (a 2 s deadline, defer, fault
# seed 3 with dropout 0.4, loss 0.2, outage 0.5, quorum 0.5:
# tests/test_faults.py's resume shape); (d) "fed_resume": the same at 1
# layer of the published width, 1 step a round: a checkpoint holds both
# pods' train and async states (8.2 GB), four are written and one read,
# which makes (d) the phase's longest part (87 s on that card)
FED_PODS = 2
FED_LAYERS = 4
FED_COUPLED = {"deadline_s": 2.0, "deadline_policy": "defer",
               "dropout_rate": 0.4, "loss_rate": 0.2, "outage_rate": 0.5,
               "fault_seed": 3, "quorum": 0.5}
FED_RUNS = {"fed": ({"n_layers": FED_LAYERS}, 2, {}),
            "fed_async": ({"n_layers": FED_LAYERS}, 3, FED_COUPLED),
            "fed_resume": ({"n_layers": 1}, 3, FED_COUPLED)}
FED_STEPS = {"fed": 4, "fed_async": 2, "fed_resume": 1}
# each round's sync (s) of those runs' timelines on the JAX package's
# engine; tests/test_torch_train.py::test_chip_smoke_fed_sync_pins
# recomputes them
FED_SYNC_PINS = {"fed": (5.164100000000059, 5.164100000000059),
                 "fed_async": (4.0, 3.6950999999997043, 0.3241000000000002),
                 "fed_resume": (4.0, 2.8200999999998007, 0.1491000000000001)}

# mesh phase: olmo-1b at its published width and depth, one pod, batch
# TRAIN_BATCH x TRAIN_SEQ, train()'s defaults (AdamW, warmup_cosine(3e-3,
# 20, MESH_STEPS)), MESH_STEPS steps
MESH_STEPS = 2

# K3/K3' grid (shape, block): tests/test_kernels.py's shapes x {64, 256,
# 4096}, ragged tails, block >= n, blocks past one CTA's 4096-element tile;
# each in float32 and bfloat16, as drawn, with half its elements zero
# (all-zero blocks) and on exact .5 ties. Then every CNN leaf at block = n
# and the whole update at block 4096. q, scales and the dequantised values
# must equal the plain versions' bit for bit
K3_GRID = ([(s, b) for s in [(100,), (1000, 37), (5, 5, 5)]
            for b in (64, 256, 4096)]
           + [((4097,), 4096), ((300,), 4096), ((1,), 4096),
              ((3 * 8193 + 5,), 8193), ((100_000,), 100_000)])
K3_BLOCK = 4096
# K3 at block = n past the card's on-chip capacity (132 SMs x 231,424
# bytes on an H100: 7.6 M float32 or 15.3 M bfloat16 elements), where
# each CTA reads the rest of its share a second time
K3_PAST_CAPACITY = ((10_000_000, torch.float32), (20_000_003, torch.float32),
                    (20_000_003, torch.bfloat16))
UPDATE_N = 6_603_710            # the CNN's parameters at width 1
INT8_BITS = 52_829_936          # 8 bits an element and 32 a leaf's scale
NONE_BITS = 211_318_720         # 32 bits an element
# fl_fig2a phase: benchmarks/fig2a_accuracy.py's settings
FL_CLIENTS, FL_SAMPLES, FL_ROUNDS, FL_TEST = 16, 64, 10, 512
FL_FRACTIONS = (0.25, 0.5, 1.0)
FL_LR, FL_BATCH, FL_EPOCHS = 0.04, 16, 2
# K3/K3' are timed on one input, warm in L2, and over COLD_COPIES copies
# of it in turn (8 x 26 MB, past the card's 50 MB L2), read from HBM
COLD_COPIES = 8
# one batch's CNN loss and gradients on the card against the port's CPU
# run, both in full float32 (TF32 off), each leaf's gradient relative to
# its largest value (the loss relative to itself). Measured on an NVIDIA
# H100 80GB HBM3 (700 W) by scripts/check_cnn_grads.py: the loss within
# 1.2e-7 and every leaf within 7.6e-7 but conv1's weight gradient, 2.2e-4
# to 3.9e-4 off the CPU's over runs and as far off a float64 run (3.4e-4
# with cudnn.deterministic): cuDNN's weight-gradient kernel sums each tap
# over the batch's 12,544 positions of one input channel in long float32
# chains; with cuDNN off it is 4.9e-7. So conv1's weight is held to
# CNN_WGRAD_TOL and the loss and every other leaf to CNN_CARD_TOL, which
# TF32 (about three decimal digits) must fail: the phase runs the batch
# with TF32 on too and fails if that run passes the gate
CNN_CARD_TOL = 1e-5
CNN_WGRAD_TOL = 1e-3
CNN_WGRAD_LEAF = 1              # conv1/w in tree order (conv1/b first)
# Fig. 2a accuracy gates, set from the first reading on an NVIDIA H100
# 80GB HBM3 (700 W): final accuracies (round 10) int8 0.9766 / 0.9531 /
# 0.9688 and none 0.9727 / 0.9570 / 0.9688 at fractions 0.25 / 0.5 / 1.0;
# the JAX package's own benchmarks/fig2a_accuracy.py (uncompressed, its
# own init, on the CPU) ends at FIG2A_JAX_FINAL. The curves swing by up
# to 0.03 between late rounds (0.9609 -> 0.9297 at fraction 0.5). So:
# every final accuracy at least FL_ACC_MIN and within FL_REF_GAP of the
# JAX package's, and int8 within FL_INT8_GAP of none (measured 0.0039)
FIG2A_JAX_FINAL = {0.25: 0.957, 0.5: 0.961, 1.0: 0.977}
FL_ACC_MIN = 0.9
FL_REF_GAP = 0.05
FL_INT8_GAP = 0.05


def _line(phase: str, seconds: float, **kw) -> None:
    extra = " ".join(f"{k}={v}" for k, v in kw.items())
    print(f"[{phase}] {seconds:.3f}s {extra}".rstrip(), flush=True)


def _clients(n: int, n_onus: int, seed: int = 42):
    from repro_torch.core.slicing import ClientProfile

    t_uds = np.random.default_rng(seed).uniform(1.0, 5.0, n_onus)
    return [ClientProfile(client_id=i, t_ud=float(t_uds[i]), t_dl=0.0,
                          m_ud_bits=M_BITS) for i in range(n)]


def fig2b_cases(seed: int = 1):
    """The Fig. 2b grid in ``SYNC_TABLE`` order, as port types."""
    from repro_torch.net import FLRoundWorkload, SweepCase

    names, cases = [], []
    for policy, load in GRID:
        for frac in FRACTIONS:
            n = max(1, int(frac * N_ONUS))
            wl = FLRoundWorkload(clients=_clients(n, N_ONUS),
                                 model_bits=M_BITS)
            names.append(f"{policy}_load{load}_n{n}")
            cases.append(SweepCase(workload=wl, load=load, policy=policy,
                                   seed=seed))
    return names, cases


def full_width_spec(n: int = 2048):
    """One FCFS load-0.8 round at ``n`` ONUs, every ONU a client."""
    from repro_torch.net import (
        FLRoundWorkload,
        PONConfig,
        SweepCase,
        SweepSpec,
    )

    cfg = PONConfig(n_onus=n, line_rate_bps=10e9 * n / 128)
    wl = FLRoundWorkload(clients=_clients(n, n), model_bits=M_BITS)
    return SweepSpec(cases=(SweepCase(workload=wl, load=0.8,
                                      policy="fcfs", seed=0),), pon=cfg)


def _device_ms(fn, args, reps: int = 16) -> float:
    """Device milliseconds a call of ``fn``: ``reps`` calls, the i-th on
    ``args[i % len(args)]``, enqueued behind a ~25 ms sleep kernel,
    between CUDA events recorded after the sleep, so that the card runs
    them back to back and the host's enqueue (tens of microseconds a
    call through the wrapper) stays out of the window; the median of 3
    windows. Every kernel, its plain version and its library call are
    timed so: CUDA events around one launch would time the host's
    enqueue for a kernel shorter than it."""
    fn(*args[0])
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(*args[i % len(args)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_lint():
    """The port's static analysis: its self-test, then its rules over the
    tree this script runs from (``src/repro_torch`` and this file)
    against ``analysis-baseline-torch.json``. A finding or a stale
    baseline entry fails the run."""
    from repro_torch.analysis.baseline import apply_baseline, load_baseline
    from repro_torch.analysis.core import load_modules, run_checkers
    from repro_torch.analysis.selftest import run_self_test

    t0 = time.time()
    if run_self_test(verbose=False):
        raise SystemExit("the port's static analysis fails its self-test")
    modules = load_modules([os.path.join(ROOT, "src", "repro_torch"),
                            os.path.join(ROOT, "chip_smoke.py")])
    entries = load_baseline(os.path.join(ROOT,
                                         "analysis-baseline-torch.json"))
    new, baselined, stale = apply_baseline(run_checkers(modules), entries)
    for f in new:
        print(f"  {f.location()}: {f.code} [{f.symbol}] {f.message}")
    for e in stale:
        print(f"  stale baseline entry {e.code} {e.path} [{e.symbol}]")
    _line("lint", time.time() - t0, files=len(modules), findings=len(new),
          baselined=len(baselined), stale=len(stale))
    if new or stale:
        raise SystemExit(f"the port's static analysis: {len(new)} "
                         f"finding(s), {len(stale)} stale baseline "
                         f"entr{'y' if len(stale) == 1 else 'ies'}")


def phase_build():
    from repro_torch import _cuda

    t0 = time.time()
    lib = _cuda.build()
    _cuda.library()
    log = lib.with_suffix(".log").read_text()
    for row in log.splitlines():
        spills = "spill" in row and "0 bytes spill stores, 0 bytes " \
            "spill loads" not in row
        if ("registers" in row or "==" in row or "error" in row.lower()
                or spills):
            print("  " + row.strip())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    _line("build", time.time() - t0, torch=torch.__version__,
          cuda=torch.version.cuda, lib=lib.name)
    return smi.splitlines()[0]


def _k1_inputs(keys, lam, dev):
    from repro_torch.kernels.traffic import ops, ref

    keys = np.atleast_2d(np.asarray(keys, np.uint32))
    lam = np.ascontiguousarray(np.broadcast_to(
        np.asarray(lam, np.float32), (keys.shape[0],)))
    n_draws = ops._tail_bound(float(lam.max()) * ref.WINDOW)
    thr = ref.poisson_thresholds(lam.astype(np.float64) * ref.WINDOW,
                                 n_draws)
    starts, lengths = ops._table(1.0 / 16.0, dev)
    return (torch.as_tensor(keys.astype(np.int64), device=dev),
            torch.as_tensor(thr, device=dev), starts, lengths)


def _engine_streams(n_onus: int, cases, cfg):
    """(keys, lams) of the FCFS upload rows the engine samples."""
    from repro_torch.kernels.traffic.ops import make_stream_key
    from repro_torch.net import MultiPonTopology, burst_lambda, pon_bg_rates

    topo = MultiPonTopology()
    keys, lams = [], []
    for c in cases:
        if c.policy != "fcfs":
            continue
        rate = pon_bg_rates(c.workload.clients, c.workload.model_bits,
                            c.load, cfg, topo)[0]
        keys.append(make_stream_key(c.seed, 1, 0, 0))
        lams.append(burst_lambda(rate, cfg.cycle_time_s))
    return np.stack(keys), np.asarray(lams, np.float32)


def _k1_timed(kernel, ref, kt, thr, st, ln, n_cycles: int, n_onus: int,
              pkt: float) -> dict:
    """K1 at one shape from cycle 0: its device ms, its plain version's,
    its bound (the output written once and the keys and tables read
    once over HBM_BYTES_S; a threefry a cell and a live burst over
    OPS32_S) and the device operations a call (torch.profiler over 3
    calls; None if the profiler saw no device time)."""
    args = (kt, 0, thr, st, ln, pkt)
    kw = dict(n_cycles=n_cycles, n_onus=n_onus)

    def call():
        return kernel.sample_arrival_bits_cuda(*args, **kw)

    ms = _device_ms(call, [()])
    plain_ms = _device_ms(lambda: ref.sample_arrival_bits_ref(*args, **kw),
                          [()], reps=4)
    dev_ms, events = _profiled_device_ms(
        lambda: [call() for _ in range(3)], top=8)
    cells = kt.shape[0] * ref._windows(0, n_cycles)[1] * n_onus
    bursts = int(ref.window_counts(kt, 0, n_cycles, n_onus, thr).sum())
    n_bytes = (kt.numel() * 8 + thr.numel() * 4 + st.numel() * 8
               + kt.shape[0] * n_cycles * n_onus * 8)
    n_ops = THREEFRY_OPS * (cells + bursts)
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(n_bytes / HBM_BYTES_S, n_ops / OPS32_S) * 1e3,
            "bound_by": ("bytes" if n_bytes / HBM_BYTES_S >= n_ops / OPS32_S
                         else "operations"),
            "device_ops": (None if dev_ms is None
                           else sum(n for _, n, _ in events) / 3)}


def phase_k1():
    from repro_torch.kernels.traffic import kernel, ref
    from repro_torch.kernels.traffic.ops import make_stream_key
    from repro_torch.net import PONConfig

    t0 = time.time()
    dev = torch.device("cuda")
    pkt = 12_000.0
    checks = []           # (keys, cycle0, n_cycles, n_onus, lam)
    key = make_stream_key(5, 0, 1)
    for c0, nc, no in [(0, 64, 8), (5, 64, 21), (77, 130, 2),
                       (1000, 200, 37), (63, 65, 1)]:
        checks.append((key, c0, nc, no, 0.6))
    _, cases = fig2b_cases()
    k8, l8 = _engine_streams(N_ONUS, cases, PONConfig(n_onus=N_ONUS))
    checks.append((k8, 0, 1024, N_ONUS, l8))
    checks.append((k8, 5120, 1024, N_ONUS, l8))
    spec = full_width_spec()
    k1, l1 = _engine_streams(2048, spec.cases, spec.pon)
    checks.append((k1, 0, 1024, 2048, l1))
    # the tiling's edges: n_cycles under a window at 1, 129 and 2048
    # ONUs; lo > 0 across three windows; a row at rate 0 beside rows
    # whose draw budget runs to the hundreds (n_draws 543); an even row
    # cut into odd spans (74 ONUs at 4096 cycles); thresholds past 48 KB
    # of shared memory (n_draws 12,816: the kernel opts in to more)
    mixed = np.stack([make_stream_key(s, 1, 0) for s in range(3)])
    checks += [(key, 0, 50, 1, 0.6), (key, 3, 50, 129, 0.6),
               (key, 7, 40, 2048, 0.6), (key, 100, 150, 37, 0.6),
               (k8, 36, 150, N_ONUS + 1, l8),
               (mixed, 0, 256, N_ONUS + 1, (0.0, 5.0, 3.0)),
               (k8, 0, 4096, 74, l8),
               (mixed[:2], 5, 70, 3, (0.0, 180.0))]
    err = 0.0
    for keys, c0, nc, no, lam in checks:
        kt, thr, st, ln = _k1_inputs(keys, lam, dev)
        got = kernel.sample_arrival_bits_cuda(
            kt, c0, thr, st, ln, pkt, n_cycles=nc, n_onus=no)
        want = ref.sample_arrival_bits_ref(
            kt, c0, thr, st, ln, pkt, n_cycles=nc, n_onus=no)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"K1 differs from its plain version at "
                             f"cycle0={c0} n_cycles={nc} n_onus={no}")
        err = max(err, float((got - want).abs().max()))
    for pon, total in ((0, 209_160_000.0), (1, 193_656_000.0)):
        kt, thr, st, ln = _k1_inputs(make_stream_key(3, 1, 2, pon), 0.5,
                                     dev)
        got = kernel.sample_arrival_bits_cuda(
            kt, 128, thr, st, ln, pkt, n_cycles=256, n_onus=8)
        if float(got.sum()) != total:
            raise SystemExit(f"K1 stream fingerprint pon={pon}: "
                             f"{float(got.sum())} != {total}")

    # timed at the main path's chunk shape (8 rows x 1024 cycles x 128)
    # and at the 2048-ONU round's (1 row x 1024 x 2048)
    main = _k1_timed(kernel, ref, *_k1_inputs(k8, l8, dev), 1024, N_ONUS,
                     pkt)
    wide = _k1_timed(kernel, ref, *_k1_inputs(k1, l1, dev), 1024, 2048,
                     pkt)
    for t in (main, wide):
        if t["device_ops"] not in (None, 1):
            raise SystemExit(f"K1: {t['device_ops']} device operations "
                             "a call, not 1")
    _line("k1", time.time() - t0, checks=len(checks) + 2,
          bitwise="yes", ms=f"{main['ms']:.4f}",
          plain_ms=f"{main['plain_ms']:.4f}",
          bound_ms=f"{main['bound_ms']:.5f}",
          wide_ms=f"{wide['ms']:.4f}", wide_bound_ms=f"{wide['bound_ms']:.5f}",
          device_ops_a_call=("not measured" if main["device_ops"] is None
                             else f"{main['device_ops']:g}"))
    return {
        "name": "traffic_sampler", "route": "cuda",
        "source": "src/repro_torch/csrc/traffic.cu",
        "replaces": "src/repro/kernels/traffic/kernel.py:164",
        "max_abs_err": err, "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "device_ops_a_call": main["device_ops"],
        "wide_ms": wide["ms"], "wide_plain_ms": wide["plain_ms"],
        "wide_bound_ms": wide["bound_ms"],
    }


def k2_case(rng, R: int, N: int, int_keys: bool):
    """Random waterfill rows: ties, empty queues (inf keys), zero
    backlogs, rows on both sides of ``cap - 1``."""
    from repro_torch.net.engine import _IKEY_INF

    backlog = rng.integers(0, 50, (R, N)) * 12_000.0
    backlog[:, ::3] += rng.uniform(0, 1e4, (R, (N + 2) // 3))
    backlog[rng.random((R, N)) < 0.3] = 0.0
    if int_keys:
        key = rng.integers(0, max(2, N // 4), (R, N)).astype(np.int64)
        key = np.where(backlog > 0, key, _IKEY_INF)
    else:
        key = np.round(rng.uniform(0, 1, (R, N)), 1)
        key = np.where(backlog > 0, key, np.inf)
    total = backlog.sum(axis=1)
    frac = rng.uniform(0.2, 0.9, R)
    cap = np.where(np.arange(R) % 2 == 0, total * frac,
                   total + 1.0 + rng.uniform(0, 1e3, R))
    cap[1 % R] = total[1 % R] + 1.0    # exactly at cap - 1: not hard
    return backlog, key, cap


def phase_k2():
    from repro_torch.kernels.ponsim import kernel, ops, ref

    t0 = time.time()
    rng = np.random.default_rng(11)
    err = 0.0
    n_checks = 0
    # the engine's rows (128, 2048 and 4096 ONUs a PON), up to the card's
    # shared memory (16,384) and past it (the wrapper's global scratch)
    for R, N in ((8, 1), (8, 37), (8, 128), (8, 2048), (2, 4096),
                 (2, K2_SMEM_QUEUES), (2, K2_PAST_SMEM)):
        for int_keys in (False, True):
            b, k, c = (torch.as_tensor(a)
                       for a in k2_case(rng, R, N, int_keys))
            # one hard mask for both: the row sums of the card and the CPU
            # may round apart on the row that sits at cap - 1
            hard = ref.hard_rows(b, c)
            got = ops.waterfill_grants(b, k, c, hard.cuda(),
                                       device="cuda").cpu()
            want = ref.waterfill_grants_ref(b, k, c, hard)
            if not torch.equal(got, want):
                raise SystemExit(f"K2 differs from its plain version at "
                                 f"N={N} int_keys={int_keys}")
            err = max(err, float((got - want).abs().max()))
            n_checks += 1

    def timed(R, N):
        b, k, c = (torch.as_tensor(a, device="cuda")
                   for a in k2_case(rng, R, N, False))
        c = b.sum(dim=1) * 0.5           # every row hard
        hard = ref.hard_rows(b, c)
        args = [(b, k, c, hard)]
        ms = _device_ms(kernel.waterfill_grants_cuda, args)
        plain = _device_ms(ref.waterfill_grants_ref, args, reps=8)
        n_bytes = 3 * b.numel() * 8 + R * 9
        n_ops = R * (N * max(1, math.ceil(math.log2(N))) + 3 * N)
        bound = max(n_bytes / HBM_BYTES_S, n_ops / FP64_S) * 1e3
        by = "bytes" if n_bytes / HBM_BYTES_S >= n_ops / FP64_S \
            else "operations"
        return ms, plain, bound, by

    ms, plain_ms, bound, by = timed(8, N_ONUS)
    wide = {}
    for N in (2048, 4096, K2_PAST_SMEM):
        ms_w, plain_w, bound_w, _ = timed(1, N)
        wide.update({f"ms_1x{N}": f"{ms_w:.5f}",
                     f"plain_ms_1x{N}": f"{plain_w:.5f}",
                     f"bound_ms_1x{N}": f"{bound_w:.6f}"})
    _line("k2", time.time() - t0, checks=n_checks, bitwise="yes",
          ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          bound_ms=f"{bound:.6f}", **wide)
    return {
        "name": "waterfill_grants", "route": "cuda",
        "source": "src/repro_torch/csrc/waterfill.cu",
        "replaces": "src/repro/kernels/ponsim/kernel.py:86",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        **{key: float(val) for key, val in wide.items()},
    }


def _record_phases(spec, device):
    """Run ``spec`` through the engine on ``device`` and return each
    ``run_phase_device`` call it made, as ``(args, kwargs)`` without the
    device."""
    from repro_torch.net import engine, simulate

    calls = []
    run = engine.run_phase_device

    def record(*args, **kwargs):
        calls.append((args, {k: v for k, v in kwargs.items()
                             if k != "device"}))
        return run(*args, **kwargs)

    engine.run_phase_device = record
    try:
        simulate(spec, device=device)
    finally:
        engine.run_phase_device = run
    return calls


def _short_workload(ids, seed: int):
    from repro_torch.core.slicing import ClientProfile
    from repro_torch.net import FLRoundWorkload

    rng = np.random.default_rng(seed)
    return FLRoundWorkload(clients=[ClientProfile(
        client_id=int(i), t_ud=float(rng.uniform(0.05, 0.5)), t_dl=0.0,
        m_ud_bits=float(rng.uniform(1e5, 2e6))) for i in ids],
        model_bits=1.5e6)


def phase_check_sweeps():
    """Short sweeps at 128 ONUs (1 Gb/s, every client ready within 0.5 s)
    whose phases cover what the phase kernel compiles (``PHASE_COVER``)."""
    from repro_torch.net import MultiPonTopology, PONConfig, SweepCase, \
        SweepSpec

    cfg = PONConfig(n_onus=N_ONUS, line_rate_bps=1e9)
    one = _short_workload(range(0, N_ONUS, 8), 1)    # one client an ONU
    # ONUs 0-3 hold three clients, 4-7 two
    multi = _short_workload([*range(16), *range(128, 136),
                             *range(256, 260)], 2)
    topo = MultiPonTopology(n_pons=3, cps_rate_bps=1.5e9)
    spread = _short_workload([0, 130, 260, 5, 300, 140], 3)
    outage = np.array([[0.1, 0.4], [0.0, 0.0], [0.2, 0.5]])
    return {
        "fast_bs": SweepSpec(cases=(
            SweepCase(workload=one, load=0.3, policy="fcfs", seed=1),
            SweepCase(workload=one, load=0.9, policy="fcfs", seed=2),
            SweepCase(workload=one, load=0.5, policy="bs", seed=3)),
            pon=cfg, backend="jit"),
        "multi": SweepSpec(cases=(
            SweepCase(workload=multi, load=0.6, policy="fcfs", seed=4),),
            pon=cfg, backend="jit"),
        "cps_masks": SweepSpec(cases=(
            SweepCase(workload=spread, load=0.3, policy="fcfs", seed=5,
                      topology=topo),
            SweepCase(workload=spread, load=0.3, policy="bs", seed=5,
                      topology=topo)),
            pon=cfg, ul_deadline_s=[1.2, 1.2], ul_outage_s=[outage, outage],
            backend="jit"),
        "overload": SweepSpec(cases=(
            SweepCase(workload=one, load=0.8, policy="fcfs", seed=3),),
            pon=cfg, ul_deadline_s=[1.5], ul_outage_s=[(0.2, 0.6)],
            backend="jit"),
    }


# what the kernel-vs-plain phases must have covered between them
PHASE_COVER = {
    "scalar-S with background": lambda s, x: s.fast and s.has_bg,
    "several clients an ONU": lambda s, x: not s.single,
    "bs slots": lambda s, x: s.mode == "bs",
    "CPS, deadline and outage": lambda s, x: (s.has_cps and s.has_deadline
                                              and s.has_outage),
    "an inexact ring walk": lambda s, x: not x,
}
PHASE_RTOL = 1e-9     # rem against the plain version (done_t bit for bit)


def wide_check_sweeps():
    """Short sweeps past the widths the phase kernel once refused (ROADMAP
    F4): 33 PONs of 4 ONUs and 100 PONs of 8 (CPS binding, fcfs and bs);
    ONU 0 of 2 PONs holding 33 clients under CPS (fcfs); 2 PONs of 6
    clients each under CPS (bs; :func:`wide_phases` gives its ONUs 3
    slots each); one PON of 16,385 ONUs at 1 Gb/s and load 0.5 (bursts
    of 192 kbit against 1 Mbit a cycle make the row hard on many cycles;
    rows past 16,384 queues: the sort's pairs in global scratch)."""
    from repro_torch.net import MultiPonTopology, PONConfig, SweepCase, \
        SweepSpec

    def cases(ids, topo, load=0.3, policies=("fcfs", "bs")):
        return tuple(SweepCase(workload=_short_workload(ids, 6), load=load,
                               policy=policy, seed=6, topology=topo)
                     for policy in policies)

    g4 = PONConfig(n_onus=4, line_rate_bps=1e9)
    g8 = PONConfig(n_onus=8, line_rate_bps=1e9)
    wide = PONConfig(n_onus=WIDE_ROW, line_rate_bps=1e9)
    two = MultiPonTopology(n_pons=2, cps_rate_bps=1.2e9)
    return {
        "pons33": SweepSpec(cases=cases(
            [0, 5, 9, 30, 61, 77, 100, 131],
            MultiPonTopology(n_pons=33, cps_rate_bps=10.5e9)), pon=g4,
            backend="jit"),
        "pons100": SweepSpec(cases=cases(
            [0, 9, 130, 257, 400, 555, 642, 799],
            MultiPonTopology(n_pons=100, cps_rate_bps=31e9)), pon=g8,
            backend="jit"),
        # ids = 0 mod 16 land on PON 0's ONU 0
        "clients33": SweepSpec(cases=cases(
            [*range(0, 33 * 16, 16), 9, 11, 14], two, policies=("fcfs",)),
            pon=g8, backend="jit"),
        "slots_cps": SweepSpec(cases=cases(
            [0, 1, 2, 3, 5, 6, 8, 10, 11, 12, 13, 15], two,
            policies=("bs",)), pon=g8, backend="jit"),
        "row16385": SweepSpec(cases=cases(
            [0, 1000, 5000, 9000, 16384], None, load=0.5,
            policies=("fcfs",)), pon=wide, backend="jit"),
    }


def _pile_slots(slot_arrays, copies: int = 3):
    """The slot arrays with every slot repeated ``copies`` times, each
    copy after the last in slot order: each ONU holds ``copies`` slots
    (the engine's bs policy gives an ONU one client and one slot; the
    phase program takes any slot arrays)."""
    ts, te, sonu, srate, svalid = slot_arrays
    return (np.tile(ts, copies), np.tile(te, copies), np.tile(sonu, copies),
            srate, np.tile(svalid, copies))


def wide_phases(device):
    """``(name, args, kwargs)`` of every phase of
    :func:`wide_check_sweeps`, recorded on ``device``; the bs phases of
    ``slots_cps`` with their slots piled 3 to an ONU."""
    out = []
    for name, spec in wide_check_sweeps().items():
        for args, kwargs in _record_phases(spec, device):
            if name == "slots_cps" and args[4] == "bs":
                kwargs = dict(kwargs,
                              slot_arrays=_pile_slots(kwargs["slot_arrays"]))
            out.append((name, args, kwargs))
    return out


WIDE_ROW = 16_385


def _slots_an_onu(dyn) -> int:
    """The most valid slots one ONU of a row holds (bs phases)."""
    ostart = dyn["ostart"]
    return int((ostart[:, 1:] - ostart[:, :-1]).max())


# what the wide phases must have covered between them
WIDE_COVER = {
    "33 PONs a case": lambda s, d: s.P == 33,
    "100 PONs a case": lambda s, d: s.P == 100,
    "33 clients an ONU": lambda s, d: s.max_slots == 33,
    "several slots an ONU under CPS (bs)": lambda s, d: (
        s.mode == "bs" and s.has_cps and _slots_an_onu(d) > 1),
    "a row of 16,385 queues": lambda s, d: s.N == WIDE_ROW and s.has_bg,
}


def _phase_bound(spec, dyn, k_stop) -> tuple:
    """``(bytes, float64 adds, threefry draws)`` of one phase: its inputs
    read once and its outputs (``done_t``, ``rem``, the exact flags)
    written once; a background row's arrivals added into its prefix, its
    backlog formed and summed (3 N a cycle), a general FL row's per-ONU
    backlog and its sum (U + N), a bs row's slot prefix (S), over the
    cycles each case ran; the window draws and burst draws of those
    cycles."""
    from repro_torch.kernels.traffic.ref import WINDOW, window_counts

    n_bytes = sum(t.numel() * t.element_size() for t in dyn.values())
    n_bytes += spec.R * spec.U * 8 * 2 + len(k_stop)
    per_row = 0
    if spec.has_bg:
        per_row += 3 * spec.N
    if not spec.fast:
        per_row += spec.U + spec.N
    if spec.mode == "bs":
        per_row += spec.S
    adds = per_row * spec.P * int(k_stop.sum())
    draws = 0
    if spec.has_bg:
        # a row samples a window at each of its case's cycles k % 64 == 0
        n_win = torch.as_tensor(-(-np.repeat(k_stop, spec.P) // WINDOW))
        counts = window_counts(dyn["keys"].cpu(), 0, int(k_stop.max()),
                               spec.N, dyn["thr"].cpu())
        live = torch.arange(counts.shape[1])[None, :] < n_win[:, None]
        draws = int(n_win.sum()) * spec.N + int(counts[live].sum())
    return n_bytes, adds, draws


def _check_phase(what: str, mode: str, got, want) -> float:
    """The kernel's ``(done_t, rem, exact)`` against the plain version's:
    ``done_t`` bit for bit, ``rem`` within ``PHASE_RTOL``, the same exact
    flag, or the smoke fails. Returns the largest ``rem`` error."""
    (got_t, got_r, got_x), (want_t, want_r, want_x) = got, want
    got_t, got_r = got_t.cpu(), got_r.cpu()
    if (got_x != want_x
            or not np.array_equal(got_t.numpy(), want_t.numpy(),
                                  equal_nan=True)
            or not torch.allclose(got_r, want_r, rtol=PHASE_RTOL,
                                  atol=0.0)):
        raise SystemExit(f"phase kernel differs from its plain version on "
                         f"{what} {mode} (exact {got_x} vs {want_x})")
    return float((got_r - want_r).abs().max())


def _plain_phase(spec, tens, threads: int = 1, card_draws: bool = False):
    """``run_phase_ref`` in a worker process, on ``threads`` threads.

    With ``card_draws`` the plain version's arrival windows
    (``ref.sample_window_ref``) are drawn by the same plain code on the
    card and copied back; every other step stays on the CPU copies. A
    window is threefry draws, integer packet counts and one float32
    product each, exact on any device, so ``done_t`` is the same to the
    bit; at 100 PONs x 1,024 ONUs the draws are about two thirds of the
    plain version's CPU time."""
    from repro_torch.kernels.ponsim import ref

    torch.set_num_threads(threads)
    if card_draws:
        sample = ref.sample_window_ref

        def on_card(keys, thresholds, win, **kwargs):
            return sample(keys.cuda(), thresholds.cuda(), win,
                          **kwargs).cpu()

        ref.sample_window_ref = on_card
    return ref.run_phase_ref(spec, tens)


class _PhaseHolds:
    """Recorded phases held to the plain version in the background:
    :meth:`add` runs each through the phase kernel here at once and hands
    ``run_phase_ref`` on CPU copies of the same inputs to worker
    processes (:func:`_plain_phase`, ``threads`` threads each; by default
    one a core but one, on one thread: narrow rows run as fast on one
    thread as on a shared pool), which go on beside the card's later work
    until :meth:`finish` holds the kernel's results to theirs: ``done_t`` bit
    for bit, ``rem`` within ``PHASE_RTOL``, the same exact flag, or the
    smoke fails (:func:`_check_phase`). The workers are daemons: a smoke
    that fails before :meth:`finish` stops them as it exits."""

    def __init__(self, workers=None, threads: int = 1,
                 card_draws: bool = False):
        self.workers = workers or max(1, len(os.sched_getaffinity(0)) - 1)
        self.threads, self.card_draws = threads, card_draws
        self.pool, self.rows, self.ended = None, {}, []

    def add(self, name: str, calls) -> None:
        import multiprocessing

        from repro_torch.kernels.ponsim import kernel, ops

        if self.pool is None:
            self.t0 = time.time()
            self.pool = multiprocessing.get_context("spawn").Pool(
                self.workers)
        rows = self.rows.setdefault(name, [])
        for args, kwargs in calls:
            sc, tc = ops.phase_inputs(*args, **kwargs, use_k2=True,
                                      device="cuda")
            got = kernel.run_phase_cuda(sc, tc)
            sh, th = ops.phase_inputs(*args, **kwargs, use_k2=True,
                                      device="cpu")
            rows.append((sc, tc, got, self.pool.apply_async(
                _plain_phase, (sh, th, self.threads, self.card_draws),
                callback=lambda _: self.ended.append(time.time()))))

    def finish(self) -> dict:
        """Waits for the plain runs and holds every phase to its own;
        ``hold_s`` is then the time from the first :meth:`add` to the
        last plain run's end. Returns name -> ``[(card inputs, rem error,
        exact flag)]``."""
        out = {}
        for name, rows in self.rows.items():
            out[name] = []
            for sc, tc, got, run in rows:
                want = run.get()
                out[name].append((sc, tc,
                                  _check_phase(name, sc.mode, got, want),
                                  want[2]))
        if self.pool is not None:
            self.pool.close()
            self.pool.join()
        self.hold_s = max(self.ended) - self.t0 if self.ended else 0.0
        return out


def _hold_phases(groups: dict) -> dict:
    """:class:`_PhaseHolds` on every recorded phase of ``groups`` (name ->
    ``_record_phases`` calls), waited for at once."""
    holds = _PhaseHolds()
    for name, calls in groups.items():
        holds.add(name, calls)
    return holds.finish()


def phase_kphase():
    """The fused phase kernel against its plain version (``run_phase_ref``
    on CPU copies of the same inputs, in worker processes:
    :func:`_hold_phases`): ``done_t`` bit for bit, ``rem`` within
    ``PHASE_RTOL``, the same exact flag, on every phase of
    :func:`phase_check_sweeps`, of :func:`wide_phases` and of the fig2b-16
    sweep; then timed on those three beside the plain version on the
    card."""
    from repro_torch.kernels.ponsim import kernel, ref
    from repro_torch.net import PONConfig, SweepSpec

    t0 = time.time()
    checks = {f"check {name}": _record_phases(spec, "cuda")
              for name, spec in phase_check_sweeps().items()}
    wide = wide_phases("cuda")
    # the main path's phases: the fig2b-16 sweep's three
    _, cases = fig2b_cases()
    main = SweepSpec(cases=tuple(cases), pon=PONConfig(n_onus=N_ONUS),
                     backend="jit")
    held = _hold_phases({
        **checks,
        **{f"wide {name}_{i}": [(args, kwargs)]
           for i, (name, args, kwargs) in enumerate(wide)},
        "fig2b-16": _record_phases(main, "cuda")})
    n_checks = sum(len(v) for v in held.values())
    err = max(e for v in held.values() for _, _, e, _ in v)
    covered = {c for key in checks for sc, _, _, exact in held[key]
               for c, hit in PHASE_COVER.items() if hit(sc, exact)}
    missing = set(PHASE_COVER) - covered
    if missing:
        raise SystemExit(f"phase checks did not cover {sorted(missing)}")
    # past the widths the kernel once refused
    wide_covered, wide_ms, smem = set(), {}, {}
    for i, (name, _, _) in enumerate(wide):
        sc, tc, _, _ = held[f"wide {name}_{i}"][0]
        hits = {c for c, hit in WIDE_COVER.items() if hit(sc, tc)}
        wide_covered |= hits
        if hits:
            what = f"{name}_{i}_{sc.mode}"
            wide_ms[what] = _device_ms(kernel.launch_phase, [(sc, tc)],
                                       reps=3)
            smem[what] = kernel.phase_plan(sc, tc)
    missing = set(WIDE_COVER) - wide_covered
    if missing:
        raise SystemExit(f"wide phase checks did not cover "
                         f"{sorted(missing)}")
    if any("sort" in plan["regions_on_chip"] for what, plan in smem.items()
           if what.startswith("row16385")):
        raise SystemExit("the 16,385-queue row's sort was not in global "
                         "scratch")

    ms, plain_ms, cycles = [], [], []
    n_bytes = n_adds = n_draws = 0
    for sc, tc, _, _ in held["fig2b-16"]:
        state = kernel.launch_phase(sc, tc)
        k_stop = state["k_stop"].cpu().numpy().astype(np.int64)
        ms.append(_device_ms(kernel.launch_phase, [(sc, tc)], reps=3))
        t_run = time.time()
        ref.run_phase_ref(sc, tc)
        torch.cuda.synchronize()
        plain_ms.append((time.time() - t_run) * 1e3)
        cycles.append(int(k_stop.max()))
        b, a, d = _phase_bound(sc, tc, k_stop)
        n_bytes, n_adds, n_draws = n_bytes + b, n_adds + a, n_draws + d
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    ops_ms = (THREEFRY_OPS * n_draws / OPS32_S + n_adds / FP64_S) * 1e3
    bound = max(bytes_ms, ops_ms)
    total = sum(ms)
    us_cycle = [m * 1e3 / c for m, c in zip(ms, cycles)]
    _line("k_phase", time.time() - t0, checks=n_checks,
          covered=len(covered), wide_covered=len(wide_covered),
          done_t_bitwise="yes",
          rem_max_abs_err=f"{err:.3g}",
          ms=",".join(f"{m:.4f}" for m in ms),
          cycles=",".join(str(c) for c in cycles),
          us_per_cycle=",".join(f"{u:.3f}" for u in us_cycle),
          plain_ms=",".join(f"{m:.1f}" for m in plain_ms),
          bound_ms=f"{bound:.6f}", bytes_ms=f"{bytes_ms:.6f}",
          ops_ms=f"{ops_ms:.6f}", n_bytes=n_bytes, f64_adds=n_adds,
          draws=n_draws,
          wide_ms=",".join(f"{k}:{v:.4f}" for k, v in wide_ms.items()),
          on_chip=",".join(f"{k}:{v['smem_bytes']}B/{v['threads']}t"
                           for k, v in smem.items()))
    return {
        "name": "ponsim_phase", "route": "cuda",
        "source": "src/repro_torch/csrc/ponsim_phase.cu",
        "replaces": "src/repro/kernels/ponsim/ops.py:584",
        "carries": ["src/repro/kernels/traffic/kernel.py:164",
                    "src/repro/kernels/ponsim/kernel.py:86"],
        "max_abs_err": err, "ms": total, "plain_ms": sum(plain_ms),
        "bound_ms": bound,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "ms_by_phase": ms, "cycles_by_phase": cycles,
        "us_per_cycle_by_phase": us_cycle, "plain_ms_by_phase": plain_ms,
        "wide_checks_ms": wide_ms,
    }


def _k3_input(shape, dtype, seed: int, kind: str = "normal"):
    """~0.01 N(0, 1) in ``dtype``; ``zeros``: the first half zero;
    ``ties``: halves and wholes with 127 every 64 elements, so a block's
    scale is 1 and half its x / scale land on .5."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") * 1e-2
    flat = x.view(-1)
    if kind == "zeros":
        flat[: flat.numel() // 2] = 0.0
    elif kind == "ties":
        flat.copy_(torch.round(flat * 4e3) / 2 + 0.5)
        flat[::64] = 127.0
    return x.to(dtype)


def _k3_equal(q, s, qr, sr) -> bool:
    return torch.equal(q, qr) and torch.equal(s.view(torch.int32),
                                              sr.view(torch.int32))


def _dequantize_library(q, scales, block: int):
    """K3' as one PyTorch call: int8 times float32 promotes to float32,
    the int8 converts exactly and the product rounds once."""
    return torch.mul(q.view(-1, block), scales[:, None])


def _k3_hold(x, block: int, what: str) -> None:
    """K3, then K3' on its output, against the plain versions on the same
    inputs, bit for bit; the library's dequantisation too."""
    from repro_torch.kernels.quant import kernel, ref

    q, s = kernel.quantize_int8_cuda(x, block)
    qr, sr = ref.quantize_int8_ref(x, block)
    out = kernel.dequantize_int8_cuda(q, s, block)
    want = ref.dequantize_int8_ref(q, s, block)
    lib = _dequantize_library(q, s, ref.block_size(block, x.numel()))
    torch.cuda.synchronize()
    if not _k3_equal(q, s, qr, sr):
        raise SystemExit(f"K3 differs from its plain version at {what}")
    if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
        raise SystemExit(f"K3' differs from its plain version at {what}")
    if not torch.equal(out.view(torch.int32),
                       lib.reshape(-1).view(torch.int32)):
        raise SystemExit(f"K3' differs from the library's torch.mul at "
                         f"{what}")


def _cnn_update(seed: int):
    """A CNN-shaped update (leaves ~ 1e-3 N(0, 1)) in the tree order."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.models import cnn

    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = cnn._init(None, cnn.N_CLASSES, 1, torch.device("meta"))
    tree = tree_map(lambda t: torch.randn(t.shape, generator=g,
                                          device="cuda") * 1e-3, shapes)
    return tree, tree_leaves(tree)


def _k3_bounds(n: int, block: int, in_bytes: int):
    """(K3 bound ms, K3' bound ms, bound by) for n elements of
    ``in_bytes`` each: K3 reads x once and writes q and the scales, K3'
    the reverse in float32; 5 and 1 float32 operations an element."""
    n_blocks = -(-n // block)
    n_pad = n_blocks * block
    q_bytes = in_bytes * n + n_pad + 4 * n_blocks
    d_bytes = n_pad + 4 * n_blocks + 4 * n_pad
    by = "bytes" if q_bytes / HBM_BYTES_S >= 5 * n / OPS32_S \
        else "operations"
    return (max(q_bytes / HBM_BYTES_S, 5 * n / OPS32_S) * 1e3,
            max(d_bytes / HBM_BYTES_S, n_pad / OPS32_S) * 1e3, by)


def _k3_timed(xs, block: int) -> dict:
    """Device ms a call of K3, its plain version, K3', its plain version
    and the library's dequantisation, each over the inputs ``xs`` in
    turn: one input stays warm in L2; ``COLD_COPIES`` copies of one are
    read from HBM."""
    from repro_torch.kernels.quant import kernel, ref

    whole = ref.block_size(block, xs[0].numel())
    xa = [(x, block) for x in xs]
    qa = [(*kernel.quantize_int8_cuda(x, block), block) for x in xs]
    return {
        "ms": _device_ms(kernel.quantize_int8_cuda, xa),
        "plain_ms": _device_ms(ref.quantize_int8_ref, xa, reps=8),
        "dq_ms": _device_ms(kernel.dequantize_int8_cuda, qa),
        "dq_plain_ms": _device_ms(ref.dequantize_int8_ref, qa, reps=8),
        "dq_library_ms": _device_ms(_dequantize_library,
                                    [(q, s, whole) for q, s, _ in qa]),
    }


def _k3_readings(x, block: int):
    """``_k3_timed`` on ``x`` warm in L2, and on copies from HBM."""
    warm = _k3_timed([x], block)
    cold = _k3_timed([x.clone() for _ in range(COLD_COPIES)], block)
    return warm, cold


def _device_ops(fn, *args) -> list:
    """The names of the device operations (kernels, memsets, copies) of
    one call of ``fn``, by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def phase_k3():
    from repro_torch.kernels.quant import kernel

    t0 = time.time()
    n_checks = 0
    for i, (shape, block) in enumerate(K3_GRID):
        for dtype in (torch.float32, torch.bfloat16):
            for kind in ("normal", "zeros", "ties"):
                _k3_hold(_k3_input(shape, dtype, i, kind), block,
                         f"{shape} block={block} {dtype} {kind}")
                n_checks += 1
    tree, leaves = _cnn_update(7)
    for leaf in leaves:
        for dtype in (torch.float32, torch.bfloat16):
            _k3_hold(leaf.to(dtype), leaf.numel(),
                     f"CNN leaf {tuple(leaf.shape)} {dtype} block=n")
            n_checks += 1
    update = torch.cat([leaf.reshape(-1) for leaf in leaves])
    if update.numel() != UPDATE_N:
        raise SystemExit(f"the CNN update has {update.numel()} elements")
    _k3_hold(update, K3_BLOCK, f"the update at block {K3_BLOCK}")
    n_checks += 1
    for i, (n_big, dtype) in enumerate(K3_PAST_CAPACITY):
        _k3_hold(_k3_input((n_big,), dtype, 50 + i), n_big,
                 f"{n_big} {dtype} at block = n, past on-chip capacity")
        n_checks += 1

    fc1 = tree["fc1"]["w"]
    n = fc1.numel()
    # a trained update's fc1 holds whole rows of zeros (input features that
    # never fired); one row in eight here, -0.0 among them
    dead = fc1.clone()
    dead[::8] = 0.0
    dead[4::64] = -0.0
    _k3_hold(dead, n, "fc1 with zero rows at block = n")
    n_checks += 1
    ops = _device_ops(kernel.quantize_int8_cuda, fc1, n)
    if len(ops) != 1:
        raise SystemExit(f"K3 at fc1 ran {len(ops)} device operations a "
                         f"call, not 1: {ops}")
    bound, d_bound, by = _k3_bounds(n, n, 4)
    u_bound, ud_bound, _ = _k3_bounds(UPDATE_N, K3_BLOCK, 4)
    warm, cold = _k3_readings(fc1, n)
    z_warm, z_cold = _k3_readings(dead, n)
    u_warm, u_cold = _k3_readings(update, K3_BLOCK)

    def fmt(times, tag):
        return {f"{k}{tag}": f"{v:.5f}" for k, v in times.items()}

    # ms from HBM; _l2 the input warm in L2
    _line("k3", time.time() - t0, checks=n_checks, bitwise="yes",
          fc1_n=n, device_ops_a_call_fc1=len(ops),
          kernel_fc1=re.search(r"(\w+_kernel)", ops[0]).group(1),
          bound_ms=f"{bound:.5f}", dq_bound_ms=f"{d_bound:.5f}",
          **fmt(cold, ""), **fmt(warm, "_l2"),
          **fmt(z_cold, "_zero_rows"), **fmt(z_warm, "_l2_zero_rows"),
          update_blocks=-(-UPDATE_N // K3_BLOCK),
          bound_ms_update=f"{u_bound:.5f}",
          dq_bound_ms_update=f"{ud_bound:.5f}",
          **fmt(u_cold, "_update"), **fmt(u_warm, "_l2_update"))
    common = {"route": "cuda", "source": "src/repro_torch/csrc/quant_int8.cu",
              "max_abs_err": 0.0, "bound_by": by}

    def entry(name, line, key, lib, bounds):
        """A kernels-line entry: fc1's weight at block = n, then the
        update at block 4096; times from HBM, ``_l2`` warm in L2."""
        out = {"name": name,
               "replaces": f"src/repro/kernels/quant/kernel.py:{line}",
               **common, "bound_ms": bounds[0],
               "bound_ms_update_4096": bounds[1]}
        for tag, times in (("", cold), ("_l2", warm),
                           ("_update_4096", u_cold),
                           ("_l2_update_4096", u_warm)):
            out[f"ms{tag}"] = times[f"{key}ms"]
            out[f"plain_ms{tag}"] = times[f"{key}plain_ms"]
            out[f"library_ms{tag}"] = (times["dq_library_ms"] if lib
                                       else None)
        return out

    # no single PyTorch call quantises by amax / 127; K3' is one torch.mul
    k3 = entry("quantize_int8", 46, "", False, (bound, u_bound))
    k3["device_ops_a_call_fc1"] = len(ops)
    return [k3, entry("dequantize_int8", 69, "dq_", True,
                      (d_bound, ud_bound))]


def _k3_checked():
    """A patch under which every K3 and K3' launch is held to its plain
    version on the same input, bit for bit, and counted in ``held``."""
    from repro_torch.kernels.quant import kernel, ref

    quantize, dequantize = kernel.quantize_int8_cuda, \
        kernel.dequantize_int8_cuda
    held = {"quantize_int8": 0, "dequantize_int8": 0}

    def quantize_held(x, block=K3_BLOCK):
        q, s = quantize(x, block)
        if not _k3_equal(q, s, *ref.quantize_int8_ref(x, block)):
            raise SystemExit(f"K3 differs from its plain version in the "
                             f"round at {tuple(x.shape)}")
        held["quantize_int8"] += 1
        return q, s

    def dequantize_held(q, s, block=K3_BLOCK):
        out = dequantize(q, s, block)
        want = ref.dequantize_int8_ref(q, s, block)
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            raise SystemExit(f"K3' differs from its plain version in the "
                             f"round at {tuple(q.shape)}")
        held["dequantize_int8"] += 1
        return out

    return mock.patch.multiple(kernel, quantize_int8_cuda=quantize_held,
                               dequantize_int8_cuda=dequantize_held), held


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@contextlib.contextmanager
def _tf32_on():
    """TF32 for cuDNN's convolutions and cuBLAS's products: the fault
    the CNN gate must see."""
    saved = _tf32_flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@contextlib.contextmanager
def _matmul_tf32_off():
    """Float32 products in full float32 inside the block (a decorator of
    the K4 and K5 phases, whose plain versions multiply in float32); the
    flag in force before is restored on the way out."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _cnn_grads(params, batch, precision=None):
    """(loss, gradients) of one batch, in full float32 as a client step
    (or under the ``precision`` context)."""
    from repro_torch._device import full_float32
    from repro_torch._tree import tree_leaves, tree_unflatten
    from repro_torch.models import cnn

    live = [p.detach().clone().requires_grad_(True)
            for p in tree_leaves(params)]
    with (precision or full_float32)():
        loss = cnn.loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
    return loss.item(), grads


def _cnn_off(card, cpu) -> list:
    """The loss's and each gradient leaf's error of a card run against
    the CPU's, and the names of those past their gate."""
    loss_err = abs(card[0] - cpu[0]) / abs(cpu[0])
    errs = [_rel_err(g.cpu(), w) for g, w in zip(card[1], cpu[1])]
    past = ["loss"] if loss_err > CNN_CARD_TOL else []
    past += [f"leaf {i}" for i, e in enumerate(errs)
             if e > (CNN_WGRAD_TOL if i == CNN_WGRAD_LEAF else CNN_CARD_TOL)]
    return loss_err, errs, past


def _tf32_spy(loss_fn, seen: dict):
    """``loss_fn`` that counts in ``seen`` the client steps, their
    backwards (a hook on the loss) and those of either with TF32 on."""
    def check(_grad):
        seen["backwards"] += 1
        seen["tf32"] += any(_tf32_flags())

    def spied(params, batch):
        seen["steps"] += 1
        seen["tf32"] += any(_tf32_flags())
        loss = loss_fn(params, batch)
        if loss.requires_grad:
            loss.register_hook(check)
        return loss
    return spied


def _fl_run(scheme: str, clients, test_batch):
    """The three fractions through ``CPSServer`` at width 1: returns, per
    fraction, (accuracies, ms a round, logs, K3 and K3' launches), and
    the K3/K3' calls held to their plain versions in first rounds."""
    from repro_torch import fl
    from repro_torch.kernels.quant import kernel as k3
    from repro_torch.models import cnn

    runs, held_total = {}, 0
    for frac in FL_FRACTIONS:
        params = cnn.init_params(
            torch.Generator(device="cuda").manual_seed(0))
        server = fl.CPSServer(
            global_params=params, clients=clients,
            selection=fl.SelectionConfig(strategy="fraction", fraction=frac),
            compression=fl.CompressorConfig(scheme=scheme), seed=1)
        accs, ms, logs = [], [], []
        k3.quantize_launches = k3.dequantize_launches = 0
        for r in range(FL_ROUNDS):
            patch, held = _k3_checked()
            torch.cuda.synchronize()
            t_round = time.perf_counter()
            with patch if r == 0 else contextlib.nullcontext():
                log = server.run_round(
                    eval_fn=lambda p: cnn.accuracy(p, test_batch))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t_round) * 1e3)
            accs.append(log.eval_metric)
            logs.append(log)
            held_total += held["quantize_int8"] + held["dequantize_int8"]
        runs[frac] = (accs, ms, logs,
                      (k3.quantize_launches, k3.dequantize_launches))
    return runs, held_total


def phase_fl_fig2a():
    from repro_torch._tree import tree_map
    from repro_torch.data import build_federated_cnn_clients
    from repro_torch.fl import LocalTrainConfig
    from repro_torch.models import cnn

    t0 = time.time()
    tf32_seen = {"steps": 0, "backwards": 0, "tf32": 0}
    clients, test = build_federated_cnn_clients(
        n_clients=FL_CLIENTS, samples_per_client=FL_SAMPLES,
        loss_fn=_tf32_spy(cnn.loss_fn, tf32_seen),
        train_cfg=LocalTrainConfig(lr=FL_LR, batch_size=FL_BATCH,
                                   local_epochs=FL_EPOCHS), seed=0)
    test_batch = {k: v[:FL_TEST] for k, v in test.items()}

    # one batch's loss and gradients on the card against the CPU, in full
    # float32 and, as the gate's control, with TF32 on
    params = cnn.init_params(torch.Generator(device="cuda").manual_seed(0))
    batch = {k: v[:FL_BATCH] for k, v in clients[0].data.items()}
    flags = _tf32_flags()
    cpu = _cnn_grads(tree_map(lambda t: t.cpu(), params), batch)
    loss_err, errs, past = _cnn_off(_cnn_grads(params, batch), cpu)
    tf32_loss_err, tf32_errs, tf32_past = _cnn_off(
        _cnn_grads(params, batch, _tf32_on), cpu)
    for label, l_err, e in (("full float32", loss_err, errs),
                            ("TF32 on", tf32_loss_err, tf32_errs)):
        print(f"  CNN on the card ({label}) vs the CPU, one batch of "
              f"{FL_BATCH}: loss rel {l_err:.3g}, gradients (tree order) "
              f"{' '.join(f'{x:.3g}' for x in e)} of each leaf's largest",
              flush=True)
    if past:
        raise SystemExit(f"CNN loss/gradients on the card differ from the "
                         f"CPU's past the gate at {past}")
    if not tf32_past:
        raise SystemExit("the CNN gate passes a TF32 run: it cannot see "
                         "TF32 leak into the float32 path")
    if _tf32_flags() != flags:
        raise SystemExit("full_float32 did not restore the TF32 flags")
    grad_err = max(errs)
    del params

    result, launches = {}, 0
    for scheme, bits in (("int8", INT8_BITS), ("none", NONE_BITS)):
        t_run = time.time()
        runs, held = _fl_run(scheme, clients, test_batch)
        for frac, (accs, ms, logs, (n_q, n_d)) in runs.items():
            arrived = sum(log.n_arrived for log in logs)
            want = 8 * arrived if scheme == "int8" else 0
            if (n_q, n_d) != (want, want):
                raise SystemExit(f"{scheme} fraction {frac}: K3/K3' ran "
                                 f"{n_q}/{n_d} times, not {want}")
            for log in logs:
                if log.update_bits != log.n_arrived * bits:
                    raise SystemExit(f"{scheme} fraction {frac} round "
                                     f"{log.round_index}: update_bits "
                                     f"{log.update_bits} != "
                                     f"{log.n_arrived} x {bits}")
            if not all(0.0 <= a <= 1.0 for a in accs):
                raise SystemExit(f"{scheme} fraction {frac}: accuracy "
                                 f"{accs}")
            if scheme == "int8":
                launches += n_q
            print(f"  {scheme} fraction {frac}: acc "
                  f"{'/'.join(f'{a:.4f}' for a in accs)}; ms a round "
                  f"first {ms[0]:.1f}, median of the rest "
                  f"{statistics.median(ms[1:]):.3f}; arrived "
                  f"{[log.n_arrived for log in logs]}; update_bits a round "
                  f"{logs[0].update_bits:.0f}; k3 {n_q} k3' {n_d}; loss "
                  f"{'/'.join(f'{log.mean_loss:.3f}' for log in logs)}",
                  flush=True)
        if held != (16 * sum(runs[f][2][0].n_arrived for f in runs)
                    if scheme == "int8" else 0):
            raise SystemExit(f"{scheme}: {held} K3/K3' calls held in the "
                             f"first rounds")
        result[scheme] = {f: r[0] for f, r in runs.items()}
        print(f"  {scheme}: {time.time() - t_run:.1f}s for the "
              f"fractions; {held} K3/K3' calls held bit for bit in first "
              f"rounds", flush=True)
    _hold_accuracy(result)
    if tf32_seen["tf32"] or not (tf32_seen["steps"]
                                 == tf32_seen["backwards"] > 0):
        raise SystemExit(f"client steps with TF32 on: {tf32_seen}")
    final = {f"acc_final_{s}_{f}": f"{result[s][f][-1]:.4f}"
             for s in result for f in FL_FRACTIONS}
    _line("fl_fig2a", time.time() - t0, clients=FL_CLIENTS,
          rounds=FL_ROUNDS, grad_err=f"{grad_err:.3g}",
          tf32_grad_err=f"{max(tf32_errs):.3g}",
          steps_tf32=f"{tf32_seen['tf32']}/{tf32_seen['steps']}",
          k3_launches=launches, **final)
    return launches


def _hold_accuracy(result) -> None:
    """The Fig. 2a gates on the final accuracies (``FL_ACC_MIN``,
    ``FL_REF_GAP``, ``FL_INT8_GAP``)."""
    for scheme, curves in result.items():
        for frac, accs in curves.items():
            ref_gap = abs(accs[-1] - FIG2A_JAX_FINAL[frac])
            if accs[-1] < FL_ACC_MIN or ref_gap > FL_REF_GAP:
                raise SystemExit(
                    f"{scheme} fraction {frac}: final accuracy {accs[-1]} "
                    f"(at least {FL_ACC_MIN}, within {FL_REF_GAP} of the "
                    f"JAX package's {FIG2A_JAX_FINAL[frac]})")
    gap = max(abs(result["int8"][f][-1] - result["none"][f][-1])
              for f in FL_FRACTIONS)
    if gap > FL_INT8_GAP:
        raise SystemExit(f"int8 and uncompressed final accuracies {gap} "
                         f"apart (> {FL_INT8_GAP})")


def _rel_err(got, want) -> float:
    """Largest absolute difference over the largest absolute value."""
    return float((got - want).abs().max()) / (float(want.abs().max())
                                              + 1e-30)


def _live_keys(S: int, T: int, causal: bool, window) -> int:
    """Sum over queries of the keys the mask leaves live."""
    qi = np.arange(S)
    hi = np.minimum(T - 1, qi) if causal else np.full(S, T - 1)
    lo = np.maximum(0, qi - window + 1) if window else np.zeros(S, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def _close(got, want, tol: float) -> bool:
    """Elementwise ``|got - want| <= tol + tol * |want|`` in float32."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= tol + tol * w.abs()).all())


def _qkv(B, S, T, H, K, D, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, S, H, D), (B, T, K, D), (B, T, K, D)))


def _k4_hold(shape, causal, window, dtype, seed=0) -> float:
    """K4 once at ``shape`` (B, S, T, H, K, D) against its plain version
    within ``K4_TOL``, through the kernel ``route`` names (the
    tensor-core counter must move exactly when it names the tensor
    cores). Returns the largest absolute error."""
    from repro_torch.kernels.attention import kernel, ref

    B, S, T, H, K, D = shape
    q, k, v = _qkv(B, S, T, H, K, D, dtype, seed=seed)
    tc = kernel.route(dtype, D) == "tensor_cores"
    before = (kernel.launches, kernel.launches_tc)
    got = kernel.flash_attention_cuda(q, k, v, causal, window)
    want = ref.attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    if (kernel.launches, kernel.launches_tc) != (before[0] + 1,
                                                 before[1] + tc):
        raise SystemExit(f"K4 at {shape} {dtype}: not one launch of the "
                         f"{'tensor' if tc else 'CUDA'}-core kernel")
    err = float((got.float() - want.float()).abs().max())
    name = str(dtype).removeprefix("torch.")
    if not _close(got, want, K4_TOL[name]):
        raise SystemExit(f"K4 differs from its plain version by {err} at "
                         f"{shape} causal={causal} window={window} {name}")
    return err


def _k4_timed(shape, window, seed):
    """K4 at ``shape`` (B, S, T, H, K, D) bf16, causal, with ``window``:
    held to its plain version through the tensor-core kernel, then timed
    beside it and beside ``scaled_dot_product_attention`` (k/v given to
    every query head; causal, or with a boolean mask where the window
    cuts). Returns (max abs error, ms, plain ms, library ms, bound ms,
    bound by, operations)."""
    from repro_torch.kernels.attention import kernel, ref

    B, S, T, H, K, D = shape
    if kernel.route(torch.bfloat16, D) != "tensor_cores":
        raise SystemExit(f"K4 at {shape} bf16 does not route to the "
                         f"tensor cores")
    err = _k4_hold(shape, True, window, torch.bfloat16, seed)
    q, k, v = _qkv(B, S, T, H, K, D, torch.bfloat16, seed=seed)
    ms = _device_ms(kernel.flash_attention_cuda, [(q, k, v, True, window)])
    plain_ms = _device_ms(ref.attention_ref, [(q, k, v, True, window)],
                          reps=4)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if K != H:
        kt, vt = (x.repeat_interleave(H // K, dim=1) for x in (kt, vt))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is not None and window < S:
        qi = torch.arange(S, device="cuda")[:, None]
        kj = torch.arange(T, device="cuda")[None, :]
        mask = (kj <= qi) & (qi - kj < window)
        library_ms = _device_ms(
            lambda a, b, c: sdpa(a, b, c, attn_mask=mask), [(qt, kt, vt)])
    else:
        library_ms = _device_ms(
            lambda a, b, c: sdpa(a, b, c, is_causal=True), [(qt, kt, vt)])
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    n_ops = 4 * B * H * D * _live_keys(S, T, True, window)
    bound = max(n_bytes / HBM_BYTES_S, n_ops / BF16_S) * 1e3
    by = "bytes" if n_bytes / HBM_BYTES_S >= n_ops / BF16_S else "operations"
    return err, ms, plain_ms, library_ms, bound, by, n_ops


@_matmul_tf32_off()
def phase_k4():
    from repro_torch.kernels.attention import kernel

    t0 = time.time()
    grid_err = {"float32": 0.0, "bfloat16": 0.0}
    tc_before = kernel.launches_tc
    for B, S, T, H, K, D, causal, window in K4_GRID:
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            grid_err[name] = max(grid_err[name], _k4_hold(
                (B, S, T, H, K, D), causal, window, dtype))
    err_edges = max(_k4_hold((B, S, T, H, K, D), causal, window,
                             torch.bfloat16, seed=i)
                    for i, (B, S, T, H, K, D, causal, window)
                    in enumerate(K4_TC_EDGES))
    # holds on the tensor-core kernel: these, the two prefills, the cut
    tc_held = kernel.launches_tc - tc_before + 3

    err, ms, plain_ms, library_ms, bound, by, n_ops = _k4_timed(
        OLMO_PREFILL, None, 1)
    err_rg, ms_rg, plain_rg, library_rg, bound_rg, by_rg, ops_rg = \
        _k4_timed(RG_PREFILL, RG_WINDOW, 2)
    # recurrentgemma's heads where the window cuts
    err_cut = _k4_hold(RG_WINDOW_CUT, True, RG_WINDOW, torch.bfloat16, 3)

    _line("k4", time.time() - t0,
          checks=2 * len(K4_GRID) + len(K4_TC_EDGES) + 3,
          tensor_core_checks=tc_held, err_f32=f"{grid_err['float32']:.3g}",
          err_bf16=f"{grid_err['bfloat16']:.3g}",
          err_tc_edges=f"{err_edges:.3g}", err_olmo=f"{err:.3g}",
          ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.4f}",
          library_ms=f"{library_ms:.5f}", bound_ms=f"{bound:.5f}",
          tflops=f"{n_ops / ms / 1e9:.2f}", err_d256=f"{err_rg:.3g}",
          err_d256_window_cut=f"{err_cut:.3g}", ms_d256=f"{ms_rg:.5f}",
          plain_ms_d256=f"{plain_rg:.4f}",
          library_ms_d256=f"{library_rg:.5f}",
          bound_ms_d256=f"{bound_rg:.5f}",
          tflops_d256=f"{ops_rg / ms_rg / 1e9:.2f}")
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:139",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
        # recurrentgemma-2b's prefill shape, D 256
        "max_abs_err_d256": max(err_rg, err_cut), "ms_d256": ms_rg,
        "plain_ms_d256": plain_rg, "bound_ms_d256": bound_rg,
        "bound_by_d256": by_rg, "library_ms_d256": library_rg,
    }


def _check_syncs(names, results):
    for name, res in zip(names, results):
        want = SYNC_TABLE[name]
        if not math.isfinite(res.sync_time) or abs(
                res.sync_time - want) > SYNC_TOL:
            raise SystemExit(f"sync {name}: {res.sync_time!r} != {want!r}")


def phase_main():
    from repro_torch.kernels.ponsim import kernel as k2
    from repro_torch.kernels.traffic import kernel as k1
    from repro_torch.net import PONConfig, SweepSpec, simulate

    t0 = time.time()
    names, cases = fig2b_cases()
    spec = SweepSpec(cases=tuple(cases), pon=PONConfig(n_onus=N_ONUS))
    k1.launches = 0
    k2.launches = 0
    t_run = time.time()
    results = simulate(spec, device="cuda")
    torch.cuda.synchronize()
    first = time.time() - t_run
    launches = {"traffic_sampler": k1.launches,
                "waterfill_grants": k2.launches}
    _check_syncs(names, results)
    if not all(launches.values()):
        raise SystemExit(f"a kernel was not launched on the main path: "
                         f"{launches}")
    walls = []
    for _ in range(3):
        t_run = time.time()
        results = simulate(spec, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.time() - t_run)
        _check_syncs(names, results)
    _line("main", time.time() - t0, cases=len(cases),
          sync_match="16/16", warmup_s=f"{first:.3f}",
          wall_s_median=f"{statistics.median(walls):.3f}",
          walls=",".join(f"{w:.3f}" for w in walls),
          k1_launches=launches["traffic_sampler"],
          k2_launches=launches["waterfill_grants"])
    return launches, walls


def _reset_round_counts():
    """Set the round engine's kernel counts and jit re-runs to 0."""
    from repro_torch.kernels.ponsim import kernel as k2
    from repro_torch.kernels.traffic import kernel as k1
    from repro_torch.net import engine

    k1.launches = k2.launches = k2.phase_launches = 0
    engine.phase_fallbacks = 0


def _round_counts() -> dict:
    from repro_torch.kernels.ponsim import kernel as k2
    from repro_torch.kernels.traffic import kernel as k1
    from repro_torch.net import engine

    return {"phase": k2.phase_launches, "k1": k1.launches,
            "k2": k2.launches, "fallbacks": engine.phase_fallbacks}


def _hold_jit_counts(counts: dict, min_phases: int, what: str) -> None:
    """The jit path went through the phase kernel alone: at least
    ``min_phases`` phase launches, no standalone K1/K2 launch and no
    re-run on the per-cycle loop."""
    if (counts["phase"] < min_phases or counts["k1"] or counts["k2"]
            or counts["fallbacks"]):
        raise SystemExit(f"{what}: jit path counts {counts}")


def phase_main_jit(main_walls=None):
    """The fig2b-16 sweep through ``backend="jit"``: each phase one launch
    of the phase kernel, with the sampler and the waterfill inside it."""
    from repro_torch.net import PONConfig, SweepSpec, simulate

    t0 = time.time()
    names, cases = fig2b_cases()
    spec = SweepSpec(cases=tuple(cases), pon=PONConfig(n_onus=N_ONUS),
                     backend="jit")
    _reset_round_counts()
    t_run = time.time()
    results = simulate(spec, device="cuda")
    torch.cuda.synchronize()
    first = time.time() - t_run
    counts = _round_counts()
    _check_syncs(names, results)
    _hold_jit_counts(counts, 3, "main_jit")
    walls = []
    for _ in range(3):
        t_run = time.time()
        results = simulate(spec, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.time() - t_run)
        _check_syncs(names, results)
    walls_out = {"sweep_wall_s_jit": statistics.median(walls),
                 "sweep_walls_s_jit": walls, "sweep_warmup_s_jit": first}
    if main_walls:
        walls_out["sweep_wall_s_per_cycle"] = statistics.median(main_walls)
    _line("main_jit", time.time() - t0, cases=len(cases),
          sync_match="16/16", warmup_s=f"{first:.3f}",
          wall_s_median=f"{walls_out['sweep_wall_s_jit']:.4f}",
          walls=",".join(f"{w:.4f}" for w in walls),
          per_cycle_wall_s_median=walls_out.get("sweep_wall_s_per_cycle"),
          phase_launches=counts["phase"], k1_launches=counts["k1"],
          k2_launches=counts["k2"], fallbacks=counts["fallbacks"])
    return counts["phase"], walls_out


# the oracle phase: fig2b cases run on the cycle-level simulator, fed the
# engine's counter streams, and held to the card's engine
ORACLE_CASES = ("fcfs_load0.3_n12", "fcfs_load0.8_n12", "bs_load0.3_n12",
                "bs_load0.8_n12", "fcfs_load0.8_n128")
ORACLE_RTOL = 1e-6    # the oracle against the engine (the engines' contract)
# 4 PONs x 128 ONUs, 16 clients 4 a PON, fcfs at load 0.8: the CPS uplink
# (34 Gb/s) sits above the PONs' background (4 x ~8 Gb/s) and below their
# payload capacity (4 x 9.2 Gb/s), so it binds whenever every PON's
# queues are busy; at or under the background the downloads would starve
ORACLE_PONS = 4
ORACLE_CPS_BPS = 34e9


def oracle_multi_pon_case():
    """(workload, topology) of the oracle phase's multi-PON round."""
    from repro_torch.core.slicing import ClientProfile
    from repro_torch.net import FLRoundWorkload, MultiPonTopology

    ids = range(0, ORACLE_PONS * N_ONUS, 32)
    t_uds = np.random.default_rng(42).uniform(1.0, 5.0, len(ids))
    wl = FLRoundWorkload(clients=[
        ClientProfile(client_id=i, t_ud=float(t), t_dl=0.0, m_ud_bits=M_BITS)
        for i, t in zip(ids, t_uds)], model_bits=M_BITS)
    return wl, MultiPonTopology(n_pons=ORACLE_PONS,
                                cps_rate_bps=ORACLE_CPS_BPS)


def _engine_streams_of(cfg, case):
    """The download and upload counter streams the engine draws for a
    single-PON ``case``, on the card."""
    from repro_torch.kernels.traffic.ops import make_stream_key
    from repro_torch.net import CounterStream, MultiPonTopology, pon_bg_rates

    wl = case.workload
    rate = pon_bg_rates(wl.clients, wl.model_bits, case.load, cfg,
                        MultiPonTopology())[0]
    return [CounterStream(make_stream_key(case.seed, phase,
                                          case.stream_round),
                          rate, cfg.cycle_time_s, cfg.n_onus,
                          burst_packets=cfg.bg_burst_packets, device="cuda")
            for phase in (0, 1)]


def _same_round(what: str, got, want) -> None:
    """``got`` is ``want`` bit for bit: the sync, every client's times
    and left-over bits, in the same order."""
    if got.sync_time != want.sync_time:
        raise SystemExit(f"{what}: sync {got.sync_time!r} != "
                         f"{want.sync_time!r}")
    for attr in ("dl_done", "ready", "ul_done", "ul_remaining"):
        g, w = getattr(got, attr) or {}, getattr(want, attr) or {}
        if list(g) != list(w) or not np.array_equal(
                list(g.values()), list(w.values()), equal_nan=True):
            raise SystemExit(f"{what}: {attr} differs")


def phase_oracle():
    """The single-round API and the cycle-level oracles beside the card's
    engine: (a) ``simulate_round`` at the Fig. 2b point on the per-cycle
    loop and through the phase kernel; (b) the cycle-level simulator on
    the engine's counter streams (K1 draws their chunks on the card) held
    to the engine at ``ORACLE_RTOL`` and to the pinned syncs; (c) the
    multi-PON oracle on a binding CPS uplink, held to the engine, then
    again under a collector: its CPS counters recorded, its round the
    same bit for bit."""
    from repro_torch import obs
    from repro_torch.net import (
        PONConfig,
        SweepSpec,
        simulate,
        simulate_multi_pon_round,
        simulate_round,
    )

    t0 = time.time()
    cfg = PONConfig(n_onus=N_ONUS)
    names, cases = fig2b_cases()
    by_name = dict(zip(names, cases))
    walls = {}
    _reset_round_counts()

    # (a) the single-round API
    op_name = "fcfs_load0.8_n12"
    op = by_name[op_name]
    for backend in ("vectorized", "jit"):
        before = _round_counts()
        t = time.time()
        res = simulate_round(cfg, op.workload, op.load, op.policy,
                             seed=op.seed, backend=backend, device="cuda")
        torch.cuda.synchronize()
        walls[f"api_{backend}_s"] = time.time() - t
        counts = {k: v - before[k] for k, v in _round_counts().items()}
        _check_syncs([op_name], [res])
        if backend == "jit":
            _hold_jit_counts(counts, 2, "oracle simulate_round jit")
        elif not (counts["k1"] and counts["k2"]) or counts["phase"]:
            raise SystemExit(f"oracle simulate_round: counts {counts}")

    # (b) the oracle on the engine's counter streams
    held = [by_name[n] for n in ORACLE_CASES]
    t = time.time()
    engine = simulate(SweepSpec(cases=tuple(held), pon=cfg), device="cuda")
    torch.cuda.synchronize()
    walls["engine_s"] = time.time() - t
    t = time.time()
    refs, copies, chunks = [], 0, 0
    for case in held:
        streams = _engine_streams_of(cfg, case)
        dl, ul = ([s.source(i) for i in range(cfg.n_onus)] for s in streams)
        refs.append(simulate_round(
            cfg, case.workload, case.load, case.policy, seed=case.seed,
            backend="reference", _dl_sources=dl, _ul_sources=ul,
            device="cuda"))
        copies += sum(s.host_copies for s in streams)
        chunks += sum(-(-src[0].cursor // s.chunk)
                      for s, src in zip(streams, (dl, ul)))
    walls["oracle_s"] = time.time() - t
    _check_syncs(ORACLE_CASES, refs)
    for name, got, want in zip(ORACLE_CASES, refs, engine):
        _hold_round(f"oracle {name}", got, want, sync_rtol=ORACLE_RTOL)
    if copies != chunks:
        raise SystemExit(f"oracle: {copies} host copies for {chunks} "
                         "chunks of 1,024 cycles")

    # (c) the multi-PON oracle on a binding CPS uplink
    wl, topo = oracle_multi_pon_case()
    t = time.time()
    mp_engine = simulate_round(cfg, wl, 0.8, "fcfs", seed=1, topology=topo,
                               device="cuda")
    torch.cuda.synchronize()
    walls["mp_engine_s"] = time.time() - t
    t = time.time()
    mp = simulate_multi_pon_round(cfg, topo, wl, 0.8, "fcfs", seed=1,
                                  device="cuda")
    walls["mp_oracle_s"] = time.time() - t
    _hold_round("oracle multi-PON", mp, mp_engine, sync_rtol=ORACLE_RTOL)
    col = obs.Collector(device="cuda")
    t = time.time()
    mp_col = simulate_multi_pon_round(cfg, topo, wl, 0.8, "fcfs", seed=1,
                                      collector=col, device="cuda")
    walls["mp_collector_s"] = time.time() - t
    _same_round("oracle multi-PON under a collector", mp_col, mp)
    want_bits = col.counters["multi_pon.cps_want_bits"].value
    eff_bits = col.counters["multi_pon.cps_eff_bits"].value
    util = col.gauges["multi_pon.cps_util"].summary()
    if not (want_bits.shape == eff_bits.shape == (ORACLE_PONS,)
            and bool((eff_bits <= want_bits).all())
            and util["count"] > 0 and util["max"] >= 1.0 - 1e-9
            and ("fcfs", 0.8) in col.delay_hist):
        raise SystemExit(f"oracle multi-PON collector: util {util}")
    counts = _round_counts()
    _line("oracle", time.time() - t0, cases=len(held), sync_match=(
        f"{len(held)}/{len(held)}"), mp_clients=len(wl.clients),
        mp_cycles=int(util["count"]), cps_util_max=f"{util['max']:.6f}",
        host_copies=copies,
        **{k: f"{v:.3f}" for k, v in walls.items()},
        k1_launches=counts["k1"], k2_launches=counts["k2"],
        phase_launches=counts["phase"])
    return counts, walls


def phase_full_width():
    """One FCFS load-0.8 round on one PON of 2048 ONUs, then of 4096 (K2
    at 4096 queues a row), each held to the numpy engine's sync, on the
    per-cycle loop and through the fused phase (``backend="jit"``)."""
    import dataclasses

    from repro_torch.kernels.ponsim import kernel as k2
    from repro_torch.kernels.traffic import kernel as k1
    from repro_torch.net import simulate

    t0 = time.time()
    out = {}
    for n, want in ((2048, SYNC_2048), (4096, SYNC_4096)):
        t_run = time.time()
        k1.launches = 0
        k2.launches = 0
        res = simulate(full_width_spec(n), device="cuda")[0]
        torch.cuda.synchronize()
        wall = time.time() - t_run
        if abs(res.sync_time - want) > SYNC_TOL:
            raise SystemExit(f"{n}-ONU sync {res.sync_time!r} != {want!r}")
        if not (k1.launches and k2.launches):
            raise SystemExit(f"{n}-ONU round: K1 {k1.launches}, K2 "
                             f"{k2.launches} launches")
        out.update({f"wall_s_{n}": f"{wall:.3f}",
                    f"sync_{n}": repr(res.sync_time),
                    f"k1_launches_{n}": k1.launches,
                    f"k2_launches_{n}": k2.launches})
        # the same round through the fused phase
        spec = dataclasses.replace(full_width_spec(n), backend="jit")
        _reset_round_counts()
        t_run = time.time()
        res = simulate(spec, device="cuda")[0]
        torch.cuda.synchronize()
        wall = time.time() - t_run
        if abs(res.sync_time - want) > SYNC_TOL:
            raise SystemExit(f"{n}-ONU jit sync {res.sync_time!r} != "
                             f"{want!r}")
        counts = _round_counts()
        _hold_jit_counts(counts, 2, f"{n}-ONU round")
        out.update({f"jit_wall_s_{n}": f"{wall:.3f}",
                    f"jit_sync_{n}": repr(res.sync_time),
                    f"jit_phase_launches_{n}": counts["phase"]})
    _line("full_width", time.time() - t0, **out)


WIDE_PONS, WIDE_ONUS = 100, 1024


def wide_pons_spec(backend=None):
    """``benchmarks/timeline.py::stacked_run``'s deployment, one round:
    100 PONs of 1,024 ONUs in one case (10 Gb/s x 1,024 / 128 a PON, no
    CPS), 1,024 clients of 26.416 Mbit, FCFS at load 0.8, seed 0."""
    from repro_torch.net import (
        FLRoundWorkload,
        MultiPonTopology,
        PONConfig,
        SweepCase,
        SweepSpec,
    )

    cfg = PONConfig(n_onus=WIDE_ONUS,
                    line_rate_bps=10e9 * WIDE_ONUS / 128)
    wl = FLRoundWorkload(clients=_clients(WIDE_ONUS, WIDE_ONUS),
                         model_bits=M_BITS)
    case = SweepCase(workload=wl, load=0.8, policy="fcfs", seed=0,
                     topology=MultiPonTopology(n_pons=WIDE_PONS))
    return SweepSpec(cases=(case,), pon=cfg, backend=backend)


def _hold_round(what: str, got, want, sync_rtol=None) -> None:
    """Every client's times and left-over bits of round ``got`` within
    ``ROUND_RTOL`` of ``want``'s, and the sync within ``SYNC_TOL`` (or
    within ``sync_rtol`` of it, where given)."""
    tol = SYNC_TOL if sync_rtol is None else sync_rtol * abs(want.sync_time)
    if not (math.isfinite(got.sync_time)
            and abs(got.sync_time - want.sync_time) <= tol):
        raise SystemExit(f"{what} sync {got.sync_time!r} != "
                         f"{want.sync_time!r}")
    for attr in ("dl_done", "ready", "ul_done", "ul_remaining"):
        g, w = getattr(got, attr) or {}, getattr(want, attr) or {}
        ids = sorted(w)
        if sorted(g) != ids or not np.allclose(
                [g[i] for i in ids], [w[i] for i in ids], rtol=ROUND_RTOL,
                atol=0.0, equal_nan=True):
            raise SystemExit(f"{what}: {attr} differs")


ROUND_RTOL = 1e-6     # a client's time or bits, jit against the per-cycle loop


def _finish_wide_hold(holds: _PhaseHolds) -> dict:
    """Waits for the wide round's plain runs (:func:`phase_wide_pons`)
    and holds its phases to them; prints the ``wide_pons_hold`` line."""
    t_wait = time.time()
    held = holds.finish()["wide_pons"]
    err = max(e for _, _, e, _ in held)
    _line("wide_pons_hold", time.time() - t_wait, phases_held=len(held),
          done_t_bitwise="yes", rem_max_abs_err=f"{err:.3g}",
          hold_s=f"{holds.hold_s:.1f}")
    return {"wide_pons_max_abs_err": err, "wide_pons_hold_s": holds.hold_s}


def phase_wide_pons(hold_later: bool = False):
    """One FCFS load-0.8 round on 100 PONs x 1,024 ONUs in one case
    through ``backend="jit"`` (each phase one launch of one CTA, its
    state past shared memory in global scratch), held to the per-cycle
    loop on the same card client by client (:func:`_hold_round`); each of
    its two phases then held in full, at its full widths, to the plain
    version on CPU copies (:class:`_PhaseHolds`, one worker a phase, their
    arrival windows drawn on the card: :func:`_plain_phase`; with
    ``hold_later`` the plain runs go on in the background and the hold is
    returned to be finished later). Prints the wall, each phase's device
    ms and µs a cycle, and the device's busy share of the wall."""
    from repro_torch.kernels.ponsim import kernel
    from repro_torch.net import engine, simulate

    t0 = time.time()
    launch = kernel.launch_phase
    run = engine.run_phase_device
    timed, calls = [], []

    def timed_launch(spec, dyn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state = launch(spec, dyn)
        end.record()
        timed.append((start, end, state["k_stop"], spec.mode))
        return state

    def record(*args, **kwargs):
        calls.append((args, {k: v for k, v in kwargs.items()
                             if k != "device"}))
        return run(*args, **kwargs)

    _reset_round_counts()
    kernel.launch_phase = timed_launch
    engine.run_phase_device = record
    try:
        t_run = time.time()
        jit = simulate(wide_pons_spec("jit"), device="cuda")[0]
        torch.cuda.synchronize()
        wall = time.time() - t_run
    finally:
        kernel.launch_phase = launch
        engine.run_phase_device = run
    counts = _round_counts()
    _hold_jit_counts(counts, 2, "wide_pons")
    ms = [s.elapsed_time(e) for s, e, _, _ in timed]
    cycles = [int(k.max()) for _, _, k, _ in timed]
    hold = _PhaseHolds(workers=len(calls), threads=max(
        1, (len(os.sched_getaffinity(0)) - 2) // len(calls)),
        card_draws=True)
    hold.add("wide_pons", calls)
    t_run = time.time()
    loop = simulate(wide_pons_spec(), device="cuda")[0]
    torch.cuda.synchronize()
    loop_wall = time.time() - t_run
    _hold_round("wide_pons jit against the per-cycle loop", jit, loop)
    out = {"wide_pons_wall_s": wall, "wide_pons_ms_by_phase": ms,
           "wide_pons_cycles_by_phase": cycles,
           "wide_pons_us_per_cycle_by_phase": [
               m * 1e3 / c for m, c in zip(ms, cycles)],
           "wide_pons_device_busy": sum(ms) / (wall * 1e3),
           "wide_pons_sync": jit.sync_time,
           "wide_pons_per_cycle_wall_s": loop_wall}
    _line("wide_pons", time.time() - t0, pons=WIDE_PONS, onus=WIDE_ONUS,
          sync=repr(jit.sync_time), loop_sync=repr(loop.sync_time),
          wall_s=f"{wall:.3f}", loop_wall_s=f"{loop_wall:.3f}",
          ms=",".join(f"{m:.2f}" for m in ms),
          cycles=",".join(str(c) for c in cycles),
          us_per_cycle=",".join(f"{u:.2f}" for u in
                                out["wide_pons_us_per_cycle_by_phase"]),
          device_busy=f"{out['wide_pons_device_busy']:.3f}",
          phase_launches=counts["phase"], fallbacks=counts["fallbacks"],
          clients_match="yes", phases_to_hold=len(calls))
    if hold_later:
        return out, hold
    out.update(_finish_wide_hold(hold))
    return out


# ---- multi-round timelines and the co-simulation ---------------------------

# benchmarks/timeline.py's Fig. 3 grid: {fcfs, bs} x load {0.3, 0.8}, seed 0,
# every ONU a client, FIG3_ROUNDS rounds under its elastic_schedule
# (participation 0.8, membership seed 7)
FIG3_ROUNDS = 24
FIG3_PARTICIPATION, FIG3_MEMBERSHIP_SEED = 0.8, 7
FIG3_GRID = (("fcfs", 0.3), ("fcfs", 0.8), ("bs", 0.3), ("bs", 0.8))
# benchmarks/training_time_saving.py's timeline: load 0.8, seeds {0, 1}
SAVING_ROUNDS, SAVING_SEEDS = 8, 2
# benchmarks/async_timeline.py's op point: 12 clients, load 0.8, seed 1
OP_CLIENTS, OP_ROUNDS = 12, 6
OP_MODES = {"defer": {"deadline_s": 4.0},
            "drop": {"deadline_s": 4.0, "deadline_policy": "drop"},
            "partial": {"deadline_s": 4.0, "deadline_policy": "partial"},
            "async": {"buffer_k": 6}}
# benchmarks/timeline.py::stacked_run's timeline: 100 PONs x 1,024 ONUs,
# FCFS at load 0.05, seed 0, WIDE_TL_ROUNDS elastic rounds
WIDE_TL_ROUNDS, WIDE_TL_LOAD = 2, 0.05
# the short timelines whose every phase is held to the plain version: the
# same schedules at 16 ONUs (1 Gb/s), 3 rounds, clients ready within 0.5 s
SHORT_ONUS, SHORT_ROUNDS, SHORT_DEADLINE = 16, 3, 0.35
# benchmarks/async_timeline.py::accuracy_part's co-simulation
COSIM_CLIENTS, COSIM_SAMPLES, COSIM_DATA_SEED, COSIM_SERVER_SEED = 8, 64, 0, 1
COSIM_LR, COSIM_BATCH, COSIM_EPOCHS, COSIM_TEST = 0.04, 16, 2, 512
COSIM_LOAD, COSIM_MODEL_BITS, COSIM_UPLOAD_BITS = 0.8, 2e6, 3e8
COSIM_ONUS, COSIM_RATE, COSIM_ROUNDS, COSIM_TARGET = 8, 1e9, 4, 0.8
COSIM_MODES = {
    "sync": {},
    "defer": {"deadline_s": 3.5, "deadline_policy": "defer"},
    "drop": {"deadline_s": 3.5, "deadline_policy": "drop"},
    "partial": {"deadline_s": 3.5, "deadline_policy": "partial"},
    "async": {"mode": "async", "async_buffer": 4},
    "faulty": {"deadline_s": 3.5, "deadline_policy": "drop"},
    "faulty_quorum": {"deadline_s": 3.5, "deadline_policy": "drop"},
}

# the JAX package's values of these runs on the CPU (its numpy engine), as
# tests/test_torch_timeline.py::reference_pins computes them (that test
# checks they equal these constants)
FIG3_SYNC = {
    "fcfs_load0.3": (
        5.277100000000097, 5.187100000000067, 5.210100000000074,
        5.216100000000076, 5.217100000000077, 5.218100000000077,
        5.217100000000077, 5.182100000000065, 5.195100000000069,
        5.16710000000006, 5.220100000000078, 4.975099999999996,
        5.211100000000075, 5.212100000000075, 5.184100000000066,
        5.209100000000074, 5.234100000000082, 5.19610000000007,
        4.9740999999999955, 5.151100000000055, 4.966099999999993,
        5.216100000000076, 5.207100000000073, 5.213100000000075,
    ),
    "fcfs_load0.8": (
        6.378100000000464, 6.078100000000364, 6.115100000000377,
        6.188100000000401, 6.128100000000381, 6.188100000000401,
        6.199100000000405, 6.09610000000037, 6.12510000000038,
        6.012100000000342, 6.210100000000408, 5.899100000000304,
        6.153100000000389, 6.198100000000404, 6.062100000000359,
        6.150100000000388, 6.257100000000424, 6.148100000000388,
        5.8851000000003, 6.027100000000347, 5.964100000000326,
        6.192100000000402, 6.0881000000003676, 6.177100000000397,
    ),
    "bs_load0.3": (
        4.909099999999974, 4.909099999999974, 4.909099999999974,
        4.909099999999974, 4.909099999999974, 4.909099999999974,
        4.909099999999974, 4.909099999999974, 4.909099999999974,
        4.883099999999965, 4.889099999999967, 4.909099999999974,
        4.909099999999974, 4.909099999999974, 4.889099999999967,
        4.909099999999974, 4.909099999999974, 4.889099999999967,
        4.909099999999974, 4.909099999999974, 4.909099999999974,
        4.909099999999974, 4.889099999999967, 4.889099999999967,
    ),
    "bs_load0.8": (
        4.909099999999974, 4.909099999999974, 4.909099999999974,
        4.909099999999974, 4.909099999999974, 4.909099999999974,
        4.909099999999974, 4.909099999999974, 4.909099999999974,
        4.883099999999965, 4.889099999999967, 4.909099999999974,
        4.909099999999974, 4.909099999999974, 4.889099999999967,
        4.909099999999974, 4.909099999999974, 4.889099999999967,
        4.909099999999974, 4.909099999999974, 4.909099999999974,
        4.909099999999974, 4.889099999999967, 4.889099999999967,
    ),
}
SAVING_SYNC = {
    "fcfs_seed0": (
        6.378100000000464, 6.36510000000046, 6.300100000000438,
        6.373100000000463, 6.297100000000437, 6.346100000000454,
        6.387100000000467, 6.410100000000475,
    ),
    "fcfs_seed1": (
        6.312100000000442, 6.318100000000444, 6.33510000000045,
        6.36510000000046, 6.36610000000046, 6.393100000000469,
        6.376100000000464, 6.343100000000453,
    ),
    "bs_seed0": (
        4.909099999999974, 4.909099999999974, 4.909099999999974,
        4.909099999999974, 4.909099999999974, 4.909099999999974,
        4.909099999999974, 4.909099999999974,
    ),
    "bs_seed1": (
        4.909099999999974, 4.909099999999974, 4.909099999999974,
        4.909099999999974, 4.909099999999974, 4.909099999999974,
        4.909099999999974, 4.909099999999974,
    ),
}
SAVING_TOTALS = {
    "fcfs_total_s": 50.83280000000365,
    "bs_total_s": 39.27279999999979,
    "saving_pct": 22.741222202993004,
    "bs_analytic_s": 4.905560710894849,
}
OP_SYNC = {
    "fcfs_defer": (
        4.0, 3.850099999999687, 4.0,
        3.842099999999688, 4.0, 3.853099999999687,
    ),
    "fcfs_drop": (
        4.0, 4.0, 4.0,
        4.0, 4.0, 4.0,
    ),
    "fcfs_partial": (
        4.0, 4.0, 4.0,
        4.0, 4.0, 4.0,
    ),
    "fcfs_async": (
        3.9090999999996807, 0.13010000000000008, 0.11110000000000009,
        0.12610000000000007, 0.11510000000000009, 0.10410000000000008,
    ),
    "bs_defer": (
        4.0, 3.796099999999693, 4.0,
        3.796099999999693, 4.0, 3.796099999999693,
    ),
    "bs_drop": (
        4.0, 4.0, 4.0,
        4.0, 4.0, 4.0,
    ),
    "bs_partial": (
        4.0, 4.0, 4.0,
        4.0, 4.0, 4.0,
    ),
    "bs_async": (
        3.796099999999693, 0.01810000000000001, 0.01810000000000001,
        0.01810000000000001, 0.01810000000000001, 0.01810000000000001,
    ),
}
COSIM_SYNC = {
    "sync": (
        5.4501000000001545, 5.4501000000001545, 5.4501000000001545,
        5.4501000000001545,
    ),
    "defer": (
        3.5, 3.2920999999997487, 3.5,
        3.2920999999997487,
    ),
    "drop": (
        3.5, 3.5, 3.5,
        3.5,
    ),
    "partial": (
        3.5, 3.5, 3.5,
        3.5,
    ),
    "async": (
        3.2920999999997487, 1.3030999999999673, 1.305099999999967,
        1.305099999999967,
    ),
    "faulty": (3.5, 3.5, 3.5, 3.5),
    "faulty_quorum": (7.0, 5.4501000000001545, 3.5, 3.5),
}
# the faulty co-simulation modes' (arrived, failed, lost) clients a round
COSIM_FAULT_COUNTS = {
    "faulty": ((2, 1, 0), (3, 2, 0), (5, 0, 0), (4, 1, 0)),
    "faulty_quorum": ((5, 1, 0), (6, 2, 0), (5, 0, 0), (4, 1, 0)),
}
# fault_outcomes() of each cell of fault_cells() (tests/
# test_torch_fault_pins.py recomputes them with the JAX package)
FAULT_PINS = {'sync_d0.0_o0.0': ((4.0, (), (), (), (), 0),
                    (3.850099999999687, (), (), (), (), 0),
                    (4.0, (), (), (), (), 0),
                    (3.842099999999688, (), (), (), (), 0),
                    (4.0, (), (), (), (), 0),
                    (3.853099999999687, (), (), (), (), 0)),
 'async_d0.0_o0.0': ((3.9090999999996807, (), (), (), (), 0),
                     (0.13010000000000008, (), (), (), (), 0),
                     (0.11110000000000009, (), (), (), (), 0),
                     (0.12610000000000007, (), (), (), (), 0),
                     (0.11510000000000009, (), (), (), (), 0),
                     (0.10410000000000008, (), (), (), (), 0)),
 'quorum_d0.0_o0.0': ((5.058100000000024, (), (), (), (), 1),
                      (5.045100000000019, (), (), (), (), 1),
                      (5.072100000000028, (), (), (), (), 1),
                      (5.044100000000019, (), (), (), (), 1),
                      (5.073100000000029, (), (), (), (), 1),
                      (5.049100000000021, (), (), (), (), 1)),
 'sync_d0.0_o0.5': ((4.0, (), (), (), (), 0),
                    (0.26710000000000017, (), (), (), (), 0),
                    (4.0, (), (), (), (), 0),
                    (4.0, (), (), (), (), 0),
                    (4.0, (), (), (), (), 0),
                    (4.0, (), (), (), (), 0)),
 'async_d0.0_o0.5': ((5.161100000000058, (), (), (), (), 0),
                     (0.12810000000000007, (), (), (), (), 0),
                     (0.11110000000000009, (), (), (), (), 0),
                     (0.12610000000000007, (), (), (), (), 0),
                     (0.11510000000000009, (), (), (), (), 0),
                     (0.10410000000000008, (), (), (), (), 0)),
 'quorum_d0.0_o0.5': ((5.289100000000101, (), (), (), (), 1),
                      (5.045100000000019, (), (), (), (), 1),
                      (5.072100000000028, (), (), (), (), 1),
                      (5.812100000000275, (), (), (), (), 1),
                      (5.073100000000029, (), (), (), (), 1),
                      (5.3901000000001345, (), (), (), (), 1)),
 'sync_d0.2_o0.0': ((4.0,
                     ((4, 8370800.325779244),
                      (5, 0.0),
                      (8, 1407600.2954188734)),
                     (),
                     ((4, 1), (5, 1), (8, 1)),
                     (),
                     0),
                    (3.850099999999687,
                     ((10, 24431894.32673715),),
                     (),
                     ((10, 2),),
                     (),
                     0),
                    (4.0,
                     ((0, 0.0),
                      (8, 14567954.10994254),
                      (9, 5551688.35969083)),
                     (),
                     ((0, 3), (8, 3), (9, 3)),
                     (),
                     0),
                    (3.842099999999688,
                     ((6, 2000739.2139937729),),
                     (),
                     ((6, 4),),
                     (),
                     0),
                    (4.0,
                     ((4, 6480049.086054787),
                      (8, 23440153.384255245),
                      (11, 0.0)),
                     (),
                     ((4, 5), (8, 5), (11, 5)),
                     (),
                     0),
                    (4.0, ((3, 5108235.556380823),), (), ((3, 6),), (), 0)),
 'async_d0.2_o0.0': ((4.232099999999748,
                      ((4, 8370800.325779244),
                       (5, 0.0),
                       (8, 1407600.2954188734)),
                      (),
                      ((4, 1), (5, 1), (8, 1)),
                      (),
                      0),
                     (0.13010000000000008,
                      ((10, 0.0),),
                      (),
                      ((10, 2),),
                      (),
                      0),
                     (4.259099999999757,
                      ((0, 15616846.97411023),
                       (8, 14567954.10994254),
                       (9, 5551688.35969083)),
                      (),
                      ((0, 3), (8, 3), (9, 3)),
                      (),
                      0),
                     (0.12610000000000007, ((6, 0.0),), (), ((6, 4),), (), 0),
                     (2.964099999999785,
                      ((4, 6480049.086054787),
                       (8, 23440153.384255245),
                       (11, 0.0)),
                      (),
                      ((4, 5), (8, 5), (11, 5)),
                      (),
                      0),
                     (0.10410000000000008,
                      ((3, 0.0),),
                      (),
                      ((3, 6),),
                      (),
                      0)),
 'quorum_d0.2_o0.0': ((5.049100000000021,
                       ((4, 8370800.325779244),
                        (5, 2602602.047631517),
                        (8, 1407600.2954188734)),
                       (),
                       ((4, 1), (5, 1), (8, 1)),
                       (),
                       1),
                      (4.9290999999999805,
                       ((10, 24431894.32673715),),
                       (),
                       ((10, 2),),
                       (),
                       1),
                      (5.07610000000003,
                       ((0, 15616846.97411023),
                        (8, 14567954.10994254),
                        (9, 5551688.35969083)),
                       (),
                       ((0, 3), (8, 3), (9, 3)),
                       (),
                       1),
                      (5.021100000000011,
                       ((6, 2000739.2139937729),),
                       (),
                       ((6, 4),),
                       (),
                       1),
                      (5.073100000000029,
                       ((4, 6480049.086054787),
                        (8, 23440153.384255245),
                        (11, 10977771.06876485)),
                       (),
                       ((4, 5), (8, 5), (11, 5)),
                       (),
                       1),
                      (5.031100000000015,
                       ((3, 5108235.556380823),),
                       (),
                       ((3, 6),),
                       (),
                       1)),
 'sync_d0.2_o0.5': ((4.0,
                     ((4, 0.0), (5, 0.0), (8, 0.0)),
                     (),
                     ((4, 1), (5, 1), (8, 1)),
                     (),
                     0),
                    (0.26510000000000017,
                     ((10, 24431894.32673715),),
                     (),
                     ((10, 2),),
                     (),
                     0),
                    (4.0,
                     ((0, 0.0),
                      (8, 14567954.10994254),
                      (9, 5551688.35969083)),
                     (),
                     ((0, 3), (8, 3), (9, 3)),
                     (),
                     0),
                    (4.0, ((6, 2000739.2139937729),), (), ((6, 4),), (), 0),
                    (4.0,
                     ((4, 6480049.086054787),
                      (8, 23440153.384255245),
                      (11, 0.0)),
                     (),
                     ((4, 5), (8, 5), (11, 5)),
                     (),
                     0),
                    (4.0, ((3, 0.0),), (), ((3, 6),), (), 0)),
 'async_d0.2_o0.5': ((5.201100000000071,
                      ((4, 8370800.325779244),
                       (5, 0.0),
                       (8, 1407600.2954188734)),
                      (),
                      ((4, 1), (5, 1), (8, 1)),
                      (),
                      0),
                     (0.12810000000000007,
                      ((10, 0.0),),
                      (),
                      ((10, 2),),
                      (),
                      0),
                     (4.259099999999757,
                      ((0, 15616846.97411023),
                       (8, 14567954.10994254),
                       (9, 5551688.35969083)),
                      (),
                      ((0, 3), (8, 3), (9, 3)),
                      (),
                      0),
                     (0.12610000000000007, ((6, 0.0),), (), ((6, 4),), (), 0),
                     (2.964099999999785,
                      ((4, 6480049.086054787),
                       (8, 23440153.384255245),
                       (11, 0.0)),
                      (),
                      ((4, 5), (8, 5), (11, 5)),
                      (),
                      0),
                     (0.10410000000000008,
                      ((3, 0.0),),
                      (),
                      ((3, 6),),
                      (),
                      0)),
 'quorum_d0.2_o0.5': ((5.25610000000009,
                       ((4, 8370800.325779244),
                        (5, 2602602.047631517),
                        (8, 1407600.2954188734)),
                       (),
                       ((4, 1), (5, 1), (8, 1)),
                       (),
                       1),
                      (4.9290999999999805,
                       ((10, 24431894.32673715),),
                       (),
                       ((10, 2),),
                       (),
                       1),
                      (5.07610000000003,
                       ((0, 15616846.97411023),
                        (8, 14567954.10994254),
                        (9, 5551688.35969083)),
                       (),
                       ((0, 3), (8, 3), (9, 3)),
                       (),
                       1),
                      (5.773100000000262,
                       ((6, 2000739.2139937729),),
                       (),
                       ((6, 4),),
                       (),
                       1),
                      (5.073100000000029,
                       ((4, 6480049.086054787),
                        (8, 23440153.384255245),
                        (11, 10977771.06876485)),
                       (),
                       ((4, 5), (8, 5), (11, 5)),
                       (),
                       1),
                      (5.333100000000115,
                       ((3, 5108235.556380823),),
                       (),
                       ((3, 6),),
                       (),
                       1))}
# job_outcomes() of each run of jobs_specs() (tests/test_torch_jobs.py
# recomputes them with the JAX package)
JOBS_PINS = {'maxmin_j1': ((4.909099999999974, ((0, 4.909099999999974),)),),
 'maxmin_j2': ((4.909099999999974,
                ((0, 4.909099999999974), (1, 4.711099999999908))),),
 'maxmin_j4': ((4.909099999999974,
                ((0, 4.909099999999974),
                 (1, 4.711099999999908),
                 (2, 4.886099999999966),
                 (3, 4.874099999999962))),),
 'maxmin_j8': ((4.909099999999974,
                ((0, 4.909099999999974),
                 (1, 4.711099999999908),
                 (2, 4.886099999999966),
                 (3, 4.874099999999962),
                 (4, 3.6830999999997056),
                 (5, 4.334099999999782),
                 (6, 4.152099999999721),
                 (7, 4.064099999999692))),),
 'weighted_j1': ((4.909099999999974, ((0, 4.909099999999974),)),),
 'weighted_j2': ((4.909099999999974,
                  ((0, 4.909099999999974), (1, 4.711099999999908))),),
 'weighted_j4': ((4.909099999999974,
                  ((0, 4.909099999999974),
                   (1, 4.711099999999908),
                   (2, 4.886099999999966),
                   (3, 4.874099999999962))),),
 'weighted_j8': ((4.909099999999974,
                  ((0, 4.909099999999974),
                   (1, 4.711099999999908),
                   (2, 4.886099999999966),
                   (3, 4.874099999999962),
                   (4, 3.6830999999997056),
                   (5, 4.334099999999782),
                   (6, 4.152099999999721),
                   (7, 4.064099999999692))),),
 'fcfs_deadline_j4': ((5.270100000000094,
                       ((0, 5.186100000000066),
                        (1, 4.765099999999926),
                        (2, 5.009100000000007),
                        (3, 5.270100000000094))),),
 'cps4_weighted_j4': ((4.9140999999999755,
                       ((0, 4.9140999999999755),
                        (1, 4.714099999999909),
                        (2, 4.889099999999967),
                        (3, 4.877099999999963))),),
 'timeline_maxmin_j4': ((4.909099999999974,
                         ((0, 4.909099999999974), (1, 4.711099999999908))),
                        (4.909099999999974,
                         ((0, 4.909099999999974), (2, 4.886099999999966))),
                        (4.909099999999974,
                         ((0, 4.909099999999974), (1, 4.711099999999908))),
                        (4.909099999999974,
                         ((0, 4.909099999999974),
                          (2, 4.886099999999966),
                          (3, 4.874099999999962))))}

# benchmarks/faults.py's grid: the op point (OP_CLIENTS clients, FCFS,
# load 0.8, seed 1, 128 ONUs at 10 Gb/s) for FAULT_ROUNDS rounds under
# dropout x outage rates (no loss), in each aggregation mode; a cell with
# no fault runs faults=None, as the benchmark does
FAULT_ROUNDS, FAULT_SEED = 6, 3
FAULT_DROPOUTS, FAULT_OUTAGES = (0.0, 0.2), (0.0, 0.5)
FAULT_OUTAGE_S, FAULT_OUTAGE_START_MAX_S = 0.5, 2.0
FAULT_MODES = {"sync": {"deadline_s": 4.0},
               "async": {"buffer_k": 6},
               "quorum": {"deadline_s": 4.0, "deadline_policy": "drop",
                          "quorum_frac": 0.75}}
# phases a cell with 0.5 s outages re-runs on the per-cycle loop (none
# without outages): its upload phases whose outage outgrows the phase
# kernel's HISTORY_CYCLES-cycle background ring (the JAX program's, which
# the JAX engine re-runs the same way); in the d0.2 o0.5 cells every
# phase's exact flag is also held to the plain version's
FAULT_FALLBACKS = {"sync": 3, "async": 5, "quorum": 8}
# the smoke runs a cell with outages over its mode's first
# FAULT_OUTAGE_ROUNDS rounds (each fallback is ~10 s of the per-cycle loop
# on the card), which re-run FAULT_OUTAGE_FALLBACKS phases: sync re-runs
# its one in round 1 and keeps FAULT_LOOP_ROUNDS for the loop cell; async
# and quorum re-run 2 in round 1 (3 and 4 by round 2)
FAULT_OUTAGE_ROUNDS = {"sync": 3, "async": 1, "quorum": 1}
FAULT_OUTAGE_FALLBACKS = {"sync": 1, "async": 2, "quorum": 2}
FAULT_LOOP_CELL = ("sync", 0.2, 0.5)   # held on the per-cycle loop too,
FAULT_LOOP_ROUNDS = 3                  # over its first rounds
# accuracy_part's faulty co-simulation modes (COSIM_MODES' run arguments)
COSIM_FAULTS = {"seed": 3, "dropout_rate": 0.2, "loss_rate": 0.1,
                "outage_rate": 0.5, "outage_duration_s": 0.5,
                "outage_start_max_s": 2.0}
COSIM_FAULTY = {"faulty": None, "faulty_quorum": 0.5}   # quorum_frac
# FL_REF_GAP's loss half is not held in the faulty modes: their card runs'
# round losses differ from the CPU's by up to 5.4% on cuDNN's default
# (atomic, run to run different) algorithms at the smoke's weights, 3.95%
# over 3 weight seeds, and a run with the clients' float32 in TF32 (the
# lower-precision control) reads at most 3.2%: no limit tells it from a
# sound run (scripts/cosim_learning_spread.py, PERF.md). Their accuracy
# (sound runs within 0.027, the control 0.039) stays held at FL_REF_GAP,
# as a gate on gross errors, with their syncs, arrivals and fault counts
# benchmarks/jobs.py's grid: one BS round at 2048 ONUs (10 Gb/s), load
# 0.8, JOBS_CLIENTS clients a job, the primary job and half-sized tenants
# of weight 2, over jobs x fairness; then an FCFS case under "deadline"
# fairness (per-job soft deadlines), a 4-PON case under a binding CPS
# uplink and a cadenced timeline
JOBS_ONUS, JOBS_LOAD, JOBS_CLIENTS = 2048, 0.8, 8
JOBS_GRID, JOBS_FAIRNESS = (1, 2, 4, 8), ("maxmin", "weighted")
JOBS_DEADLINES = (6.0, 3.0, 4.5, None)
JOBS_CPS_PONS, JOBS_CPS_RATE = 4, 3e9
JOBS_CADENCE = ((1, 0), (2, 0), (2, 1), (4, 3))
JOBS_TL_ROUNDS = 4
# the collector (repro_torch.obs): benchmarks/obs_overhead.py's run (the
# Fig. 3 grid, OBS_ROUNDS elastic rounds, folded, 128 ONUs), collector off
# and on OBS_REPEATS times each (one pair: each run is ~19 s of the
# per-cycle loop on the card); OBS_PINS are the JAX package's values on
# the CPU for it, the Fig. 2b sweep, the jobs grid's per-job p95 and the
# faults loop cell (obs_pin; tests/test_torch_obs_pins.py recomputes them)
OBS_ROUNDS, OBS_REPEATS = 6, 1
OBS_SUM_RTOL = 1e-12   # bit totals and grant_utilization
OBS_PCT_TOL = 1e-9     # upload-delay percentiles (s)
OBS_BITS_RTOL = 1e-6   # a round's uploaded bits (the engines' contract)
OBS_PINS = {'overhead': {'phases': (('dl:fcfs', 12, 1856, 22272.0,
                                     204902400000.0, 109616364000.0,
                                     34182304000.0, 61103732000.0,
                                     0.7017910380747127),
                                    ('ul:fcfs', 12, 6378, 76536.0,
                                     704131200000.0, 377465060000.0,
                                     34182304000.0, 292483836000.0,
                                     0.5846174178903023),
                                    ('ul:bs', 12, 4909, 58908.0,
                                     541953600000.0, 0.0, 34182303999.99999,
                                     507771296000.0, 0.0630723811042126)),
                         'delay': {'bs@load0.3': (647.0, 2.8865853658536587,
                                                  4.733, 4.897956521739131),
                                   'bs@load0.8': (647.0, 2.8865853658536587,
                                                  4.733, 4.897956521739131),
                                   'fcfs@load0.3': (647.0, 3.154761904761905,
                                                    4.9226, 5.1906),
                                   'fcfs@load0.8': (647.0, 3.8676470588235294,
                                                    5.444166666666667,
                                                    6.136142857142857)},
                         'rounds': 24,
                         'spans': {'phase:dl:fcfs': 1,
                                   'phase:ul:bs': 1,
                                   'phase:ul:fcfs': 1,
                                   'timeline:folded': 1}},
            'fig2b': {'bs@load0.3': (280.0, 2.8944444444444444, 4.75,
                                     4.909099999999974),
                      'bs@load0.8': (280.0, 2.8944444444444444, 4.75,
                                     4.909099999999974),
                      'fcfs@load0.3': (280.0, 3.1833333333333336, 4.9,
                                       5.079999999999999),
                      'fcfs@load0.8': (280.0, 3.8499999999999996, 5.4,
                                       6.119999999999998)},
            'jobs': {'maxmin_j1': {'bs/job0@load0.8': (8.0,
                                                       4.909099999999974)},
                     'maxmin_j2': {'bs/job0@load0.8': (8.0, 4.909099999999974),
                                   'bs/job1@load0.8': (8.0,
                                                       4.711099999999908)},
                     'maxmin_j4': {'bs/job0@load0.8': (8.0, 4.909099999999974),
                                   'bs/job1@load0.8': (8.0, 4.711099999999908),
                                   'bs/job2@load0.8': (8.0, 4.86),
                                   'bs/job3@load0.8': (8.0, 4.86)},
                     'maxmin_j8': {'bs/job0@load0.8': (8.0, 4.909099999999974),
                                   'bs/job1@load0.8': (8.0, 4.711099999999908),
                                   'bs/job2@load0.8': (8.0, 4.86),
                                   'bs/job3@load0.8': (8.0, 4.86),
                                   'bs/job4@load0.8': (8.0, 3.66),
                                   'bs/job5@load0.8': (8.0, 4.334099999999782),
                                   'bs/job6@load0.8': (8.0, 4.152099999999721),
                                   'bs/job7@load0.8': (8.0, 4.06)},
                     'weighted_j1': {'bs/job0@load0.8': (8.0,
                                                         4.909099999999974)},
                     'weighted_j2': {'bs/job0@load0.8': (8.0,
                                                         4.909099999999974),
                                     'bs/job1@load0.8': (8.0,
                                                         4.711099999999908)},
                     'weighted_j4': {'bs/job0@load0.8': (8.0,
                                                         4.909099999999974),
                                     'bs/job1@load0.8': (8.0,
                                                         4.711099999999908),
                                     'bs/job2@load0.8': (8.0, 4.86),
                                     'bs/job3@load0.8': (8.0, 4.86)},
                     'weighted_j8': {'bs/job0@load0.8': (8.0,
                                                         4.909099999999974),
                                     'bs/job1@load0.8': (8.0,
                                                         4.711099999999908),
                                     'bs/job2@load0.8': (8.0, 4.86),
                                     'bs/job3@load0.8': (8.0, 4.86),
                                     'bs/job4@load0.8': (8.0, 3.66),
                                     'bs/job5@load0.8': (8.0,
                                                         4.334099999999782),
                                     'bs/job6@load0.8': (8.0,
                                                         4.152099999999721),
                                     'bs/job7@load0.8': (8.0, 4.06)},
                     'fcfs_deadline_j4': {'fcfs/job0@load0.8': (8.0, 5.16),
                                          'fcfs/job1@load0.8': (8.0, 4.76),
                                          'fcfs/job2@load0.8': (8.0,
                                                                5.009100000000007),
                                          'fcfs/job3@load0.8': (8.0, 5.26)},
                     'cps4_weighted_j4': {'bs/job0@load0.8': (8.0,
                                                              4.9140999999999755),
                                          'bs/job1@load0.8': (8.0,
                                                              4.714099999999909),
                                          'bs/job2@load0.8': (8.0, 4.86),
                                          'bs/job3@load0.8': (8.0, 4.86)},
                     'timeline_maxmin_j4': {'bs/job0@load0.8': (32.0,
                                                                4.909099999999974),
                                            'bs/job1@load0.8': (16.0,
                                                                4.711099999999908),
                                            'bs/job2@load0.8': (16.0, 4.86),
                                            'bs/job3@load0.8': (8.0, 4.86)}},
            'faults': {'events': {'fault.dropout': 7},
                       'rounds': ((('load', 0.8), ('n_arrived', 0),
                                   ('n_deferred', 9), ('n_dropped', 0),
                                   ('n_partial', 0), ('policy', 'fcfs'),
                                   ('round', 0), ('seed', 1),
                                   ('sync_time', 4.0), ('t_end', 4.0),
                                   ('t_start', 0.0), ('ul_bits', 0.0)),
                                  (('load', 0.8), ('n_arrived', 11),
                                   ('n_deferred', 0), ('n_dropped', 0),
                                   ('n_partial', 0), ('policy', 'fcfs'),
                                   ('round', 1), ('seed', 1),
                                   ('sync_time', 0.26510000000000017),
                                   ('t_end', 4.2651), ('t_start', 4.0),
                                   ('ul_bits', 315007894.32673717)),
                                  (('load', 0.8), ('n_arrived', 4),
                                   ('n_deferred', 5), ('n_dropped', 0),
                                   ('n_partial', 0), ('policy', 'fcfs'),
                                   ('round', 2), ('seed', 1),
                                   ('sync_time', 4.0), ('t_end', 8.2651),
                                   ('t_start', 4.2651),
                                   ('ul_bits', 125783642.46963337)))}}


def _elastic(rounds: int, n_clients: int):
    """``benchmarks/timeline.py::elastic_schedule``'s membership mask."""
    memb = (np.random.default_rng(FIG3_MEMBERSHIP_SEED).random(
        (rounds, n_clients)) < FIG3_PARTICIPATION)
    memb[0] = True
    return memb


def _timeline_setup(short: bool):
    """``(PONConfig, workload of n clients)``: full size, or the short
    timelines' 16 ONUs at 1 Gb/s with clients ready within 0.5 s."""
    from repro_torch.net import FLRoundWorkload, PONConfig

    if short:
        return (PONConfig(n_onus=SHORT_ONUS, line_rate_bps=1e9),
                _short_workload(range(SHORT_ONUS), 7))
    return PONConfig(n_onus=N_ONUS), FLRoundWorkload(
        clients=_clients(N_ONUS, N_ONUS), model_bits=M_BITS)


def fig3_spec(backend=None, short=False):
    """The Fig. 3 grid, folded: 4 cases x ``FIG3_ROUNDS`` elastic rounds
    in one stacked simulation (names in ``FIG3_SYNC`` order)."""
    from repro_torch.net import SweepCase, SweepSpec, TimelineSchedule

    cfg, wl = _timeline_setup(short)
    rounds = SHORT_ROUNDS if short else FIG3_ROUNDS
    cases = tuple(SweepCase(workload=wl, load=load, policy=policy, seed=0)
                  for policy, load in FIG3_GRID)
    sched = TimelineSchedule(n_rounds=rounds,
                             membership=_elastic(rounds, len(wl.clients)))
    return SweepSpec(cases=cases, pon=cfg, schedule=sched, mode="folded",
                     backend=backend)


def saving_spec(backend=None, short=False):
    """``training_time_saving.py``'s timeline: {fcfs, bs} x seeds {0, 1}
    at load 0.8, ``SAVING_ROUNDS`` rounds (``SAVING_SYNC`` order)."""
    from repro_torch.net import SweepCase, SweepSpec, TimelineSchedule

    cfg, wl = _timeline_setup(short)
    cases = tuple(SweepCase(workload=wl, load=0.8, policy=policy, seed=s)
                  for policy in ("fcfs", "bs") for s in range(SAVING_SEEDS))
    sched = TimelineSchedule(n_rounds=SHORT_ROUNDS if short
                             else SAVING_ROUNDS)
    return SweepSpec(cases=cases, pon=cfg, schedule=sched, backend=backend)


def op_point_spec(mode: str, backend=None, short=False):
    """The op point's 12 clients, FCFS and BS at load 0.8, seed 1, under
    ``OP_MODES[mode]`` for ``OP_ROUNDS`` rounds (the short one: 12 of 16
    ONUs, 3 rounds, deadlines at ``SHORT_DEADLINE``)."""
    from repro_torch.net import (
        FLRoundWorkload,
        PONConfig,
        SweepCase,
        SweepSpec,
        TimelineSchedule,
    )

    kw = dict(OP_MODES[mode])
    if short:
        cfg = PONConfig(n_onus=SHORT_ONUS, line_rate_bps=1e9)
        wl = _short_workload(range(OP_CLIENTS), 8)
        if "deadline_s" in kw:
            kw["deadline_s"] = SHORT_DEADLINE
    else:
        cfg = PONConfig(n_onus=N_ONUS)
        wl = FLRoundWorkload(clients=_clients(OP_CLIENTS, N_ONUS),
                             model_bits=M_BITS)
    cases = tuple(SweepCase(workload=wl, load=0.8, policy=policy, seed=1)
                  for policy in ("fcfs", "bs"))
    sched = TimelineSchedule(n_rounds=SHORT_ROUNDS if short else OP_ROUNDS,
                             **kw)
    return SweepSpec(cases=cases, pon=cfg, schedule=sched, backend=backend)


def wide_timeline_spec(backend=None):
    """``stacked_run``'s timeline: 100 PONs x 1,024 ONUs in one case (80
    Gb/s a PON), 1,024 clients, FCFS at load 0.05, seed 0,
    ``WIDE_TL_ROUNDS`` elastic rounds, folded."""
    import dataclasses

    from repro_torch.net import TimelineSchedule

    spec = wide_pons_spec(backend)
    case = dataclasses.replace(spec.cases[0], load=WIDE_TL_LOAD)
    sched = TimelineSchedule(n_rounds=WIDE_TL_ROUNDS,
                             membership=_elastic(WIDE_TL_ROUNDS, WIDE_ONUS))
    return dataclasses.replace(spec, cases=(case,), schedule=sched)


def _port_types():
    """The port's ``(net, ClientProfile)``; the spec builders below take
    the JAX package's instead when its tests recompute the pins."""
    from repro_torch import net
    from repro_torch.core.slicing import ClientProfile

    return net, ClientProfile


def fault_cells():
    """``(name, mode, dropout, outage)`` of the fault grid, pin order."""
    return [(f"{mode}_d{d}_o{o}", mode, d, o) for d in FAULT_DROPOUTS
            for o in FAULT_OUTAGES for mode in FAULT_MODES]


def faults_spec(mode: str, dropout: float, outage: float, backend=None,
                rounds: int = FAULT_ROUNDS, trivial: bool = False,
                types=None):
    """``benchmarks/faults.py``'s cell: the op point under
    ``FAULT_MODES[mode]`` and ``FaultSchedule(seed=3, dropout, outage,
    0.5 s windows starting within 2 s)``; ``faults=None`` when both rates
    are 0 (``trivial``: the all-zero schedule instead)."""
    net, profile = types or _port_types()
    faults = net.FaultSchedule(
        seed=FAULT_SEED, dropout_rate=dropout, loss_rate=0.0,
        outage_rate=outage, outage_duration_s=FAULT_OUTAGE_S,
        outage_start_max_s=FAULT_OUTAGE_START_MAX_S)
    if faults.trivial and not trivial:
        faults = None
    t_uds = np.random.default_rng(42).uniform(1.0, 5.0, N_ONUS)
    wl = net.FLRoundWorkload(clients=[profile(
        client_id=i, t_ud=float(t_uds[i]), t_dl=0.0, m_ud_bits=M_BITS)
        for i in range(OP_CLIENTS)], model_bits=M_BITS)
    case = net.SweepCase(workload=wl, load=0.8, policy="fcfs", seed=1)
    sched = net.TimelineSchedule(n_rounds=rounds, faults=faults,
                                 **FAULT_MODES[mode])
    return net.SweepSpec(cases=(case,), pon=net.PONConfig(n_onus=N_ONUS),
                         schedule=sched, backend=backend)


def jobs_case(n_jobs: int, fairness: str, policy: str = "bs", ids=None,
              topology=None, deadlines=None, cadence=None, types=None):
    """``benchmarks/jobs.py::_case``: the primary job and ``n_jobs - 1``
    half-sized tenants of weight 2, ``JOBS_CLIENTS`` clients each (ids
    ``ids``, by default 0, 1, ...; compute times uniform in [1, 5] s from
    seed 42), with optional per-job soft deadlines and cadences."""
    net, profile = types or _port_types()
    rng = np.random.default_rng(42)
    ids = list(range(n_jobs * JOBS_CLIENTS)) if ids is None else ids
    jobs, clients = [], []
    for j in range(n_jobs):
        cids = ids[j * JOBS_CLIENTS:(j + 1) * JOBS_CLIENTS]
        mb = M_BITS if j == 0 else 0.5 * M_BITS
        period, phase = cadence[j] if cadence else (1, 0)
        jobs.append(net.JobSpec(
            job_id=j, clients=tuple(cids), model_bits=mb,
            weight=1.0 if j == 0 else 2.0,
            deadline_s=deadlines[j] if deadlines else None,
            period=period, phase=phase))
        clients.extend(profile(client_id=i, t_ud=float(rng.uniform(1.0, 5.0)),
                               t_dl=0.0, m_ud_bits=mb) for i in cids)
    return net.SweepCase(
        workload=net.FLRoundWorkload(clients=clients, model_bits=M_BITS),
        load=JOBS_LOAD, policy=policy, seed=0, jobs=tuple(jobs),
        fairness=fairness, topology=topology)


def jobs_specs(backend=None, types=None) -> dict:
    """name -> the jobs phase's specs: the grid, the FCFS deadline case,
    the 4-PON CPS case and the cadenced timeline."""
    net, _ = types or _port_types()
    cfg = net.PONConfig(n_onus=JOBS_ONUS)

    def spec(case, pon=cfg, schedule=None):
        return net.SweepSpec(cases=(case,), pon=pon, schedule=schedule,
                             backend=backend)

    out = {f"{fair}_j{n}": spec(jobs_case(n, fair, types=types))
           for fair in JOBS_FAIRNESS for n in JOBS_GRID}
    out["fcfs_deadline_j4"] = spec(jobs_case(
        4, "deadline", "fcfs", deadlines=JOBS_DEADLINES, types=types))
    topo = net.MultiPonTopology(n_pons=JOBS_CPS_PONS,
                                cps_rate_bps=JOBS_CPS_RATE)
    out["cps4_weighted_j4"] = spec(jobs_case(
        4, "weighted", ids=list(range(0, JOBS_ONUS, JOBS_ONUS // 32)),
        topology=topo, types=types),
        net.PONConfig(n_onus=JOBS_ONUS // JOBS_CPS_PONS))
    out["timeline_maxmin_j4"] = spec(
        jobs_case(4, "maxmin", cadence=JOBS_CADENCE, types=types),
        schedule=net.TimelineSchedule(n_rounds=JOBS_TL_ROUNDS))
    return out


def obs_spec(types=None):
    """``benchmarks/obs_overhead.py``'s run: ``fig3_cases()``,
    ``elastic_schedule(OBS_ROUNDS)``, folded, 128 ONUs at 10 Gb/s."""
    net, profile = types or _port_types()
    t_uds = np.random.default_rng(42).uniform(1.0, 5.0, N_ONUS)
    wl = net.FLRoundWorkload(clients=[profile(
        client_id=i, t_ud=float(t_uds[i]), t_dl=0.0, m_ud_bits=M_BITS)
        for i in range(N_ONUS)], model_bits=M_BITS)
    cases = tuple(net.SweepCase(workload=wl, load=load, policy=policy,
                                seed=0) for policy, load in FIG3_GRID)
    sched = net.TimelineSchedule(n_rounds=OBS_ROUNDS,
                                 membership=_elastic(OBS_ROUNDS, N_ONUS))
    return net.SweepSpec(cases=cases, pon=net.PONConfig(n_onus=N_ONUS),
                         schedule=sched, mode="folded")


def _delays(report, jobs: bool = False) -> dict:
    """``(n, p50, p95, p99)`` of each upload-delay histogram (the jobs'
    ``<policy>/job<id>`` keys alone with ``jobs``, ``(n, p95)`` there)."""
    if jobs:
        return {k: (v["n"], v["p95"]) for k, v in
                report.delay_percentiles.items() if "/job" in k}
    return {k: (v["n"], v["p50"], v["p95"], v["p99"])
            for k, v in report.delay_percentiles.items()}


def obs_pin(cell: str, collector) -> dict:
    """What ``OBS_PINS[cell]`` holds of a run's collector (either
    package's): ``overhead``: each phase's label, rows, cycles,
    utilisation-histogram n, bit totals and ``grant_utilization``, the
    delay percentiles, the rounds recorded and the spans by name;
    ``fig2b``: the delay percentiles; ``jobs``: each job's (n, p95);
    ``faults``: the events by kind and every ``record_round``'s fields."""
    import collections

    rep = collector.report()
    if cell == "overhead":
        return {"phases": tuple(
            (p["label"], p["rows"], p["cycles"], p["util_hist"]["n"],
             p["cap_bits"], p["bg_grant_bits"], p["fl_grant_bits"],
             p["residual_bits"], p["grant_utilization"])
            for p in rep.phases),
            "delay": _delays(rep), "rounds": len(rep.rounds),
            "spans": dict(sorted(collections.Counter(
                e["name"] for e in collector.tracer.events).items()))}
    if cell == "fig2b":
        return _delays(rep)
    if cell == "jobs":
        return _delays(rep, jobs=True)
    return {"events": dict(sorted(collections.Counter(
        e["kind"] for e in collector.events).items())),
        "rounds": tuple(tuple(sorted(r.items())) for r in rep.rounds)}


def _near(a, b, rtol: float = 0.0, atol: float = 0.0) -> bool:
    return abs(a - b) <= atol + rtol * abs(b)


def _hold_obs(cell: str, got: dict, want: dict, what: str) -> None:
    """``got`` (``obs_pin(cell, ...)`` of a card run) against its pin
    ``want``: labels, rows, cycles, counts, spans and events exactly, bit
    totals and ``grant_utilization`` within ``OBS_SUM_RTOL``, percentiles
    within ``OBS_PCT_TOL``, a round's times within ``SYNC_TOL`` and its
    bits within ``OBS_BITS_RTOL``."""

    def delays(g, w):
        return g.keys() == w.keys() and all(
            g[k][0] == w[k][0] and all(_near(a, b, atol=OBS_PCT_TOL)
                                       for a, b in zip(g[k][1:], w[k][1:]))
            for k in w)

    if cell == "overhead":
        ok = (len(got["phases"]) == len(want["phases"]) and all(
            g[:4] == w[:4] and all(_near(a, b, OBS_SUM_RTOL)
                                   for a, b in zip(g[4:], w[4:]))
            for g, w in zip(got["phases"], want["phases"]))
            and delays(got["delay"], want["delay"])
            and got["rounds"] == want["rounds"]
            and got["spans"] == want["spans"])
    elif cell in ("fig2b", "jobs"):
        ok = delays(got, want)
    else:
        def field(k, a, b):
            if k in ("sync_time", "t_start", "t_end"):
                return _near(a, b, atol=SYNC_TOL)
            if k == "ul_bits":
                return _near(a, b, OBS_BITS_RTOL)
            return a == b

        ok = got["events"] == want["events"] and len(got["rounds"]) == len(
            want["rounds"]) and all(
            [k for k, _ in g] == [k for k, _ in w] and all(
                field(k, a, b) for (k, a), (_, b) in zip(g, w))
            for g, w in zip(got["rounds"], want["rounds"]))
    if not ok:
        raise SystemExit(f"{what}: collector report {got} != {want}")


def _timeline_run(spec, record=None, collector=None):
    """``spec`` through ``simulate`` on the card: ``(results, stats)``,
    stats the wall, the round engine's counts, and for each launch of the
    phase kernel its device ms (CUDA events around the launch), cycles
    and CTAs, and the host ms of each phase's tables and copy in
    (``ops.phase_inputs``). The device's busy share is the phases' ms
    over the wall. ``record`` (a list) gets each ``run_phase_device``
    call, as :func:`_record_phases` returns them. For each phase that
    fell back to the per-cycle loop the stats hold its longest outage
    window in cycles (0 without one). ``collector`` goes to ``simulate``."""
    from repro_torch.kernels.ponsim import kernel, ops
    from repro_torch.net import engine, simulate

    launch, inputs = kernel.launch_phase, ops.phase_inputs
    run_phase = engine.run_phase_device
    timed, host, fell = [], [], []

    def recorded(*args, **kwargs):
        if record is not None:
            record.append((args, {k: v for k, v in kwargs.items()
                                  if k != "device"}))
        out = run_phase(*args, **kwargs)
        if out is None:
            dark = kwargs.get("outage_row")
            fell.append(0.0 if dark is None else float(np.max(np.where(
                np.isfinite(dark[:, 0]), dark[:, 1] - dark[:, 0], 0.0)))
                / args[0].cycle_time_s)
        return out

    def timed_launch(sc, dyn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state = launch(sc, dyn)
        end.record()
        timed.append((start, end, state["k_stop"], sc.R // sc.P))
        return state

    def timed_inputs(*args, **kwargs):
        t_in = time.perf_counter()
        out = inputs(*args, **kwargs)
        host.append((time.perf_counter() - t_in) * 1e3)
        return out

    _reset_round_counts()
    kernel.launch_phase, ops.phase_inputs = timed_launch, timed_inputs
    engine.run_phase_device = recorded
    try:
        torch.cuda.synchronize()
        t_run = time.time()
        results = simulate(spec, collector=collector, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t_run
    finally:
        kernel.launch_phase, ops.phase_inputs = launch, inputs
        engine.run_phase_device = run_phase
    ms = [s.elapsed_time(e) for s, e, _, _ in timed]
    cycles = [int(k.max()) for _, _, k, _ in timed]
    return results, {
        "wall_s": wall, "counts": _round_counts(), "ms": ms,
        "cycles": cycles, "ctas": [c for _, _, _, c in timed],
        "us_per_cycle": [m * 1e3 / max(c, 1) for m, c in zip(ms, cycles)],
        "host_ms": host, "busy": sum(ms) / (wall * 1e3),
        "fallback_outage_cycles": fell}


def _print_run(what: str, stats) -> None:
    c = stats["counts"]
    print(f"  {what}: wall {stats['wall_s']:.3f}s; phase launches "
          f"{c['phase']}, phase_fallbacks {c['fallbacks']}, K1 {c['k1']}, "
          f"K2 {c['k2']}; device busy {stats['busy']:.3f}; phase ms "
          f"{','.join(f'{m:.2f}' for m in stats['ms'])}; CTAs "
          f"{','.join(str(n) for n in stats['ctas'])}; us a cycle "
          f"{','.join(f'{u:.3f}' for u in stats['us_per_cycle'])}; host "
          f"tables+copy ms {sum(stats['host_ms']):.2f}", flush=True)


def _hold_timeline_counts(stats, what: str, jit: bool) -> None:
    """A jit run launched the phase kernel and, unless a phase fell back
    to the per-cycle loop, no standalone K1/K2; a per-cycle run launched
    K1 and K2 and no phase."""
    c = stats["counts"]
    if jit:
        bad = c["phase"] < 1 or (not c["fallbacks"] and (c["k1"]
                                                        or c["k2"]))
    else:
        bad = c["phase"] or not (c["k1"] and c["k2"])
    if bad:
        raise SystemExit(f"{what}: engine counts {c}")


def _hold_timeline(what: str, results, names, pins) -> None:
    """Every round's sync of every case within ``SYNC_TOL`` of its pin."""
    for name, tl in zip(names, results):
        got, want = tl.sync_times.tolist(), pins[name]
        if len(got) != len(want) or not all(
                math.isfinite(g) and abs(g - w) <= SYNC_TOL
                for g, w in zip(got, want)):
            raise SystemExit(f"{what} {name}: syncs {got} != {list(want)}")


def _hold_rounds(what: str, got, want, names) -> None:
    """Every round of every case of timelines ``got`` against ``want``'s:
    the same arrivals, and the sync, every client's times and left-over
    bits as :func:`_hold_round` holds them."""
    for name, a_tl, b_tl in zip(names, got, want):
        if len(a_tl.rounds) != len(b_tl.rounds):
            raise SystemExit(f"{what} {name}: {len(a_tl.rounds)} rounds != "
                             f"{len(b_tl.rounds)}")
        for r, (a, b) in enumerate(zip(a_tl.rounds, b_tl.rounds)):
            at = f"{what} {name} round {r}"
            if a.arrived != b.arrived or (a.result is None) != (
                    b.result is None):
                raise SystemExit(f"{at}: arrivals {a.arrived} != "
                                 f"{b.arrived}")
            if a.result is None:
                if abs(a.sync_time - b.sync_time) > SYNC_TOL:
                    raise SystemExit(f"{at}: sync {a.sync_time!r} != "
                                     f"{b.sync_time!r}")
            else:
                _hold_round(at, a.result, b.result)


# what the short timelines' phases must have covered between them
TIMELINE_COVER = {
    "folded rows with dead columns": lambda run, sc, d: (
        run == "fig3" and bool((~d["part"].cpu()).any())),
    "carriers with no download": lambda run, sc, d: (
        run in ("op_defer", "op_async") and sc.mode == "fcfs"
        and bool((d["part"] & (d["rem0"] == 0.0)).any())),
    "a deadlined BS row": lambda run, sc, d: (
        sc.mode == "bs" and sc.has_deadline and bool(d["finite_dl"].any())),
    "an async round's free pass": lambda run, sc, d: (
        run == "op_async" and not sc.has_deadline),
    "an async round's cut pass": lambda run, sc, d: (
        run == "op_async" and sc.has_deadline),
}


def _short_timelines():
    return {"fig3": fig3_spec("jit", short=True),
            "saving": saving_spec("jit", short=True),
            **{f"op_{mode}": op_point_spec(mode, "jit", short=True)
               for mode in OP_MODES}}


def phase_timeline():
    """The multi-round timeline on the card (``repro_torch.net.simulate``
    with a ``TimelineSchedule``): (a) the Fig. 3 grid folded, through
    ``backend="jit"`` and the per-cycle loop, every round's sync held to
    its pin; (b) the training-time saving's timeline through jit, its
    rounds and totals held to their pins, beside the analytic BS time;
    (c) the op point under defer, drop, partial and async through jit,
    every round held to its pin; (d) ``stacked_run``'s wide timeline
    through jit, every round and client held to the per-cycle loop on the
    card; (e) every phase of the short timelines held to the plain
    version on CPU copies, covering ``TIMELINE_COVER``."""
    from repro_torch.core.round_model import bs_round_time
    from repro_torch.kernels.ponsim import kernel, ops
    from repro_torch.net import simulate

    t0 = time.time()
    out, by_path = {}, {}
    # (a) the Fig. 3 grid
    names = [f"{p}_load{load}" for p, load in FIG3_GRID]
    res, jit = _timeline_run(fig3_spec("jit"))
    _hold_timeline("fig3 jit", res, names, FIG3_SYNC)
    _hold_timeline_counts(jit, "fig3 jit", True)
    _print_run("fig3-timeline-24 jit", jit)
    # its three phases timed as k_phase times fig2b-16's (8 CTAs), for µs
    # a cycle at 48 CTAs against 8
    steady_ms, steady_us = [], []
    holds = _PhaseHolds()
    fig3_calls = _record_phases(fig3_spec("jit"), "cuda")
    holds.add("fig3", fig3_calls)
    for args, kwargs in fig3_calls:
        sc, tc = ops.phase_inputs(*args, **kwargs, use_k2=True,
                                  device="cuda")
        cycles = int(kernel.launch_phase(sc, tc)["k_stop"].max())
        steady_ms.append(_device_ms(kernel.launch_phase, [(sc, tc)],
                                    reps=3))
        steady_us.append(steady_ms[-1] * 1e3 / cycles)
    jit.update(steady_ms=steady_ms, steady_us_per_cycle=steady_us)
    print(f"  fig3-timeline-24 jit phases, back to back: ms "
          f"{','.join(f'{m:.4f}' for m in steady_ms)}; us a cycle "
          f"{','.join(f'{u:.3f}' for u in steady_us)}", flush=True)
    loop_res, loop = _timeline_run(fig3_spec())
    _hold_timeline("fig3 per-cycle", loop_res, names, FIG3_SYNC)
    _hold_timeline_counts(loop, "fig3 per-cycle", False)
    _hold_rounds("fig3 jit against the per-cycle loop", res, loop_res, names)
    _print_run("fig3-timeline-24 per-cycle", loop)
    by_path["fig3-timeline-24"] = jit["counts"]
    by_path["fig3-timeline-24-per-cycle"] = loop["counts"]
    out["fig3"] = {"jit": jit, "per_cycle": loop}

    # (b) the training-time saving
    names = [f"{p}_seed{s}" for p in ("fcfs", "bs")
             for s in range(SAVING_SEEDS)]
    res, saving = _timeline_run(saving_spec("jit"))
    _hold_timeline("saving", res, names, SAVING_SYNC)
    _hold_timeline_counts(saving, "saving", True)
    holds.add("saving", _record_phases(saving_spec("jit"), "cuda"))
    n = SAVING_SEEDS
    fcfs = float(np.mean([r.total_time_s for r in res[:n]]))
    bs = float(np.mean([r.total_time_s for r in res[n:]]))
    cfg, wl = _timeline_setup(False)
    got = {"fcfs_total_s": fcfs, "bs_total_s": bs,
           "saving_pct": 100.0 * (1 - bs / fcfs),
           "bs_analytic_s": bs_round_time(
               wl.clients, cfg.line_rate_bps * cfg.efficiency).sync_time}
    for key, want in SAVING_TOTALS.items():
        if abs(got[key] - want) > SYNC_TOL * SAVING_ROUNDS:
            raise SystemExit(f"saving {key}: {got[key]!r} != {want!r}")
    print(f"  time-saving-8: fcfs_total_s={got['fcfs_total_s']!r} "
          f"bs_total_s={got['bs_total_s']!r} "
          f"saving_pct={got['saving_pct']!r} "
          f"bs_analytic_s={got['bs_analytic_s']!r}", flush=True)
    _print_run("time-saving-8 jit", saving)
    by_path["time-saving-8"] = saving["counts"]
    out["saving"] = dict(got, **saving)

    # (c) the op point
    op_counts = dict.fromkeys(("phase", "k1", "k2", "fallbacks"), 0)
    for mode in OP_MODES:
        res, stats = _timeline_run(op_point_spec(mode, "jit"))
        _hold_timeline(f"op point {mode}", res,
                       [f"{p}_{mode}" for p in ("fcfs", "bs")], OP_SYNC)
        _hold_timeline_counts(stats, f"op point {mode}", True)
        _print_run(f"async-op-point {mode} jit", stats)
        holds.add(f"op_{mode}", _record_phases(op_point_spec(mode, "jit"),
                                               "cuda"))
        for key in op_counts:
            op_counts[key] += stats["counts"][key]
        out[f"op_{mode}"] = stats
    by_path["async-op-point"] = op_counts

    # (d) the wide timeline, against the per-cycle loop on the card
    res, wide = _timeline_run(wide_timeline_spec("jit"))
    _hold_timeline_counts(wide, "wide timeline jit", True)
    _print_run("wide-timeline-jit", wide)
    _reset_round_counts()
    t_run = time.time()
    loop_res = simulate(wide_timeline_spec(), device="cuda")
    torch.cuda.synchronize()
    wide_loop = {"wall_s": time.time() - t_run, "counts": _round_counts()}
    _hold_rounds("wide timeline", res, loop_res, ["fcfs"])
    print(f"  wide-timeline per-cycle: wall {wide_loop['wall_s']:.3f}s, "
          f"syncs {res[0].sync_times.tolist()}", flush=True)
    by_path["wide-timeline-jit"] = wide["counts"]
    by_path["wide-timeline-per-cycle"] = wide_loop["counts"]
    out["wide"] = dict(wide, per_cycle_wall_s=wide_loop["wall_s"],
                       syncs=res[0].sync_times.tolist())

    # every phase of (a)-(c) and of (e), the short timelines, held to the
    # plain version (the plain runs of (a)-(c) went on beside (b)-(d))
    t_hold = time.time()
    short = _short_timelines()
    for run, spec in short.items():
        holds.add(f"short_{run}", _record_phases(spec, "cuda"))
    checked = holds.finish()
    hold_s = time.time() - t_hold
    covered = {c for run in short for sc, tc, _, _ in checked[f"short_{run}"]
               for c, hit in TIMELINE_COVER.items() if hit(run, sc, tc)}
    missing = set(TIMELINE_COVER) - covered
    if missing:
        raise SystemExit(f"short timelines did not cover {sorted(missing)}")
    n_full = sum(len(v) for k, v in checked.items()
                 if not k.startswith("short_"))
    n_short = sum(len(v) for v in checked.values()) - n_full
    err = max(e for v in checked.values() for _, _, e, _ in v)
    print(f"  phases held to the plain version: "
          f"{', '.join(f'{k} {len(v)}' for k, v in checked.items())}; "
          f"hold wall {hold_s:.1f}s", flush=True)
    out["short"] = {"phases_held": n_short, "full_phases_held": n_full,
                    "max_abs_err": err, "hold_s": hold_s}
    _line("timeline", time.time() - t0, fig3_rounds_held=4 * FIG3_ROUNDS,
          fig3_jit_wall_s=f"{jit['wall_s']:.3f}",
          fig3_loop_wall_s=f"{loop['wall_s']:.3f}",
          saving_pct=f"{got['saving_pct']:.4f}",
          op_rounds_held=2 * len(OP_MODES) * OP_ROUNDS,
          wide_syncs=",".join(repr(s) for s in out["wide"]["syncs"]),
          fig3_clients_match="yes", wide_clients_match="yes",
          full_phases_held=n_full, short_phases_held=n_short,
          short_covered=len(covered), done_t_bitwise="yes",
          rem_max_abs_err=f"{err:.3g}", hold_s=f"{hold_s:.1f}",
          phase_fallbacks=sum(c["fallbacks"] for c in by_path.values()))
    return out, by_path


def _curve(res, key: str) -> str:
    return "/".join(f"{r[key]:.4f}" for r in res.rounds)


def _cosim_runs(device, clients, test_batch, params, count, backend=None,
                modes=None):
    """Every mode of ``COSIM_MODES`` (or of ``modes``) through
    ``FLNetworkCoSim`` on ``device`` from ``params``, its network on the
    round engine's ``backend`` (given by the run's template ``spec``):
    mode -> (result, wall s)."""
    from repro_torch import fl
    from repro_torch.models import cnn
    from repro_torch.net import FaultSchedule, PONConfig, SweepCase, SweepSpec

    pon = PONConfig(n_onus=COSIM_ONUS, line_rate_bps=COSIM_RATE)
    spec = SweepSpec(cases=(SweepCase(workload=None, load=COSIM_LOAD,
                                      policy="bs"),),
                     pon=pon, backend=backend)
    out = {}
    for mode in modes or COSIM_MODES:
        kw = COSIM_MODES[mode]
        server = fl.CPSServer(
            global_params=params, clients=clients,
            selection=fl.SelectionConfig(strategy="all"),
            compression=fl.CompressorConfig(scheme="int8"),
            seed=COSIM_SERVER_SEED)
        faulty = ({} if mode not in COSIM_FAULTY else
                  {"faults": FaultSchedule(**COSIM_FAULTS),
                   "quorum_frac": COSIM_FAULTY[mode]})
        cfg = fl.CoSimConfig(
            policy="bs", total_load=COSIM_LOAD, model_bits=COSIM_MODEL_BITS,
            upload_bits=COSIM_UPLOAD_BITS, timing_seeds=1, pon=pon,
            **faulty)
        t_run = time.time()
        with count:
            res = fl.FLNetworkCoSim(server, cfg, device=device).run(
                COSIM_ROUNDS, eval_fn=lambda p: cnn.accuracy(p, test_batch),
                spec=spec, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        out[mode] = (res, time.time() - t_run)
    return out


def _cosim_cpu_mode(mode, clients, test_batch, params, threads: int):
    """One mode of :func:`_cosim_runs` on the CPU, in a worker process
    on ``threads`` threads: (result, wall s)."""
    torch.set_num_threads(threads)
    return _cosim_runs("cpu", clients, test_batch, params,
                       contextlib.nullcontext(), modes=(mode,))[mode]


def phase_cosim():
    """``accuracy_part``'s co-simulation (``FLNetworkCoSim``, BS at load
    0.8, int8 updates through K3/K3') on the card in every mode of
    ``COSIM_MODES``, its network through ``backend="jit"``: each round's
    sync held to its pin, K3 and K3' run 8 times an update, the phase
    kernel at least as often as there are modes; and the same on the CPU
    (its network on the per-cycle loop), from the same initial weights,
    one mode a worker process beside the card's runs: syncs held to
    the pins, arrivals and staleness identical, every round's accuracy
    within ``FL_REF_GAP`` of the CPU's and its mean loss within
    ``FL_REF_GAP`` of it, relatively, but for the faulty modes' loss
    (see ``COSIM_FAULTY``); the faulty modes' arrivals, failed and lost
    clients a round held to ``COSIM_FAULT_COUNTS`` and to the CPU's.
    Prints ``time_to_metric`` and each mode's largest loss gap. Returns
    the card runs' launches of K3, K3' and the round engine's kernels."""
    import multiprocessing

    from repro_torch import fl
    from repro_torch._tree import tree_map
    from repro_torch.data import build_federated_cnn_clients
    from repro_torch.fl import server as server_mod
    from repro_torch.kernels.quant import kernel as k3
    from repro_torch.models import cnn

    t0 = time.time()
    clients, test = build_federated_cnn_clients(
        n_clients=COSIM_CLIENTS, samples_per_client=COSIM_SAMPLES,
        loss_fn=cnn.loss_fn,
        train_cfg=fl.LocalTrainConfig(lr=COSIM_LR, batch_size=COSIM_BATCH,
                                      local_epochs=COSIM_EPOCHS),
        seed=COSIM_DATA_SEED)
    test_batch = {k: v[:COSIM_TEST] for k, v in test.items()}
    params = cnn.init_params(torch.Generator(device="cuda").manual_seed(0))
    cpu_params = tree_map(lambda t: t.cpu(), params)
    workers = max(1, min(len(COSIM_MODES),
                         len(os.sched_getaffinity(0)) - 1))
    threads = max(1, (len(os.sched_getaffinity(0)) - 1) // workers)
    pool = multiprocessing.get_context("spawn").Pool(workers)
    cpu_runs = {mode: pool.apply_async(
        _cosim_cpu_mode, (mode, clients, test_batch, cpu_params, threads))
        for mode in COSIM_MODES}
    updates = [0]
    compress = server_mod.compress_delta

    def counted(*args, **kwargs):
        updates[0] += 1
        return compress(*args, **kwargs)

    k3.quantize_launches = k3.dequantize_launches = 0
    _reset_round_counts()
    card = _cosim_runs("cuda", clients, test_batch, params,
                       mock.patch.object(server_mod, "compress_delta",
                                         counted), backend="jit")
    launches = (k3.quantize_launches, k3.dequantize_launches)
    engine_counts = _round_counts()
    if launches != (8 * updates[0],) * 2 or not updates[0]:
        raise SystemExit(f"cosim: K3/K3' ran {launches} times for "
                         f"{updates[0]} updates")
    if engine_counts["phase"] < len(COSIM_MODES):
        raise SystemExit(f"cosim: engine counts {engine_counts}")
    cpu = {mode: run.get() for mode, run in cpu_runs.items()}
    pool.close()
    pool.join()
    out = {}
    for mode, (res, wall) in card.items():
        want = COSIM_SYNC[mode]
        ref, cpu_wall = cpu[mode]
        for where, got in (("card", res), ("CPU", ref)):
            syncs = [r["sync_time_s"] for r in got.rounds]
            if len(syncs) != len(want) or not all(
                    abs(a - b) <= SYNC_TOL for a, b in zip(syncs, want)):
                raise SystemExit(f"cosim {mode} on the {where}: syncs "
                                 f"{syncs} != {list(want)}")
        syncs = [r["sync_time_s"] for r in res.rounds]
        worst = 0.0
        for a, b in zip(res.rounds, ref.rounds):
            if (a["n_arrived"], a.get("staleness"), a.get("n_failed"),
                    a.get("n_lost")) != (b["n_arrived"], b.get("staleness"),
                                         b.get("n_failed"), b.get("n_lost")):
                raise SystemExit(f"cosim {mode} round {a['round']}: "
                                 f"arrivals differ from the CPU's")
            loss_gap = abs(a["mean_loss"] - b["mean_loss"]) / abs(
                b["mean_loss"])
            worst = max(worst, loss_gap)
            if (abs(a["eval_metric"] - b["eval_metric"]) > FL_REF_GAP
                    or (loss_gap > FL_REF_GAP
                        and mode not in COSIM_FAULTY)):
                raise SystemExit(
                    f"cosim {mode} round {a['round']}: accuracy "
                    f"{a['eval_metric']} loss {a['mean_loss']} against the "
                    f"CPU's {b['eval_metric']} {b['mean_loss']}")
        if mode in COSIM_FAULTY:
            counts = tuple((r["n_arrived"], r["n_failed"], r["n_lost"])
                           for r in res.rounds)
            if counts != COSIM_FAULT_COUNTS[mode]:
                raise SystemExit(f"cosim {mode}: (arrived, failed, lost) "
                                 f"{counts} != {COSIM_FAULT_COUNTS[mode]}")
        ttm = res.time_to_metric(COSIM_TARGET)
        print(f"  cosim {mode}: syncs {syncs}; acc "
              f"{_curve(res, 'eval_metric')} (CPU "
              f"{_curve(ref, 'eval_metric')}); loss "
              f"{_curve(res, 'mean_loss')} (CPU {_curve(ref, 'mean_loss')});"
              f" arrived {[r['n_arrived'] for r in res.rounds]}; "
              f"time_to_metric({COSIM_TARGET}) {ttm!r} (CPU "
              f"{ref.time_to_metric(COSIM_TARGET)!r}); largest loss gap "
              f"{worst:.4f}; wall {wall:.2f}s (CPU {cpu_wall:.2f}s)",
              flush=True)
        out[mode] = {"syncs": syncs, "time_to_metric": ttm, "wall_s": wall}
    _line("cosim", time.time() - t0, modes=len(COSIM_MODES),
          rounds=COSIM_ROUNDS, updates=updates[0], k3_launches=launches[0],
          k3p_launches=launches[1], phase_launches=engine_counts["phase"],
          phase_fallbacks=engine_counts["fallbacks"],
          k1_launches=engine_counts["k1"], k2_launches=engine_counts["k2"],
          syncs_held="yes", learning_held="yes")
    return {"quantize_int8": launches[0], "dequantize_int8": launches[1],
            **engine_counts}, out


def fault_outcomes(tl) -> tuple:
    """A timeline's rounds as ``FAULT_PINS`` holds them: ``(sync, failed
    (client, served bits) pairs, lost, retry_at (client, due round)
    pairs, gave_up, deadline extensions)`` a round."""
    return tuple((float(r.sync_time),
                  tuple(sorted((int(c), float(b))
                               for c, b in r.failed.items())),
                  tuple(sorted(int(c) for c in r.lost)),
                  tuple(sorted((int(c), int(d))
                               for c, d in r.retry_at.items())),
                  tuple(sorted(int(c) for c in r.gave_up)),
                  int(r.deadline_extensions)) for r in tl.rounds)


def _hold_faults(what: str, tl, want) -> None:
    """Every round's sync within ``SYNC_TOL``, the failed clients, the
    lost, the retry rounds, the give-ups and the deadline extensions
    exactly, and each failed client's served bits within ``ROUND_RTOL``,
    against the pins ``want``."""
    got = fault_outcomes(tl)
    if len(got) != len(want):
        raise SystemExit(f"{what}: {len(got)} rounds != {len(want)}")
    for r, (g, w) in enumerate(zip(got, want)):
        same = (abs(g[0] - w[0]) <= SYNC_TOL and g[2:] == tuple(w[2:])
                and [c for c, _ in g[1]] == [c for c, _ in w[1]]
                and all(abs(a - b) <= ROUND_RTOL * abs(b)
                        for (_, a), (_, b) in zip(g[1], w[1])))
        if not same:
            raise SystemExit(f"{what} round {r}: {g} != {w}")


def _same_results(what: str, got, want) -> None:
    """Two timelines' rounds bit for bit: syncs and every client's
    times."""
    for a_tl, b_tl in zip(got, want):
        if a_tl.sync_times.tolist() != b_tl.sync_times.tolist():
            raise SystemExit(f"{what}: syncs {a_tl.sync_times.tolist()} "
                             f"!= {b_tl.sync_times.tolist()}")
        for a, b in zip(a_tl.rounds, b_tl.rounds):
            for field in ("dl_done", "ready", "ul_done"):
                x, y = getattr(a.result, field), getattr(b.result, field)
                if sorted(x) != sorted(y) or not np.array_equal(
                        [x[c] for c in sorted(x)], [y[c] for c in sorted(y)],
                        equal_nan=True):
                    raise SystemExit(f"{what} round {a.round_index}: "
                                     f"{field} differs")


def _hold_fallbacks(what: str, stats, mode: str, outage: float) -> None:
    """A fault cell re-ran ``FAULT_OUTAGE_FALLBACKS[mode]`` phases on the
    per-cycle loop in its ``FAULT_OUTAGE_ROUNDS[mode]`` rounds with outages
    (none without), each an upload phase whose outage outgrows the phase
    kernel's background ring."""
    from repro_torch.kernels.ponsim.ref import HISTORY_CYCLES

    want = FAULT_OUTAGE_FALLBACKS[mode] if outage else 0
    fell = stats["fallback_outage_cycles"]
    if (stats["counts"]["fallbacks"] != want or len(fell) != want
            or any(c < HISTORY_CYCLES for c in fell)):
        raise SystemExit(f"{what}: {stats['counts']['fallbacks']} phases "
                         f"fell back (outages {fell} cycles), not {want} "
                         f"upload phases with an outage past "
                         f"{HISTORY_CYCLES} cycles")


def phase_faults():
    """``benchmarks/faults.py``'s grid on the card (``repro_torch.net``
    timelines with a ``FaultSchedule``): the op point, 6 rounds (a cell
    with outages its mode's ``FAULT_OUTAGE_ROUNDS``), dropout {0, 0.2} x
    outage {0, 0.5} in the sync (deadline 4 s, defer), async (buffer 6)
    and quorum (drop, quorum 0.75) modes, all through ``backend="jit"``:
    every round held to ``FAULT_PINS`` (sync, failed, lost, retry rounds,
    give-ups, extensions), the phase kernel launched (and K1/K2 only
    where a phase fell back to the per-cycle loop: exactly
    ``FAULT_OUTAGE_FALLBACKS`` upload phases a cell with outages, each
    with an outage past the kernel's 128-cycle background ring); every
    phase of the three dropout 0.2 x outage 0.5 cells held
    to the plain version on CPU copies (``_hold_phases``); the all-zero
    schedule bit for bit ``faults=None``'s result in each mode; and
    ``FAULT_LOOP_CELL`` over ``FAULT_LOOP_ROUNDS`` rounds on the
    per-cycle loop, held to its pins and to the jit run client by
    client, with a collector (``repro_torch.obs``) whose fault events and
    round records are held to ``OBS_PINS["faults"]``."""
    import dataclasses

    from repro_torch.obs import Collector

    t0 = time.time()
    grid = dict.fromkeys(("phase", "k1", "k2", "fallbacks"), 0)
    out, jit_res = {}, {}
    holds = _PhaseHolds()
    n_rounds = 0
    for name, mode, d, o in fault_cells():
        calls = []
        rounds = FAULT_OUTAGE_ROUNDS[mode] if o else FAULT_ROUNDS
        n_rounds += rounds
        res, stats = _timeline_run(faults_spec(mode, d, o, "jit", rounds),
                                   calls)
        _hold_faults(f"faults {name} jit", res[0],
                     FAULT_PINS[name][:rounds])
        _hold_timeline_counts(stats, f"faults {name} jit", True)
        _hold_fallbacks(f"faults {name} jit", stats, mode, o)
        _print_run(f"faults {name} jit", stats)
        for key in grid:
            grid[key] += stats["counts"][key]
        out[name] = stats
        jit_res[name] = res
        if (d, o) == (FAULT_DROPOUTS[-1], FAULT_OUTAGES[-1]):
            holds.add(name, calls)
    for mode in FAULT_MODES:
        res, _ = _timeline_run(faults_spec(mode, 0.0, 0.0, "jit",
                                           trivial=True))
        _same_results(f"faults {mode} trivial schedule against None", res,
                      jit_res[f"{mode}_d0.0_o0.0"])
    mode, d, o = FAULT_LOOP_CELL
    name = f"{mode}_d{d}_o{o}"
    col = Collector(device="cuda")
    loop_res, loop = _timeline_run(faults_spec(mode, d, o,
                                               rounds=FAULT_LOOP_ROUNDS),
                                   collector=col)
    _hold_obs("faults", obs_pin("faults", col), OBS_PINS["faults"],
              f"faults {name} per-cycle")
    _hold_timeline_counts(loop, f"faults {name} per-cycle", False)
    _hold_faults(f"faults {name} per-cycle", loop_res[0],
                 FAULT_PINS[name][:FAULT_LOOP_ROUNDS])
    first = [dataclasses.replace(tl, rounds=tl.rounds[:FAULT_LOOP_ROUNDS])
             for tl in jit_res[name]]
    _hold_rounds(f"faults {name} jit against the per-cycle loop", first,
                 loop_res, [name])
    _print_run(f"faults {name} per-cycle, {FAULT_LOOP_ROUNDS} rounds",
               loop)
    t_hold = time.time()
    checked = holds.finish()
    hold_s = time.time() - t_hold
    n_held = sum(len(v) for v in checked.values())
    err = max(e for v in checked.values() for _, _, e, _ in v)
    n_failed = sum(len(r.failed) for tl in jit_res.values()
                   for r in tl[0].rounds)
    _line("faults", time.time() - t0, cells=len(jit_res),
          rounds_held=n_rounds, failed=n_failed,
          retries=sum(len(r.retry_at) for tl in jit_res.values()
                      for r in tl[0].rounds),
          extensions=sum(r.deadline_extensions for tl in jit_res.values()
                         for r in tl[0].rounds),
          jit_wall_s=f"{sum(v['wall_s'] for v in out.values()):.3f}",
          loop_wall_s=f"{loop['wall_s']:.3f}",
          loop_rounds=FAULT_LOOP_ROUNDS, phases_held=n_held,
          rem_max_abs_err=f"{err:.3g}", hold_s=f"{hold_s:.1f}",
          trivial_bitwise="yes", phase_launches=grid["phase"],
          phase_fallbacks=grid["fallbacks"], fallbacks_held="yes",
          loop_obs_held="yes",
          loop_fault_events=sum(OBS_PINS["faults"]["events"].values()))
    return ({"jit": out, "per_cycle": loop, "phases_held": n_held,
             "max_abs_err": err},
            {"fault-grid-jit": grid, "fault-grid-per-cycle": loop["counts"]})


def job_outcomes(res) -> tuple:
    """A jobs run as ``JOBS_PINS`` holds it: ``(sync, (job, sync)
    pairs)`` a round (one for a round sweep's result)."""
    if hasattr(res, "rounds"):
        return tuple((float(r.sync_time), tuple(sorted(
            (int(j), float(v)) for j, v in r.job_sync.items())))
            for r in res.rounds)
    return ((float(res.sync_time), tuple(sorted(
        (int(j), float(v.sync_time)) for j, v in res.job_stats.items()))),)


def _phase_cycles(res, cyc: float) -> int:
    """A round's cycles: its FCFS download's and its upload's, counted
    from their last completions."""
    n = math.ceil(max(res.ul_done.values()) / cyc)
    if res.policy == "fcfs":
        n += math.ceil(max(res.dl_done.values()) / cyc)
    return n


def phase_jobs():
    """``benchmarks/jobs.py``'s grid on the card (one BS round at 2048
    ONUs, load 0.8, jobs {1, 2, 4, 8} x fairness {maxmin, weighted}), an
    FCFS case of 4 jobs under "deadline" fairness, a 4-PON case under a
    binding 3 Gb/s CPS and a cadenced 4-round timeline, each on the
    per-cycle loop and with ``backend="jit"`` (which runs the same loop
    for more than one job: the phase kernel has no job axis): every sync
    and every job's sync held to ``JOBS_PINS``, the two runs equal bit
    for bit with no phase launch, K1 and K2 launched by the FCFS case. A
    one-job cell is the single-tenant path, so its jit run launches the
    phase kernel and is held to the loop by ``_hold_round``. The loop run
    takes a collector (``repro_torch.obs``), whose per-job upload-delay
    p95 (``benchmarks/jobs.py``'s) is held to ``OBS_PINS["jobs"]``.
    Prints each job's sync and the loop's µs a cycle."""
    import dataclasses

    from repro_torch.net import simulate
    from repro_torch.obs import Collector

    t0 = time.time()
    by_path = {}
    cyc = 1e-3
    specs = jobs_specs()
    for name, spec in specs.items():
        runs = {}
        for backend in (None, "jit"):
            # the jit run takes no collector: the phase kernel refuses it
            col = Collector(device="cuda") if backend is None else None
            _reset_round_counts()
            torch.cuda.synchronize()
            t_run = time.time()
            res = simulate(dataclasses.replace(spec, backend=backend),
                           collector=col, device="cuda")
            torch.cuda.synchronize()
            runs[backend] = (res[0], time.time() - t_run, _round_counts())
            if col is not None:
                _hold_obs("jobs", obs_pin("jobs", col),
                          OBS_PINS["jobs"][name], f"jobs {name}")
        (res, wall, counts), (jres, jwall, jcounts) = runs[None], runs["jit"]
        got = job_outcomes(res)
        want = JOBS_PINS[name]
        if len(got) != len(want) or not all(
                abs(g[0] - w[0]) <= SYNC_TOL and len(g[1]) == len(w[1])
                and all(a[0] == b[0] and abs(a[1] - b[1]) <= SYNC_TOL
                        for a, b in zip(g[1], w[1]))
                for g, w in zip(got, want)):
            raise SystemExit(f"jobs {name}: {got} != {want}")
        rounds = res.rounds if hasattr(res, "rounds") else None
        pairs = ([(a.result, b.result) for a, b in zip(res.rounds,
                                                       jres.rounds)]
                 if rounds else [(res, jres)])
        single = len(spec.cases[0].jobs) == 1
        if single:
            # one job a case is the single-tenant path: jit runs the
            # phase kernel, held to the loop as timelines are
            for a, b in pairs:
                _hold_round(f"jobs {name} jit", b, a)
        elif job_outcomes(jres) != got or any(
                a.ul_done != b.ul_done for a, b in pairs):
            raise SystemExit(f"jobs {name}: jit {job_outcomes(jres)} "
                             f"differs from the per-cycle loop's {got}")
        fcfs = spec.cases[0].policy == "fcfs"
        for c, jit in ((counts, False), (jcounts, True)):
            phases = c["phase"] >= 1 if jit and single else not c["phase"]
            if not phases or c["fallbacks"] or (fcfs and not (
                    c["k1"] and c["k2"])):
                raise SystemExit(f"jobs {name}: engine counts {c}")
        n_cyc = sum(_phase_cycles(a, cyc) for a, _ in pairs)
        path = ("jobs-timeline" if rounds else "jobs-2048")
        for key, c in ((path, counts), (f"{path}-jit", jcounts)):
            acc = by_path.setdefault(key, dict.fromkeys(c, 0))
            for k, v in c.items():
                acc[k] += v
        print(f"  jobs {name}: syncs "
              f"{[(s, dict(j)) for s, j in got]}; wall {wall:.3f}s (jit "
              f"{jwall:.3f}s); K1 {counts['k1']}, K2 {counts['k2']}; "
              f"cycles {n_cyc}, us a cycle {wall * 1e6 / max(n_cyc, 1):.1f}",
              flush=True)
    _line("jobs", time.time() - t0, cases=len(specs),
          syncs_held="yes", jit_equals_loop="yes", job_p95_held="yes",
          k2_launches=by_path["jobs-2048"]["k2"],
          phase_launches=sum(c["phase"] for c in by_path.values()))
    return by_path


def phase_obs():
    """The collector (``repro_torch.obs``) on the card, on the per-cycle
    loop (K1 and K2 every cycle): (a) ``benchmarks/obs_overhead.py``'s
    measurement (``obs_spec``: the Fig. 3 grid, ``OBS_ROUNDS`` elastic
    rounds, folded, 128 ONUs), after a warm-up, collector off and on
    (with a ``SpanTracer``) in turn ``OBS_REPEATS`` times each: every
    run's syncs bit for bit the first's and within ``SYNC_TOL`` of
    ``FIG3_SYNC``'s first rounds, the on-run's report held to
    ``OBS_PINS["overhead"]`` (``_hold_obs``), its trace saved, loaded and
    validated, and the overhead (the better on-run over the better
    off-run, less 1; the reference's target is 10%) printed, not gated;
    (b) the Fig. 2b sweep under ``Collector(keep_phases=False)``, as
    ``benchmarks/fig2b_sync_time.py`` runs it: syncs held to
    ``SYNC_TABLE``, the upload-delay percentiles to
    ``OBS_PINS["fig2b"]``; (f) a collector on ``backend="jit"`` raises
    ``ValueError``, as in the reference. The jobs, faults and serve
    phases hold (c)-(e). Returns the engine counts of (a)'s and (b)'s
    runs with a collector."""
    import dataclasses
    import tempfile

    from repro_torch.net import PONConfig, SweepSpec, simulate
    from repro_torch.obs import (
        Collector,
        SpanTracer,
        load_trace,
        validate_trace,
    )

    t0 = time.time()
    spec = obs_spec()
    warm = dataclasses.replace(
        spec, cases=spec.cases[:1], mode="auto",
        schedule=dataclasses.replace(spec.schedule, n_rounds=1,
                                     membership=_elastic(1, N_ONUS)))
    simulate(warm, collector=Collector(device="cuda"), device="cuda")
    names = [f"{p}_load{l}" for p, l in FIG3_GRID]
    pins = {k: v[:OBS_ROUNDS] for k, v in FIG3_SYNC.items()}
    walls = {False: [], True: []}
    syncs, col, counts = [], None, None
    for _ in range(OBS_REPEATS):
        for on in (False, True):
            c = Collector(tracer=SpanTracer(), device="cuda") if on else None
            _reset_round_counts()
            torch.cuda.synchronize()
            t_run = time.time()
            res = simulate(spec, collector=c, device="cuda")
            torch.cuda.synchronize()
            walls[on].append(time.time() - t_run)
            _hold_timeline(f"obs {'on' if on else 'off'}", res, names, pins)
            syncs.append(np.stack([tl.sync_times for tl in res]))
            if on:
                col, counts = c, _round_counts()
    if not all(np.array_equal(x, syncs[0]) for x in syncs):
        raise SystemExit("obs: the collector changed the sync times")
    if counts["phase"] or not (counts["k1"] and counts["k2"]):
        raise SystemExit(f"obs: engine counts {counts}")
    t_rep = time.time()
    _hold_obs("overhead", obs_pin("overhead", col), OBS_PINS["overhead"],
              "obs overhead")
    report_s = time.time() - t_rep
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        col.tracer.save(path)
        n_spans = len(validate_trace(load_trace(path)))
        col.report().save_json(os.path.join(tmp, "summary.json"))
        col.report().save_csv(os.path.join(tmp, "summary.csv"))
    off_s, on_s = min(walls[False]), min(walls[True])

    names, cases = fig2b_cases()
    f2b = SweepSpec(cases=tuple(cases), pon=PONConfig(n_onus=N_ONUS))
    col2 = Collector(keep_phases=False, device="cuda")
    _reset_round_counts()
    t_run = time.time()
    res = simulate(f2b, collector=col2, device="cuda")
    f2b_s = time.time() - t_run
    f2b_counts = _round_counts()
    _check_syncs(names, res)
    if col2.phases or not (f2b_counts["k1"] and f2b_counts["k2"]):
        raise SystemExit(f"obs fig2b: {len(col2.phases)} phases kept, "
                         f"engine counts {f2b_counts}")
    _hold_obs("fig2b", obs_pin("fig2b", col2), OBS_PINS["fig2b"],
              "obs fig2b")
    for key, (n, p50, p95, p99) in sorted(_delays(col2.report()).items()):
        print(f"  fig2b upload delay {key}: n {n:.0f}, p50 {p50:.4f}s, "
              f"p95 {p95:.4f}s, p99 {p99:.4f}s", flush=True)

    try:
        simulate(dataclasses.replace(f2b, backend="jit"),
                 collector=Collector(device="cuda"), device="cuda")
    except ValueError as e:
        if "does not support collector" not in str(e):
            raise
    else:
        raise SystemExit("obs: backend='jit' took a collector")
    _line("obs", time.time() - t0, rounds=OBS_ROUNDS, rows=len(spec.cases)
          * OBS_ROUNDS, off_s=",".join(f"{w:.3f}" for w in walls[False]),
          on_s=",".join(f"{w:.3f}" for w in walls[True]),
          overhead=f"{on_s / off_s - 1.0:.4f}", syncs_bitwise="yes",
          report_held="yes", report_s=f"{report_s:.3f}", spans=n_spans,
          k1_launches=counts["k1"], k2_launches=counts["k2"],
          fig2b_wall_s=f"{f2b_s:.3f}", fig2b_held="yes", jit_refused="yes")
    return {"obs-fig3-6": counts, "obs-fig2b": f2b_counts}


def _serve_steps(cfg, params, prompts, kernels, feed=None, extra=None,
                 n_new=SERVE_NEW, routes=None, top_k=None) -> dict:
    """Prefill (``extra`` before the prompt), then decode: greedy for
    ``n_new - 1`` steps, or the tokens of ``feed``; through the step
    functions as ``serve()`` drives them, its cache sized as ``serve()``
    sizes it. The kernels' counts are set to 0 just before the prefill
    and just before decode and read just after each. With ``routes`` (a
    list) every MoE layer's routing of the prefill, (experts, kept), is
    appended to it; ``top_k`` (or None) stands in for the router's
    ``moe._top_k`` over the whole run (``_TopK``). Returns the
    last-position logits of each step, the tokens, the counts, prefill
    and decode ms and the cache."""
    from repro_torch.dist import stepfns
    from repro_torch.launch.serve import cache_len
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod

    route = moe_mod._route

    def spy(*args, **kwargs):
        out = route(*args, **kwargs)
        routes.append((out[1], out[4]))
        return out

    batch, prompt = prompts.shape
    cache = lm.init_cache(cfg, batch, cache_len(cfg, prompt, n_new))
    prefill_step = stepfns.make_prefill_step(cfg)
    decode_step = stepfns.make_decode_step(cfg)
    with torch.inference_mode(), (
            mock.patch.object(moe_mod, "_top_k", top_k)
            if top_k is not None else contextlib.nullcontext()):
        torch.cuda.synchronize()
        for kernel in kernels.values():
            kernel.launches = 0
        t0 = time.perf_counter()
        with (mock.patch.object(moe_mod, "_route", spy)
              if routes is not None else contextlib.nullcontext()):
            logits, cache = prefill_step(params, prompts, cache, extra)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        n_pre = {name: k.launches for name, k in kernels.items()}
        steps = [logits[:, -1].float()]
        toks = [logits[:, -1:].argmax(-1)]
        for kernel in kernels.values():
            kernel.launches = 0
        t1 = time.perf_counter()
        for i in range(n_new - 1 if feed is None else len(feed)):
            tok = toks[-1] if feed is None else feed[i]
            logits, cache = decode_step(params, tok, cache)
            steps.append(logits[:, -1].float())
            toks.append(logits[:, -1:].argmax(-1))
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t1) * 1e3
    n_dec = {name: k.launches for name, k in kernels.items()}
    return {"steps": steps, "toks": toks, "n_pre": n_pre, "n_dec": n_dec,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "cache": cache}


def _serve_run(cfg, params, prompts, kernels, feed=None):
    """``_serve_steps`` at ``SERVE_NEW`` tokens as (last-position logits
    of each step, tokens, launches of each of ``kernels`` in the prefill
    and in decode, prefill ms, decode ms)."""
    r = _serve_steps(cfg, params, prompts, kernels, feed)
    return (r["steps"], r["toks"], r["n_pre"], r["n_dec"], r["prefill_ms"],
            r["decode_ms"])


def _hold_logits(steps, want, exact, tol: float, ratio: float) -> dict:
    """Hold the kernel path's logits (``steps``) to the plain path's
    (``want``, both in bf16 compute) within ``tol``, and its distance
    from the float32 path (``exact``) to ``ratio`` times the plain
    path's. Returns the errors."""
    def max_err(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    n_cmp = len(want)
    errs = [float((a - b).abs().max()) for a, b in zip(steps[:n_cmp], want)]
    err_kernel_f32 = max_err(steps[:n_cmp], exact)
    err_plain_f32 = max_err(want, exact)
    for logits in steps:
        if not bool(torch.isfinite(logits).all()):
            raise SystemExit("non-finite logits on the kernel path")
    print(f"  logits: std {float(steps[0].std()):.4f}; kernel vs plain "
          f"{errs}; vs the float32 path: kernel {err_kernel_f32:.4g}, "
          f"plain {err_plain_f32:.4g}", flush=True)
    if max(errs) > tol:
        raise SystemExit(f"kernel path vs plain path: logits differ by "
                         f"{max(errs)} (> {tol})")
    if err_kernel_f32 > ratio * err_plain_f32:
        raise SystemExit(f"kernel path {err_kernel_f32} from the float32 "
                         f"path, plain path {err_plain_f32}")
    return {"max_err_prefill": f"{errs[0]:.4g}",
            "max_err_decode": f"{max(errs[1:]):.4g}",
            "err_kernel_f32": f"{err_kernel_f32:.4g}",
            "err_plain_f32": f"{err_plain_f32:.4g}"}


def _serve_entry(arch: str, kernels: dict, want: dict, log_jsonl=None):
    """``serve()`` at full width, the entry point a user runs, with the
    kernels' counts set to 0 just before and read just after; each must
    equal ``want``. ``log_jsonl`` goes to ``serve()``. Returns (tokens,
    launches, peak GB)."""
    from repro_torch.launch.serve import serve

    torch.cuda.reset_peak_memory_stats()
    for kernel in kernels.values():
        kernel.launches = 0
    out = serve(arch=arch, smoke=False, batch=SERVE_BATCH,
                prompt_len=SERVE_PROMPT, max_new_tokens=SERVE_NEW,
                log_jsonl=log_jsonl, device="cuda")
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != want:
        raise SystemExit(f"{arch}: the kernels ran {launches} times in "
                         f"serve(), not {want}")
    if out.shape != (SERVE_BATCH, SERVE_NEW):
        raise SystemExit(f"serve() returned {out.shape}")
    return out, launches, peak_gb


def _same_weights(cfg):
    """serve()'s parameters and prompts (seeds 0 and 1)."""
    from repro_torch.models import lm

    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.randint(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1))
    return params, prompts


def _serve_line(phase, t0, cfg, n_pre, n_dec, prefill_ms, decode_ms,
                peak_gb, held, generated, out):
    n_dec_steps = SERVE_NEW - 1
    _line(phase, time.time() - t0, arch=cfg.name, layers=cfg.n_layers,
          batch=SERVE_BATCH, prompt=SERVE_PROMPT, new=SERVE_NEW,
          **{f"{name}_prefill": n for name, n in n_pre.items()},
          **{f"{name}_decode": n for name, n in n_dec.items()},
          prefill_ms=f"{prefill_ms:.3f}", decode_ms=f"{decode_ms:.3f}",
          decode_ms_step=f"{decode_ms / n_dec_steps:.3f}",
          decode_tok_s=f"{SERVE_BATCH * n_dec_steps / decode_ms * 1e3:.1f}",
          prefill_tok_s=f"{SERVE_BATCH * SERVE_PROMPT / prefill_ms * 1e3:.0f}",
          peak_gb=f"{peak_gb:.3f}", **held,
          same_tokens_as_serve=bool((generated == out).all()),
          tokens=generated[0, :8].tolist())


class _CountOf:
    """A kernel module's other counter (``launches_tc`` of K4 and K5,
    ``phase_launches`` of the phase kernel) as a kernel count of its
    own, set and read where the phases set and read ``launches``."""

    def __init__(self, module, attr: str = "launches_tc"):
        self.module, self.attr = module, attr

    @property
    def launches(self) -> int:
        return getattr(self.module, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.module, self.attr, value)


def _serve_event(path: str) -> dict:
    """The one ``serve`` event of a ``--log-jsonl`` file, checked."""
    with open(path) as f:
        events = [json.loads(line) for line in f]
    ok = (len(events) == 1 and events[0].get("event") == "serve"
          and all(isinstance(events[0].get(k), float) and events[0][k] > 0
                  for k in ("prefill_ms", "decode_ms", "tps")))
    if not ok:
        raise SystemExit(f"serve --log-jsonl wrote {events}")
    return events[0]


def phase_serve():
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import kernel as k4

    t0 = time.time()
    kernels = {"k4": k4, "k4_tc": _CountOf(k4)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve.jsonl")
        out, launches, peak_gb = _serve_entry(
            "olmo-1b", kernels, {"k4": 16, "k4_tc": 16}, log_jsonl=path)
        ev = _serve_event(path)
    print(f"  serve --log-jsonl: one serve event, prefill_ms "
          f"{ev['prefill_ms']:.3f}, decode_ms {ev['decode_ms']:.3f}, tps "
          f"{ev['tps']:.3f}", flush=True)

    # the same weights and prompts through the step functions: K4 per
    # layer in the prefill and never in decode, then the plain attention
    cfg = get_config("olmo-1b")
    params, prompts = _same_weights(cfg)
    _serve_run(cfg, params, prompts, kernels)            # warm-up
    steps, toks, n_pre, n_dec, prefill_ms, decode_ms = _serve_run(
        cfg, params, prompts, kernels)
    if (n_pre, n_dec) != ({"k4": 16, "k4_tc": 16},
                          {"k4": 0, "k4_tc": 0}):
        raise SystemExit(f"K4 launches: prefill {n_pre}, decode {n_dec}; "
                         f"want 16 (all on the tensor cores) and 0")
    generated = torch.cat(toks, dim=1).cpu().numpy()
    feed = toks[:SERVE_FORCED]
    plain = cfg.replace(attn_impl="reference")
    want = _serve_run(plain, params, prompts, kernels, feed)[0]
    exact = _serve_run(plain.replace(dtype="float32"), params, prompts,
                       kernels, feed)[0]
    held = _hold_logits(steps, want, exact, LOGIT_TOL, F32_RATIO)
    _serve_line("serve", t0, cfg, n_pre, n_dec, prefill_ms, decode_ms,
                peak_gb, held, generated, out)
    return launches


def _ssd_inputs(B, S, H, P, N, dtype, seed=0, h0=False):
    """SSD scan inputs as the model passes them: x, B and C slices of one
    xBC tensor in ``dtype``; float32 step sizes rising across heads."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=g, device="cuda")
    xbc[..., H * P:] *= 0.3
    xbc = xbc.to(dtype)
    xh = xbc[..., :H * P].reshape(B, S, H, P)
    bias = torch.linspace(-4.0, 1.0, H, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device="cuda") + bias)
    a = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.2)
    h0 = (torch.randn((B, H, P, N), generator=g, device="cuda")
          if h0 else None)
    return (xh, xbc[..., H * P:H * P + N], xbc[..., H * P + N:], dt, a), h0


def _chunk_sum(dt, a, chunk: int) -> float:
    """The largest in-chunk sum of dt |a|."""
    B, S, H = dt.shape
    Q = min(chunk, S)
    d = torch.nn.functional.pad(dt * -a, (0, 0, 0, -S % Q))
    return float(d.reshape(B, -1, Q, H).sum(2).max())


def _ssd_flops(B, S, H, P, N, chunk) -> int:
    """Products the chunked scan needs for these shapes: C.B^T once per
    (batch, chunk) and scores.x over the live s <= t only; C.h and the
    chunk states in full."""
    Q = min(chunk, S)
    total = 0
    for t0 in range(0, S, Q):
        L = min(Q, S - t0)
        tri = L * (L + 1) // 2
        total += B * (2 * tri * N + H * (2 * tri * P + 4 * L * P * N))
    return total


@_matmul_tf32_off()
def phase_k5():
    from repro_torch.kernels.ssd import kernel, ref

    t0 = time.time()
    grid_err = {"float32": 0.0, "cuda_cores": 0.0, "tensor_cores": 0.0}
    largest_sum = 0.0
    n_checks = n_tc = 0
    for B, S, H, P, N, chunk in K5_GRID:
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            for with_h0 in (False, True):
                args, h0 = _ssd_inputs(B, S, H, P, N, dtype, n_checks,
                                       with_h0)
                route = kernel.route(dtype, P, N, chunk,
                                     kernel.tma_strides(*args[:3]))
                routes = (["tensor_cores", "cuda_cores"]
                          if route == "tensor_cores" else ["cuda_cores"])
                y_w, h_w = ref.ssd_chunked_ref(*args, chunk, h0)
                for which in routes:
                    before = kernel.launches_tc
                    y, h = kernel.ssd_scan_cuda(*args, chunk, h0,
                                                route_to=which)
                    torch.cuda.synchronize()
                    n_tc += kernel.launches_tc - before
                    err = max(_rel_err(y, y_w), _rel_err(h, h_w))
                    if not (err <= K5_TOL and bool(torch.isfinite(y).all())):
                        raise SystemExit(
                            f"K5 ({which}) differs from its plain version "
                            f"by {err} (relative) at "
                            f"{(B, S, H, P, N, chunk)} {name} h0={with_h0}")
                    key = "float32" if name == "float32" else which
                    grid_err[key] = max(grid_err[key], err)
                    n_checks += 1
                largest_sum = max(largest_sum, _chunk_sum(*args[3:], chunk))
    if largest_sum <= 88.8:
        raise SystemExit(f"the K5 grid's chunk sums stop at {largest_sum}: "
                         f"the masked exponent is not exercised")

    B, S, H, P, N, chunk = MAMBA_PREFILL
    args, _ = _ssd_inputs(B, S, H, P, N, torch.bfloat16, seed=99)
    h0 = torch.zeros((B, H, P, N), device="cuda")     # as the prefill passes
    if kernel.route(torch.bfloat16, P, N, chunk,
                    kernel.tma_strides(*args[:3])) != "tensor_cores":
        raise SystemExit("mamba2-780m's prefill shape is not routed to the "
                         "tensor cores")
    y_w, h_w = ref.ssd_chunked_ref(*args, chunk, h0)
    errs = {}
    for which in ("tensor_cores", "cuda_cores"):
        y, h = kernel.ssd_scan_cuda(*args, chunk, h0, route_to=which)
        torch.cuda.synchronize()
        errs[which] = (_rel_err(y, y_w), _rel_err(h, h_w),
                       float((y - y_w).abs().max()))
        if max(errs[which][:2]) > K5_TOL:
            raise SystemExit(f"K5 ({which}) differs from its plain version "
                             f"by {max(errs[which][:2])} (relative) at "
                             f"mamba2-780m's prefill shape")
        n_checks += 1
    n_tc += 1
    del y, h, y_w, h_w

    def timed(which):
        return _device_ms(
            lambda *a: kernel.ssd_scan_cuda(*a, route_to=which),
            [(*args, chunk, h0)])

    # in turns: tensor cores, CUDA cores, CUDA cores, tensor cores
    ms_tc = [timed("tensor_cores")]
    ms_cc = [timed("cuda_cores"), timed("cuda_cores")]
    ms_tc.append(timed("tensor_cores"))
    ms, ms_cuda_cores = min(ms_tc), min(ms_cc)
    plain_ms = _device_ms(ref.ssd_chunked_ref, [(*args, chunk, h0)], reps=4)
    if not ms < ms_cuda_cores:
        raise SystemExit(f"K5 on the tensor cores ({ms_tc} ms) is not faster "
                         f"than on the CUDA cores ({ms_cc} ms)")
    xh, bm, cm, dt, a = args
    n_bytes = (xh.numel() * 2 + (bm.numel() + cm.numel()) * 2
               + dt.numel() * 4 + a.numel() * 4 + 2 * h0.numel() * 4
               + xh.numel() * 4)
    n_ops = _ssd_flops(B, S, H, P, N, chunk)
    bound = max(n_bytes / HBM_BYTES_S, n_ops / TF32_S) * 1e3
    err_y, err_h, abs_err = errs["tensor_cores"]
    _line("k5", time.time() - t0, checks=n_checks, tensor_core_checks=n_tc,
          err_f32=f"{grid_err['float32']:.3g}",
          err_bf16_cuda_cores=f"{grid_err['cuda_cores']:.3g}",
          err_bf16_tensor_cores=f"{grid_err['tensor_cores']:.3g}",
          largest_chunk_sum=f"{largest_sum:.1f}",
          err_mamba_y=f"{err_y:.3g}", err_mamba_h=f"{err_h:.3g}",
          err_mamba_cuda_cores=f"{max(errs['cuda_cores'][:2]):.3g}",
          abs_err_mamba=f"{abs_err:.3g}",
          ms=" ".join(f"{m:.5f}" for m in ms_tc),
          ms_cuda_cores=" ".join(f"{m:.4f}" for m in ms_cc),
          plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.5f}",
          gflop=f"{n_ops / 1e9:.3f}", tflops=f"{n_ops / ms / 1e9:.2f}")
    return {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_tc.cu",
        "source_cuda_cores": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:104",
        "max_abs_err": abs_err, "ms": ms, "ms_cuda_cores": ms_cuda_cores,
        "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": ("bytes" if n_bytes / HBM_BYTES_S >= n_ops / TF32_S
                     else "operations"),
        "library_ms": None,
    }


def phase_serve_mamba2():
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import kernel as k5
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    t0 = time.time()
    cfg = get_config("mamba2-780m")
    kernels = {"k5": k5, "k5_tc": _CountOf(k5)}
    want_prefill = {"k5": cfg.n_layers, "k5_tc": cfg.n_layers}
    out, launches, peak_gb = _serve_entry(cfg.name, kernels, want_prefill)

    params, prompts = _same_weights(cfg)
    _serve_run(cfg, params, prompts, kernels)            # warm-up
    steps, toks, n_pre, n_dec, prefill_ms, decode_ms = _serve_run(
        cfg, params, prompts, kernels)
    if (n_pre, n_dec) != (want_prefill, {"k5": 0, "k5_tc": 0}):
        raise SystemExit(f"K5 launches: prefill {n_pre}, decode {n_dec}; "
                         f"want {cfg.n_layers} (all on the tensor cores) "
                         f"and 0")
    generated = torch.cat(toks, dim=1).cpu().numpy()
    feed = toks[:SERVE_FORCED]
    f32 = cfg.replace(dtype="float32")
    exact_kernel = _serve_run(f32, params, prompts, kernels, feed)[0]
    # the plain scan in place of the dispatch, for this comparison only
    with mock.patch.object(ssd_ops, "ssd_scan", ssd_ref.ssd_chunked_ref):
        want = _serve_run(cfg, params, prompts, kernels, feed)[0]
        exact = _serve_run(f32, params, prompts, kernels, feed)[0]
    held = _hold_logits(steps, want, exact, MAMBA_LOGIT_TOL, MAMBA_F32_RATIO)
    err_f32 = max(float((a - b).abs().max())
                  for a, b in zip(exact_kernel, exact))
    print(f"  float32 compute: kernel path vs plain scan {err_f32:.4g}",
          flush=True)
    if not err_f32 <= MAMBA_F32_TOL:
        raise SystemExit(f"float32 compute: the kernel path is {err_f32} "
                         f"from the plain scan (> {MAMBA_F32_TOL})")
    held["err_f32_kernel_plain"] = f"{err_f32:.4g}"
    _serve_line("serve_mamba2", t0, cfg, n_pre, n_dec, prefill_ms,
                decode_ms, peak_gb, held, generated, out)
    return launches


def _k6_args(B, S, R, lo, hi, dtype, h0, seed=0):
    """a uniform in [lo, hi] and b ~ 0.1 N(0, 1) in ``dtype``; h0 ~ N(0, 1)
    float32 or None."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = lo + (hi - lo) * torch.rand((B, S, R), generator=g, device="cuda")
    b = torch.randn((B, S, R), generator=g, device="cuda") * 0.1
    h = torch.randn((B, R), generator=g, device="cuda") if h0 else None
    return a.to(dtype), b.to(dtype), h


def phase_k6():
    from repro_torch.kernels.rglru import kernel, ref

    t0 = time.time()
    grid_err = {"float32": 0.0, "bfloat16": 0.0}
    n_checks = 0
    for B, S, R, lo, hi in K6_GRID:
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            for with_h0 in (False, True):
                a, b, h = _k6_args(B, S, R, lo, hi, dtype, with_h0, n_checks)
                got = kernel.rglru_scan_cuda(a, b, h)
                want = ref.rglru_scan_ref(a, b, h)
                torch.cuda.synchronize()
                err = _rel_err(got, want)
                if not (err <= K6_TOL and bool(torch.isfinite(got).all())):
                    raise SystemExit(
                        f"K6 differs from its plain version by {err} "
                        f"(relative) at {(B, S, R, lo, hi)} {name} "
                        f"h0={with_h0}")
                grid_err[name] = max(grid_err[name], err)
                n_checks += 1

    B, S, R = RG_SCAN
    a, b, _ = _k6_args(B, S, R, 0.0, 1.0, torch.float32, False, seed=99)
    h0 = torch.zeros((B, R), device="cuda")          # as the prefill passes
    got = kernel.rglru_scan_cuda(a, b, h0)
    want = ref.rglru_scan_ref(a, b, h0)
    torch.cuda.synchronize()
    err = _rel_err(got, want)
    abs_err = float((got - want).abs().max())
    if err > K6_TOL:
        raise SystemExit(f"K6 differs from its plain version by {err} "
                         f"(relative) at recurrentgemma-2b's prefill shape")
    del got, want
    ms = _device_ms(kernel.rglru_scan_cuda, [(a, b, h0)])
    plain_ms = _device_ms(ref.rglru_scan_ref, [(a, b, h0)], reps=2)
    n_bytes = (a.numel() + b.numel() + h0.numel() + a.numel()) * 4
    n_ops = 2 * a.numel()                            # one FMA an element
    bound = max(n_bytes / HBM_BYTES_S, n_ops / OPS32_S) * 1e3
    _line("k6", time.time() - t0, checks=n_checks + 1,
          err_f32=f"{grid_err['float32']:.3g}",
          err_bf16=f"{grid_err['bfloat16']:.3g}", err_rg=f"{err:.3g}",
          abs_err_rg=f"{abs_err:.3g}", ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.5f}",
          gb_s=f"{n_bytes / ms / 1e6:.1f}")
    return {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru/kernel.py:69",
        "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": ("bytes" if n_bytes / HBM_BYTES_S >= n_ops / OPS32_S
                     else "operations"),
        "library_ms": None,
    }


def phase_serve_recurrentgemma():
    from repro_torch.configs import RGLRU, get_config
    from repro_torch.kernels.attention import kernel as k4
    from repro_torch.kernels.rglru import kernel as k6
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.rglru import ref as rglru_ref

    t0 = time.time()
    cfg = get_config("recurrentgemma-2b")
    n_rec = sum(s.kind == RGLRU for s in
                cfg.pattern * cfg.n_units + cfg.remainder_pattern)
    kernels = {"k6": k6, "k4": k4, "k4_tc": _CountOf(k4)}
    want_pre = {"k6": n_rec, "k4": cfg.n_layers - n_rec,
                "k4_tc": cfg.n_layers - n_rec}
    out, launches, peak_gb = _serve_entry(cfg.name, kernels, want_pre)

    params, prompts = _same_weights(cfg)
    _serve_run(cfg, params, prompts, kernels)            # warm-up
    steps, toks, n_pre, n_dec, prefill_ms, decode_ms = _serve_run(
        cfg, params, prompts, kernels)
    if (n_pre, n_dec) != (want_pre, {"k6": 0, "k4": 0, "k4_tc": 0}):
        raise SystemExit(f"K6/K4 launches: prefill {n_pre}, decode {n_dec}; "
                         f"want {want_pre} and none")
    generated = torch.cat(toks, dim=1).cpu().numpy()
    feed = toks[:SERVE_FORCED]
    f32 = cfg.replace(dtype="float32")
    exact_kernel = _serve_run(f32, params, prompts, kernels, feed)[0]
    # the plain scan and the plain attention, for this comparison only
    plain = cfg.replace(attn_impl="reference")
    with mock.patch.object(rglru_ops, "rglru_scan", rglru_ref.rglru_scan_ref):
        want = _serve_run(plain, params, prompts, kernels, feed)[0]
        exact = _serve_run(plain.replace(dtype="float32"), params, prompts,
                           kernels, feed)[0]
    held = _hold_logits(steps, want, exact, RG_LOGIT_TOL, RG_F32_RATIO)
    err_f32 = max(float((a - b).abs().max())
                  for a, b in zip(exact_kernel, exact))
    print(f"  float32 compute: kernel path vs plain path {err_f32:.4g}",
          flush=True)
    if not err_f32 <= RG_F32_TOL:
        raise SystemExit(f"float32 compute: the kernel path is {err_f32} "
                         f"from the plain path (> {RG_F32_TOL})")
    held["err_f32_kernel_plain"] = f"{err_f32:.4g}"
    _serve_line("serve_recurrentgemma", t0, cfg, n_pre, n_dec, prefill_ms,
                decode_ms, peak_gb, held, generated, out)
    return launches


def _zoo_cfg(name: str):
    """The published config, its depth cut to ``ZOO_LAYERS`` (printed as
    a ``reduced`` line); every width as published."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    if name in ZOO_LAYERS:
        print(f"  reduced: {name} n_layers {cfg.n_layers} -> "
              f"{ZOO_LAYERS[name]} (widths, experts, cache dtype as "
              f"published)", flush=True)
        cfg = cfg.replace(n_layers=ZOO_LAYERS[name])
    return cfg


class _TopK:
    """The router's top-k, recorded or replayed: ``_TopK()`` runs
    ``moe._top_k`` and keeps each call's experts; ``_TopK(recorded)``
    returns those experts, call by call, with their gate values read
    from the probabilities it is given. Replaying one run's experts in
    another holds the expert choices equal, so the two runs differ only
    where their inputs do."""

    def __init__(self, recorded=None):
        from repro_torch.models import moe as moe_mod

        self.top_k = moe_mod._top_k
        self.replay = recorded
        self.experts = []

    def __call__(self, probs, k):
        if self.replay is None:
            vals, idx = self.top_k(probs, k)
            self.experts.append(idx)
            return vals, idx
        idx = self.replay[len(self.experts)]
        self.experts.append(idx)
        return probs.gather(-1, idx), idx


def _cache_bytes(cache) -> dict:
    """Bytes of a model cache's tensors by leaf name (k, v, k_scale, ...)."""
    out = {}
    for part in ("units", "rem"):
        for block in cache.get(part, {}).values():
            for key, t in block.items():
                out[key] = out.get(key, 0) + t.numel() * t.element_size()
    return out


def _kv_step(cache) -> float:
    """The int8 cache's largest half step over its rows' RMS: max over
    written (batch, slot) rows of ``scale / 2 / rms(row)``, the scale
    ``amax / 127``; unwritten rows (all zero) are skipped."""
    worst = 0.0
    for part in ("units", "rem"):
        for block in cache.get(part, {}).values():
            for key in ("k", "v"):
                q, scale = block[key].float(), block[f"{key}_scale"]
                rms = (q * scale[..., None]).square().mean(-1).sqrt()
                live = rms > 0
                worst = max(worst, float((scale[live] / 2
                                          / rms[live]).max()))
    return worst


def _moe_loads(routes, n_experts: int) -> dict:
    """Per MoE layer of one prefill: tokens each expert took (kept
    choices) and the share of choices dropped at capacity."""
    loads, dropped = [], []
    for idx, keep in routes:
        loads.append(torch.bincount(idx[keep], minlength=n_experts).tolist())
        dropped.append(float((~keep).float().mean()))
    return {"loads": loads, "dropped": dropped}


def phase_serve_zoo():
    import gc

    from repro_torch.configs import ATTN
    from repro_torch.kernels.attention import kernel as k4
    from repro_torch.launch.serve import frontend_embeds
    from repro_torch.models import lm

    t0 = time.time()
    gc.collect()                  # the earlier phases' tensors, cached
    torch.cuda.empty_cache()
    kernels = {"k4": k4, "k4_tc": _CountOf(k4)}
    results = {}
    for i, name in enumerate(ZOO):
        t1 = time.time()
        cfg = _zoo_cfg(name)
        n_attn = sum(s.kind == ATTN for s in
                     cfg.pattern * cfg.n_units + cfg.remainder_pattern)
        seq = cfg.n_frontend_tokens + SERVE_PROMPT
        window = cfg.pattern[0].window
        k4_shape = (SERVE_BATCH, seq, seq, cfg.n_heads, cfg.n_kv_heads,
                    cfg.d_head)
        # K4 alone at this config's prefill shape (its first layer's
        # window): held to its plain version, timed beside it and SDPA
        err, ms, plain_ms, library_ms, bound, by, _ = _k4_timed(
            k4_shape, window, 20 + i)

        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = lm.init_params(cfg, gen)
        extra = frontend_embeds(cfg, SERVE_BATCH, gen)
        prompts = torch.randint(
            0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(1))
        # (b)'s yardstick first: the same prefill with the plain attention
        want = _serve_steps(cfg.replace(attn_impl="reference"), params,
                            prompts, kernels, feed=[], extra=extra,
                            n_new=ZOO_NEW)["steps"][0]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        routes = [] if cfg.moe is not None else None
        experts = _TopK() if cfg.kv_cache_dtype == "int8" else None
        run = _serve_steps(cfg, params, prompts, kernels, extra=extra,
                           n_new=ZOO_NEW, routes=routes, top_k=experts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # (a) K4 in every attention layer of the prefill, on the tensor
        # cores, never in decode
        if (run["n_pre"], run["n_dec"]) != (
                {"k4": n_attn, "k4_tc": n_attn}, {"k4": 0, "k4_tc": 0}):
            raise SystemExit(f"{name}: K4 launches prefill {run['n_pre']}, "
                             f"decode {run['n_dec']}; want {n_attn} on the "
                             f"tensor cores and none")
        # (b) the kernel path's prefill logits against the plain path's
        rel = float((run["steps"][0] - want).abs().max()
                    / want.abs().max())
        if not rel <= ZOO_LOGIT_RTOL:
            raise SystemExit(f"{name}: prefill logits {rel} (relative) from "
                             f"the plain attention's (> {ZOO_LOGIT_RTOL})")
        # (c) finite logits, (batch, ZOO_NEW) tokens
        generated = torch.cat(run["toks"], dim=1)
        if not all(bool(torch.isfinite(x).all()) for x in run["steps"]):
            raise SystemExit(f"{name}: non-finite logits")
        if tuple(generated.shape) != (SERVE_BATCH, ZOO_NEW):
            raise SystemExit(f"{name}: tokens {tuple(generated.shape)}")
        held = {}
        if routes is not None:
            stats = _moe_loads(routes, cfg.moe.n_experts)
            for layer, (loads, drop) in enumerate(zip(stats["loads"],
                                                      stats["dropped"])):
                print(f"  {name} MoE layer {layer}: expert loads (tokens "
                      f"kept) min {min(loads)} max {max(loads)} of "
                      f"{sum(loads)}; dropped {drop:.6f} of the choices; "
                      f"loads {loads}", flush=True)
            held["moe_dropped"] = f"{max(stats['dropped']):.6f}"
        if cfg.kv_cache_dtype == "int8":
            held.update(_hold_int8_cache(cfg, params, prompts, extra,
                                         kernels, run, n_attn, experts))
        results[name] = {"k4": run["n_pre"]["k4"],
                         "k4_tc": run["n_pre"]["k4_tc"], "k4_err": err,
                         "k4_ms": ms, "k4_plain_ms": plain_ms,
                         "k4_library_ms": library_ms, "k4_bound_ms": bound,
                         "k4_bound_by": by}
        n_dec = ZOO_NEW - 1
        _line(f"serve_zoo:{name}", time.time() - t1, layers=cfg.n_layers,
              batch=SERVE_BATCH, prompt=SERVE_PROMPT,
              frontend=cfg.n_frontend_tokens, new=ZOO_NEW,
              k4_prefill=run["n_pre"]["k4"],
              k4_tc_prefill=run["n_pre"]["k4_tc"],
              k4_decode=run["n_dec"]["k4"],
              prefill_ms=f"{run['prefill_ms']:.3f}",
              decode_ms=f"{run['decode_ms']:.3f}",
              decode_ms_step=f"{run['decode_ms'] / n_dec:.3f}",
              peak_gb=f"{peak_gb:.3f}", k4_shape=list(k4_shape),
              window=window, k4_ms=f"{ms:.5f}", k4_plain_ms=f"{plain_ms:.4f}",
              k4_library_ms=f"{library_ms:.5f}", k4_bound_ms=f"{bound:.5f}",
              k4_err=f"{err:.3g}", prefill_rel_err=f"{rel:.4g}", **held,
              tokens=generated[0, :8].tolist())
        del params, extra, prompts, want, run, routes
        gc.collect()
        torch.cuda.empty_cache()
    _line("serve_zoo", time.time() - t0, configs=len(results))
    return results


def _hold_int8_cache(cfg, params, prompts, extra, kernels, run,
                     n_attn: int, experts) -> dict:
    """(d) the int8 cache's bytes: half the bf16 cache's, plus the
    scales; (e) its decode logits against the same decode (the same
    tokens fed) with a bf16 cache, within ``ZOO_KV_FACTOR`` times the
    attention layers times the cache's largest half step (``_kv_step``),
    in RMS over the logits' RMS. ``experts`` recorded the int8 run's
    expert choices: the bf16 run replays them (``_TopK``), so the two
    decodes differ by the cache alone; the same bf16 decode with its own
    choices is printed beside it with the tokens whose experts moved."""
    bf16_cfg = cfg.replace(kv_cache_dtype="bfloat16")
    free = _TopK()
    own = _serve_steps(bf16_cfg, params, prompts, kernels,
                       feed=run["toks"][:-1], extra=extra, n_new=ZOO_NEW,
                       top_k=free)
    bf16 = _serve_steps(bf16_cfg, params, prompts, kernels,
                        feed=run["toks"][:-1], extra=extra, n_new=ZOO_NEW,
                        top_k=_TopK(experts.experts))
    b8, b16 = _cache_bytes(run["cache"]), _cache_bytes(bf16["cache"])
    scales = b8["k_scale"] + b8["v_scale"]
    if not (b8["k"] + b8["v"] == (b16["k"] + b16["v"]) // 2
            and sum(b8.values()) == sum(b16.values()) // 2 + scales):
        raise SystemExit(f"int8 cache {b8} bytes against bf16 {b16}")
    moved = sum(int((a.sort(-1)[0] != b.sort(-1)[0]).any(-1).sum())
                for a, b in zip(experts.experts, free.experts))
    step = _kv_step(run["cache"])
    bound = ZOO_KV_FACTOR * n_attn * step

    def rel_rms(steps):
        return [float((a - b).square().mean().sqrt()
                      / b.square().mean().sqrt())
                for a, b in zip(run["steps"][1:], steps[1:])]

    errs, errs_own = rel_rms(bf16["steps"]), rel_rms(own["steps"])
    print(f"  int8 cache: {sum(b8.values())} bytes (scales {scales}) "
          f"against bf16 {sum(b16.values())}; largest half step "
          f"{step:.5f} of a row's RMS; decode logits vs the bf16 cache's "
          f"(RMS over RMS), the same experts {[round(e, 6) for e in errs]}"
          f", bound {bound:.5f}; with the bf16 run's own experts "
          f"{[round(e, 6) for e in errs_own]}, {moved} token-layer "
          f"choices moved", flush=True)
    if not max(errs) <= bound:
        raise SystemExit(f"int8 cache decode {max(errs)} from the bf16 "
                         f"cache's (> {bound})")
    return {"int8_cache_bytes": sum(b8.values()),
            "bf16_cache_bytes": sum(b16.values()),
            "int8_decode_rel_rms": f"{max(errs):.5g}",
            "int8_bound": f"{bound:.5g}",
            "int8_own_experts_rel_rms": f"{max(errs_own):.5g}",
            "experts_moved": moved}


def _train_kernels() -> dict:
    """The kernel counts of the training path: K4 (and its tensor-core
    launches) and the backward from its log-sum-exp in the steps, K1, K2
    and the phase kernel in the timeline."""
    from repro_torch.kernels.attention import kernel as k4
    from repro_torch.kernels.ponsim import kernel as k2
    from repro_torch.kernels.traffic import kernel as k1

    return {"k4": k4, "k4_tc": _CountOf(k4),
            "k4_bwd": _CountOf(k4, "bwd_launches"), "k1": k1, "k2": k2,
            "phase": _CountOf(k2, "phase_launches")}


def _train_entry(name: str, log_jsonl=None, **kw):
    """``train()`` at olmo-1b's full width, the entry point a user runs,
    with the kernels' counts set to 0 just before and read just after.
    Returns (state, history, launches, peak GB, wall s)."""
    from repro_torch.launch.train import train

    overrides, rounds = TRAIN_RUNS[name]
    kernels = _train_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in kernels.values():
        kernel.launches = 0
    t0 = time.perf_counter()
    state, history = train(
        arch="olmo-1b", smoke=False, steps_per_round=TRAIN_STEPS[name],
        rounds=rounds, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        config_overrides=overrides, log_jsonl=log_jsonl, device="cuda",
        **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernel.launches for k, kernel in kernels.items()}
    syncs = tuple(h["sync_s"] for h in history)
    want = TRAIN_SYNC_PINS[name][-len(syncs):] if syncs else ()
    if len(syncs) != len(want) or any(
            abs(a - b) > SYNC_TOL for a, b in zip(syncs, want)):
        raise SystemExit(f"train {name}: round syncs {syncs}, pinned "
                         f"{want}")
    return (state, history, launches,
            torch.cuda.max_memory_allocated() / 1e9, wall)


def _profiled_device_ms(fn, top: int = 6):
    """The device ms of one call of ``fn`` by torch.profiler: the summed
    time of its device events alone (an operator's device time holds
    its kernels', so it is not added again), or None if the profiler
    saw no device time; and the ``top`` device events by time as
    (ms, launches, name). (The profiler's own host cost stretches the
    call's wall, so the busy share divides this by an unprofiled call's
    wall.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                     for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA), reverse=True)
    dev_ms = sum(ms for ms, _, _ in events)
    return (dev_ms if dev_ms > 0 else None), events[:top]


def _timed_step(step, state, batch):
    """One warm-up call of ``step``, then the wall ms of one more, and
    the device ms and largest device events of a third, profiled."""
    step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms, top = _profiled_device_ms(lambda: step(state, batch))
    return wall_ms, dev_ms, top


def _print_top(what, dev_ms, wall_ms, top):
    busy = "not measured" if dev_ms is None else f"{dev_ms / wall_ms:.3f}"
    print(f"  {what}: {wall_ms:.3f} ms unprofiled, device "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.3f}'} ms "
          f"profiled (busy {busy}); largest: "
          + "; ".join(f"{ms:.3f} ms x{n} {name[:60]}" for ms, n, name
                      in top), flush=True)


def _train_whole_step():
    """(b): one olmo-1b full-width state and one batch through one AdamW
    step (constant lr 3e-3) with K4 in bf16, with the plain attention in
    bf16 and in float32 compute. Returns, for each, the loss, the global
    gradient norm and the parameter change, and K4's launches."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenBatcher, lm_tokens
    from repro_torch.dist import stepfns
    from repro_torch.kernels.attention import kernel as k4
    from repro_torch.optim import OptimizerConfig
    from repro_torch._tree import tree_leaves

    cfg = get_config("olmo-1b").replace(grad_accum=1)
    opt_cfg = OptimizerConfig(name="adamw", lr=3e-3)
    state = stepfns.init_train_state(
        cfg, opt_cfg, torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    batch = next(iter(TokenBatcher(lm_tokens(400_000, cfg.vocab_size,
                                             seed=0),
                                   TRAIN_BATCH, TRAIN_SEQ)))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    before = tree_leaves(state.params)
    runs = {}
    plain = cfg.replace(attn_impl="reference")
    for name, c in (("kernel", cfg), ("plain", plain),
                    ("f32", plain.replace(dtype="float32"))):
        k4.launches = k4.launches_tc = k4.bwd_launches = 0
        new, m = stepfns.make_train_step(c, opt_cfg)(state, batch)
        delta = torch.cat([(a - b).reshape(-1) for a, b in
                           zip(tree_leaves(new.params), before)])
        runs[name] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]), "delta": delta,
                      "k4": k4.launches, "k4_tc": k4.launches_tc,
                      "k4_bwd": k4.bwd_launches}
        del new, m
    return runs


def _hold_whole_step(runs) -> dict:
    """The kernel run's distance from the float32 run at most
    ``TRAIN_F32_RATIO`` times the plain run's plus a floor, for the loss,
    the gradient norm (relative) and the parameter change (relative L2
    over every parameter)."""
    f32 = runs["f32"]
    out = {}
    for what, floor in (("loss", TRAIN_LOSS_FLOOR),
                        ("grad_norm", TRAIN_GNORM_FLOOR),
                        ("delta", TRAIN_DELTA_FLOOR)):
        if what == "delta":
            ref = f32["delta"]
            dist = {k: float((runs[k]["delta"] - ref).norm() / ref.norm())
                    for k in ("kernel", "plain")}
        elif what == "grad_norm":
            dist = {k: abs(runs[k][what] - f32[what]) / f32[what]
                    for k in ("kernel", "plain")}
        else:
            dist = {k: abs(runs[k][what] - f32[what])
                    for k in ("kernel", "plain")}
        out[f"{what}_kernel_f32"] = f"{dist['kernel']:.4g}"
        out[f"{what}_plain_f32"] = f"{dist['plain']:.4g}"
        if not dist["kernel"] <= TRAIN_F32_RATIO * dist["plain"] + floor:
            raise SystemExit(
                f"train (b): {what}: kernel run {dist['kernel']} from the "
                f"float32 run, plain run {dist['plain']} (ratio "
                f"{TRAIN_F32_RATIO}, floor {floor})")
    print(f"  whole step: loss {runs['kernel']['loss']:.6f} / "
          f"{runs['plain']['loss']:.6f} / {f32['loss']:.6f}, grad norm "
          f"{runs['kernel']['grad_norm']:.6g} / "
          f"{runs['plain']['grad_norm']:.6g} / {f32['grad_norm']:.6g}, "
          f"largest change {float(runs['kernel']['delta'].abs().max()):.4g}"
          f" / {float(runs['plain']['delta'].abs().max()):.4g} / "
          f"{float(f32['delta'].abs().max()):.4g} (kernel / plain / f32)",
          flush=True)
    return out


def _bwd_bytes_bound(ins, grads_out) -> float:
    """ms to read the inputs and upstream gradients once and write the
    input gradients once at HBM_BYTES_S."""
    n = sum(2 * t.numel() * t.element_size() for t in ins)
    n += sum(t.numel() * t.element_size() for t in grads_out)
    return n / HBM_BYTES_S * 1e3


def _host_ms(fn):
    """``fn()`` once to warm up, then three more calls, each ended by a
    synchronise: the last call's result and the median host ms."""
    fn()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return got, statistics.median(times)


def _backward_ms(fn, ins, grads_out, n_out=1):
    """The input gradients of ``fn`` on leaf copies of ``ins`` against
    ``grads_out`` (of its first ``n_out`` outputs), and the host ms of
    that backward (``_host_ms``; the graph built once, kept)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in ins]
    out = fn(*leaves)
    outs = out[:n_out] if isinstance(out, tuple) else (out,)
    return _host_ms(lambda: torch.autograd.grad(outs, leaves, grads_out,
                                                retain_graph=True))


def _bwd_check(what, function, plain, ins, grads_out, n_out=1):
    """(c): ``function`` (an autograd Function's apply, kernel forward)
    and ``plain`` (the plain version) on the same leaf inputs ``ins``
    and upstream gradients: every input gradient equal bit for bit.
    Returns (largest difference, backward ms of the Function, of the
    plain version, bound ms: the bytes bound; K4's caller takes the
    larger of it and the operations' bound)."""
    got, ms = _backward_ms(function, ins, grads_out, n_out)
    want, plain_ms = _backward_ms(plain, ins, grads_out, n_out)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"  backward {what}: max |diff| {err:.3g}, bit for bit {same}, "
          f"{ms:.3f} ms (plain {plain_ms:.3f} ms)", flush=True)
    if not same:
        raise SystemExit(f"train (c): {what}: the Function's gradients "
                         f"differ from the plain version's by {err}")
    return err, ms, plain_ms, _bwd_bytes_bound(ins, grads_out)


def _sdpa_backward_ms(ins, gy, group: int, window):
    """``scaled_dot_product_attention`` under autograd on the same
    inputs as a K4 backward check (k/v given to every query head; causal,
    with a boolean mask where the window cuts), a yardstick only: ms of
    its forward and backward (``_host_ms``)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (t.detach().transpose(1, 2) for t in ins)
    if group > 1:
        k, v = (t.repeat_interleave(group, dim=1) for t in (k, v))
    q, k, v = (t.contiguous().requires_grad_(True) for t in (q, k, v))
    S, T = q.shape[2], k.shape[2]
    kw = {"is_causal": True}
    if window is not None and window < S:
        qi = torch.arange(S, device="cuda")[:, None]
        kj = torch.arange(T, device="cuda")[None, :]
        kw = {"attn_mask": (kj <= qi) & (qi - kj < window)}
    g = gy.transpose(1, 2).contiguous()

    return _host_ms(lambda: torch.autograd.grad(sdpa(q, k, v, **kw),
                                                (q, k, v), g))[1]


def _lse_bwd_ops_s(n_ops: int, dtype) -> float:
    """Seconds of the backward's five products (``n_ops`` = 10 B H D a
    live key, 2 B H D each) at the card's peaks for their operands. From
    bf16 inputs Q K^T and dO V^T take bf16 operands, exact on the tensor
    cores with fp32 accumulation (``BF16_S``); P^T dO, dS K and dS^T Q
    take the float32 P or dS, at the rate the repo gives float32-accurate
    products (``OPS32_S``; TF32 would round them to about three digits).
    From float32 inputs all five at ``OPS32_S``. The two terms add."""
    if dtype == torch.bfloat16:
        return 0.4 * n_ops / BF16_S + 0.6 * n_ops / OPS32_S
    return n_ops / OPS32_S


def _xla_backward(what: str, B, S, H, K, D, window, seed) -> dict:
    """(c): the backward from the log-sum-exp at (B, S, S, H, K, D) in
    bf16, causal, with ``window``. K4 with its lse: the output bit for
    bit K4's without, the lse within ``XLA_LSE_TOL`` of the plain
    version's; the kernel's dq, dk, dv within ``XLA_BWD_RTOL`` of the
    largest magnitude of ``flash_attention_bwd_ref``'s on the same (q, k,
    v, out, lse, g), and ``XLA_REPEATS`` calls the same bits. Then its
    device ms beside the plain version's and the bound (the bytes read
    and written once over ``HBM_BYTES_S``, or the five products at their
    operands' rates, ``_lse_bwd_ops_s``, whichever is larger), and through
    autograd the new Function's backward beside the recompute Function's
    (``FlashAttention``) and SDPA's forward and backward."""
    from repro_torch.kernels.attention import kernel as k4
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention import ref as attn_ref

    q, k, v = _qkv(B, S, S, H, K, D, torch.bfloat16, seed=seed)
    gy = torch.randn((B, S, H, D), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(
                         seed + 1)).to(torch.bfloat16)
    out, lse = k4.flash_attention_lse_cuda(q, k, v, True, window)
    _, want_lse = attn_ref.flash_attention_lse_ref(q, k, v, True, window)
    lse_err = float((lse - want_lse).abs().max())
    if not torch.equal(out, k4.flash_attention_cuda(q, k, v, True, window)) \
            or not _close(lse, want_lse, XLA_LSE_TOL):
        raise SystemExit(f"train (c): K4 with lse at {what}: the output is "
                         f"not K4's or the lse is {lse_err} from the plain "
                         f"version's")
    del want_lse
    got = k4.flash_attention_bwd_cuda(q, k, v, out, lse, gy, True, window)
    want = attn_ref.flash_attention_bwd_ref(q, k, v, out, lse, gy, True,
                                            window)
    err = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = float(b.float().abs().max())
        e = float((a.float() - b.float()).abs().max())
        err = max(err, e)
        if not (bool(torch.isfinite(a).all())
                and e <= XLA_BWD_RTOL * scale):
            raise SystemExit(f"train (c): the backward at {what}: {name} "
                             f"{e} from the plain version's (largest "
                             f"{scale}, tolerance {XLA_BWD_RTOL} of it)")
    del want
    for _ in range(XLA_REPEATS - 1):
        again = k4.flash_attention_bwd_cuda(q, k, v, out, lse, gy, True,
                                            window)
        if not all(torch.equal(a, b) for a, b in zip(again, got)):
            raise SystemExit(f"train (c): the backward at {what} gave "
                             f"other bits on a repeat")
    args = [(q, k, v, out, lse, gy, True, window)]
    ms = _device_ms(k4.flash_attention_bwd_cuda, args)
    plain_ms = _device_ms(attn_ref.flash_attention_bwd_ref, args, reps=2)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (q, k, v, out, lse, gy, *got))
    n_ops = 10 * B * H * D * _live_keys(S, S, True, window)
    ops_s = _lse_bwd_ops_s(n_ops, q.dtype)
    bound = max(n_bytes / HBM_BYTES_S, ops_s) * 1e3
    by = "bytes" if n_bytes / HBM_BYTES_S >= ops_s else "operations"
    del got, out, lse
    _, fn_ms = _backward_ms(
        lambda *t: attn_ops.FlashAttentionLSE.apply(*t, True, window),
        (q, k, v), (gy,))
    _, recompute_ms = _backward_ms(
        lambda *t: attn_ops.FlashAttention.apply(*t, True, window),
        (q, k, v), (gy,))
    library_ms = _sdpa_backward_ms((q, k, v), gy, H // K, window)
    print(f"  backward from the lse {what} ({B}, {S}, {H}, {K}, {D}): lse "
          f"max |diff| {lse_err:.3g}, dq/dk/dv max |diff| {err:.3g}, "
          f"{XLA_REPEATS} repeats bit for bit; kernel {ms:.3f} ms (plain "
          f"{plain_ms:.3f}, bound {bound:.4f} by {by}, "
          f"{n_ops / ms / 1e9:.2f} TFLOP/s); through autograd "
          f"{fn_ms:.3f} ms, the recompute's {recompute_ms:.3f} ms, SDPA "
          f"forward and backward {library_ms:.3f} ms", flush=True)
    return {"err": err, "lse_err": lse_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
            "fn_ms": fn_ms, "recompute_ms": recompute_ms, "ops": n_ops}


def _train_backwards() -> dict:
    """(c) at the serving shapes with S cut to ``TRAIN_BWD_S``: returns
    each kernel's Function launches and backward ms."""
    from repro_torch.kernels.attention import kernel as k4
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention import ref as attn_ref
    from repro_torch.kernels.rglru import kernel as k6
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.rglru import ref as rglru_ref
    from repro_torch.kernels.ssd import kernel as k5
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    S = TRAIN_BWD_S
    k4.launches = k5.launches = k6.launches = k4.bwd_launches = 0
    k4.launches_tc = k5.launches_tc = 0
    out = {}
    # the Function's forward, which the train steps use, at their shapes:
    # the one-pod step's, the fed step's a pod (fed_train) and the long one
    H, K, D = OLMO_PREFILL[3:]
    for B, T in ((TRAIN_BATCH, TRAIN_SEQ),
                 (TRAIN_BATCH // FED_PODS, TRAIN_SEQ), TRAIN_LONG):
        q, k, v = (t.requires_grad_(True) for t in
                   _qkv(B, T, T, H, K, D, torch.bfloat16, seed=11))
        before = k4.launches_tc
        got = attn_ops.FlashAttention.apply(q, k, v, True, None)
        want = attn_ref.attention_ref(q, k, v, True, None)
        err = float((got.detach().float()
                     - want.detach().float()).abs().max())
        print(f"  K4 Function forward ({B}, {T}, {H}, {K}, {D}): max |diff| "
              f"{err:.3g}", flush=True)
        if k4.launches_tc != before + 1 or not _close(
                got, want, K4_TOL["bfloat16"]):
            raise SystemExit(f"train (c): the K4 Function's forward at "
                             f"({B}, {T}, {H}, {K}, {D}) differs from the "
                             f"plain version by {err} or missed the "
                             f"tensor-core kernel")
        out[f"k4_fwd_{B}x{T}"] = err
        del q, k, v, got, want
    out["xla"] = {}
    g = torch.Generator(device="cuda").manual_seed(7)
    for name, (B, _, _, H, K, D), window in (
            ("olmo-1b", OLMO_PREFILL, None),
            ("recurrentgemma-2b", RG_PREFILL, RG_WINDOW)):
        ins = _qkv(B, S, S, H, K, D, torch.bfloat16, seed=3)
        gy = torch.randn((B, S, H, D), generator=g,
                         device="cuda").to(torch.bfloat16)
        err, ms, plain_ms, bytes_ms = _bwd_check(
            f"K4 {name} ({B}, {S}, {H}, {K}, {D})",
            lambda q, k, v: attn_ops.FlashAttention.apply(q, k, v, True,
                                                          window),
            lambda q, k, v: attn_ref.attention_ref(q, k, v, True, window),
            ins, (gy,))
        # the recomputed forward's products (4 B H D a live key) and the
        # backward's dP, dS Q/K and P^T dO products (8 B H D)
        ops_s = 12 * B * H * D * _live_keys(S, S, True, window) / BF16_S
        out[f"k4_{name}"] = (err, ms, plain_ms, max(bytes_ms, ops_s * 1e3))
        out[f"sdpa_{name}"] = _sdpa_backward_ms(ins, gy, H // K, window)
        out["xla"][f"{name}-s{S}"] = _xla_backward(
            name, B, S, H, K, D, window, seed=21)
    B, T = TRAIN_LONG
    out["xla"][f"olmo-1b-long-{B}x{T}"] = _xla_backward(
        "olmo-1b long step", B, T, *OLMO_PREFILL[3:], None, seed=23)
    B, _, H, P, N, chunk = MAMBA_PREFILL
    (xh, bm, cm, dt, a), _ = _ssd_inputs(B, S, H, P, N, torch.bfloat16,
                                         seed=5)
    h0 = torch.randn((B, H, P, N), generator=g, device="cuda")
    gy = torch.randn((B, S, H, P), generator=g, device="cuda")
    gh = torch.randn((B, H, P, N), generator=g, device="cuda")
    ins = [t.contiguous() for t in (xh, bm, cm, dt, a)]
    out["k5"] = _bwd_check(
        f"K5 mamba2-780m ({B}, {S}, {H}, {P}), N {N}, chunk {chunk}",
        lambda *t: ssd_ops.SSDScan.apply(*t, chunk, None),
        lambda *t: ssd_ref.ssd_chunked_ref(*t, chunk, None), ins, (gy,))
    out["k5_h0"] = _bwd_check(
        "K5 with h0 in, h_last out",
        lambda *t: ssd_ops.SSDScan.apply(*t[:5], chunk, t[5]),
        lambda *t: ssd_ref.ssd_chunked_ref(*t[:5], chunk, t[5]),
        ins + [h0], (gy, gh), n_out=2)
    B, _, R = RG_SCAN
    a, b, h = _k6_args(B, S, R, 0.5, 0.999, torch.float32, True, seed=9)
    gy = torch.randn((B, S, R), generator=g, device="cuda")
    out["k6"] = _bwd_check(
        f"K6 recurrentgemma-2b ({B}, {S}, {R})", rglru_ops.RGLRUScan.apply,
        rglru_ref.rglru_scan_ref, (a, b, h), (gy,))
    out["launches"] = {"k4": k4.launches, "k4_tc": k4.launches_tc,
                       "k4_bwd": k4.bwd_launches,
                       "k5": k5.launches, "k5_tc": k5.launches_tc,
                       "k6": k6.launches}
    return out


def phase_train():
    """(a) train() at olmo-1b's full width; (b) the whole step with K4
    against the plain attention in bf16 and float32; (c) the three
    backwards at kernel level; (d) a resumed run bit for bit."""
    import shutil
    import tempfile

    from repro_torch._tree import tree_leaves
    from repro_torch.dist import stepfns

    _process_group()
    t0 = time.time()
    # (a) the slice at full width, its step events read back
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.jsonl")
        state, history, launches, peak_gb, wall = _train_entry(
            "full", log_jsonl=path, log_every=1)
        with open(path) as f:
            events = [json.loads(line) for line in f]
    losses = [e["loss"] for e in events if e["event"] == "step"]
    n_steps = TRAIN_STEPS["full"] * TRAIN_RUNS["full"][1]
    if len(losses) != n_steps or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"train (a): step losses {losses}")
    want_k4 = n_steps * TRAIN_K4_A_STEP
    want_bwd = n_steps * TRAIN_K4_BWD_LAUNCHES_A_STEP
    if (launches["k4"], launches["k4_tc"], launches["k4_bwd"]) != (
            want_k4, want_k4, want_bwd):
        raise SystemExit(f"train (a): K4 ran {launches['k4']} times "
                         f"({launches['k4_tc']} on the tensor cores), the "
                         f"backward {launches['k4_bwd']}, not {want_k4} "
                         f"({TRAIN_K4_A_STEP} a step, all on the tensor "
                         f"cores) and {want_bwd} ({TRAIN_K4_BWD_A_STEP} "
                         f"calls a step, {K4_BWD_LAUNCHES_A_CALL} launches "
                         f"each)")
    step_ms = [h["wall_s"] * 1e3 / TRAIN_STEPS["full"] for h in history]
    # one more step of the same state, profiled: the device's busy share
    from repro_torch.configs import get_config
    from repro_torch.optim import OptimizerConfig

    cfg = get_config("olmo-1b").replace(grad_accum=1)
    step = stepfns.make_train_step(cfg, OptimizerConfig("adamw", lr=3e-3))
    tok = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                        device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(2))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    step_wall_ms, dev_ms, top = _timed_step(step, state, batch)
    print(f"  (a) losses {[round(x, 4) for x in losses]}; K4 "
          f"{launches['k4']} ({launches['k4_tc']} tensor cores), its "
          f"backward {launches['k4_bwd']}, K1 "
          f"{launches['k1']}, K2 {launches['k2']}, phase kernel "
          f"{launches['phase']}", flush=True)
    _print_top(f"a step at {TRAIN_BATCH} x {TRAIN_SEQ}", dev_ms,
               step_wall_ms, top)
    # one step at the published 2048-token context
    from repro_torch.kernels.attention import kernel as k4

    B, T = TRAIN_LONG
    tok = torch.randint(0, cfg.vocab_size, (B, T + 1), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(3))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k4.launches = k4.launches_tc = k4.bwd_launches = 0
    new, m = step(state, batch)
    long_loss = float(m["loss"])
    long_k4 = (k4.launches, k4.launches_tc, k4.bwd_launches)
    del new, m
    long_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not math.isfinite(long_loss) or long_k4 != (
            TRAIN_K4_A_STEP, TRAIN_K4_A_STEP, TRAIN_K4_BWD_LAUNCHES_A_STEP):
        raise SystemExit(f"train (a) at {B} x {T}: loss {long_loss}, K4 "
                         f"and its backward {long_k4} (not "
                         f"{TRAIN_K4_A_STEP} a step, all on the tensor "
                         f"cores, and {TRAIN_K4_BWD_LAUNCHES_A_STEP})")
    long_wall_ms, long_dev_ms, long_top = _timed_step(step, state, batch)
    _print_top(f"a step at {B} x {T} (loss {long_loss:.6f}, peak "
               f"{long_peak_gb:.3f} GB)", long_dev_ms, long_wall_ms,
               long_top)
    # the same step through attn_impl="pallas" (K4, then the plain
    # recompute in the backward): its peak and ms beside the chunked one's
    pallas = stepfns.make_train_step(cfg.replace(attn_impl="pallas"),
                                     OptimizerConfig("adamw", lr=3e-3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    new, m = pallas(state, batch)
    pallas_loss = float(m["loss"])
    del new, m
    pallas_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pallas_wall_ms, pallas_dev_ms, pallas_top = _timed_step(pallas, state,
                                                            batch)
    _print_top(f"the same step through \"pallas\" (loss {pallas_loss:.6f}, "
               f"peak {pallas_peak_gb:.3f} GB)", pallas_dev_ms,
               pallas_wall_ms, pallas_top)
    del state, batch, tok

    # (b) the kernel against its plain version through a whole step
    runs = _train_whole_step()
    if (runs["kernel"]["k4"], runs["kernel"]["k4_tc"],
            runs["kernel"]["k4_bwd"]) != (
            TRAIN_K4_A_STEP, TRAIN_K4_A_STEP,
            TRAIN_K4_BWD_LAUNCHES_A_STEP) or \
            runs["plain"]["k4"] or runs["f32"]["k4"] or \
            runs["plain"]["k4_bwd"] or runs["f32"]["k4_bwd"]:
        raise SystemExit(f"train (b): K4 launches "
                         f"{[runs[k]['k4'] for k in runs]}, its backward "
                         f"{[runs[k]['k4_bwd'] for k in runs]}")
    held = _hold_whole_step(runs)
    del runs

    # (c) the three backwards at kernel level
    bwd = _train_backwards()
    checks = {k: v for k, v in bwd.items()
              if isinstance(v, tuple) and not k.startswith("sdpa_")}

    # (d) resume: only round 2's checkpoint into a fresh directory
    with tempfile.TemporaryDirectory() as tmp:
        full_dir, fresh = os.path.join(tmp, "full"), os.path.join(tmp, "re")
        full, _, res_launches, _, full_wall = _train_entry(
            "resume", ckpt_dir=full_dir, resume=False)
        os.makedirs(fresh)
        shutil.copy(os.path.join(full_dir, "step_2.ckpt"), fresh)
        ckpt_gb = os.path.getsize(os.path.join(fresh, "step_2.ckpt")) / 1e9
        resumed, hist, _, _, resume_wall = _train_entry(
            "resume", ckpt_dir=fresh)
    a = (tree_leaves(full.params) + tree_leaves(full.opt.mu)
         + tree_leaves(full.opt.nu) + [full.opt.step])
    b = (tree_leaves(resumed.params) + tree_leaves(resumed.opt.mu)
         + tree_leaves(resumed.opt.nu) + [resumed.opt.step])
    if [h["round"] for h in hist] != [2] or len(a) != len(b) or not all(
            torch.equal(x, y) for x, y in zip(a, b)):
        raise SystemExit("train (d): the resumed run's state differs from "
                         "the uninterrupted run's")
    del full, resumed, a, b

    _line("train", time.time() - t0, arch="olmo-1b", layers=16,
          batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=n_steps,
          wall_s=f"{wall:.3f}",
          step_ms=",".join(f"{x:.3f}" for x in step_ms),
          step_wall_ms=f"{step_wall_ms:.3f}",
          profiled_step_device_ms=("not measured" if dev_ms is None
                                   else f"{dev_ms:.3f}"),
          device_busy=("not measured" if dev_ms is None
                       else f"{dev_ms / step_wall_ms:.3f}"),
          peak_gb=f"{peak_gb:.3f}", k4=launches["k4"],
          k4_tc=launches["k4_tc"], k1=launches["k1"], k2=launches["k2"],
          phase_launches=launches["phase"], long_batch=B, long_seq=T,
          long_loss=f"{long_loss:.6f}", long_k4=long_k4[0],
          long_k4_bwd=long_k4[2], k4_bwd=launches["k4_bwd"],
          long_step_ms=f"{long_wall_ms:.3f}",
          long_device_ms=("not measured" if long_dev_ms is None
                          else f"{long_dev_ms:.3f}"),
          long_device_busy=("not measured" if long_dev_ms is None
                            else f"{long_dev_ms / long_wall_ms:.3f}"),
          long_peak_gb=f"{long_peak_gb:.3f}",
          long_pallas_loss=f"{pallas_loss:.6f}",
          long_pallas_step_ms=f"{pallas_wall_ms:.3f}",
          long_pallas_device_ms=("not measured" if pallas_dev_ms is None
                                 else f"{pallas_dev_ms:.3f}"),
          long_pallas_peak_gb=f"{pallas_peak_gb:.3f}",
          k4_fwd_err={k: f"{v:.3g}" for k, v in bwd.items()
                      if k.startswith("k4_fwd")},
          syncs_held="yes", **held,
          bwd_ms={k: f"{v[1]:.3f}" for k, v in checks.items()},
          bwd_plain_ms={k: f"{v[2]:.3f}" for k, v in checks.items()},
          bwd_bound_ms={k: f"{v[3]:.5f}" for k, v in checks.items()},
          bwd_library_fwd_bwd_ms={k: f"{v:.3f}" for k, v in bwd.items()
                                  if k.startswith("sdpa_")},
          **{f"lse_bwd_{key}": {k: f"{v[key]:.5g}" for k, v in
                                bwd["xla"].items()}
             for key in ("err", "lse_err", "ms", "plain_ms", "bound_ms",
                         "fn_ms", "recompute_ms", "library_ms")},
          resume_bitwise="yes", ckpt_gb=f"{ckpt_gb:.3f}",
          resume_full_wall_s=f"{full_wall:.3f}",
          resume_wall_s=f"{resume_wall:.3f}", resume_k4=res_launches["k4"])
    return {"olmo-1b-train": launches, "bwd": bwd}


def _fed_kernels() -> dict:
    """The kernel counts of the federated path: those of the training
    path, and K3 and K3' in the int8 rounds."""
    from repro_torch.kernels.quant import kernel as k3

    return {**_train_kernels(), "k3": _CountOf(k3, "quantize_launches"),
            "k3p": _CountOf(k3, "dequantize_launches")}


def _fed_entry(name: str, log_jsonl=None, **kw):
    """``train()``'s federated branch at olmo-1b's width, reached as a
    user with ``FED_PODS`` devices reaches it (here through its
    ``device_count`` seam), with the kernels' counts set to 0 just before
    and read just after. Returns (state, history, launches, wall s)."""
    from repro_torch.launch import train as ttrain

    overrides, rounds, extra = FED_RUNS[name]
    kernels = _fed_kernels()
    torch.cuda.synchronize()
    for kernel in kernels.values():
        kernel.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(ttrain, "device_count", lambda dev: FED_PODS):
        state, history = ttrain.train(
            arch="olmo-1b", smoke=False, steps_per_round=FED_STEPS[name],
            rounds=rounds, n_pods=FED_PODS, global_batch=TRAIN_BATCH,
            seq_len=TRAIN_SEQ, config_overrides=overrides,
            log_jsonl=log_jsonl, device="cuda", **extra, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernel.launches for k, kernel in kernels.items()}
    syncs = tuple(h["sync_s"] for h in history)
    want = FED_SYNC_PINS[name][-len(syncs):] if syncs else ()
    if len(syncs) != len(want) or any(
            abs(a - b) > SYNC_TOL for a, b in zip(syncs, want)):
        raise SystemExit(f"fed_train {name}: round syncs {syncs}, pinned "
                         f"{want}")
    return state, history, launches, wall


def _bitwise(a, b) -> bool:
    """Two trees of tensors (dicts, NamedTuples, tuples) equal bit for
    bit, float32 by their bits."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths

    la, lb = ([t for _, t in _flatten_with_paths(x)] for x in (a, b))

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(bits(x), bits(y)) for x, y in zip(la, lb))


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms for one hold (cuBLAS needs its
    workspace setting named; 4096:8 is the H100's default, 32 MiB)."""
    was = torch.are_deterministic_algorithms_enabled()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = env or ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]


def _plain_quant():
    """A patch under which the int8 dispatch takes the plain versions on
    the card's tensors (a hold's yardstick; no user reaches it)."""
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref

    return mock.patch.multiple(
        qops,
        quantize_int8=lambda x, block=qref.DEFAULT_BLOCK:
            qref.quantize_int8_ref(x, block),
        dequantize_int8=lambda q, s, block=qref.DEFAULT_BLOCK:
            qref.dequantize_int8_ref(q, s, block))


def _process_group() -> None:
    """The smoke's process group, started once: one rank on an
    in-process ``HashStore``, NCCL, on card 0. ``train()`` and the mesh
    holds run their meshes on it."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", 0))


def _fed_mesh_step(cfg, opt_cfg, state, batch):
    """The fed step on ``state`` placed on a one-rank ``("pod", "data",
    "model")`` mesh by ``launch/specs.py`` (its pod axis ``Shard(0)``
    over ``pod``, both pods on the rank), the batch by ``shard_batch``,
    the per-pod ``grad_shardings`` and ``spmd_axis_name="pod"``: the
    new state and metrics as whole tensors."""
    from repro_torch import _dtensor
    from repro_torch._tree import tree_map
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import stepfns
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_host_mesh

    _process_group()
    mesh = make_host_mesh(1, pods=1, pod_axis=True)
    spec = specs.state_spec_tree(state, cfg, mesh, fed=True)
    placed = specs.place_tree(state, spec, mesh)
    sub = mesh["data", "model"]
    grad_sh = tree_map(lambda s: shd.to_placements(shd.P(*s[1:]), sub),
                       spec.params)
    new, m = stepfns.make_fed_train_step(
        cfg, opt_cfg, grad_shardings=grad_sh, spmd_axis_name="pod")(
            placed, shard_batch(batch, mesh, shd.P("pod", "data", None)))
    if not _dtensor.is_dtensor(new.opt.step):
        raise SystemExit("fed_train (c): the mesh step left the mesh")
    return (tree_map(_dtensor.full, new),
            {k: _dtensor.full(v) for k, v in m.items()})


def _fed_holds(cfg, state, state2, batch, n_leaves: int) -> dict:
    """(c) at (a)'s shapes: one fed step on the pod-sharded DTensor state
    against the no-mesh single-pod step on each pod's slice, bit for bit
    under deterministic algorithms; the int8 FedAvg (with and without
    error feedback) and FedBuff rounds against the same calls through
    the plain quantiser, bit for bit, K3 and K3' once a stacked leaf
    each."""
    from repro_torch._tree import tree_map
    from repro_torch.dist import stepfns
    from repro_torch.kernels.quant import kernel as k3
    from repro_torch.optim import OptimizerConfig

    opt_cfg = OptimizerConfig("adamw", lr=3e-3)
    with _deterministic():
        fed, fm = _fed_mesh_step(cfg, opt_cfg, state2, batch)
        single = stepfns.make_train_step(cfg, opt_cfg)
        for i in range(FED_PODS):
            pod = tree_map(lambda l: l[i].clone(), state2)
            one, m = single(pod, {k: v[i] for k, v in batch.items()})
            if not (_bitwise(tree_map(lambda l: l[i], fed), one)
                    and all(torch.equal(fm[k][i], m[k]) for k in m)):
                raise SystemExit(f"fed_train (c): pod {i}'s fed step on the "
                                 f"mesh differs from the no-mesh single-pod "
                                 f"step on its slice")
            del pod, one
        del fed
    dev = torch.device("cuda")
    w = torch.ones(FED_PODS, device=dev)
    calls = {
        "fedavg": (stepfns.make_fed_round_step(cfg, "int8"), (state2, w)),
        "fedavg_ef": (stepfns.make_fed_round_step(cfg, "int8",
                                                  error_feedback=True),
                      (state2, w, stepfns.init_round_residuals(state2))),
        "fedbuff": (stepfns.make_async_round_step(
            cfg, "int8", quorum_frac=0.5, quorum_expected=FED_PODS),
            (state2, stepfns.init_async_state(state), w,
             torch.ones(FED_PODS, dtype=torch.bool, device=dev),
             torch.tensor([0, 1], dtype=torch.int32, device=dev),
             torch.tensor([1.0, 0.5], device=dev),
             torch.ones(FED_PODS, dtype=torch.bool, device=dev),
             torch.ones(FED_PODS, dtype=torch.bool, device=dev)))}
    held = {}
    for name, (fn, args) in calls.items():
        k3.quantize_launches = k3.dequantize_launches = 0
        got = fn(*args)
        torch.cuda.synchronize()
        counts = (k3.quantize_launches, k3.dequantize_launches)
        with _plain_quant():
            want = fn(*args)
        if counts != (n_leaves, n_leaves) or not _bitwise(got, want):
            raise SystemExit(f"fed_train (c): the int8 {name} round with K3 "
                             f"({counts} launches for {n_leaves} leaves) "
                             f"differs from its plain quantiser's")
        held[name] = counts[0]
        del got, want
    return held


def _fed_leaf(state, state2):
    """(c) K3 and K3' alone on the largest stacked leaf's pod deltas (the
    payload of a FedBuff round), one block a pod: held to the plain
    versions bit for bit, then timed beside them and the bound."""
    from repro_torch._tree import tree_leaves

    pairs = sorted(zip(tree_leaves(state2.params), tree_leaves(state.params)),
                   key=lambda p: p[0].numel())
    new, old = pairs[-1]
    x = (new.float() - old.float()).contiguous()
    block = x[0].numel()
    _k3_hold(x, block, f"the stacked fed leaf {tuple(x.shape)}, one block "
                       f"a pod")
    times = _k3_timed([x], block)
    bound, d_bound, by = _k3_bounds(x.numel(), block, 4)
    return {"shape": list(x.shape), "block": block, **times,
            "bound_ms": bound, "dq_bound_ms": d_bound, "bound_by": by}


def phase_fed_train():
    """(a) train()'s federated branch at olmo-1b's width, two pods, int8
    FedAvg rounds; (b) its coupled FedBuff branch under a deadline,
    faults and quorum; (c) the fed step and the int8 rounds held, K3/K3'
    alone at the largest fed leaf; (d) a resumed coupled run bit for
    bit."""
    import tempfile

    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.dist import stepfns
    from repro_torch.optim import OptimizerConfig

    _process_group()
    t0 = time.time()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("olmo-1b").replace(grad_accum=1, n_layers=FED_LAYERS)
    k4_a_step = 2 * FED_LAYERS * FED_PODS   # forward + recompute, a pod
    # the backward from the lse, its launches
    bwd_a_step = FED_LAYERS * FED_PODS * K4_BWD_LAUNCHES_A_CALL
    runs = {}
    # (a) and (b): the branch at olmo-1b's width, events read back
    for name, path_name in (("fed", "olmo-1b-fed"),
                            ("fed_async", "olmo-1b-fed-async")):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "train.jsonl")
            state, history, launches, wall = _fed_entry(
                name, log_jsonl=path, log_every=1)
            with open(path) as f:
                events = [json.loads(line) for line in f]
        n_leaves = len(tree_leaves(state.params))
        n_rounds = FED_RUNS[name][1]
        n_steps = FED_STEPS[name] * n_rounds
        losses = [e["loss"] for e in events if e["event"] == "step"]
        if len(losses) != n_steps or not all(math.isfinite(x)
                                             for x in losses):
            raise SystemExit(f"fed_train {name}: step losses {losses}")
        if events[0]["shape"] != {"pod": FED_PODS, "data": 1, "model": 1}:
            raise SystemExit(f"fed_train {name}: mesh {events[0]}")
        want = {"k4": n_steps * k4_a_step, "k4_tc": n_steps * k4_a_step,
                "k4_bwd": n_steps * bwd_a_step,
                "k3": n_leaves * n_rounds, "k3p": n_leaves * n_rounds}
        if any(launches[k] != v for k, v in want.items()):
            raise SystemExit(f"fed_train {name}: launches {launches}, want "
                             f"{want} (K4 {k4_a_step} a step, all on the "
                             f"tensor cores; its backward {bwd_a_step}; K3 "
                             f"and K3' one a stacked leaf a round)")
        if tuple(state.opt.step.shape) != (FED_PODS,):
            raise SystemExit(f"fed_train {name}: not a pod-stacked state")
        step_ms = [h["wall_s"] * 1e3 / FED_STEPS[name] for h in history]
        print(f"  ({'a' if name == 'fed' else 'b'}) {name}: losses "
              f"{[round(x, 4) for x in losses]}; syncs "
              f"{[h['sync_s'] for h in history]}; K4 {launches['k4']} "
              f"({launches['k4_tc']} tensor cores), its backward "
              f"{launches['k4_bwd']}, K3 {launches['k3']}, "
              f"K3' {launches['k3p']}, K1 {launches['k1']}, K2 "
              f"{launches['k2']}, phase kernel {launches['phase']}; "
              f"{wall:.3f} s", flush=True)
        runs[path_name] = {"launches": launches, "wall_s": wall,
                           "step_ms": step_ms, "losses": losses}
        if name == "fed_async":
            del state
        else:
            fed_state = state
    state = fed_state
    peak_ab = torch.cuda.max_memory_allocated() / 1e9
    split = {"ab": time.time() - t0}

    # a step and a round of (a)'s state timed, and profiled: busy share
    opt_cfg = OptimizerConfig("adamw", lr=3e-3)
    fed_step = stepfns.make_fed_train_step(cfg, opt_cfg)
    round_step = stepfns.make_fed_round_step(cfg, "int8")
    g = torch.Generator(device="cuda").manual_seed(4)
    tok = torch.randint(0, cfg.vocab_size, (FED_PODS, TRAIN_BATCH // FED_PODS,
                                            TRAIN_SEQ + 1), device="cuda",
                        generator=g)
    batch = {"tokens": tok[..., :-1], "labels": tok[..., 1:]}
    state2, _ = fed_step(state, batch)       # the pods apart again
    step_wall_ms, dev_ms, top = _timed_step(fed_step, state, batch)
    _print_top(f"a fed step, {FED_PODS} pods x {TRAIN_BATCH // FED_PODS} x "
               f"{TRAIN_SEQ}", dev_ms, step_wall_ms, top)
    weights = torch.ones(FED_PODS, device="cuda")
    round_wall_ms, round_dev_ms, round_top = _timed_step(round_step, state2,
                                                         weights)
    _print_top("an int8 FedAvg round", round_dev_ms, round_wall_ms,
               round_top)
    split["timed"] = time.time() - t0 - sum(split.values())

    # (c) the holds at (a)'s shapes
    n_leaves = len(tree_leaves(state.params))
    tok = torch.randint(0, cfg.vocab_size, tok.shape, device="cuda",
                        generator=g)
    held = _fed_holds(cfg, state, state2,
                      {"tokens": tok[..., :-1], "labels": tok[..., 1:]},
                      n_leaves)
    split["holds"] = time.time() - t0 - sum(split.values())
    leaf = _fed_leaf(state, state2)
    split["leaf"] = time.time() - t0 - sum(split.values())
    print(f"  K3 at the fed leaf {leaf['shape']} (block {leaf['block']}): "
          f"{leaf['ms']:.5f} ms (plain {leaf['plain_ms']:.5f}, bound "
          f"{leaf['bound_ms']:.5f}); K3' {leaf['dq_ms']:.5f} ms (plain "
          f"{leaf['dq_plain_ms']:.5f}, torch.mul "
          f"{leaf['dq_library_ms']:.5f}, bound {leaf['dq_bound_ms']:.5f})",
          flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state, state2, batch, tok

    # (d) resume: only round 2's checkpoint into a fresh directory; the
    # dry run's cell of mesh (d) runs beside these writes
    _dryrun_cell_start()
    with tempfile.TemporaryDirectory() as tmp:
        full_dir, fresh = os.path.join(tmp, "full"), os.path.join(tmp, "re")
        full, _, res_launches, full_wall = _fed_entry(
            "fed_resume", ckpt_dir=full_dir, resume=False)
        os.makedirs(fresh)
        # moved, not copied: the uninterrupted run is done with it
        os.replace(os.path.join(full_dir, "step_2.ckpt"),
                   os.path.join(fresh, "step_2.ckpt"))
        ckpt_gb = os.path.getsize(os.path.join(fresh, "step_2.ckpt")) / 1e9
        resumed, hist, _, resume_wall = _fed_entry("fed_resume",
                                                   ckpt_dir=fresh)
    if [h["round"] for h in hist] != [2] or not _bitwise(full, resumed):
        raise SystemExit("fed_train (d): the resumed coupled run's state "
                         "differs from the uninterrupted run's")
    del full, resumed
    split["resume"] = time.time() - t0 - sum(split.values())

    a, b = runs["olmo-1b-fed"], runs["olmo-1b-fed-async"]
    _line("fed_train", time.time() - t0, arch="olmo-1b", layers=FED_LAYERS,
          reduced=f"{FED_LAYERS} of 16 layers (memory)", pods=FED_PODS,
          batch=TRAIN_BATCH, seq=TRAIN_SEQ, syncs_held="yes",
          wall_s=f"{a['wall_s']:.3f}",
          step_ms_by_round=",".join(f"{x:.3f}" for x in a["step_ms"]),
          step_wall_ms=f"{step_wall_ms:.3f}",
          profiled_step_device_ms=("not measured" if dev_ms is None
                                   else f"{dev_ms:.3f}"),
          device_busy=("not measured" if dev_ms is None
                       else f"{dev_ms / step_wall_ms:.3f}"),
          round_step_ms=f"{round_wall_ms:.3f}",
          round_step_device_ms=("not measured" if round_dev_ms is None
                                else f"{round_dev_ms:.3f}"),
          round_device_busy=("not measured" if round_dev_ms is None
                             else f"{round_dev_ms / round_wall_ms:.3f}"),
          peak_gb_ab=f"{peak_ab:.3f}", peak_gb=f"{peak_gb:.3f}",
          **{f"{k}_launches": v for k, v in a["launches"].items()},
          async_wall_s=f"{b['wall_s']:.3f}",
          async_step_ms_by_round=",".join(f"{x:.3f}"
                                          for x in b["step_ms"]),
          **{f"async_{k}_launches": v for k, v in b["launches"].items()},
          step_held_bitwise="yes",
          rounds_held_bitwise=",".join(f"{k}:{v}" for k, v in held.items()),
          fed_leaf=leaf["shape"], fed_leaf_k3_ms=f"{leaf['ms']:.5f}",
          fed_leaf_k3_plain_ms=f"{leaf['plain_ms']:.5f}",
          fed_leaf_k3_bound_ms=f"{leaf['bound_ms']:.5f}",
          fed_leaf_k3p_ms=f"{leaf['dq_ms']:.5f}",
          fed_leaf_k3p_plain_ms=f"{leaf['dq_plain_ms']:.5f}",
          fed_leaf_k3p_library_ms=f"{leaf['dq_library_ms']:.5f}",
          fed_leaf_k3p_bound_ms=f"{leaf['dq_bound_ms']:.5f}",
          resume_bitwise="yes",
          resume_reduced="1 of 16 layers (checkpoint I/O)",
          ckpt_gb=f"{ckpt_gb:.3f}",
          resume_full_wall_s=f"{full_wall:.3f}",
          resume_wall_s=f"{resume_wall:.3f}", resume_k4=res_launches["k4"],
          split_s={k: f"{v:.1f}" for k, v in split.items()})
    return {**{p: r["launches"] for p, r in runs.items()}, "leaf": leaf}


def _mesh_batches(cfg):
    """The host batches ``train()`` draws for one pod: ``TokenBatcher``
    over ``lm_tokens`` (seed 0), ``MESH_STEPS`` of them."""
    from repro_torch.data import TokenBatcher, lm_tokens

    it = iter(TokenBatcher(lm_tokens(400_000, cfg.vocab_size, seed=0),
                           TRAIN_BATCH, TRAIN_SEQ, seed=0))
    return [next(it) for _ in range(MESH_STEPS)]


def _mesh_steps(cfg, opt_cfg, schedule, on_mesh: bool):
    """``MESH_STEPS`` steps of a fresh full-width state (``train()``'s
    init, seed 0) on ``_mesh_batches``: through the mesh step (the state
    placed by ``launch/specs.py``, the batches by ``shard_batch``, the
    gradients pinned to the parameters' placements) or through
    ``make_train_step`` on plain tensors. Returns (the final state, the
    last batch, the step, each step's (loss, grad norm), K4 launches, of
    them on the tensor cores, and its backward's)."""
    from repro_torch import _dtensor
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import stepfns
    from repro_torch.kernels.attention import kernel as k4
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_host_mesh

    state = stepfns.init_train_state(cfg, opt_cfg, device="cuda")
    hosts = _mesh_batches(cfg)
    if on_mesh:
        mesh = make_host_mesh(1)
        spec = specs.state_spec_tree(state, cfg, mesh)
        state = specs.place_tree(state, spec, mesh)
        step = stepfns.make_train_step(
            cfg, opt_cfg, schedule,
            grad_shardings=shd.spec_tree_placements(spec.params, mesh))
        batches = [shard_batch(b, mesh) for b in hosts]
    else:
        step = stepfns.make_train_step(cfg, opt_cfg, schedule)
        batches = [{k: torch.as_tensor(v, device="cuda")
                    for k, v in b.items()} for b in hosts]
    k4.launches = k4.launches_tc = k4.bwd_launches = 0
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append((_dtensor.full(m["loss"]),
                        _dtensor.full(m["grad_norm"])))
    torch.cuda.synchronize()
    launches = (k4.launches, k4.launches_tc, k4.bwd_launches)
    if on_mesh and not _dtensor.is_dtensor(state.opt.step):
        raise SystemExit("mesh (a): the mesh step left the mesh")
    return state, batches[-1], step, metrics, launches


def _spec_bytes(tree, mesh) -> float:
    """Bytes one device of ``mesh`` holds of a tree of ``TensorSpec``s:
    each dim cut by the sizes of its spec's axes, rounded up."""
    from repro_torch._tree import tree_leaves

    sizes = dict(mesh.shape)
    total = 0
    for t in tree_leaves(tree):
        n = 1
        for d, size in enumerate(t.shape):
            entry = t.spec[d] if d < len(t.spec) else None
            axes = (() if entry is None else entry if isinstance(entry, tuple)
                    else (entry,))
            split = math.prod(sizes[a] for a in axes)
            n *= -(-size // split)
        total += n * t.dtype.itemsize
    return total


def _spec_table() -> dict:
    """(b): each config's parameter and moment bytes a device on the two
    production meshes (single pod, and fed with two pods), from
    ``launch/specs.py``'s specs of its meta-device state."""
    from repro_torch.configs import get_config, list_architectures
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.optim import OptimizerConfig

    table = {}
    for arch in list_architectures():
        cfg = get_config(arch)
        row = {}
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            st, _ = specs.state_specs(cfg, OptimizerConfig(), mesh,
                                      fed=multi, n_pods=2)
            key = "2x16x16" if multi else "16x16"
            row[f"{key}_params_gb"] = round(
                _spec_bytes(st.params, mesh) / 1e9, 4)
            row[f"{key}_moments_gb"] = round(
                (_spec_bytes(st.opt.mu, mesh)
                 + _spec_bytes(st.opt.nu, mesh)) / 1e9, 4)
        table[arch] = row
        print(f"  {arch}: " + ", ".join(f"{k} {v}" for k, v in row.items()),
              flush=True)
    return table


_DRYRUN_CELL: list = []          # (process, record path, its directory)


def _dryrun_cell_start() -> None:
    """``mesh`` (d), started (once): ``olmo-1b x train_4k x 16x16``
    through the dry run's CLI (``python -m repro_torch.launch.dryrun``)
    in a process of its own (this one's process group is up). The
    smoke starts it beside ``fed_train``'s checkpoint writes, where its
    host work slows no timed step; ``mesh`` alone starts it itself."""
    import atexit
    import tempfile

    if _DRYRUN_CELL:
        return
    out_dir = tempfile.mkdtemp()
    path = os.path.join(out_dir, "dryrun_olmo_train.jsonl")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    # at a lower priority than this process, whose steps it runs beside
    proc = subprocess.Popen(
        ["nice", "-n", "10", sys.executable, "-m",
         "repro_torch.launch.dryrun", "--arch", "olmo-1b", "--shape",
         "train_4k", "--mesh", "single", "--out", path], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _DRYRUN_CELL.append((proc, path, out_dir))
    atexit.register(_dryrun_cell_stop)


def _dryrun_cell_stop() -> None:
    """Kill the (d) process if it still runs; remove its directory."""
    import shutil

    while _DRYRUN_CELL:
        proc, _, out_dir = _DRYRUN_CELL.pop()
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)


def _dryrun_cell_finish() -> dict:
    """(d), ended: the cell's record, which must be ``ok``, from the CLI
    that printed ``1/1 cells OK`` and exited 0; its numbers printed."""
    from repro_torch.launch import roofline

    proc, path, _ = _DRYRUN_CELL[0]
    text, _ = proc.communicate(timeout=900)
    if proc.returncode or "1/1 cells OK" not in text:
        raise SystemExit(f"mesh (d): the dry run failed ({proc.returncode}):"
                         f"\n{text[-4000:]}")
    with open(path) as f:
        rec = json.loads(f.readlines()[-1])
    _dryrun_cell_stop()
    row = roofline.analyze_record(rec)
    if row is None or rec["kernels"].get("flash_attention_lse", 0) < 1 or \
            rec["kernels"].get("flash_attention_bwd", 0) < 1:
        raise SystemExit(f"mesh (d): not an ok record through K4 and the "
                         f"backward from its lse: {rec}")
    mem = rec["memory_analysis"]
    print(f"  (d) dry run olmo-1b x train_4k x 16x16 (fake cuda, one rank "
          f"of 256): trace {rec['lower_s']} s, flops {rec['hlo_flops']:.6e}, "
          f"hbm {rec['hlo_hbm_bytes']:.6e} B, dots {rec['hlo_dot_count']}, "
          f"collectives {rec['collectives']['per_kind']}, kernels "
          f"{rec['kernels']}, args {mem['argument_size_in_bytes']} B, temp "
          f"{mem['temp_size_in_bytes']} B; at the H100's peaks compute "
          f"{row.compute_s:.6f} s, memory {row.memory_s:.6f} s, "
          f"collective {row.collective_s:.6f} s ({row.dominant}), useful "
          f"{row.useful_ratio:.4f}", flush=True)
    return rec


def _dryrun_hold(step, state, batch, step_ms: float) -> dict:
    """(c): one real step of ``step`` on the card under the dry run's op
    counter, and the same step traced on fake tensors of the same shapes
    on a fake ``cuda`` device: every count equal (per operator, dot
    FLOPs, HBM bytes, products, kernel operators; K4 with its lse
    ``TRAIN_K4_A_STEP`` a step, the backward from it
    ``TRAIN_K4_BWD_A_STEP``), the real step's launches those of its
    kernel operators (``K4_BWD_LAUNCHES_A_CALL`` a backward). Prints the
    roofline terms at the H100's peaks beside ``step_ms``."""
    from repro_torch.kernels.attention import kernel as k4
    from repro_torch.launch import dryrun, roofline

    before = (k4.launches, k4.bwd_launches)
    real = dryrun.trace_step(step, (state, batch))
    torch.cuda.synchronize()
    launched = (k4.launches - before[0], k4.bwd_launches - before[1])
    mode = dryrun.fake_mode()
    fake_args = dryrun._map(lambda t: mode.from_tensor(t)
                            if isinstance(t, torch.Tensor) else t,
                            (state, batch))
    fake = dryrun.trace_step(step, fake_args)
    if (k4.launches - before[0], k4.bwd_launches - before[1]) != launched:
        raise SystemExit("mesh (c): the fake trace launched K4 or its "
                         "backward")
    keys = ("ops", "hlo_flops", "hlo_hbm_bytes", "hlo_dot_count", "kernels")
    diff = {k: (real[k], fake[k]) for k in keys if real[k] != fake[k]}
    if diff.get("ops"):
        r, f = diff["ops"]
        diff["ops"] = {n: (r.get(n), f.get(n)) for n in set(r) | set(f)
                       if r.get(n) != f.get(n)}
    want = {"flash_attention_lse": TRAIN_K4_A_STEP,
            "flash_attention_bwd": TRAIN_K4_BWD_A_STEP}
    if (diff or real["kernels"] != want
            or launched != (TRAIN_K4_A_STEP,
                            TRAIN_K4_BWD_LAUNCHES_A_STEP)):
        raise SystemExit(f"mesh (c): the fake trace differs from the "
                         f"card's step: {diff}; kernels {real['kernels']} "
                         f"(want {want}), K4 and its backward launched "
                         f"{launched}")
    row = roofline.analyze_record(dict(
        real, ok=True, arch="olmo-1b", shape="train", mesh="1",
        kind="train"))
    bound_ms = max(row.compute_s, row.memory_s) * 1e3
    print(f"  (c) a step at {TRAIN_BATCH} x {TRAIN_SEQ}: {step_ms:.3f} ms "
          f"measured; counted {real['hlo_flops']:.6e} dot flops, "
          f"{real['hlo_hbm_bytes']:.6e} HBM B, {real['hlo_dot_count']} "
          f"products, {sum(real['ops'].values())} operators, kernels "
          f"{real['kernels']}: at the H100's peaks compute "
          f"{row.compute_s * 1e3:.3f} ms, memory {row.memory_s * 1e3:.3f} "
          f"ms (bound {bound_ms:.3f} ms, {step_ms / bound_ms:.1f}x); temp "
          f"{real['memory_analysis']['temp_size_in_bytes']} B real, "
          f"{fake['memory_analysis']['temp_size_in_bytes']} B fake; trace "
          f"{fake['lower_s']} s", flush=True)
    return {"real": real, "fake": fake, "compute_ms": row.compute_s * 1e3,
            "memory_ms": row.memory_s * 1e3}


def phase_mesh():
    """(a) olmo-1b at its published width and depth through the mesh
    step, bit for bit the no-mesh steps, both timed; (b) the production
    meshes' spec table; (c) the no-mesh step on the card under the dry
    run's op counter, equal in every count to its fake trace; (d) one
    production cell through the dry run's CLI, started beside
    ``fed_train``'s checkpoint writes (here, after (a)'s timed steps, when
    ``mesh`` runs alone). ``split_s`` gives each part's seconds, ``d``
    the wait for the cell, ``c+d`` what (c) and (d) add to the phase."""
    _process_group()
    t0 = time.time()
    try:
        return _mesh_parts(t0)
    finally:
        _dryrun_cell_stop()


def _mesh_parts(t0: float) -> dict:
    from repro_torch import _dtensor
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.optim import OptimizerConfig, warmup_cosine

    cfg = get_config("olmo-1b").replace(grad_accum=1)
    opt_cfg = OptimizerConfig(name="adamw", lr=3e-3)
    schedule = warmup_cosine(3e-3, 20, MESH_STEPS)
    k4_want = (MESH_STEPS * TRAIN_K4_A_STEP, MESH_STEPS * TRAIN_K4_A_STEP,
               MESH_STEPS * TRAIN_K4_BWD_LAUNCHES_A_STEP)
    with _deterministic():
        plain, plain_batch, plain_step, plain_m, plain_k4 = _mesh_steps(
            cfg, opt_cfg, schedule, on_mesh=False)
        mesh, mesh_batch, mesh_step, mesh_m, mesh_k4 = _mesh_steps(
            cfg, opt_cfg, schedule, on_mesh=True)
        if (not _bitwise(tree_map(_dtensor.full, mesh), plain)
                or mesh_k4 != plain_k4
                or plain_k4 != k4_want
                or not all(torch.equal(a, b) for x, y in zip(mesh_m, plain_m)
                           for a, b in zip(x, y))):
            raise SystemExit(
                f"mesh (a): the mesh step differs from the no-mesh step: "
                f"(loss, grad norm) {[tuple(map(float, m)) for m in mesh_m]}"
                f" / {[tuple(map(float, m)) for m in plain_m]}, K4, of "
                f"them on the tensor cores, and its backward {mesh_k4} / "
                f"{plain_k4} (want {k4_want})")
        n_leaves = len(tree_leaves(plain.params))
    # one more step of each final state, timed and profiled (outside
    # deterministic mode, as train() runs)
    plain_ms, plain_dev, plain_top = _timed_step(plain_step, plain,
                                                 plain_batch)
    mesh_ms, mesh_dev, mesh_top = _timed_step(mesh_step, mesh, mesh_batch)
    del mesh
    _print_top(f"a no-mesh step at {TRAIN_BATCH} x {TRAIN_SEQ}", plain_dev,
               plain_ms, plain_top)
    _print_top(f"a mesh step at {TRAIN_BATCH} x {TRAIN_SEQ}", mesh_dev,
               mesh_ms, mesh_top)
    split = {"a": time.time() - t0}
    # (d) runs beside fed_train's checkpoint writes, or (mesh alone) here,
    # after the timed steps (its host work would slow them)
    t_cd = time.time()
    _dryrun_cell_start()
    held = _dryrun_hold(plain_step, plain, plain_batch, plain_ms)
    split["c"] = time.time() - t_cd
    del plain
    t_b = time.time()
    table = _spec_table()
    split["b"] = time.time() - t_b
    t_d = time.time()
    cell_rec = _dryrun_cell_finish()
    split["d"] = time.time() - t_d          # the wait beyond (c) and (b)
    split["c+d"] = time.time() - t_cd - split["b"]

    def busy(dev, wall):
        return "not measured" if dev is None else f"{dev / wall:.3f}"

    _line("mesh", time.time() - t0, arch="olmo-1b", layers=16,
          batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=MESH_STEPS,
          mesh_shape="data 1 x model 1 (one rank, NCCL)",
          held_bitwise="the mesh step vs no mesh: losses, grad norms, "
                       "params, moments",
          leaves=n_leaves, k4=mesh_k4[0], k4_tc=mesh_k4[1],
          k4_bwd=mesh_k4[2],
          losses=",".join(f"{float(m[0]):.6f}" for m in mesh_m),
          mesh_step_ms=f"{mesh_ms:.3f}",
          mesh_step_device_ms=("not measured" if mesh_dev is None
                               else f"{mesh_dev:.3f}"),
          mesh_device_busy=busy(mesh_dev, mesh_ms),
          no_mesh_step_ms=f"{plain_ms:.3f}",
          no_mesh_step_device_ms=("not measured" if plain_dev is None
                                  else f"{plain_dev:.3f}"),
          no_mesh_device_busy=busy(plain_dev, plain_ms),
          spec_table_s=f"{split['b']:.3f}",
          dryrun_equal="ops, flops, HBM bytes, products, kernel operators",
          dryrun_k4_a_step=held["real"]["kernels"]["flash_attention_lse"],
          dryrun_k4_bwd_a_step=held["real"]["kernels"][
              "flash_attention_bwd"],
          dryrun_step_flops=f"{held['real']['hlo_flops']:.6e}",
          dryrun_step_hbm_bytes=f"{held['real']['hlo_hbm_bytes']:.6e}",
          dryrun_compute_ms=f"{held['compute_ms']:.3f}",
          dryrun_memory_ms=f"{held['memory_ms']:.3f}",
          dryrun_cell_flops=f"{cell_rec['hlo_flops']:.6e}",
          dryrun_cell_coll_bytes=(
              f"{cell_rec['collectives']['total_bytes']:.6e}"),
          dryrun_cell_trace_s=cell_rec["lower_s"],
          split_s={k: f"{v:.1f}" for k, v in split.items()})
    return {"olmo-1b-mesh": {"k4": mesh_k4[0], "k4_tc": mesh_k4[1],
                             "k4_bwd": mesh_k4[2]},
            "spec_table": table}


def _lse_backward_entry(bwd: dict, by_path: dict) -> dict:
    """The kernels line's entry of the backward from K4's lse: its
    numbers at the long train step's shape, and by shape at the two
    S-512 ones, from ``train`` (c); launches on the main paths."""
    B, T = TRAIN_LONG
    main_shape = f"olmo-1b-long-{B}x{T}"
    xla = bwd["xla"]
    top = xla[main_shape]
    entry = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn_bwd.cu",
        "replaces": "src/repro/models/flash_xla.py:139",
        "launches": sum(v for k, v in by_path.items()
                        if k != "train-backward-check"),
        "launches_by_path": by_path,
        "launches_a_call": K4_BWD_LAUNCHES_A_CALL,
        "max_abs_err": max(x["err"] for x in xla.values()),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        # SDPA's forward and backward under autograd, same inputs
        "library_ms": top["library_ms"], "shape": main_shape,
        "lse_max_abs_err": max(x["lse_err"] for x in xla.values())}
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "fn_ms", "recompute_ms"):
        entry[f"{key}_by_shape"] = {k: x[key] for k, x in xla.items()}
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.time()
    phase_lint()
    phase_build()
    # first: its plain runs go on beside every later phase
    wide, wide_hold = phase_wide_pons(hold_later=True)
    phase_entry = phase_kphase()
    kernels = [phase_k1(), phase_k2(), phase_entry, *phase_k3(), phase_k4(),
               phase_k5(), phase_k6()]
    launches, main_walls = phase_main()
    launches["ponsim_phase"], jit_walls = phase_main_jit(main_walls)
    phase_entry.update(jit_walls)
    oracle, _ = phase_oracle()
    phase_full_width()
    phase_entry.update(wide)
    timeline, by_path = phase_timeline()
    by_path["oracle"] = oracle
    fig3 = timeline["fig3"]
    phase_entry.update({
        "fig3_jit_wall_s": fig3["jit"]["wall_s"],
        "fig3_jit_ms_by_phase": fig3["jit"]["ms"],
        "fig3_jit_cycles_by_phase": fig3["jit"]["cycles"],
        "fig3_jit_us_per_cycle_by_phase": fig3["jit"]["us_per_cycle"],
        "fig3_jit_steady_ms_by_phase": fig3["jit"]["steady_ms"],
        "fig3_jit_steady_us_per_cycle_by_phase":
            fig3["jit"]["steady_us_per_cycle"],
        "fig3_jit_ctas_by_phase": fig3["jit"]["ctas"],
        "fig3_jit_host_tables_ms": sum(fig3["jit"]["host_ms"]),
        "fig3_jit_device_busy": fig3["jit"]["busy"],
        "fig3_per_cycle_wall_s": fig3["per_cycle"]["wall_s"],
        "short_timeline_phases_held": timeline["short"]["phases_held"],
        "timeline_phases_held": timeline["short"]["full_phases_held"]})
    phase_entry["max_abs_err"] = max(phase_entry["max_abs_err"],
                                     timeline["short"]["max_abs_err"])
    cosim, _ = phase_cosim()
    by_path["cosim-accuracy"] = cosim
    faults, fault_paths = phase_faults()
    by_path.update(fault_paths)
    phase_entry["max_abs_err"] = max(phase_entry["max_abs_err"],
                                     faults["max_abs_err"])
    phase_entry["fault_grid_phases_held"] = faults["phases_held"]
    by_path.update(phase_jobs())
    by_path.update(phase_obs())
    # K3 and K3' run once a leaf of every arrived update of the int8 run
    launches["quantize_int8"] = launches["dequantize_int8"] = \
        phase_fl_fig2a()
    olmo = phase_serve()
    mamba = phase_serve_mamba2()
    launches["ssd_scan"] = mamba["k5"]
    rg = phase_serve_recurrentgemma()
    zoo = phase_serve_zoo()
    trained = phase_train()
    train_counts, bwd = trained["olmo-1b-train"], trained["bwd"]
    by_path["olmo-1b-train"] = {"k1": train_counts["k1"],
                                "k2": train_counts["k2"],
                                "phase": train_counts["phase"]}
    fed = phase_fed_train()
    fed_paths = ("olmo-1b-fed", "olmo-1b-fed-async")
    for path in fed_paths:
        by_path[path] = {k: fed[path][k] for k in ("k1", "k2", "phase")}
    mesh = phase_mesh()["olmo-1b-mesh"]
    # K4 runs on the prefill of every served config but mamba2-780m, on
    # the tensor-core kernel alone, and on olmo-1b's train steps, one pod,
    # federated and on the mesh
    launches["flash_attention"] = (olmo["k4"] + rg["k4"]
                                   + sum(z["k4"] for z in zoo.values())
                                   + train_counts["k4"]
                                   + sum(fed[p]["k4"] for p in fed_paths)
                                   + mesh["k4"])
    launches["rglru_scan"] = rg["k6"]
    # the backward from K4's lse runs once a layer of every train step:
    # one pod, federated and on the mesh; held and timed in train (c)
    launches["flash_attention_bwd"] = (train_counts["k4_bwd"]
                                       + sum(fed[p]["k4_bwd"]
                                             for p in fed_paths)
                                       + mesh["k4_bwd"])
    kernels.append(_lse_backward_entry(
        bwd, {"olmo-1b-train": train_counts["k4_bwd"],
              **{p: fed[p]["k4_bwd"] for p in fed_paths},
              "olmo-1b-mesh": mesh["k4_bwd"],
              "train-backward-check": bwd["launches"]["k4_bwd"]}))
    phase_entry.update(_finish_wide_hold(wide_hold))
    phase_entry["max_abs_err"] = max(phase_entry["max_abs_err"],
                                     phase_entry["wide_pons_max_abs_err"])
    engine_paths = {"traffic_sampler": "k1", "waterfill_grants": "k2",
                    "ponsim_phase": "phase"}
    main_path = {"traffic_sampler": "fig2b-16", "waterfill_grants":
                 "fig2b-16", "ponsim_phase": "fig2b-16-jit"}
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        name = entry["name"]
        if name in engine_paths:
            entry["launches_by_path"] = {
                main_path[name]: launches[name],
                **{path: c[engine_paths[name]]
                   for path, c in by_path.items()}}
        if name in ("quantize_int8", "dequantize_int8"):
            key = "k3" if name == "quantize_int8" else "k3p"
            entry["launches_by_path"] = {
                "fig2a-int8": launches[name], "cosim-accuracy": cosim[name],
                **{p: fed[p][key] for p in fed_paths}}
            # alone at the largest stacked leaf of the fed rounds, one
            # block a pod
            leaf, dq = fed["leaf"], "" if key == "k3" else "dq_"
            entry.update({
                "fed_leaf_shape": leaf["shape"],
                "ms_fed_leaf": leaf[f"{dq}ms"],
                "plain_ms_fed_leaf": leaf[f"{dq}plain_ms"],
                "bound_ms_fed_leaf": leaf[f"{dq}bound_ms"],
                "library_ms_fed_leaf": (leaf["dq_library_ms"] if dq
                                        else None)})
        if entry["name"] == "flash_attention":
            entry["launches_tc"] = (olmo["k4_tc"] + rg["k4_tc"]
                                    + sum(z["k4_tc"] for z in zoo.values())
                                    + train_counts["k4_tc"]
                                    + sum(fed[p]["k4_tc"]
                                          for p in fed_paths)
                                    + mesh["k4_tc"])
            entry["launches_by_path"] = {
                "olmo-1b": olmo["k4"], "recurrentgemma-2b": rg["k4"],
                **{name: z["k4"] for name, z in zoo.items()},
                "olmo-1b-train": train_counts["k4"],
                **{p: fed[p]["k4"] for p in fed_paths},
                "olmo-1b-mesh": mesh["k4"],
                "train-backward-check": bwd["launches"]["k4"]}
            # K4 alone at each zoo config's prefill shape
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by"):
                entry[f"{key}_by_path"] = {name: z[f"k4_{key}"]
                                           for name, z in zoo.items()}
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       *(z["k4_err"] for z in zoo.values()))
            entry["backward_ms"] = {
                "olmo-1b-s512": bwd["k4_olmo-1b"][1],
                "recurrentgemma-2b-s512": bwd["k4_recurrentgemma-2b"][1]}
            entry["backward_plain_ms"] = {
                "olmo-1b-s512": bwd["k4_olmo-1b"][2],
                "recurrentgemma-2b-s512": bwd["k4_recurrentgemma-2b"][2]}
            entry["backward_bound_ms"] = {
                "olmo-1b-s512": bwd["k4_olmo-1b"][3],
                "recurrentgemma-2b-s512": bwd["k4_recurrentgemma-2b"][3]}
            # SDPA's forward and backward under autograd, same inputs
            entry["backward_library_ms"] = {
                "olmo-1b-s512": bwd["sdpa_olmo-1b"],
                "recurrentgemma-2b-s512": bwd["sdpa_recurrentgemma-2b"]}
        if entry["name"] == "ssd_scan":
            entry["launches_tc"] = mamba["k5_tc"]
            entry["launches_by_path"] = {
                "mamba2-780m": mamba["k5"],
                "train-backward-check": bwd["launches"]["k5"]}
            entry["backward_ms"] = {"mamba2-780m-s512": bwd["k5"][1],
                                    "with-h0": bwd["k5_h0"][1]}
            entry["backward_plain_ms"] = {
                "mamba2-780m-s512": bwd["k5"][2], "with-h0": bwd["k5_h0"][2]}
            entry["backward_bound_ms"] = {
                "mamba2-780m-s512": bwd["k5"][3], "with-h0": bwd["k5_h0"][3]}
        if entry["name"] == "rglru_scan":
            entry["launches_by_path"] = {
                "recurrentgemma-2b": rg["k6"],
                "train-backward-check": bwd["launches"]["k6"]}
            entry["backward_ms"] = {"recurrentgemma-2b-s512": bwd["k6"][1]}
            entry["backward_plain_ms"] = {
                "recurrentgemma-2b-s512": bwd["k6"][2]}
            entry["backward_bound_ms"] = {
                "recurrentgemma-2b-s512": bwd["k6"][3]}
    _line("total", time.time() - t0)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
