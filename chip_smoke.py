#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dgen_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

``--parent`` names another checkout of the repository (default
build/parent beside this script, where present), for example the parent
commit unpacked with git archive, whose micro-benchmark tensor-core
kernels [9] times against this checkout's.

Phases, in order (each path runs with the launch counts set to 0 just
before it and read just after; each kernel wrapper keeps the operands of
its first launch in the path):
  1. the card: its name and power limit;
  2. the build of the CUDA kernels from dgen_tpu_torch/csrc (one nvcc per
     source, all started together, sm_90a) and each kernel's registers,
     spills and shared memory;
  3. the main path: ercot-all-sector at 8,192 agents for 3 model years
     (month kernel, battery dispatch kernel), with per-year wall time and
     agent-years/s, and the port on the card against the port on the CPU
     at a small size;
  3c. the streaming year step against the whole table: ercot-all-sector
     at 32,768 agents for 2 model years, hourly aggregate and storage on
     and batteries allocated, once in 4 chunks of 8,192 rows and once
     whole, held to each other at the JAX package's tolerance for this
     computation, in three worlds: the default path (month kernel), the
     gated knobs on int8 banks (stream kernel) and a rate-switch world
     (pair kernel); then, in one more first year of each run, the first
     launch of each bucket-sums kernel the run launched and the first
     dispatch launches (the remat pass's too) held against the plain
     versions as they launch;
  3d. national-all-sector at its full width, 1,048,576 agents, under the
     automatic chunk, for 2 model years (depth cut from the preset's 19):
     chunks, padded rows, per-year wall, agent-years/s, modeled step
     bytes beside the card's measured peaks, the health verdict and the
     launch counts (two dispatch launches a chunk a year: sizing and the
     hourly remat pass), and the preset runner's record; the run keeps
     no operands, and one more first year holds its first launches at
     the chunk's rows (87,424 on an 80 GB card) against the plain versions as [3c] does;
  3e. both golden fixtures on the card, through the calls a user makes:
     golden #1 loaded from the committed port-format package
     (tests/torch_fixtures/golden_pkg, io.package.load_population) and
     run for 19 model years through RunConfig.from_env, held to
     tests/fixtures/golden_adoption.json under tests/test_golden_e2e.py's
     contract (curves rtol 1e-3, state-hourly atol 0.05, the system-size
     histogram exact), its gated run within 1e-4 of the default run's
     curves and its bf16 and int8 runs within 2%; golden #2, the NEM cap
     flip of tests/test_golden_capflip.py rebuilt on the port's synthetic
     world, held to golden_capflip.json (NEM-eligible counts exact); each
     run's launch counts and walls, and its first launches held against
     the plain versions as [3c] holds them;
  3f. the run outputs at national-all-sector's full width (1,048,576
     agents, the automatic chunk, 2 model years, in a temporary directory
     the phase removes), in four runs through the calls a user makes: (a)
     no host consumer, the floor; (b) the host-I/O pipeline (pinned copies
     on a side CUDA stream) with the preset runner's exporter, a checkpoint
     a year and collect=True; (c) the serialized path with the exporter
     and the checkpoints; (d) a fresh Simulation resumed from (b)'s 2014
     checkpoint. (b)'s and (c)'s agent_outputs, finance_series and
     agents.npz files must be byte for byte equal, state-hourly within
     [3c]'s tolerance; (d)'s 2016 outputs equal (b)'s per agent bit for
     bit; every compact-quantized value of (b) within max|x| / 65532 of
     its collected float32, its int16 codes the CPU's; each run launches
     the month and dispatch kernels as [3d] counts them. Logs the four
     walls and their ratios to (a), the pipeline's stats, the bytes
     fetched and written a year, and the checkpoint's save and restore
     seconds; the fetch stage alone; year 2 traced with and
     without the exporter (device idle share, where the main thread's
     host time goes); and, below national scale, sim.run() on the
     pipeline against the serialized path (96 and 8,192 agents, collect on,
     4 alternated pairs);
  3g. resilience on the card, in a temporary directory the phase
     removes: (a) load-time containment at national-all-sector's full
     width for 1 model year: the clean population validates clean (the
     same objects back, the validation's seconds logged), the population
     built with ingest_corrupt_row injected quarantines exactly rows 3
     and 17 with the JAX package's reasons and its files equal a
     clean-population run under the same report, and bank_corrupt_row@1
     is refused (row 3 is referenced by more agents than MAX_QUARANTINE);
     (b) the fault drill and the quarantine drill on [3c]'s world and
     chunk for 3 model years: every fault site recovered, its files
     equal the clean run's (the chunk-halved OOM re-entry within the OOM
     tolerance), the manifest verifying, and the ingest, bank and
     sentinel rounds; (c) run_supervised at national width with an
     explicit agent_chunk of 262,144 rows: real torch.OutOfMemoryErrors
     recovered by halving the chunk, the allocated bytes back at their
     level after each failed attempt, the outputs within the OOM
     tolerance of the automatic chunk's, and both runs collected and
     compared float32 per agent by agent_id, stage by stage (sizing,
     market step, the exporter's int16 codes): a row's sizing and market
     results may not depend on the chunk (the int16 codes may, through
     the column's scale); (d), in [9], NaN and +Inf loads
     through the month, stream and pair kernels, their non-finite
     positions equal to the plain versions';
  3h. the tariff-clustered mixed national world, in a temporary directory
     the phase removes: (a) NationalSpec(n_agents=1,048,576,
     tariff_mix="mixed", seed=0) generated on the card by the port's
     generator (models.synth), saved with int8 banks (save_world),
     verified clean (verify_world) and loaded back (io.package) with its
     agent columns equal to the generated table's, and its cluster report
     (ops.tariffcluster); (b) the loaded world run clustered and
     unclustered under the automatic chunk for 2 model years, per agent
     by agent_id within the JAX package's rtol = atol = 1e-5
     (tests/test_tariffcluster.py), every masked row (chunk padding and
     cluster filler) inert, the layout held to every agent exactly once;
     per-year walls, the layout's segments and filler share, the
     bucket-sums launches by period count P, and one more first year of
     each run holding each kernel's first launch (at each P, clustered)
     against the plain version; (c) a mixed world of 32,768 agents run
     clustered in chunks of 8,192 rows and clustered whole, equal bit for
     bit per agent, in the default world and [3c]'s gated int8 world; the
     default whole run's first month launches (P = 1) give [9] the month
     kernel's rows at P = 1, logged beside the kernels line;
  3i. sweeps and ensembles, through SweepSimulation and
     EnsembleSimulation, in a temporary directory the phase removes: (a)
     national-all-sector at its full width, 1 model year (2 until
     [3n] took the room of the second), S = 2 (the
     preset's inputs, and no ITC), planned on the card's memory (one vmap
     group, chunked: S x chunk rows a kernel launch) and again with
     max_vmap_scenarios=1 (loop mode), both collected and equal bit for
     bit by agent_id in system_kw, npv, payback_period,
     number_of_adopters and batt_kwh; the siblings share the base's
     tensors and grow the allocated bytes by less than a bank; the plan,
     modeled step bytes beside the measured peak, each scenario-year's
     wall, agent-years/s beside [3d]'s, the launch counts held as [3d]
     holds them, and one more first year holding the vmap run's first
     launches against the plain versions; (b) [3c]'s world, S = 3 ITC
     levels over 2 model years (3 until [3o] needed the room), default and
     gated int8: the vmap sweep
     equals each scenario's own Simulation.run bit for bit per agent, and
     a loop-mode sweep exporting as it runs, under the supervisor with
     sweep_scenario@2 injected, resumes at (scenario, year) with the
     clean sweep's files byte for byte (state_hourly within [3c]'s
     tolerance); (c) [3c]'s world, E = 8 members under DEFAULT_DRAWS with
     2,048 rows entering in 2015, 2 model years: vmap (planned) and loop
     mode equal bit for bit by agent_id, the device quantiles within 1e-6
     of numpy's on the members' curves, E = 1 with zero draws equal to
     Simulation.run, and a vmap run killed in its last year and resumed
     with the same statistics;
  3j. the per-agent sizing oracle, the analysis side and the
     differentiable twin on the main path's world and its first model
     year's economics: (a) size_agents(fast=False) (14 golden-section
     iterations, agent chunks, the dispatch kernel) against the fast path
     at tests/test_sizing.py:117-128's bounds (both first-year bills at the
     same size; at each path's own size counted and logged), 64 rows alone
     equal to their rows bit for bit; (b) newton_size (soft, tau 0.1)
     against the oracle at 20 iterations: every agent within xatol and its
     bracket, fewer fallbacks than agents, no bucket-sums launch in soft
     mode, and the hard objective through the month kernel against the
     plain sums; (c) the gradcheck on the CLI's 8-agent world; (d)
     recover_pq(64, steps=5, gn) within 5%, solve_incentive at the CLI's
     defaults, and one rollout-loss gradient through the dispatch kernel
     and through the plain loop, equal within rtol 1e-5; (e)
     demand_charge_audit over (a)'s sized outputs with a flat demand charge,
     dispatch_diagnostics and summarize_dispatch, the first 256 rows equal
     to the port's CPU result; (f) RunConfig(soft_boundaries=True) for 2
     model years (no bucket-sums launch), and the same years run hard after
     it equal to the main path's bit for bit with its launch counts;
  3k. the serving stack (dgen_tpu_torch.serve): (a) a ServeEngine over
     national-all-sector at 1,048,576 agents, every bucket of 1 to 64
     warmed (its first launch's wall), then 20 queries a bucket (p50,
     p99, launches a query, bytes allocated beyond the placed
     Simulation), the whole-table starting_state_kw's share of a bucket,
     512 agents spread over the states equal bit for bit at every bucket
     and at bucket=None, 8 producer threads x 64 single-agent requests
     through a Microbatcher (none lost or duplicated, each equal to the
     engine's answer, queries a second), an ITC override that lowers NPV,
     and no kernel-library build or load after warmup; (b) the HTTP
     server on the main path's world with ingest_corrupt_row injected
     (/readyz before and after warmup, /query rows equal to the engine's,
     400/404/413/422/503/504, keep-alive through refusals, /metricz, the
     drain); (c) the answer surface at bucket 64 over 2 years against the
     engine bit for bit, a stale copy refused, the result cache's second
     answer equal to the engine's first; logged, the year-0 answers
     beside the world's first year_step; (d) the pair kernel inside a
     bucket of the rate-switch world, and the mixed twin of [3h] (c)
     clustered: mono-cluster buckets at P = 1 and 2 equal to the
     unclustered engine bit for bit, a mixed bucket on the full bank;
  3l. the serving fleet (dgen_tpu_torch.serve.fleet, .front, .autoscale,
     through resilience.fleetdrill): (a) 2 replica processes of the serve
     CLI's synthetic population at 1,048,576 agents behind the routing
     front, buckets of 8, 4 closed-loop clients and 80 requests, one
     replica killed (serve_replica_kill) and one hung (serve_replica_hang)
     mid-load: every answer equal bit for bit to an in-process ServeEngine
     on the card (its launches counted under the fleet path), only bounded
     503 retries, the fleet back to 2 READY replicas, the hung replica's
     breaker closed again, nothing built or loaded after warmup on any
     replica, the restarted one's boot loading the library and building
     nothing, p99 under the drill's bound; then 400 requests through the
     healed fleet (queries a second, p50, p99); the boot and restart walls
     and the card's free memory before the spawn, with every replica up
     and after the kill; (b) the same drill at 8,192 agents with the
     answer surface and the shared result cache on every replica, all
     three paths answering; (c) the scale drill at 8,192 agents, 1 -> 2 ->
     1 on a synthetic signal, a result-cache hit byte-identical to the
     engine's answer;
  3m. reference-format inputs on the card, from the committed input root
     (tests/torch_fixtures/reference_inputs): (a) scenario_inputs_from_
     reference and wholesale_profile_bank onto the card with pandas,
     pyarrow, jax and the JAX package unimportable (the wall, the files
     picked, the provenance; ITC, NEM caps, max market curves and Bass
     parameters must read ingested); (b) national-all-sector on the root
     (presets.build(..., input_root=...)) at 1,048,576 agents under the
     automatic chunk for 2 model years: every national sum finite,
     battery adopters allocated in both years, agents NEM-capped in year
     2, the launch counts (the ingest path), per-year walls and
     agent-years/s beside [3d]'s, one more first year's first launches
     held against the plain versions; (c) the same preset at 512 agents x
     3 years on the card and on the CPU: curves within rtol 1e-3, battery
     adopters equal per agent, system_kw, npv and the first-year bills per
     agent at tests/test_torch_slice.py's bounds; (d) a mixed world of
     32,768 agents clustered and unclustered for 2 years at a battery
     attachment rate of 0.4: battery units per agent by agent_id equal;
   3n. the multi-rank run (dgen_tpu_torch.parallel), each rank a process of
     the port's entry point (python -m dgen_tpu_torch.parallel.launch) on
     a localhost rendezvous: (a) a world of one rank over NCCL,
     national-all-sector at 32,768 agents x 2 years with batteries
     allocated, per agent bit for bit against the plain Simulation; (b)
     two ranks sharing the card over gloo, national-all-sector at its
     full 1,048,576 agents (524,288 a rank, 32,768-row chunks set by hand)
     x 1 year (2 until [3o] (a) took both of [3d]'s years): each rank's
     per-year wall, peak allocated bytes and launches, agent-years/s over
     both ranks beside [3d]'s, and the
     per-agent outputs against [3d]'s run by agent_id at the JAX
     package's sharded bound (rtol 5e-4, atol 1e-3), battery units
     equal, the count of values not bit-equal logged; (c) two ranks at
     131,072 agents with exports and checkpoints: the union of the
     ranks' year=<Y>-p<rank> parts against the single-process export
     row for row, and the ranks' 2014 checkpoint resumed by one process
     (the restored carry bit for bit against the ranks' outputs, the
     resumed year within the bound); a rank that fails fails the phase;
  3o. the rank gang (dgen_tpu_torch.resilience.gang and .gangworker, the
     sweep CLI on ranks): (a) national-all-sector at its full width,
     1,048,576 agents, x 2 years as a gang of 2 ranks sharing the card
     under the GangSupervisor, each rank's chunk automatic (its half of
     the card), rank 1 killed at its second year's export
     (gang_worker_kill@2:kill): the gang torn down and relaunched from the
     merged manifest frontier (2014), the ranks resuming from the 2014
     checkpoint parts by agent id; the merged export against [3d]'s run
     bit for bit, every battery unit equal, the merged manifest verifying
     clean; the detection, teardown and relaunch walls, each rank's peak
     allocated bytes against its budget, the card's free memory before the
     first spawn and before the relaunch; rank 0 of the relaunch keeps
     its first launches for [9]; (b) the sweep CLI (python -m
     dgen_tpu_torch.sweep) as 2 ranks sharing the card, national-all-sector
     at 32,768 agents x 2 years, S = 2 (ITC 0.3 and 0), batteries attached
     at 0.4, the gathered results against the single-process sweep per
     agent id, bit for bit;
 4. the gated main path: the same world with daylight_compact, pack_once
     and stream_segments (stream kernel, no month kernel), its national
     curves against the main path's;
  5. the rate-switch path (1,024 agents, 2 model years) through the pair
     kernel, then the same with the three knobs (pair kernel on
     daylight-compacted lanes);
  6. the daylight path (1,024 agents, 1 model year, daylight_compact
     alone): the month kernel on compacted lanes, its national curves
     against the same world's without the knob;
  7. the dot path: one model year of the main path's world (8,192
     agents) through year_step(..., sizing_impl="dot"), its national
     curves against the month engine's on the same world;
  8. the micro-benchmark path: dgen_tpu_torch.tools.kernel_microbench at
     its own full size (8,192 agents x 250 scales x 8,760 hours, P = 2),
     every default variant: the six variant kernels (sums_variant in its
     seven settings, monthmask, monthmask_g at 4 and 8 agents per block,
     monthdot, monthdot_pre, mnet and mnet_hi) and the month and stream
     kernels through lib, compact, stream and quant (int8 codes); each
     parity line is held to the tolerance of its kind, and an unknown
     variant name must be refused;
  8b. the bf16-banks path: the main path's world with bf16_banks (month
     kernel on bf16 streams), and the int8-banks path: the same world with
     quant_banks, pack_once and stream_segments (stream kernel on int8
     packs); each one's national curves within 2% of the main path's;
  9. each kernel against its plain PyTorch version on the operands the
     paths gave it, with a check that the comparison would catch a
     kernel that drops one TOU period of any agent, and each kernel's
     time beside its plain version's and the card's bound for the same
     work (the dot kernel's bound: the tensor-core products its bucket
     ids need, forming relu(net), or bytes; sums_variant's bound: the
     TF32 product of the 12 P + 1 columns its outputs need, its CUDA-core
     operations, or bytes, its dense b_pad-column product logged beside
     it; every bucket-sums row's library time: torch.bmm of the
     pre-formed relu(net) and the one-hot M of its buckets, 12 P + 1
     columns a tariff, under TF32, the contraction alone, on the row's
     own operands, the micro path's for the micro-benchmark rows); the
     battery dispatch kernel, bit for bit against its plain
     loop on the main path's first-year dispatch and on every model
     path's first dispatch, its bound the larger of its bytes and its
     serial chain at the SM clock read under load;
     logged only: each row's kernel against its bmm, the dot kernel
     against the month kernel on the dot path's operands, sums_variant
     against the bmm of its 128 columns, sums_monthdot and sums_variant
     against the --parent checkout's kernels (kernel_parent_ab),
     sums_monthdot against the month kernel on the micro path's operands
     at its P and at P = 10, in alternated pairs; the month
     kernel against the stream kernel on the stream kernel's operands,
     the month kernel at P = 10 on the main path's lanes and scales and
     at 1, 2 and 4 scales a thread, the dispatch kernel on one warp of
     agents (its serial chain), the narrow-stream rows' kernels on
     float32 copies of their operands, the ablated settings of
     sums_variant, its 32-column forms and its device-memory build at
     512 agents, each beside its floor; the first year's sizing call broken down (with the
     dispatch kernel and with the plain loop); the stream kernel against
     the month kernel on the gated and int8-banks paths' operands, and the
     pair kernel against two month launches on both rate-switch paths'
     operands, bit for bit (a mismatch fails the run) and timed;
 9c. one carry year of the main path and of the gated path under
     torch.profiler: the ten longest device operations with their
     launch counts, kernel time against the year's wall time, the
     device's idle share, and each piece of the year's host and device
     time;
 10. a JSON line with every ported kernel, the card, the result line.

Every model path asserts that it launched the battery dispatch kernel
once per chunk per model year it ran (the whole table is one chunk), and
once more per chunk with the state-hourly aggregate on a streaming run.

Exits non-zero, printing no result, without a CUDA device, when the
package is not beside this script, or when any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

#: published H100 SXM peaks (dense, no sparsity): float32 outside the
#: tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: dense TF32 on the tensor cores
PEAK_TF32_FLOPS = 495e12

MAIN_AGENTS = 8192
MAIN_END_YEAR = 2018          # model years 2014, 2016, 2018
CHUNK_AGENTS = 32768          # [3c]: four chunks of 8,192 rows
CHUNK_ROWS = 8192
CHUNK_END_YEAR = 2016         # model years 2014, 2016
NATIONAL = "national-all-sector"
NATIONAL_END_YEAR = 2016      # [3d]: 2 of the preset's 19 model years
#: chunked vs whole table (tests/test_simulation.py
#: test_chunked_matches_whole_table): per-agent fields, state-hourly
CHUNK_FIELDS = ("system_kw_cum", "number_of_adopters", "batt_kwh_cum", "npv",
                "payback_period", "max_market_share")
CHUNK_RTOL, CHUNK_ATOL = 2e-5, 1e-4
CHUNK_HOURLY_RTOL, CHUNK_HOURLY_ATOL = 1e-4, 1e-5
#: [3c]: every group's battery attachment rate (the synthetic default's
#: is 0, which allocates no battery and leaves the remat pass's battery
#: profile out of the aggregate), as tests/test_torch_chunk.py sets it
CHUNK_ATTACHMENT = 0.4
#: [3c]'s worlds: name -> (RunConfig knobs, rate_switch_frac, the kernels
#: its years must launch): the default path (month kernel), the gated
#: knobs on int8 banks (stream kernel on int8 codes and compacted lanes)
#: and a rate-switch world (pair kernel)
CHUNK_WORLDS = {
    "default": ({}, 0.0, ("month", "month_signed")),
    "gated int8": (dict(daylight_compact=True, pack_once=True, stream_segments=True,
                        quant_banks=True), 0.0, ("stream", "stream_signed")),
    "rate switch": ({}, 0.4, ("month_pair", "month_signed")),
}
#: agent rows of one plain-version block where [3c], [3d], [3h] and [3i]
#: hold a kernel's launch against its plain version (held_rows): on the
#: card the plain dispatch loop takes about the same wall for 16,384 rows
#: as for 43,520 (it is launch-bound), so blocks of 32,768 rows halve the
#: national holds' plain passes at ~9 GB of plain temporaries
HELD_ROWS = 32768
#: [3e]: the golden fixtures. Golden #1 (tests/test_golden_e2e.py) from
#: the committed port-format package; golden #2, the NEM cap flip
#: (tests/test_golden_capflip.py), rebuilt on the port's synthetic world
GOLDEN_PKG = "tests/torch_fixtures/golden_pkg"
GOLDEN_JSON = "tests/fixtures/golden_adoption.json"
CAPFLIP_JSON = "tests/fixtures/golden_capflip.json"
GOLDEN_ATTACHMENT = 0.35
CAPFLIP_AGENTS = 192
CAPFLIP_STATES = ("DE", "CA", "TX")
CAP_FRACTION = 0.30
#: the golden contract: exact metrics, curves within GOLDEN_RTOL, state-
#: hourly MWh within GOLDEN_RTOL and GOLDEN_HOURLY_ATOL; the gated path
#: within GOLDEN_GATED_RTOL of the default run's curves
GOLDEN_EXACT = ("years", "kw_histogram", "nem_allowed")
GOLDEN_CURVES = ("adopters", "system_kw_cum", "batt_kwh_cum", "cash_flow_total",
                 "adoption_checksum")
GOLDEN_HOURLY = ("state_hourly_net_mwh", "state_hourly_abs_mwh")
GOLDEN_RTOL = 1e-3
GOLDEN_HOURLY_ATOL = 0.05
GOLDEN_GATED_RTOL = 1e-4
KW_BINS = (0.0, 1e-6, 2, 4, 6, 8, 12, 20, 50, 200, 1e9)
SWITCH_AGENTS = 1024
SWITCH_END_YEAR = 2016        # model years 2014, 2016
DAYLIGHT_AGENTS = 1024
DOT_AGENTS = MAIN_AGENTS
MICRO_AGENTS = 8192           # the micro-benchmark's own default
HBM_AGENTS = 512              # M from device memory: 2.3 GB at 512 agents
GATED = dict(daylight_compact=True, pack_once=True, stream_segments=True)
#: kernel vs plain version: rtol 1e-4, atol 1e-3 x the agent's largest
#: |plain| value in that output (the two sum float32 terms in different
#: orders; per agent, because loads span 4 MWh/yr homes to GWh/yr plants)
RTOL = 1e-4
ATOL_FRAC = 1e-3
#: the dot kernel multiplies in TF32: the JAX package's bound for its dot
#: engine (rtol 5e-3, atol 2.0) and the per-agent atol at that rtol
DOT_RTOL = 5e-3
DOT_ATOL = 2.0
#: a dropped period must be caught in every agent where it carries at
#: least this share of the agent's largest bucket
DROPPED_SHARE = 1e-2
#: national curves: port on the card vs on the CPU, and the gated path
#: vs the default one (the golden contract)
CURVE_RTOL = 1e-3
#: national curves of the dot engine vs the month engine, and of the bf16
#: and int8 banks vs float32 (tests/test_golden_e2e.py's envelope for a
#: lower-precision engine or bank)
DOT_CURVE_RTOL = 2e-2
BANK_CURVE_RTOL = 2e-2
#: kernel vs plain version on bf16 sums: one bfloat16 unit in the last
#: place (2^-7 of the value) on top of RTOL, as both round the same float32
#: sum, taken in two orders, to bfloat16 and may land on neighbours
BF16_RTOL = RTOL + 2.0 ** -7
BF16 = dict(bf16_banks=True)
QUANT = dict(quant_banks=True, pack_once=True, stream_segments=True)

SOURCES = {
    "month": "dgen_tpu_torch/csrc/bucket_sums.cu",
    "stream": "dgen_tpu_torch/csrc/bucket_sums_stream.cu",
    "dot": "dgen_tpu_torch/csrc/bucket_sums_dot.cu",
    "micro_mask": "dgen_tpu_torch/csrc/microbench_mask.cu",
    "micro_dot": "dgen_tpu_torch/csrc/microbench_dot.cu",
    "micro_pre": "dgen_tpu_torch/csrc/microbench_pre.cu",
    "dispatch": "dgen_tpu_torch/csrc/battery_dispatch.cu",
}
#: float32 operations of one (agent, hour) of the dispatch: two subtracts,
#: two maxes and two mins for surplus and deficit, three each for the
#: charge and discharge limits (subtract, max, divide or multiply) and
#: their mins, a multiply, an add, a divide and a subtract for soc, a
#: subtract and an add for system_out
DISPATCH_OPS = 20
#: dependent instructions between two hours' soc in the dispatch kernel's
#: fast path, counted in its SASS (cuobjdump -sass): subtract, max, three
#: multiply-adds (the division), min, multiply, add, subtract; each takes
#: DEPENDENT_CYCLES, the arithmetic latency the CUDA C++ Programming Guide
#: gives for compute capability 7.0 and later
DISPATCH_CHAIN = 9
DEPENDENT_CYCLES = 4
#: the dot kernel's column tiles: 7 buckets and a sell slot of 8 columns
#: (csrc/bucket_sums_dot.cu kGroup), and hours of a k-step
DOT_GROUP = 7
DOT_K = 8
#: f32 operations per (scale, hour) to form relu(net) (a multiply-add and
#: a max; the signed kernel takes net from the same multiply-add)
DOT_FORM_OPS = 3
#: bytes of pre-formed operands a torch.bmm yardstick call may take
BMM_BYTES = 12 << 30
#: alternated pairs of each row's logged kernel-vs-bmm A/B (6 until [3o]
#: needed the room; the row's library_ms is its own median of 5 calls)
BMM_AB_PAIRS = 3
#: the month kernel's logged A/B at the most periods a tariff may carry
AB_PERIODS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def year0_envs(sim):
    """The sizing inputs the first model year builds."""
    from dgen_tpu_torch.models.scenario import apply_year
    from dgen_tpu_torch.models.simulation import (
        build_econ_inputs, compute_nem_allowed, starting_state_kw)
    from dgen_tpu_torch.ops.sizing import _fill_env_defaults

    ya = apply_year(sim.table, sim.inputs, 0)
    nem = compute_nem_allowed(sim.table, sim.inputs, 0,
                              starting_state_kw(sim.table, sim.inputs))
    return _fill_env_defaults(build_econ_inputs(
        sim.table, sim.profiles, sim.tariffs, ya, nem, sim.table.incentives,
        rate_switch=sim._rate_switch))


def micro_pair(fn, plain, n_args=5, **override) -> tuple:
    """(wrapper, plain version) of a micro-benchmark variant over its
    captured operands (``n_args`` tensors, then the keyword arguments),
    with ``override`` laid over the captured keywords; the plain version
    takes the keywords it reads."""
    def call(f, keep=None):
        def run(*a):
            kw = {**a[n_args], **override}
            if keep is not None:
                kw = {k: v for k, v in kw.items() if k in keep}
            return f(*a[:n_args], **kw)
        return run
    return call(fn), call(plain, ("n_periods",) if n_args == 4 else None)


def kernel_specs(bk, mk) -> dict:
    """JSON name -> (capture, wrapper, plain version, float32 operations
    per (agent, scale, lane), rtol, source, TPU kernel replaced). A
    capture is (path, LAUNCHES or NARROW_LAUNCHES key) of the run whose
    first-launch operands the kernel is checked and timed on; the bytes
    of the bound are those of the captured lane arrays and outputs."""
    month = (bk.month_sums, bk.month_sums_plain)
    stream = (bk.stream_sums, bk.month_sums_plain)
    pair = (bk.month_pair_sums, bk.month_pair_sums_plain)
    dot = (bk.dot_sums, bk.dot_sums_plain)
    bp = "dgen_tpu/ops/billpallas.py"
    mb = "tools/kernel_microbench.py"
    return {
        "bucket_sums_month": (("main", "month"), *month, 6, RTOL, "month",
                              f"{bp}:343"),
        "bucket_sums_month_signed": (("main", "month_signed"), *month, 9, RTOL,
                                     "month", f"{bp}:343"),
        # [3j] (a): the fast path the per-agent oracle holds
        "bucket_sums_month_3j": (("oracle", "month"), *month, 6, RTOL, "month",
                                 f"{bp}:343"),
        "bucket_sums_month_signed_3j": (("oracle", "month_signed"), *month, 9, RTOL,
                                        "month", f"{bp}:343"),
        "bucket_sums_month_pair": (("switch", "month_pair"), *pair, 9, RTOL,
                                   "month", f"{bp}:427"),
        # [3k]: the serving path's first launches at buckets 1 and 64 (a
        # bucket launches at least 16 rows) and in the rate-switch world
        "bucket_sums_month_serve1": (("serve1", "month"), *month, 6, RTOL, "month",
                                     f"{bp}:343"),
        "bucket_sums_month_signed_serve1": (("serve1", "month_signed"), *month, 9,
                                            RTOL, "month", f"{bp}:343"),
        "bucket_sums_month_serve64": (("serve64", "month"), *month, 6, RTOL, "month",
                                      f"{bp}:343"),
        "bucket_sums_month_signed_serve64": (("serve64", "month_signed"), *month, 9,
                                             RTOL, "month", f"{bp}:343"),
        "bucket_sums_month_pair_serve": (("serve_switch", "month_pair"), *pair, 9, RTOL,
                                         "month", f"{bp}:427"),
        # [3l]: the fleet's in-process oracle (a bucket of 8, 16 rows launched)
        "bucket_sums_month_fleet": (("fleet", "month"), *month, 6, RTOL, "month",
                                    f"{bp}:343"),
        "bucket_sums_month_signed_fleet": (("fleet", "month_signed"), *month, 9, RTOL,
                                           "month", f"{bp}:343"),
        # [3m] (b): the national run on the committed input root (a chunk's
        # first INGEST_CAPTURE_ROWS rows of its first launches)
        "bucket_sums_month_ingest": (("ingest", "month"), *month, 6, RTOL, "month",
                                     f"{bp}:343"),
        "bucket_sums_month_signed_ingest": (("ingest", "month_signed"), *month, 9, RTOL,
                                            "month", f"{bp}:343"),
        # [3n] (b): rank 0 of two ranks sharing the card (a chunk's first
        # RANKS_CAPTURE_ROWS rows of its first launches; launches: both ranks')
        "bucket_sums_month_ranks": (("ranks", "month"), *month, 6, RTOL, "month",
                                    f"{bp}:343"),
        "bucket_sums_month_signed_ranks": (("ranks", "month_signed"), *month, 9, RTOL,
                                           "month", f"{bp}:343"),
        # [3o] (a): rank 0 of the gang's relaunched attempt (two ranks sharing
        # the card under the automatic chunk; a chunk's first
        # RANKS_CAPTURE_ROWS rows; launches: both ranks' of that attempt)
        "bucket_sums_month_gang": (("gang", "month"), *month, 6, RTOL, "month",
                                   f"{bp}:343"),
        "bucket_sums_month_signed_gang": (("gang", "month_signed"), *month, 9, RTOL,
                                          "month", f"{bp}:343"),
        "bucket_sums_stream": (("gated", "stream"), *stream, 6, RTOL, "stream",
                               f"{bp}:840"),
        "bucket_sums_stream_signed": (("gated", "stream_signed"), *stream, 9,
                                      RTOL, "stream", f"{bp}:840"),
        "bucket_sums_month_compacted": (("daylight", "month"), *month, 6, RTOL,
                                        "month", f"{bp}:343"),
        "bucket_sums_month_signed_daylight": (("daylight", "month_signed"), *month,
                                              9, RTOL, "month", f"{bp}:343"),
        "bucket_sums_month_pair_compacted": (("switch_gated", "month_pair"), *pair,
                                             9, RTOL, "month", f"{bp}:427"),
        "bucket_sums_dot": (("dot", "dot"), *dot, 6, DOT_RTOL, "dot",
                            f"{bp}:296"),
        "bucket_sums_dot_signed": (("dot", "dot_signed"), *dot, 9, DOT_RTOL,
                                   "dot", f"{bp}:296"),
        "sums_monthmask": (("micro", "monthmask"),
                           *micro_pair(mk.sums_monthmask, mk.sums_monthmask_plain),
                           6, RTOL, "micro_mask", f"{mb}:112"),
        # the path's first monthmask_g launch has 4 agents per block; the
        # row is the 8-agent launch on the same operands
        "sums_monthmask_g": (("micro", "monthmask_g"),
                             *micro_pair(mk.sums_monthmask_g,
                                         mk.sums_monthmask_g_plain, g_block=8),
                             6, RTOL, "micro_mask", f"{mb}:220"),
        "sums_variant": (("micro", "variant"),
                         *micro_pair(mk.sums_variant, mk.sums_variant_plain),
                         6, DOT_RTOL, "micro_dot", f"{mb}:49"),
        "sums_monthdot": (("micro", "monthdot"),
                          *micro_pair(mk.sums_monthdot, mk.sums_monthdot_plain),
                          6, DOT_RTOL, "micro_dot", f"{mb}:146"),
        # the prebuilt-mask kernels on (load, gen, M, scales)
        "microbench_monthdot_pre": (("micro", "monthdot_pre"),
                                    *micro_pair(mk.monthdot_pre_sums,
                                                mk.mask_product_plain, n_args=4),
                                    6, DOT_RTOL, "micro_pre", f"{mb}:391"),
        "microbench_mnet": (("micro", "mnet"),
                            *micro_pair(mk.mnet_sums, mk.mask_product_plain,
                                        n_args=4),
                            6, DOT_RTOL, "micro_pre", f"{mb}:493"),
        "microbench_mnet_hi": (("micro", "mnet_hi"),
                               *micro_pair(mk.mnet_sums, mk.mask_product_plain,
                                           n_args=4),
                               6, RTOL, "micro_pre", f"{mb}:493"),
        # the engine kernels on narrow streams
        "bucket_sums_month_bf16": (("bf16", "month/bfloat16"), *month, 6, BF16_RTOL,
                                   "month", f"{bp}:343"),
        "bucket_sums_month_int8": (("micro", "month/int8"), *month, 6, RTOL,
                                   "month", f"{bp}:343"),
        "bucket_sums_stream_int8": (("quant", "stream/int8"), *stream, 6, RTOL,
                                    "stream", f"{bp}:840"),
    }


def ab_specs(bk) -> dict:
    """As :func:`kernel_specs`, for the A/Bs logged beside the kernels
    line: the month kernel on the stream kernel's uniform compacted
    operands (the gated path launches no month kernel), and the kernels
    of the narrow-stream rows on float32 copies of the same operands
    (equal operations, four bytes an element; :func:`float32_copies`)."""
    bp = "dgen_tpu/ops/billpallas.py"
    month = (bk.month_sums, bk.month_sums_plain)
    return {
        "bucket_sums_month_on_stream_operands": (
            ("gated", "stream"), *month, 6, RTOL, "month", f"{bp}:343"),
        "bucket_sums_month_bf16_as_float32": (
            ("bf16", "month/float32"), *month, 6, RTOL, "month", f"{bp}:343"),
        "bucket_sums_month_int8_as_float32": (
            ("micro", "month/int8-float32"), *month, 6, RTOL, "month", f"{bp}:343"),
        "bucket_sums_stream_int8_as_float32": (
            ("quant", "stream/float32"), bk.stream_sums, bk.month_sums_plain, 6,
            RTOL, "stream", f"{bp}:840"),
    }


def p1_specs(bk) -> dict:
    """As :func:`kernel_specs`, for the month kernel's rows logged beside
    the kernels line at P = 1: imports and signed on the first launches of
    [3h] (c)'s clustered whole run (default world), whose first
    net-billing cluster is single-period."""
    bp = "dgen_tpu/ops/billpallas.py"
    month = (bk.month_sums, bk.month_sums_plain)
    return {
        "bucket_sums_month_p1": (("cluster", "month"), *month, 6, RTOL, "month",
                                 f"{bp}:343"),
        "bucket_sums_month_signed_p1": (("cluster", "month_signed"), *month, 9, RTOL,
                                        "month", f"{bp}:343"),
    }


def p1_rows(capture: dict, bk, launches_p1: dict) -> list:
    """[9]'s month kernel rows at P = 1 (:func:`p1_specs`): checked against
    the plain version and timed as :func:`check_and_time` times every row,
    with its bound and torch.bmm time; ``launches_p1``: the row name ->
    its launches at P = 1 in [3h] (b)'s clustered national run. Raises
    unless the captured launches are at P = 1."""
    for key in ("month", "month_signed"):
        if capture[key][6] != 1:
            raise AssertionError(f"[3h] the first {key} launch of the clustered run "
                                 f"is at P = {capture[key][6]}, not 1")
    rows = check_and_time({"cluster": capture}, p1_specs(bk), {"cluster": None},
                          micro_library=0.0)
    for r in rows:
        r["launches"] = launches_p1[r["name"]]
        log(f"    {r['name']}: {r['launches']} launches at P = 1 in [3h] (b)'s "
            f"clustered national run")
    return rows


def float32_copies(captures: dict) -> None:
    """Adds to ``captures`` the narrow-stream rows' operands with load, gen
    and sell as float32 (the same values; int8 codes stay in quantized
    units), for the equal-operation A/Bs of :func:`ab_specs`."""
    def widen(args):
        return tuple(a.float() if i < 3 else a for i, a in enumerate(args))

    captures["bf16"]["month/float32"] = widen(captures["bf16"]["month/bfloat16"])
    captures["micro"]["month/int8-float32"] = widen(captures["micro"]["month/int8"])
    captures["quant"]["stream/float32"] = widen(captures["quant"]["stream/int8"])


def check_variant_forms(operands: tuple, mk, tool) -> None:
    """The ablated settings of sums_variant at the path's full size, and
    its device-memory build at HBM_AGENTS agents, each against its plain
    version (the product forms at the dot kernel's tolerance, the forms
    without a product at the month kernel's) and timed; logged only."""
    import torch

    load, base = operands[0], operands[5]
    if {k: v for k, v in base.items() if v is not None} != dict(
            n_periods=tool.N_PERIODS, b_pad=128, build="onehot", dot="dot",
            net="fma"):
        raise AssertionError(f"the path's first sums_variant launch is not the "
                             f"base setting: {base}")
    forms = [(name, kw, operands[:5]) for name, (kw, real)
             in tool.SUMS_VARIANTS.items() if not real]
    # the one-hot kernel's own width at P = 2 (12 P + 1 columns in 32): how
    # bucket_sums_dot's time splits between forming M and the products
    forms += [(f"b32{tag}", dict(b_pad=32, **kw), operands[:5])
              for tag, kw in (("", {}), ("_const", dict(build="const")),
                              ("_no_dot", dict(dot="none")))]
    part = tuple(t[:HBM_AGENTS] for t in operands[:5])
    g = torch.Generator(device=load.device).manual_seed(1)
    m_hbm = torch.rand((HBM_AGENTS, load.shape[1], 128), generator=g,
                       device=load.device)
    forms.append((f"hbm(M from device memory, {HBM_AGENTS} agents)",
                  dict(build="hbm", m_hbm=m_hbm), part))
    for name, kw, args in forms:
        kw = dict(n_periods=tool.N_PERIODS, **kw)
        got = mk.sums_variant(*args, **kw)
        ref = mk.sums_variant_plain(*args, **kw)
        torch.cuda.synchronize()
        rtol = RTOL if kw.get("dot") == "none" else DOT_RTOL
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        for i, (a, b) in enumerate(zip(got, ref)):
            if bool(bad_agents(a, b, rtol).any()) or (
                    rtol == DOT_RTOL and not torch.allclose(
                        a, b, rtol=DOT_RTOL, atol=DOT_ATOL)):
                raise AssertionError(f"sums_variant {name}: output {i} disagrees "
                                     f"with the plain version (max abs err "
                                     f"{err:.3e})")
        del got, ref
        ms = time_ms(lambda: mk.sums_variant(*args, **kw))
        n, r = args[4].shape
        hours = args[0].shape[1]
        if kw.get("dot") == "none":
            floor = (f"CUDA-core floor "
                     f"{float(n) * r * hours * 6 / PEAK_F32_FLOPS * 1e3:.3f} ms")
        else:
            p, cols = kw["n_periods"], kw.get("b_pad", 128)
            need, dense = variant_floors_ms(n, r, hours, p, cols)
            floor = (f"TF32 floor of the {12 * p + 1} columns the outputs need "
                     f"{need:.3f} ms, dense TF32 floor of all {cols} columns "
                     f"{dense:.3f} ms")
        log(f"  sums_variant {name}: N={n} max_abs_err={err:.3e} "
            f"(rtol {rtol}) kernel {ms:.3f} ms; {floor}")
        torch.cuda.empty_cache()


def micro_path(tool, bk) -> dict:
    """The micro-benchmark at its full size through its entry point, with
    the launch counts set to 0 before and read after; every parity line
    held to its kind's tolerance."""
    bk.CAPTURE = {}
    bk.reset_launches()
    t0 = time.perf_counter()
    try:
        out = tool.run(MICRO_AGENTS)
    finally:
        launches = dict(bk.LAUNCHES)
        capture, bk.CAPTURE = bk.CAPTURE, None
    wall = time.perf_counter() - t0
    narrow = dict(bk.NARROW_LAUNCHES)
    expected = len(tool.SUMS_VARIANTS) + 12
    if len(out["variants"]) != expected or out["timed_on"] != "device":
        raise AssertionError(f"the default run gave {list(out['variants'])} on "
                             f"{out['timed_on']}, expected {expected} variants "
                             "on the device")
    for name, v in out["variants"].items():
        par = v["parity"]
        if not v["ms"] > 0 or (par is not None and par["bad_agents"]):
            raise AssertionError(f"micro-benchmark variant {name}: {v}")
    n_parity = sum(v["parity"] is not None for v in out["variants"].values())
    if n_parity != 13:
        raise AssertionError(f"{n_parity} parity lines, expected 13")
    try:
        tool.run(MICRO_AGENTS, ["monthmasc"])
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("the tool ran a variant named 'monthmasc'")
    return dict(out=out, wall=wall, launches=launches, narrow=narrow,
                capture=capture, refusal=refusal)


def bad_agents(got, ref, rtol=RTOL):
    """[N] bool: agents with an element outside rtol + atol ATOL_FRAC x
    that agent's largest |ref| in this output."""
    row_max = ref.abs().flatten(1).amax(1).view(-1, *[1] * (ref.ndim - 1))
    tol = rtol * ref.abs() + ATOL_FRAC * row_max
    return ((got - ref).abs() > tol).flatten(1).any(1)


def dropped_period_caught(ref, rtol=RTOL) -> tuple[int, int, int]:
    """Holds a copy of the bucket sums ``ref`` [N, R, 12P] with the last
    period zeroed (a kernel that drops it) against ``ref``. Returns the
    agents where that period carries >= DROPPED_SHARE of the agent's
    largest bucket, how many of them :func:`bad_agents` flags, and how
    many one atol over the whole output (ATOL_FRAC x max|ref|) would."""
    p = ref.shape[-1] // 12
    mutant = ref.clone()
    mutant[..., p - 1::p] = 0.0
    row_max = ref.abs().flatten(1).amax(1)
    col_max = ref[..., p - 1::p].abs().flatten(1).amax(1)
    must = (col_max >= DROPPED_SHARE * row_max) & (row_max > 0)
    flagged = bad_agents(mutant, ref, rtol)
    whole = rtol * ref.abs() + ATOL_FRAC * ref.abs().max()
    flagged_whole = ((mutant - ref).abs() > whole).flatten(1).any(1)
    return (int(must.sum()), int((flagged & must).sum()),
            int((flagged_whole & must).sum()))


#: timed calls of a plain version in [9]'s rows, after the correctness
#: check's call on the same operands (its warm-up since [3o] took the room
#: of a separate one): its time is the yardstick the kernel is read
#: against, 65-1,500 ms a call (one call since [3n] took the room of the
#: others)
PLAIN_REPS = 1


def time_ms(fn, reps: int = 5, warm: bool = True) -> float:
    """Median of ``reps`` launches timed with CUDA events, after a warm-up
    (``warm=False``: the caller has just run ``fn`` on the same operands)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def lane_bytes(args, n_lanes: int) -> int:
    """Bytes of the captured lane arrays ([N, L] streams and ids, the
    prebuilt M [N, c, L]) at their own dtypes."""
    import torch

    return sum(t.numel() * t.element_size() for t in args
               if isinstance(t, torch.Tensor) and t.dim() >= 2
               and t.shape[-1] == n_lanes)


def bound_ms(n: int, r: int, work_lanes: int, ops_per_elem: int,
             in_bytes: int, out_bytes: int) -> tuple[float, str]:
    """Least time for the work: operations on the ``work_lanes`` that hold
    an hour (a compacted layout's padding lanes do no work) over the
    float32 peak vs bytes moved (each lane array read once, the float32
    scales read once, each output written once, at their dtypes) over
    HBM."""
    ops = float(n) * r * work_lanes * ops_per_elem
    nbytes = float(in_bytes) + 4.0 * n * r + out_bytes
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def dot_bound_ms(args, out_bytes: int) -> tuple[float, str, str]:
    """Least time for the dot kernel's work on ``args``: the larger of the
    TF32 products of the column tiles these bucket ids touch (per k-step
    of DOT_K hours, the distinct tiles of DOT_GROUP buckets, each R rows x
    8 columns x DOT_K hours; twice that signed) over the tensor cores'
    peak, forming relu(net) (DOT_FORM_OPS float32 operations per (scale,
    hour)) over the CUDA cores' peak, and the bytes (each stream and the
    scales read once, each output written once). Returns (ms, "operations"
    or "bytes", a note naming what sets it beside the dense product's
    floor, all 12 P + 1 columns padded to a multiple of 8)."""
    import torch

    load, gen, sell, bucket, scales, p, signed = args
    n, r = scales.shape
    hours = bucket.shape[1]
    tiles = (bucket // DOT_GROUP).view(n, hours // DOT_K, DOT_K).long()
    live = torch.zeros((n, hours // DOT_K, -(-12 * p // DOT_GROUP)),
                       dtype=torch.bool, device=bucket.device)
    live.scatter_(2, tiles, True)
    products = float(live.sum())
    del live, tiles
    a_sets = 2 if signed else 1
    t_tc = products * r * 8 * DOT_K * 2 * a_sets / PEAK_TF32_FLOPS * 1e3
    t_form = float(n) * r * hours * DOT_FORM_OPS / PEAK_F32_FLOPS * 1e3
    t_bytes = (lane_bytes(args, hours) + 4.0 * n * r + out_bytes) / PEAK_BYTES_PER_S * 1e3
    dense = (float(n) * r * hours * -(-(12 * p + 1) // 8) * 8 * 2 * a_sets
             / PEAK_TF32_FLOPS * 1e3)
    b_ms, what = max((t_tc, "tensor-core products"), (t_form, "forming relu(net)"),
                     (t_bytes, "bytes"))
    note = (f"bound set by {what} (tensor-core products {t_tc:.3f} ms over "
            f"{products / (n * hours / DOT_K):.3f} live tiles a k-step, forming "
            f"relu(net) {t_form:.3f} ms, bytes {t_bytes:.3f} ms; the dense "
            f"product's tensor-core floor {dense:.3f} ms)")
    return b_ms, "bytes" if what == "bytes" else "operations", note


def lane_buckets(period, offsets, p: int):
    """[N, L] bucket ids month x P + period of lanes whose month m is
    [offsets[m], offsets[m + 1]), and the lanes whose period lies in [0,
    P) (the others count for the sell sum alone)."""
    import torch

    lens = torch.tensor([b - a for a, b in zip(offsets[:-1], offsets[1:])],
                        device=period.device)
    month = torch.repeat_interleave(torch.arange(12, device=period.device), lens)
    period = period.long()
    return month * p + period, (period >= 0) & (period < p)


def sums_terms(args) -> tuple:
    """A bucket-sums row's operands as (load, gen, scales, P, signed,
    tariffs), ``tariffs`` one (bucket ids, valid lanes, sell) [N, L] each:
    ``args`` are the dot kernel's (load, gen, sell, bucket ids, scales, P,
    signed), the month and stream kernels' (load, gen, sell, period,
    scales, offsets, P, signed) or the pair kernel's (load, gen, sell_a,
    period_a, sell_b, period_b, scales, offsets, P)."""
    if len(args) == 7:
        load, gen, sell, bucket, scales, p, signed = args
        return load, gen, scales, p, signed, [(bucket.long(), None, sell)]
    if len(args) == 8:
        load, gen, sell, period, scales, offsets, p, signed = args
        return load, gen, scales, p, signed, [(*lane_buckets(period, offsets, p), sell)]
    load, gen, sell_a, period_a, sell_b, period_b, scales, offsets, p = args
    return load, gen, scales, p, False, [
        (*lane_buckets(period, offsets, p), sell)
        for period, sell in ((period_a, sell_a), (period_b, sell_b))]


def bmm_operands(terms: tuple, a0: int, a1: int, cols: int) -> tuple:
    """The bmm yardstick's operands for agents [a0, a1) of ``terms``
    (:func:`sums_terms`): relu(net) (and net below it, signed) [n, R or
    2R, L] and M [n, L, cols x tariffs], per tariff its one-hot bucket
    columns, zero columns up to its last, and the sell rate in its
    last."""
    import torch

    load, gen, scales, p, signed, tariffs = terms
    nb = 12 * p
    ld, gn, sc = (t[a0:a1].float() for t in (load, gen, scales))
    net = ld[:, None, :] - sc[:, :, None] * gn[:, None, :]
    a = torch.clamp_min(net, 0.0)
    if signed:
        a = torch.cat([a, net], dim=1)
    del net
    m = torch.zeros((a1 - a0, load.shape[1], cols * len(tariffs)), device=load.device)
    for t, (bucket, valid, sell) in enumerate(tariffs):
        mt = m[:, :, t * cols:(t + 1) * cols]
        ids = bucket[a0:a1].clamp(0, nb - 1)[..., None]
        if valid is None:
            mt.scatter_(2, ids, 1.0)
        else:  # an hour outside [0, P) has no import column
            mt.scatter_(2, ids, valid[a0:a1, :, None].float())
        mt[:, :, cols - 1] = sell[a0:a1].float()
    return a, m


def bmm_outputs(out, terms: tuple, cols: int) -> tuple:
    """The bucket sums in the bmm's product ``out`` [n, R or 2R, cols x
    tariffs], in the order the row's kernel returns them."""
    r, p, signed, tariffs = terms[2].shape[1], terms[3], terms[4], terms[5]
    nb = 12 * p
    want = ()
    for t in range(len(tariffs)):
        c0 = t * cols
        want += (out[:, :r, c0:c0 + nb], out[:, :r, c0 + cols - 1])
    if signed:
        want += (out[:, r:, :nb], out[:, r:, cols - 1])
    return want


def bmm_yardstick(args, kernel, what: str, cols=None, rtol=DOT_RTOL) -> float:
    """A bucket-sums row's library time: one torch.bmm of the pre-formed
    relu(net) (and net, signed) [n, R, L] with M [n, L, cols x tariffs]
    (:func:`bmm_operands`; ``cols`` defaults to 12 P + 1, all the function
    needs) under TF32 (set and restored around these timings only), the
    contraction alone: the medians of agent chunks of at most BMM_BYTES
    of operands, each formed before it is timed, added up. On the first
    chunk the bmm is held to ``kernel`` (called on ``args`` cut to the
    chunk's agents) at the larger of ``rtol`` and the dot tolerance, and
    the two are timed in alternated pairs (logged)."""
    import torch

    from dgen_tpu_torch.tools.kernel_microbench import ab_ms
    from dgen_tpu_torch.tools.kernel_parent_ab import first_rows

    terms = sums_terms(args)
    load, scales, p, signed, tariffs = terms[0], terms[2], terms[3], terms[4], terms[5]
    n, r = scales.shape
    hours = load.shape[1]
    cols = cols or 12 * p + 1
    width = cols * len(tariffs)
    a_rows = r * (2 if signed else 1)
    chunk = max(1, min(n, BMM_BYTES // (4 * hours * (a_rows + width))))

    total, calls = 0.0, 0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for a0 in range(0, n, chunk):
            a1 = min(n, a0 + chunk)
            a, m = bmm_operands(terms, a0, a1, cols)
            if a0 == 0:
                part = first_rows(args, a1)
                got = kernel(*part)
                want = bmm_outputs(torch.bmm(a, m), terms, cols)
                for g, w in zip(got, want, strict=True):
                    if bool(bad_agents(g.float(), w, max(rtol, DOT_RTOL)).any()):
                        raise AssertionError(f"the torch.bmm yardstick disagrees with "
                                             f"{what}")
                del got, want
                ms, bmm_ms, wins = ab_ms(lambda: kernel(*part),
                                         lambda: torch.bmm(a, m), pairs=BMM_AB_PAIRS)
                log(f"    {what} vs torch.bmm of pre-formed relu(net) and M [{width} "
                    f"columns] (TF32, the contraction alone) on agents 0-{a1 - 1}: "
                    f"kernel {ms:.3f} ms | bmm {bmm_ms:.3f} ms (medians of "
                    f"{BMM_AB_PAIRS} alternated pairs; kernel faster in {wins})")
            total += time_ms(lambda: torch.bmm(a, m))
            calls += 1
            del a, m
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"    torch.bmm yardstick [{width} columns] over all {n} agents: {calls} "
        f"calls of up to {chunk} agents, {total:.3f} ms in all (operands formed "
        "outside the timing)")
    return total


def micro_library_ms(operands: tuple, mk) -> float:
    """The micro-benchmark rows' library time on the micro path's operands
    (the first sums_variant launch's: load, gen, sell, bucket ids, scales,
    keywords): the bmm yardstick at 12 P + 1 columns, the function every
    micro-benchmark kernel computes, held to and timed against
    sums_monthdot. The yardstick at the variant's own b_pad columns, the
    product its ablation multiplies, is held to and timed against
    sums_variant and logged only."""
    kw = operands[5]
    p, b_pad = kw["n_periods"], kw["b_pad"]
    args = tuple(operands[:5]) + (p, False)
    log("  library time of the micro-benchmark rows (the torch.bmm yardstick on "
        "the micro path's operands):")
    library = bmm_yardstick(args, lambda *a: mk.sums_monthdot(*a[:5], n_periods=p),
                            "sums_monthdot")
    dense = bmm_yardstick(args, lambda *a: mk.sums_variant(*a[:5], n_periods=p,
                                                           b_pad=b_pad),
                          "sums_variant", cols=b_pad)
    log(f"    the micro rows' library time is the {12 * p + 1}-column bmm, "
        f"{library:.3f} ms; the {b_pad}-column bmm ({dense:.3f} ms) computes the "
        "same outputs with zero columns and is not a row's")
    return library


def variant_floors_ms(n: int, r: int, hours: int, p: int, b_pad: int) -> tuple:
    """sums_variant's tensor-core floors: the TF32 product of the 12 P + 1
    columns its outputs need, and the dense product of all ``b_pad``
    columns its ablation multiplies (2 N R H columns operations each, at
    the TF32 peak)."""
    per_col = 2.0 * n * r * hours / PEAK_TF32_FLOPS * 1e3
    return per_col * (12 * p + 1), per_col * b_pad


def variant_bound_ms(n: int, r: int, hours: int, p: int, b_pad: int,
                     in_bytes: int, out_bytes: int) -> tuple[float, str, str]:
    """Least time for sums_variant's function: the larger of its CUDA-core
    operations (6 a (agent, scale, hour)), the TF32 product of the 12 P +
    1 columns its outputs need, and the bytes. The dense product of its
    ``b_pad`` columns, which includes columns known to be zero, is named
    in the note and not counted. Returns (ms, "operations" or "bytes", the
    note)."""
    t_ops = float(n) * r * hours * 6 / PEAK_F32_FLOPS * 1e3
    t_tc, t_dense = variant_floors_ms(n, r, hours, p, b_pad)
    t_bytes = (float(in_bytes) + 4.0 * n * r + out_bytes) / PEAK_BYTES_PER_S * 1e3
    b_ms = max(t_ops, t_tc, t_bytes)
    note = (f"; bound: the TF32 product of the {12 * p + 1} columns the outputs "
            f"need {t_tc:.3f} ms, CUDA-core operations {t_ops:.3f} ms, bytes "
            f"{t_bytes:.3f} ms; the dense TF32 product of all {b_pad} columns "
            f"{t_dense:.3f} ms (not the bound)")
    return b_ms, "bytes" if b_ms == t_bytes else "operations", note


def monthdot_month_ab(operands: tuple, mk) -> None:
    """sums_monthdot against the month kernel on the micro path's operands
    (the same function: bucket ids as period ids on the full-hour lanes),
    at the path's P and at AB_PERIODS periods from a seeded period map
    (monthdot's two-tile form), held to the dot tolerance and timed in
    alternated pairs; logged."""
    import torch

    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops.layout import FULL_OFFSETS
    from dgen_tpu_torch.tools.kernel_microbench import ab_ms

    load, gen, sell, bucket, scales = operands[:5]
    g = torch.Generator(device=load.device).manual_seed(10)
    period10 = torch.randint(0, AB_PERIODS, bucket.shape, generator=g,
                             device=load.device, dtype=torch.int32)
    for p, ids in ((operands[5]["n_periods"], bucket),
                   (AB_PERIODS, bk.hourly_bucket_ids(period10, AB_PERIODS))):
        args = (load, gen, sell, ids, scales)
        month = (load, gen, sell, (ids % p).to(torch.int32), scales, FULL_OFFSETS,
                 p, False)
        got = mk.sums_monthdot(*args, n_periods=p)
        ref = bk.month_sums(*month)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            if bool(bad_agents(a, b, DOT_RTOL).any()) or not torch.allclose(
                    a, b, rtol=DOT_RTOL, atol=DOT_ATOL):
                raise AssertionError(f"sums_monthdot disagrees with the month kernel "
                                     f"on the same operands at P = {p}")
        del got, ref
        ms, month_ms, wins = ab_ms(lambda: mk.sums_monthdot(*args, n_periods=p),
                                   lambda: bk.month_sums(*month))
        log(f"  sums_monthdot vs the month kernel on the micro path's operands: "
            f"N={load.shape[0]} R={scales.shape[1]} P={p}: within rtol {DOT_RTOL} / "
            f"atol {DOT_ATOL}; monthdot {ms:.3f} ms | month kernel {month_ms:.3f} ms "
            f"(medians of 6 alternated pairs; monthdot faster in {wins})")


def parent_ab(operands: tuple, parent_root: str) -> None:
    """The redesigned micro-benchmark kernels (sums_variant, sums_monthdot)
    against another checkout's (``parent_root``, e.g. the parent commit
    unpacked with git archive) on the micro path's operands, through
    kernel_parent_ab: both held to the plain version at the dot tolerance
    (rtol and the per-agent atol), then timed in 6 alternated pairs;
    logged. Skipped, and said so, without such a checkout."""
    import os

    from dgen_tpu_torch.ops import _build
    from dgen_tpu_torch.tools import kernel_parent_ab as ab

    csrc = os.path.join(parent_root, "dgen_tpu_torch", "csrc")
    if not os.path.isdir(csrc):
        log(f"  the redesigned kernels against the parent's: skipped, no checkout "
            f"at {parent_root} (unpack the parent commit there with git archive)")
        return
    t0 = time.perf_counter()
    other = _build.library(csrc)
    log(f"  the redesigned kernels against the checkout at {parent_root} (its "
        f"kernels built in {time.perf_counter() - t0:.1f} s), on the micro path's "
        "operands:")
    args = tuple(operands[:5])
    for key in ("variant", "monthdot"):
        row = ab.compare(key, args, other, DOT_RTOL, DOT_ATOL)
        if row["this_bad_agents"] or row["this_tol_ratio"] > 1.0:
            raise AssertionError(f"{key}: this checkout's kernel is outside the dot "
                                 f"tolerance: {row}")
        row.update(ab.timed(key, args, other))
        log(f"    {key}: this checkout {row['ms']:.3f} ms | parent "
            f"{row['other_ms']:.3f} ms (this faster in {row['wins']} of 6 "
            f"alternated pairs); against the plain version max abs err "
            f"{row['this_max_abs_err']:.3e} (parent {row['other_max_abs_err']:.3e}), "
            f"agents outside rtol {DOT_RTOL} + the per-agent atol "
            f"{row['this_bad_agents']} (parent {row['other_bad_agents']})")


def dot_month_ab(captures: dict) -> None:
    """The dot kernel against the month kernel on the dot path's own
    operands (bucket ids as period ids on the full-hour lanes), held to the
    dot tolerance and timed in alternated pairs; logged."""
    import torch

    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops.layout import FULL_OFFSETS
    from dgen_tpu_torch.tools.kernel_microbench import ab_ms

    for key in ("dot", "dot_signed"):
        load, gen, sell, bucket, scales, p, signed = args = captures["dot"][key]
        month = (load, gen, sell, (bucket % p).to(torch.int32), scales, FULL_OFFSETS,
                 p, signed)
        got, ref = bk.dot_sums(*args), bk.month_sums(*month)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            g, r = g.float(), r.float()
            if bool(bad_agents(g, r, DOT_RTOL).any()) or not torch.allclose(
                    g, r, rtol=DOT_RTOL, atol=DOT_ATOL):
                raise AssertionError(f"{key}: the dot kernel disagrees with the "
                                     "month kernel on the same operands")
        del got, ref
        ms, month_ms, wins = ab_ms(lambda: bk.dot_sums(*args),
                                   lambda: bk.month_sums(*month))
        log(f"  {key} vs the month kernel on the dot path's operands: N={load.shape[0]} "
            f"R={scales.shape[1]} P={p}: within rtol {DOT_RTOL} / atol {DOT_ATOL}; "
            f"dot kernel {ms:.3f} ms | month kernel {month_ms:.3f} ms (medians of 6 "
            f"alternated pairs; dot faster in {wins})")


def check_and_time(captures: dict, specs: dict, hour_lanes: dict,
                   micro_library: float | None = None) -> list:
    """Each kernel of ``specs`` against its plain version, and both timed,
    on the operands a path gave it. ``hour_lanes``: path -> lanes of its
    daylight layout that hold an hour (None without a layout);
    ``micro_library``: the micro-benchmark rows' library ms
    (:func:`micro_library_ms`). With it, every other row's library time
    is the bmm yardstick on its own operands; without it (the logged
    A/Bs), no row has one."""
    import torch

    from dgen_tpu_torch.ops.tariff import HOURS

    rows = []
    for name, (cap, kernel, plain, ops, rtol, src, replaces) in specs.items():
        args = captures[cap[0]][cap[1]]
        got = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            if g.dtype != r.dtype:
                raise AssertionError(f"{name}: the kernel stores {g.dtype}, its "
                                     f"plain version {r.dtype}")
        out_bytes = sum(g.numel() * g.element_size() for g in got)
        got = [g.float() for g in got]
        ref = [r.float() for r in ref]
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        for i, (g, r) in enumerate(zip(got, ref)):
            bad = bad_agents(g, r, rtol)
            if bool(bad.any()):
                raise AssertionError(
                    f"{name}: output {i} disagrees with the plain version for "
                    f"{int(bad.sum())} agents (max abs err {err:.3e})")
            if rtol == DOT_RTOL and not torch.allclose(g, r, rtol=DOT_RTOL,
                                                       atol=DOT_ATOL):
                raise AssertionError(f"{name}: output {i} is outside rtol "
                                     f"{DOT_RTOL} / atol {DOT_ATOL}")
        must, caught, caught_whole = dropped_period_caught(ref[0], rtol)
        if caught != must:
            raise AssertionError(f"{name}: a dropped period passes the check "
                                 f"for {must - caught} of {must} agents")
        n, r = got[1].shape
        n_lanes = args[0].shape[1]
        work_lanes = n_lanes if n_lanes == HOURS else hour_lanes[cap[0]]
        p = got[0].shape[-1] // 12
        del got, ref
        ms = time_ms(lambda: kernel(*args))
        # the check above ran the plain version on these operands: its warm-up
        plain_ms = time_ms(lambda: plain(*args), reps=PLAIN_REPS, warm=False)
        library_ms, note = None, ""
        if src == "dot":
            b_ms, b_by, note = dot_bound_ms(args, out_bytes)
            note = "; " + note
        elif name == "sums_variant":
            b_ms, b_by, note = variant_bound_ms(
                n, r, n_lanes, p, args[5]["b_pad"], lane_bytes(args, n_lanes),
                out_bytes)
        else:
            b_ms, b_by = bound_ms(n, r, work_lanes, ops, lane_bytes(args, n_lanes),
                                  out_bytes)
        if src.startswith("micro"):
            library_ms = micro_library
        elif micro_library is not None:
            library_ms = bmm_yardstick(args, kernel, name, rtol=rtol)
        if library_ms is not None:
            note += f"; library (torch.bmm, TF32) {library_ms:.3f} ms"
        dtypes = "/".join(str(a.dtype).replace("torch.", "") for a in args[:3])
        log(f"  {name}: N={n} R={r} lanes={n_lanes} ({work_lanes} hours) P={p} "
            f"streams {dtypes} max_abs_err={err:.3e} "
            f"kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | bound {b_ms:.3f} ms "
            f"({b_by}){note}; a dropped period is caught in {caught} of {must} "
            f"agents (one atol over the whole output: {caught_whole})")
        rows.append(dict(name=name, source=SOURCES[src], replaces=replaces,
                         path=cap[0], err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                         shape=(n, r, n_lanes), work_lanes=work_lanes))
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def first_dispatch(capture: dict):
    """Keeps the operands of the first battery dispatch made inside the
    block in ``capture["dispatch"]``; the dispatch runs as it would."""
    from dgen_tpu_torch.ops import dispatch

    kernel = dispatch.dispatch_battery

    def keep(*args, **kw):
        capture.setdefault("dispatch", args)
        return kernel(*args, **kw)

    dispatch.dispatch_battery = keep
    try:
        yield
    finally:
        dispatch.dispatch_battery = kernel


def run_path(sim) -> dict:
    """Run every model year of ``sim`` with the launch counts set to 0
    before and read after; returns the results, per-year seconds, wall,
    launch counts and first-launch operands (the first battery dispatch's
    among them)."""
    import torch

    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops import dispatch
    from dgen_tpu_torch.presets import year_timer

    seconds = []
    bk.CAPTURE = {}
    bk.reset_launches()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    try:
        with first_dispatch(bk.CAPTURE), year_timer(sim, seconds):
            res = sim.run()
    finally:
        launches = {**bk.LAUNCHES, **dispatch.LAUNCHES}
        capture, bk.CAPTURE = bk.CAPTURE, None
    wall = time.perf_counter() - t0
    check_outputs(res, sim)
    want = dispatch_per_year(sim) * len(res.years)
    if launches["dispatch"] != want:
        raise AssertionError(f"{launches['dispatch']} dispatch kernel launches in "
                             f"{len(res.years)} model years, {want} expected")
    lay = sim._daylight
    return dict(res=res, year_s=seconds, wall=wall, launches=launches,
                narrow=dict(bk.NARROW_LAUNCHES),
                capture=capture, n_real=int(sim.host_mask.sum()),
                hour_lanes=None if lay is None else int(lay.valid.sum()))


def report_path(tag: str, title: str, run: dict) -> None:
    res = run["res"]
    n_years = len(res.years)
    log(f"[{tag}] {title}: {run['n_real']} agents x {n_years} years {res.years}; "
        f"per-year s {[round(s, 3) for s in run['year_s']]}, run wall "
        f"{run['wall']:.3f} s, {run['n_real'] * n_years / run['wall']:.1f} "
        f"agent-years/s")
    log(f"    launches {run['launches']}"
        + (f"; on narrow streams {run['narrow']}" if run.get("narrow") else ""))


def need_launches(path: str, launches: dict, keys: tuple, zero: tuple = ()) -> None:
    missing = [k for k in keys if launches[k] == 0]
    extra = [k for k in zero if launches[k] != 0]
    if missing or extra:
        raise AssertionError(f"{path}: kernels {missing} never launched or "
                             f"{extra} launched: {launches}")


def curves_gap(a: dict, b: dict, keys=("adopters", "system_kw_cum",
                                       "batt_kwh_cum")) -> float:
    import numpy as np

    return max(float(np.max(np.abs(a[k] - b[k]) / np.maximum(np.abs(b[k]), 1e-6)))
               for k in keys)


def dispatch_operands(sim) -> tuple:
    """(envs, operands) of the first model year's battery dispatch on
    ``sim``'s shapes: the year's sizing inputs, and load, the generation
    of a system sized to the agent's annual load, that system's battery
    and the year's round-trip efficiencies."""
    import torch

    from dgen_tpu_torch.ops import dispatch, sizing

    envs = year0_envs(sim)
    kw = envs.load_kwh_per_customer / torch.clamp_min(envs.gen_per_kw.sum(1), 1e-9)
    batt_kw, batt_kwh = dispatch.batt_size_from_pv(kw)
    gen = envs.gen_per_kw * (sizing.INV_EFF * kw[:, None])
    return envs, (envs.load, gen, batt_kw, batt_kwh, envs.batt_rt_eff)


def breakdown(sim, knobs: dict, kernel_ms: float) -> dict:
    """Seconds of the first year's sizing call (with the run's knobs),
    once with the battery dispatch kernel and once with the plain loop in
    its place, and of the dispatch kernel and the plain loop alone on the
    main path's shapes, each timed alone after a synchronize, beside the
    sum of the isolated launch medians of the year's kernel launches (not
    timed inside the sizing call)."""
    import torch

    from dgen_tpu_torch.ops import dispatch, sizing

    envs, ops = dispatch_operands(sim)

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def size():
        sizing.size_agents(
            envs, n_periods=sim.tariffs.max_periods, n_years=sim.econ_years,
            n_iters=sim.run_config.sizing_iters, keep_hourly=sim.with_hourly,
            net_billing=sim._net_billing, **knobs)

    sizing_s = timed(size)
    kernel = dispatch.dispatch_battery
    dispatch.dispatch_battery = lambda *a: dispatch.dispatch_battery_plain(*a)
    try:
        sizing_plain_s = timed(size)
    finally:
        dispatch.dispatch_battery = kernel
    return dict(
        sizing_s=sizing_s, sizing_plain_dispatch_s=sizing_plain_s,
        dispatch_s=timed(lambda: dispatch.dispatch_battery(*ops)),
        dispatch_plain_s=timed(lambda: dispatch.dispatch_battery_plain(*ops)),
        kernel_medians_s=kernel_ms / 1e3,
    )


def sm_clock_mhz_under(fn) -> float:
    """The SM clock nvidia-smi reads while ``fn`` is launched back to back
    (at most 2,000 launches)."""
    import torch

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, text=True)
    for _ in range(2000):
        if proc.poll() is not None:
            break
        fn()
    out = proc.communicate(timeout=60)[0]
    torch.cuda.synchronize()
    return float(out.strip().splitlines()[0])


def dispatch_row(ops: tuple, launches: int) -> dict:
    """The dispatch kernel against its plain loop on ``ops``, bit for
    bit, both timed, its bound: the larger of its bytes (load and gen
    read, the four outputs written, the three [N] battery inputs read, at
    4 bytes; DISPATCH_OPS float32 operations an (agent, hour) take less)
    and its serial chain (DISPATCH_CHAIN dependent instructions of
    DEPENDENT_CYCLES an hour at the SM clock read under load); and the
    kernel on the first warp of agents alone (its chain in practice,
    logged)."""
    import torch

    from dgen_tpu_torch.ops import dispatch

    got = dispatch.dispatch_battery(*ops)
    ref = dispatch.dispatch_battery_plain(*ops)
    torch.cuda.synchronize()
    err = 0.0
    for k in ("system_out", "soc", "charge", "discharge"):
        a, b = getattr(got, k), getattr(ref, k)
        err = max(err, float((a - b).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError(f"battery_dispatch: {k} differs from the plain "
                                 f"loop (max abs err {err:.3e})")
    del got, ref
    n, hours = ops[0].shape
    ms = time_ms(lambda: dispatch.dispatch_battery(*ops))
    # the check above ran the plain loop on these operands: its warm-up
    plain_ms = time_ms(lambda: dispatch.dispatch_battery_plain(*ops), reps=PLAIN_REPS,
                       warm=False)
    mhz = sm_clock_mhz_under(lambda: dispatch.dispatch_battery(*ops))
    t_bytes = 4.0 * (6 * n * hours + 3 * n) / PEAK_BYTES_PER_S * 1e3
    t_ops = float(n) * hours * DISPATCH_OPS / PEAK_F32_FLOPS * 1e3
    t_chain = float(hours) * DISPATCH_CHAIN * DEPENDENT_CYCLES / (mhz * 1e6) * 1e3
    b_ms, b_by = max((t_bytes, "bytes"), (t_ops, "operations"),
                     (t_chain, "operations"))
    warp = tuple(t[:32] for t in ops)
    warp_ms = time_ms(lambda: dispatch.dispatch_battery(*warp))
    log(f"  battery_dispatch: N={n} H={hours} equal to the plain loop bit for bit "
        f"(torch.equal, every output) kernel {ms:.3f} ms | plain {plain_ms:.3f} ms "
        f"| bound {b_ms:.3f} ms ({'bytes' if b_ms == t_bytes else 'serial chain'}; "
        f"bytes {t_bytes:.3f} ms, serial chain {t_chain:.3f} ms = {DISPATCH_CHAIN} "
        f"dependent instructions x {DEPENDENT_CYCLES} cycles x {hours} hours at "
        f"{mhz:.0f} MHz under load); one warp of 32 agents alone (the serial "
        f"chain in practice) {warp_ms:.3f} ms")
    return dict(name="battery_dispatch", route="cuda", source=SOURCES["dispatch"],
                replaces="dgen_tpu/ops/dispatch.py:88", launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, shape_n_hours=[n, hours],
                sm_clock_mhz=mhz, serial_chain_ms=warp_ms, path="main")


def dispatch_every_path(captures: dict) -> None:
    """The dispatch kernel against its plain loop, bit for bit, on the
    first battery dispatch of every model path (every path but the
    micro-benchmark's, which runs no model year); logged, a mismatch or a
    model path with no captured dispatch fails the run."""
    import torch

    from dgen_tpu_torch.ops import dispatch

    for path, cap in captures.items():
        if path == "micro":
            continue
        if "dispatch" not in cap:
            raise AssertionError(f"the {path} path captured no battery dispatch")
        ops = cap["dispatch"]
        got = dispatch.dispatch_battery(*ops)
        ref = dispatch.dispatch_battery_plain(*ops)
        torch.cuda.synchronize()
        for k in ("system_out", "soc", "charge", "discharge"):
            if not torch.equal(getattr(got, k), getattr(ref, k)):
                raise AssertionError(f"battery_dispatch on the {path} path: {k} "
                                     "differs from the plain loop")
        log(f"  battery_dispatch on the {path} path's first dispatch: "
            f"N={ops[0].shape[0]} H={ops[0].shape[1]}, equal to the plain loop bit "
            "for bit (torch.equal, every output)")
        del got, ref
        torch.cuda.empty_cache()


def month_kernel_ab(imports: tuple, signed: tuple) -> None:
    """Logged A/B of the month kernel on the main path's first imports
    launch (R = 300) at its own P and at AB_PERIODS periods from a seeded
    period map, and on its first signed launch (R = 25), each at 1, 2 and
    4 scales a thread beside the kernel's own choice; at AB_PERIODS also
    against its plain version. Every form sums in the same order, so the
    forms must agree bit for bit."""
    import torch

    from dgen_tpu_torch.ops import billkernels as bk

    load, gen, sell, period, scales, offsets, p, _ = imports
    g = torch.Generator(device=load.device).manual_seed(10)
    period10 = torch.randint(0, AB_PERIODS, period.shape, generator=g,
                             device=load.device, dtype=torch.int32)
    cases = [("imports", imports),
             ("imports", (load, gen, sell, period10, scales, offsets, AB_PERIODS,
                          False)),
             ("signed", signed)]
    for kind, a in cases:
        base = bk.month_sums(*a)
        line = [f"own choice {time_ms(lambda: bk.month_sums(*a)):.3f} ms"]
        for spt in bk.MONTH_SCALES_PER_THREAD_FORMS:
            got = bk.month_sums(*a, scales_per_thread=spt)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, base)):
                raise AssertionError(f"month kernel at {spt} scales a thread "
                                     "differs from its own choice")
            del got
            ms = time_ms(lambda: bk.month_sums(*a, scales_per_thread=spt))
            line.append(f"{spt} a thread {ms:.3f} ms")
        msg = ""
        if a[6] == AB_PERIODS:
            ref = bk.month_sums_plain(*a)
            torch.cuda.synchronize()
            for i, (x, y) in enumerate(zip(base, ref)):
                if bool(bad_agents(x, y).any()):
                    raise AssertionError(f"month kernel at P = {AB_PERIODS}: output "
                                         f"{i} disagrees with the plain version")
            err = max(float((x - y).abs().max()) for x, y in zip(base, ref))
            del ref
            msg = (f"; max_abs_err {err:.3e}, plain "
                   f"{time_ms(lambda: bk.month_sums_plain(*a)):.3f} ms")
        del base
        log(f"  month kernel, {kind} at P={a[6]}: N={a[0].shape[0]} "
            f"R={a[4].shape[1]} lanes={a[0].shape[1]}: " + ", ".join(line) + msg)
        torch.cuda.empty_cache()


def same_bits(got, ref) -> bool:
    """Every output equal bit for bit (signed zeros included)."""
    import torch

    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return all(a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))
               for a, b in zip(got, ref, strict=True))


def staging_ab(captures: dict) -> None:
    """The stream kernel against the month kernel on the gated path's and
    the int8-banks path's own operands, and the pair kernel against two
    month launches (one a tariff) on both rate-switch paths' operands:
    bit for bit, and both sides timed in alternated pairs; a mismatch
    fails the run."""
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.tools.kernel_microbench import ab_ms

    for name, (path, key) in (
            ("stream imports, gated", ("gated", "stream")),
            ("stream signed, gated", ("gated", "stream_signed")),
            ("stream imports, int8 packs", ("quant", "stream/int8"))):
        args = captures[path][key]
        if not same_bits(bk.stream_sums(*args), bk.month_sums(*args)):
            raise AssertionError(f"{name}: the stream kernel differs from the "
                                 "month kernel on the same operands")
        ms, month_ms, wins = ab_ms(lambda: bk.stream_sums(*args),
                                   lambda: bk.month_sums(*args))
        log(f"  {name}: N={args[0].shape[0]} R={args[4].shape[1]} "
            f"lanes={args[0].shape[1]}: equal to the month kernel bit for bit; "
            f"stream kernel {ms:.3f} ms | month kernel {month_ms:.3f} ms "
            f"(medians of 6 alternated pairs; stream faster in {wins})")
    for path in ("switch", "switch_gated"):
        load, gen, sa, pa, sb, pb, scales, offsets, p = captures[path]["month_pair"]

        def two():
            return (bk.month_sums(load, gen, sa, pa, scales, offsets, p, False)
                    + bk.month_sums(load, gen, sb, pb, scales, offsets, p, False))

        def pair():
            return bk.month_pair_sums(load, gen, sa, pa, sb, pb, scales, offsets, p)

        name = f"pair, {path}"
        if not same_bits(pair(), two()):
            raise AssertionError(f"{name}: the pair kernel differs from two month "
                                 "launches on the same operands")
        ms, month_ms, wins = ab_ms(pair, two)
        log(f"  {name}: N={load.shape[0]} R={scales.shape[1]} lanes={load.shape[1]}: "
            f"equal to two month launches bit for bit; pair kernel {ms:.3f} ms | "
            f"two month launches {month_ms:.3f} ms (medians of 6 alternated "
            f"pairs; pair faster in {wins})")


#: the pieces of a model year the profiled year names, by module and
#: function: (label, module path, attribute)
YEAR_PIECES = (
    ("apply_year", "dgen_tpu_torch.models.simulation", "apply_year"),
    ("nem_gate", "dgen_tpu_torch.models.simulation", "compute_nem_allowed"),
    ("build_econ_inputs", "dgen_tpu_torch.models.simulation", "build_econ_inputs"),
    ("size_agents", "dgen_tpu_torch.ops.sizing", "size_agents"),
    ("linear_sums", "dgen_tpu_torch.ops.billkernels", "linear_sums"),
    ("pack_streams", "dgen_tpu_torch.ops.billkernels", "pack_streams"),
    ("import_sums", "dgen_tpu_torch.ops.billkernels", "import_sums"),
    ("bucket_sums", "dgen_tpu_torch.ops.billkernels", "bucket_sums"),
    ("bills_linear_nb", "dgen_tpu_torch.ops.billkernels", "bills_linear_nb"),
    ("bills_linear_nem", "dgen_tpu_torch.ops.billkernels", "bills_linear_nem"),
    ("bills_from_sums", "dgen_tpu_torch.ops.billkernels", "bills_from_sums"),
    ("cashflow", "dgen_tpu_torch.ops.sizing", "cashflow"),
    ("payback_period", "dgen_tpu_torch.ops.sizing", "payback_period"),
    ("dispatch_battery", "dgen_tpu_torch.ops.dispatch", "dispatch_battery"),
    ("net_hourly_profiles", "dgen_tpu_torch.ops.sizing", "net_hourly_profiles"),
    ("max_market_share", "dgen_tpu_torch.models.simulation", "max_market_share"),
    ("diffusion_step", "dgen_tpu_torch.models.simulation", "diffusion_step"),
    ("allocate_battery", "dgen_tpu_torch.models.simulation",
     "allocate_battery_adopters"),
)


def busy_us(device_events) -> float:
    """Microseconds the device was busy: the union of the events' time
    intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_year(sim, title: str) -> None:
    """One carry year of ``sim`` (its first year run just before, outside
    the trace) under torch.profiler, its outputs collected to the host as
    Simulation.run collects them. Logs the ten device operations that
    took most time with their launch counts, kernel (and copy) time
    against the year's wall time, the device's idle share over that wall
    time (1 - the union of device intervals / wall), and per piece of the
    year (YEAR_PIECES, each wrapped in a record_function range for the
    trace) its calls, host time and device time."""
    import dataclasses
    import gc
    import importlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from dgen_tpu_torch.models.simulation import YearOutputs

    def labelled(label, fn):
        def run(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return run

    originals = []
    for label, mod, attr in YEAR_PIECES:
        m = importlib.import_module(mod)
        originals.append((m, attr, getattr(m, attr)))
        setattr(m, attr, labelled(label, getattr(m, attr)))
    fields = [f.name for f in dataclasses.fields(YearOutputs)]
    step = type(sim).step
    try:
        carry, _ = step(sim, sim.init_carry(), 0, True)
        torch.cuda.synchronize()
        # a full collection now, so that the collector's generation-2 pass
        # (~0.1-0.25 s over the script's ~270,000 live objects) does not
        # land in the traced year's host time
        gc.collect()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            carry, outs = step(sim, carry, 1, False)
            with record_function("collect"):
                for k in fields:
                    v = getattr(outs, k)
                    if v is not None:
                        v.cpu().numpy()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for m, attr, fn in originals:
            setattr(m, attr, fn)
    labels = {label for label, _, _ in YEAR_PIECES} | {"collect"}
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in labels]
    if not device:
        raise AssertionError(f"{title}: the profiler recorded no device operation")
    by_name: dict = {}
    for e in device:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = busy_us(device)
    copies = sum(us for name, (_, us) in by_name.items()
                 if name.startswith(("Memcpy", "Memset")))
    kernels = sum(us for _, us in by_name.values()) - copies
    log(f"[9c] profiled carry year, {title}: wall {wall_us / 1e3:.3f} ms; device "
        f"kernels {kernels / 1e3:.3f} ms, copies {copies / 1e3:.3f} ms; device busy "
        f"(union of intervals) {busy / 1e3:.3f} ms, idle share "
        f"{1.0 - busy / wall_us:.3f}; {sum(n for n, _ in by_name.values())} device "
        f"operations of {len(by_name)} kinds; the ten longest:")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"    {us / 1e3:8.3f} ms  {n:4d} x  {name[:110]}")
    log("    pieces of the year (host ms inclusive, device ms of the kernels "
        "they launched):")
    for label in [lb for lb, _, _ in YEAR_PIECES] + ["collect"]:
        hits = [e for e in events if e.name == label
                and e.device_type == DeviceType.CPU]
        if not hits:
            continue
        dev_us = sum(e.device_time_total if hasattr(e, "device_time_total")
                     else e.cuda_time_total for e in hits)
        log(f"    {label:20s} {len(hits):3d} calls  host {sum(e.cpu_time_total for e in hits) / 1e3:8.3f} ms  "
            f"device {dev_us / 1e3:8.3f} ms")


def n_chunks(sim) -> int:
    """Chunks of ``sim``'s year step (1 = the whole table)."""
    return sim.table.n_agents // sim._agent_chunk if sim._agent_chunk else 1


def sizing_dispatches(sim) -> int:
    """Battery dispatch launches of one model year's sizing: one a chunk,
    and on a tariff-clustered run one a chunk of each cluster's segment
    (a segment no longer than the chunk is one)."""
    lay = getattr(sim, "_cluster_layout", None)
    if lay is None:
        return n_chunks(sim)
    c = sim._agent_chunk
    return sum(s.seg_len // c if c and s.seg_len > c else 1 for s in lay.clusters)


def dispatch_per_year(sim) -> int:
    """Battery dispatch launches of one model year: those of sizing
    (:func:`sizing_dispatches`), and one more a chunk in the hourly remat
    pass of a streaming run with the state-hourly aggregate on."""
    return sizing_dispatches(sim) + (n_chunks(sim) if sim._agent_chunk
                                     and sim.with_hourly else 0)


def check_outputs(res, sim) -> None:
    """Every collected output covers the table's rows, padding included,
    and is finite."""
    import numpy as np

    for k, v in res.agent.items():
        if v.shape[1] != sim.table.n_agents or not np.all(np.isfinite(v)):
            raise AssertionError(f"output {k} has shape {v.shape} (table rows "
                                 f"{sim.table.n_agents}) or non-finite values")
    if res.state_hourly_net_mw is not None and not np.all(
            np.isfinite(res.state_hourly_net_mw)):
        raise AssertionError("non-finite state-hourly net load")


def counted_run(sim) -> tuple:
    """``sim.run()`` with no operands captured (so the card's measured
    peak is the run's own) and the launch counts set to 0 before and
    read after; (results, launches, per-year seconds ending in a
    synchronize)."""
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops import dispatch
    from dgen_tpu_torch.presets import year_timer

    bk.CAPTURE = None
    bk.reset_launches()
    dispatch.reset_launches()
    with year_timer(sim, []) as seconds:
        res = sim.run()
    return res, {**bk.LAUNCHES, **dispatch.LAUNCHES}, seconds


def held_rows(name: str, got, args: tuple, plain, same) -> float:
    """Holds the kernel's outputs ``got`` on the operands ``args`` against
    ``plain`` on the same rows, HELD_ROWS agents at a time so the plain
    version's temporaries stay small (every tensor argument whose leading
    dimension is the agent rows is sliced); ``same(g, r)`` -> the [rows]
    agents that disagree. Raises on a disagreement; returns the largest
    absolute error."""
    import torch

    n = args[0].shape[0]
    err = 0.0
    for a in range(0, n, HELD_ROWS):
        rows = slice(a, min(a + HELD_ROWS, n))
        ref = plain(*(t[rows] if isinstance(t, torch.Tensor) and t.dim()
                      and t.shape[0] == n else t for t in args))
        for i, (g, r) in enumerate(zip(got, ref, strict=True)):
            g = g[rows]
            if g.dtype != r.dtype or g.shape != r.shape:
                raise AssertionError(f"{name}: output {i} is {g.dtype} "
                                     f"{tuple(g.shape)}, plain {r.dtype} "
                                     f"{tuple(r.shape)}")
            bad = same(g, r)
            if bool(bad.any()):
                first = a + int(bad.nonzero()[0, 0])
                raise AssertionError(
                    f"{name}: output {i} disagrees with the plain version for "
                    f"{int(bad.sum())} agents of rows {rows.start}-{rows.stop - 1} "
                    f"(first: row {first} of {n})")
            err = max(err, float((g.float() - r.float()).abs().max()))
        del ref
    return err


def not_equal(g, r):
    """[rows] agents whose outputs differ in any bit."""
    return (g != r).flatten(1).any(1) if g.ndim > 1 else g != r


def sums_agree(g, r):
    """[rows] agents whose bucket sums disagree at the main path's
    tolerance (:func:`bad_agents`; bf16 sums at BF16_RTOL)."""
    import torch

    rtol = BF16_RTOL if g.dtype == r.dtype == torch.bfloat16 else RTOL
    return bad_agents(g.float(), r.float(), rtol)


#: launch-count key -> (billkernels wrapper, its plain version): the bucket
#: sums kernels held_year holds as they launch
HELD_SUMS = {
    "month": ("month_sums", "month_sums_plain"),
    "stream": ("stream_sums", "month_sums_plain"),
    "month_pair": ("month_pair_sums", "month_pair_sums_plain"),
}


def held_year(sim, tag: str, launches: dict, by_p: bool = False, step=None) -> None:
    """One more first model year of ``sim`` after its counted run (so
    that run's launch counts and memory peaks stand as it left them), in
    which the first launch of each bucket-sums kernel the counted run
    launched (``launches``: month, signed month, stream, signed stream,
    pair), and the first battery dispatch of sizing and, on a streaming
    run with hourly on, of the remat pass, are each held against the
    plain version as they launch, at the shapes the path gives them: the
    bucket sums per agent at RTOL (:func:`sums_agree`), the dispatch bit
    for bit. ``by_p``: the first launch of each kernel at each period
    count P is held (a tariff-clustered run; ``launches`` then holds the
    counted run's ``<kernel>@P<p>`` keys, :func:`launches_by_p`). Nothing
    is kept past its check, so no chunk's operands stay pinned; raises on
    a disagreement or a check that never ran. ``step``: the first year to
    run instead of ``sim``'s own (a sweep's, whose launches carry S x chunk
    rows; ``sim`` then gives the chunk and the hourly switch)."""
    import torch

    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops import dispatch

    wrappers = {key: getattr(bk, fn) for key, (fn, _) in HELD_SUMS.items()}
    disp = dispatch.dispatch_battery
    remat = sizing_dispatches(sim) if sim._agent_chunk and sim.with_hourly else None
    dispatches = []
    held = {}

    def sums_held(key):
        kernel, plain = wrappers[key], getattr(bk, HELD_SUMS[key][1])

        def run(*args):
            got = kernel(*args)
            pair = key == "month_pair"
            name = key + ("_signed" if not pair and args[7] else "")
            if by_p:
                name += f"@P{args[8] if pair else args[6]}"
            if name not in held:
                err = held_rows(f"[{tag}] {name}", got, args, plain, sums_agree)
                scales, p = (args[6], args[8]) if pair else (args[4], args[6])
                held[name] = (f"N={scales.shape[0]} R={scales.shape[1]} P={p} "
                              f"lanes={args[0].shape[1]} {args[0].dtype} "
                              f"max_abs_err={err:.3e}")
            return got
        return run

    def dispatch_held(*args, **kw):
        i = len(dispatches)
        dispatches.append(i)
        got = disp(*args, **kw)
        if i in (0, remat):
            fields = ("system_out", "soc", "charge", "discharge")

            def plain(*a):
                # one plain loop a block, its four outputs held together
                res = dispatch.dispatch_battery_plain(*a)
                return [getattr(res, k) for k in fields]

            held_rows(f"[{tag}] dispatch {i}", [getattr(got, k) for k in fields],
                      args, plain, not_equal)
            held["dispatch (sizing)" if i == 0 else "dispatch (remat pass)"] = (
                f"N={args[0].shape[0]} H={args[0].shape[1]} bit for bit")
        return got

    bk.CAPTURE = None
    for key, (fn, _) in HELD_SUMS.items():
        setattr(bk, fn, sums_held(key))
    dispatch.dispatch_battery = dispatch_held
    try:
        if step is None:
            sim.step(sim.init_carry(), 0, True)
        else:
            step()
    finally:
        for key, (fn, _) in HELD_SUMS.items():
            setattr(bk, fn, wrappers[key])
        dispatch.dispatch_battery = disp
    want = [k for k in ("month", "month_signed", "stream", "stream_signed",
                        "month_pair") if launches.get(k)]
    if by_p:
        want = sorted(k for k, v in launches.items() if "@P" in k and v)
    want.append("dispatch (sizing)")
    if remat is not None:
        want.append("dispatch (remat pass)")
    missing = [k for k in want if k not in held]
    if missing:
        raise AssertionError(f"[{tag}] no launch of {missing} to hold against "
                             "the plain version")
    log(f"    [{tag}] first launches of a further first year held against the "
        f"plain versions (bucket sums rtol {RTOL}, atol {ATOL_FRAC} x the agent's "
        f"max|plain|; in blocks of {HELD_ROWS} rows): {held}")
    torch.cuda.empty_cache()


def per_year(launches: dict, years: int) -> dict:
    return {k: v / years for k, v in launches.items() if v}


def chunked_vs_whole(presets, RunConfig) -> None:
    """[3c]: the streaming year step (4 chunks) against the whole table
    at CHUNK_AGENTS with batteries allocated (CHUNK_ATTACHMENT), per
    agent and state-hourly, in each of CHUNK_WORLDS; each run's first
    launches held against the plain versions (:func:`held_year`); raises
    on a mismatch, a world with no battery adopters, a kernel of the
    world that never launched or a launch count off the chunk count."""
    import numpy as np
    import torch

    from dgen_tpu_torch.ops import billkernels as bk

    for world, (knobs, switch, kernels) in CHUNK_WORLDS.items():
        out = {}
        for tag, chunk in (("chunked", CHUNK_ROWS), ("whole", 0)):
            tag = f"{world}, {tag}"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            sim, _, _ = presets.build("ercot-all-sector", n_agents=CHUNK_AGENTS,
                                      end_year=CHUNK_END_YEAR, device="cuda",
                                      run_config=RunConfig(agent_chunk=chunk, **knobs),
                                      attachment_rate=CHUNK_ATTACHMENT,
                                      rate_switch_frac=switch)
            if not (sim.with_hourly and sim.scenario.storage_enabled):
                raise AssertionError("the [3c] world runs without hourly or storage")
            res, launches, secs = counted_run(sim)
            narrow = dict(bk.NARROW_LAUNCHES)
            check_outputs(res, sim)
            mem = sim.memory_check
            years = len(res.years)
            log(f"[3c] {tag}: {int(sim.host_mask.sum())} agents, "
                f"{sim.table.n_agents} rows, chunk {sim._agent_chunk} "
                f"({n_chunks(sim)} chunks) x {years} years {res.years}, knobs "
                f"{sorted(knobs) or 'none'}, rate switch {sim._rate_switch}; per-year "
                f"s {[round(t, 3) for t in secs]}; launches a year "
                f"{per_year(launches, years)}"
                + (f", on narrow streams {per_year(narrow, years)}" if narrow else "")
                + f"; modeled step {mem['modeled_step_bytes'] / 2**30:.2f} GiB, "
                f"measured peak allocated {mem['device_peak_allocated'] / 2**30:.2f} "
                f"GiB, reserved {mem['device_peak_reserved'] / 2**30:.2f} GiB; "
                f"health {sim.health_report}")
            if launches["dispatch"] != dispatch_per_year(sim) * years:
                raise AssertionError(f"[3c] {tag}: {launches['dispatch']} dispatch "
                                     "launches")
            need_launches(f"[3c] {tag}", launches, kernels)
            if knobs.get("quant_banks") and narrow.get("stream/int8") != launches["stream"]:
                raise AssertionError(f"[3c] {tag}: stream launches on int8 codes "
                                     f"{narrow}, of {launches['stream']}")
            batt = float(res.agent["new_batt_adopters"].sum())
            log(f"    [3c] {tag}: {batt:.1f} battery adopters allocated over the run")
            if not batt > 0:
                raise AssertionError(f"[3c] {tag}: no battery adopters, so the "
                                     "remat pass's battery profile is not compared")
            held_year(sim, f"3c {tag}", launches)
            out[tag] = (sim, res, launches)
            del sim
        (c_sim, c_res, c_l), (w_sim, w_res, w_l) = out.values()
        if c_sim._agent_chunk != CHUNK_ROWS or n_chunks(c_sim) != CHUNK_AGENTS // CHUNK_ROWS:
            raise AssertionError(f"[3c] {world}: the chunked path did not engage: "
                                 f"chunk {c_sim._agent_chunk}, rows {c_sim.table.n_agents}")
        if w_sim._agent_chunk:
            raise AssertionError(f"[3c] {world}: the whole-table run streamed")
        k = n_chunks(c_sim)
        for key in set(kernels) | {key for key, v in w_l.items() if v}:
            if key != "dispatch" and c_l[key] != k * w_l[key]:
                raise AssertionError(f"[3c] {world}, {key}: {c_l[key]} chunked "
                                     f"launches, {w_l[key]} whole-table")
        m = w_sim.host_mask
        n = len(m)
        worst = {}
        for f in CHUNK_FIELDS:
            a, b = w_res.agent[f] * m, c_res.agent[f][:, :n] * m
            np.testing.assert_allclose(b, a, rtol=CHUNK_RTOL, atol=CHUNK_ATOL,
                                       err_msg=f"[3c] {world}: chunked vs whole {f}")
            worst[f] = float(np.max(np.abs(a - b)))
        np.testing.assert_allclose(c_res.state_hourly_net_mw, w_res.state_hourly_net_mw,
                                   rtol=CHUNK_HOURLY_RTOL, atol=CHUNK_HOURLY_ATOL,
                                   err_msg=f"[3c] {world}: chunked vs whole state-hourly")
        worst["state_hourly_net_mw"] = float(np.max(np.abs(
            c_res.state_hourly_net_mw - w_res.state_hourly_net_mw)))
        bits = {f: bool(np.array_equal(c_res.agent[f][:, :n], w_res.agent[f]))
                for f in CHUNK_FIELDS}
        log(f"    [3c] {world}: chunked vs whole within rtol {CHUNK_RTOL}/atol "
            f"{CHUNK_ATOL} per agent and rtol {CHUNK_HOURLY_RTOL}/atol "
            f"{CHUNK_HOURLY_ATOL} state-hourly; largest absolute gaps {worst}; bit "
            f"for bit per field {bits}")
        del out, c_sim, w_sim


def national_path(presets, whole_per_year: dict, keep: dict | None = None) -> float:
    """[3d]: national-all-sector at its full width under the automatic
    chunk for NATIONAL_END_YEAR's model years, collect=False, the
    national sums reduced on the card each year; prints the run's record,
    the memory model beside the measured peaks, the health verdict and
    the launch counts, and raises unless the chunked path engaged, the
    sums are finite and the launch counts match the chunk count
    (``whole_per_year``: the whole-table main path's launches a year).
    The run keeps no operands (``billkernels.CAPTURE = None``: one
    chunk's [~88k, 8760] streams would stay pinned through it); a
    further first year holds the first launches, past row 65,535, against
    the plain versions (:func:`held_year`). ``keep``: a dict the run's
    per-agent outputs (``parallel.launch.COLLECT_FIELDS``, each year's
    ``[N]`` rows fetched by the callback), row ids and first year's
    wall (``first_year_s``) go into, for [3n] (b). Returns the run's
    agent-years a second over its years."""
    import torch

    from dgen_tpu_torch.parallel.launch import COLLECT_FIELDS

    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops import dispatch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t_start = time.perf_counter()
    sim, _, meta = presets.build(NATIONAL, end_year=NATIONAL_END_YEAR, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_start
    k = n_chunks(sim)
    n_real = int(sim.host_mask.sum())
    log(f"[3d] {NATIONAL} at {n_real} agents, {len(sim.years)} model years "
        f"{sim.years} (depth cut from the preset's 19 so the script stays in its "
        f"time), hourly {sim.with_hourly}, storage {sim.scenario.storage_enabled}: "
        f"auto chunk {sim._agent_chunk} rows, {k} chunks, {sim.table.n_agents} padded "
        f"rows; built in {build_s:.3f} s")
    if not sim._agent_chunk or k < 2:
        raise AssertionError(f"[3d] the chunked path did not engage (chunk "
                             f"{sim._agent_chunk})")
    mask = sim.table.mask
    sums = []

    def national(year, yi, outs):
        sh = outs.state_hourly_net_mw
        row = torch.stack([(outs.number_of_adopters * mask).sum(),
                           (outs.system_kw_cum * mask).sum(),
                           (outs.batt_kwh_cum * mask).sum(),
                           sh.sum(), torch.isfinite(sh).all().float(),
                           torch.tensor(float(sh.numel()), device=sh.device)])
        sums.append((year, row.cpu().tolist()))
        if keep is not None:
            # the year's [N] fields stay on the card (no copy in the timed
            # years) and are fetched after the run
            for f in COLLECT_FIELDS:
                keep.setdefault(f, []).append(getattr(outs, f))

    bk.CAPTURE = None
    bk.reset_launches()
    dispatch.reset_launches()
    rec = presets.timed_run(sim, meta, t_start, build_s, callback=national)
    launches = {**bk.LAUNCHES, **dispatch.LAUNCHES}
    if keep is not None:
        for f in COLLECT_FIELDS:
            keep[f] = [t.cpu().numpy() for t in keep[f]]
        keep.update(agent_id=sim.host_agent_id, mask=sim.host_mask, years=sim.years,
                    first_year_s=rec["year_s"][0])
    ys = rec["year_s"]
    carry = ys[1:]
    log(f"    per-year s {ys}: first year {ys[0]:.3f} s, carry years "
        f"{[round(t, 3) for t in carry]} s, {n_real / (sum(carry) / len(carry)):.1f} "
        f"agent-years/s a carry year; {n_real * len(ys) / sum(ys):.1f} agent-years/s "
        f"over the run's years")
    mem = sim.memory_check
    log(f"    memory: modeled step {mem['modeled_step_bytes'] / 2**30:.2f} GiB "
        f"({sim._per_agent_bytes} bytes a chunk row), measured peak allocated "
        f"{mem['device_peak_allocated'] / 2**30:.2f} GiB, reserved "
        f"{mem['device_peak_reserved'] / 2**30:.2f} GiB, card "
        f"{mem['device_total'] / 2**30:.2f} GiB (peak/model "
        f"{mem['peak_over_model']:.3f}; {held / 2**30:.2f} GiB of earlier phases "
        f"held before the build, in the peak)")
    log(f"    health {sim.health_report}; launches {launches} "
        f"({per_year(launches, len(ys))} a year)")
    log(f"    national sums a year (adopters, system kW, battery kWh, state-hourly "
        f"MW sum, state-hourly all finite, its size): {sums}")
    log(f"    record {json.dumps(rec)}")
    for year, row in sums:
        if not all(math.isfinite(v) for v in row) or row[4] != 1.0:
            raise AssertionError(f"[3d] non-finite national sums in {year}: {row}")
        if row[5] != sim.table.n_states * 8760:
            raise AssertionError(f"[3d] state-hourly aggregate of size {row[5]}")
    if not sums[-1][1][0] > 0:
        raise AssertionError("[3d] no national adoption")
    years = len(ys)
    if launches["dispatch"] != 2 * k * years:
        raise AssertionError(f"[3d] {launches['dispatch']} dispatch launches in "
                             f"{years} years of {k} chunks, {2 * k * years} expected")
    for key in ("month", "month_signed"):
        if launches[key] != k * whole_per_year[key] * years:
            raise AssertionError(f"[3d] {launches[key]} {key} launches, "
                                 f"{k * whole_per_year[key] * years} expected")
    if not sim.health_report["clean"]:
        raise AssertionError(f"[3d] health breaches: {sim.health_report}")
    held_year(sim, "3d", launches)
    return n_real * len(ys) / sum(ys)


#: [3f]: the run outputs at national-all-sector's full width, over
#: NATIONAL_END_YEAR's model years; the year (d) resumes after
RESUME_YEAR = 2014
#: compact quantization: each quantized value within max|x| / 65532 of
#: the collected float32 (its column's for the cash-flow series), with the
#: 1% margin of tests/test_io_runtime.py for float32 rounding
QUANT_BOUND = 1.0 / 65532 * 1.01


class _CountingExporter:
    """A preset-runner exporter (``presets._TimedExporter``) that also
    records the bytes of each year's device payload, the export's share
    of the fetch."""

    def __init__(self, inner):
        self.inner = inner
        self.payload_bytes = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, year, year_idx, outs):
        self.inner(year, year_idx, outs)

    def device_payload(self, year, year_idx, outs):
        from dgen_tpu_torch.io import hostio

        p = self.inner.device_payload(year, year_idx, outs)
        self.payload_bytes.append(hostio.tree_bytes(p))
        return p


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, names in os.walk(path) for f in names)


def _year_bytes(run_dir: str, year: int) -> int:
    """Bytes written for one model year: its three surface partitions."""
    import os

    from dgen_tpu_torch.io import export

    return sum(os.path.getsize(os.path.join(run_dir, s, f"year={year}.npz"))
               for s in export.SURFACES)


def outputs_run(presets, RunConfig, *, name: str, n_agents,
                end_year: int, device: str, knobs: dict, async_io=None,
                export_dir=None, checkpoint_dir=None, collect=False,
                resume_year=None) -> dict:
    """One counted run of [3f] on a freshly built Simulation: launch counts
    set to 0 before and read after, the run's wall ending in a
    synchronize; with ``export_dir`` a preset-runner exporter writes the
    surfaces, ``checkpoint_dir`` checkpoints every year, ``resume_year``
    resumes after that year from ``checkpoint_dir``."""
    import torch

    from dgen_tpu_torch.io import export, synth
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops import dispatch
    from dgen_tpu_torch.utils import timing

    if device == "cuda":
        torch.cuda.empty_cache()
    sim, pop, meta = presets.build(name, n_agents=n_agents, end_year=end_year,
                                   device=device,
                                   run_config=RunConfig(async_host_io=async_io, **knobs))
    exporter = None
    if export_dir is not None:
        exporter = _CountingExporter(presets._TimedExporter(export.RunExporter(
            export_dir, agent_id=sim.host_agent_id, mask=sim.host_mask, meta=meta,
            device=sim.device,
            static_frame=export.static_frame_from_table(pop.table,
                                                        states=list(synth.STATES)))))
    bk.CAPTURE = None
    bk.reset_launches()
    dispatch.reset_launches()
    timing.reset_timings()
    sim._sync()
    t0 = time.perf_counter()
    res = sim.run(callback=exporter, collect=collect, checkpoint_dir=checkpoint_dir,
                  resume=resume_year is not None, resume_year=resume_year)
    sim._sync()
    wall = time.perf_counter() - t0
    timings = timing.timing_report()
    return dict(sim=sim, res=res, wall=wall, exporter=exporter,
                launches={**bk.LAUNCHES, **dispatch.LAUNCHES}, timings=timings,
                stats=sim.hostio_stats)


def fetch_seconds(nbytes: int, device: str) -> dict:
    """Seconds of the pipeline's fetch stage (``io.hostio.to_host`` on a
    side stream) for one tensor of ``nbytes`` on an idle ``device``: into
    new pinned buffers ("cold"), then again into buffers the caching host
    allocator gives back ("warm")."""
    import torch

    from dgen_tpu_torch.io import hostio

    x = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    side = torch.cuda.Stream() if device == "cuda" else None
    out = {}
    for key in ("cold", "warm"):
        ready = None
        if side is not None:
            ready = torch.cuda.Event()
            ready.record()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = hostio.to_host({"x": x}, ready=ready, stream=side)
        out[key] = time.perf_counter() - t0
        del h
    return out


def trace_outputs_year(presets, RunConfig, work: str, *, name: str, n_agents,
                       end_year: int, device: str, knobs: dict) -> dict:
    """The second model year of ``name`` under torch.profiler, once with no
    host consumer and once on the pipeline with the exporter and a
    checkpoint a year (so the first year's writes run beside the traced
    step), the card synchronized before and after the traced step. Logs,
    for each, the step's wall, device busy time (union of intervals), the
    device's idle share, the side stream's copies, and where the run loop
    thread's host time goes (its ten largest operations by self time);
    returns the walls and idle shares."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dgen_tpu_torch.io import export

    out = {}
    for tag, exp in (("no consumer", False), ("pipeline, export + checkpoint", True)):
        if device == "cuda":
            torch.cuda.empty_cache()
        sim, pop, meta = presets.build(name, n_agents=n_agents, end_year=end_year,
                                       device=device,
                                       run_config=RunConfig(async_host_io=True, **knobs))
        step = sim.step
        rec = {}

        def traced(carry, yi, first_year):
            if yi != 1:
                return step(carry, yi, first_year)
            sim._sync()
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device == "cuda" else [])
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                got = step(carry, yi, first_year)
                sim._sync()
                rec["wall_us"] = (time.perf_counter() - t0) * 1e6
            rec["prof"] = prof
            return got

        sim.step = traced
        kw = {}
        if exp:
            kw = dict(callback=export.RunExporter(
                os.path.join(work, "run"), sim.host_agent_id, sim.host_mask,
                device=sim.device), checkpoint_dir=os.path.join(work, "ckpt"))
        sim.run(collect=False, **kw)
        events = rec["prof"].events()
        wall_us = rec["wall_us"]
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        busy = busy_us(dev)
        d2h = sum(e.time_range.elapsed_us() for e in dev if "DtoH" in e.name)
        # the main thread: the one that recorded the most operations (the
        # profiler numbers threads itself)
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        counts: dict = {}
        for e in cpu:
            counts[e.thread] = counts.get(e.thread, 0) + 1
        main_tid = max(counts, key=counts.get)
        host: dict = {}
        for e in cpu:
            if e.thread == main_tid:
                host[e.name] = host.get(e.name, 0.0) + e.self_cpu_time_total
        idle = 1.0 - busy / wall_us
        log(f"    [3f] traced year 2 ({tag}): wall {wall_us / 1e3:.3f} ms, device busy "
            f"{busy / 1e3:.3f} ms, idle share {idle:.4f}, device-to-host copies "
            f"{d2h / 1e3:.3f} ms; main thread's largest host operations (self ms): "
            + ", ".join(f"{n[:48]} {us / 1e3:.1f}" for n, us in
                        sorted(host.items(), key=lambda kv: -kv[1])[:10]))
        out[tag] = dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3, idle=idle,
                        d2h_ms=d2h / 1e3)
        del sim, rec, events
    return out


#: [3f]: the pipeline against the serialized path below national scale,
#: collect=True (what ``sim.run()`` does by default): (agents, end year)
#: of the ercot-all-sector world, a golden-sized run and the main path's
SMALL_AB = ((96, 2050), (MAIN_AGENTS, MAIN_END_YEAR))
SMALL_AB_PAIRS = 4


def pipeline_ab(presets, RunConfig, sizes=SMALL_AB, pairs=SMALL_AB_PAIRS,
                device="cuda") -> dict:
    """[3f]: ``sim.run()`` (collect=True) on the host-I/O pipeline against
    the serialized path, each on its own freshly built Simulation after a
    warm-up run, in ``pairs`` alternated pairs at each of ``sizes``; logs
    each side's walls, the medians and the pairs each side won; returns
    the medians by size."""
    import statistics

    import torch

    out = {}
    for n, end in sizes:
        walls = {True: [], False: []}
        for i in range(pairs):
            for async_io in ((True, False) if i % 2 == 0 else (False, True)):
                sim = presets.build("ercot-all-sector", n_agents=n, end_year=end,
                                    device=device,
                                    run_config=RunConfig(async_host_io=async_io))[0]
                sim.run()
                sim._sync()
                t0 = time.perf_counter()
                sim.run()
                sim._sync()
                walls[async_io].append(time.perf_counter() - t0)
                del sim
                if device == "cuda":
                    torch.cuda.empty_cache()
        med = {k: statistics.median(v) for k, v in walls.items()}
        won = sum(a < s for a, s in zip(walls[True], walls[False]))
        log(f"    [3f] sim.run() (collect=True) at {n} agents x "
            f"{len(range(2014, end + 1, 2))} years, pipeline vs serialized, {pairs} "
            f"alternated pairs: walls s {walls[True]} vs {walls[False]}; medians "
            f"{med[True]:.4f} vs {med[False]:.4f} (pipeline / serialized "
            f"{med[True] / med[False]:.4f}); the pipeline won {won} of {pairs}")
        out[n] = dict(pipeline=med[True], serialized=med[False], won=won)
    return out


def run_outputs(presets, RunConfig, whole_per_year, *, name=NATIONAL, n_agents=None,
                end_year=NATIONAL_END_YEAR, device="cuda", knobs=None,
                workdir=None) -> dict:
    """[3f]: the run outputs at ``name``'s full width (NATIONAL_END_YEAR's
    model years, in a temporary directory the phase removes), in four
    runs: (a) no host consumer, the floor; (b) the host-I/O pipeline with
    the preset runner's exporter, a checkpoint a year and collect=True;
    (c) the serialized path (``async_host_io=False``) with the exporter
    and the checkpoints; (d) a fresh Simulation resumed from (b)'s
    RESUME_YEAR checkpoint, collecting. Raises unless (b)'s and (c)'s
    agent_outputs, finance_series and agents.npz files are byte for byte
    equal and their state-hourly within [3c]'s tolerance; (d)'s later
    years equal (b)'s per agent bit for bit (and its checkpoints (b)'s),
    state-hourly within [3c]'s tolerance; every compact-quantized value of
    (b)'s files lies within max|x| / 65532 of (b)'s collected float32, its
    codes are the CPU's quantization of those values, the card's codes on
    them equal the CPU's, and the exact fields are the collected values;
    and, where ``whole_per_year`` is given (the main path's month and
    signed-month launches a year), every run launched the month and
    dispatch kernels as [3d] counts them. Logs the four walls and their
    ratios to (a), the pipeline's stats, the bytes fetched
    and written a year, the checkpoint's save and restore seconds and the
    fetch stage alone (:func:`fetch_seconds`), then traces the second year
    with and without the exporter (:func:`trace_outputs_year`); returns
    the figures."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from dgen_tpu_torch.io import checkpoint, export

    knobs = dict(knobs or {})
    work = tempfile.mkdtemp(prefix="dgen-3f-", dir=workdir)
    try:
        kw = dict(name=name, n_agents=n_agents, end_year=end_year, device=device,
                  knobs=knobs)
        run = {}
        run["a"] = outputs_run(presets, RunConfig, **kw)
        run["b"] = outputs_run(presets, RunConfig, async_io=True,
                               export_dir=os.path.join(work, "b"),
                               checkpoint_dir=os.path.join(work, "b-ckpt"),
                               collect=True, **kw)
        run["c"] = outputs_run(presets, RunConfig, async_io=False,
                               export_dir=os.path.join(work, "c"),
                               checkpoint_dir=os.path.join(work, "c-ckpt"), **kw)
        shutil.copytree(os.path.join(work, "b-ckpt"), os.path.join(work, "d-ckpt"))
        run["d"] = outputs_run(presets, RunConfig, collect=True,
                               checkpoint_dir=os.path.join(work, "d-ckpt"),
                               resume_year=RESUME_YEAR, **kw)
        sim_b, res_b = run["b"]["sim"], run["b"]["res"]
        years = list(sim_b.years)
        n_real = int(sim_b.host_mask.sum())
        if run["b"]["stats"] is None or run["c"]["stats"] is not None:
            raise AssertionError("[3f] (b) did not run on the pipeline, or (c) did")
        if res_b.years != years or run["d"]["res"].years != years[1:]:
            raise AssertionError(f"[3f] years: (b) {res_b.years}, (d) "
                                 f"{run['d']['res'].years}, grid {years}")

        # (b) against (c): the files, byte for byte
        same = {}
        for sub in ("agent_outputs", "finance_series", "state_hourly"):
            for y in years:
                f = os.path.join(sub, f"year={y}.npz")
                with open(os.path.join(work, "b", f), "rb") as fb, \
                        open(os.path.join(work, "c", f), "rb") as fc:
                    same[f] = fb.read() == fc.read()
        with open(os.path.join(work, "b", "agents.npz"), "rb") as fb, \
                open(os.path.join(work, "c", "agents.npz"), "rb") as fc:
            same["agents.npz"] = fb.read() == fc.read()
        gaps = {}
        for sub in ("agent_outputs", "finance_series", "state_hourly"):
            sb = export.load_surface(os.path.join(work, "b"), sub)
            sc = export.load_surface(os.path.join(work, "c"), sub)
            for k in sb:
                if sb[k].dtype.kind == "f":
                    gaps[f"{sub}.{k}"] = float(np.max(np.abs(sb[k] - sc[k])))
            if sub == "state_hourly":
                np.testing.assert_allclose(
                    sb["net_load_mw"], sc["net_load_mw"], rtol=CHUNK_HOURLY_RTOL,
                    atol=CHUNK_HOURLY_ATOL, err_msg="[3f] (b) vs (c) state-hourly")
        differ = sorted(f for f, ok in same.items()
                        if not ok and not f.startswith("state_hourly"))
        log(f"[3f] {name} at {n_real} agents ({sim_b.table.n_agents} rows, chunk "
            f"{sim_b._agent_chunk}), {len(years)} model years {years}: (b) pipeline "
            f"vs (c) serialized files byte for byte: "
            f"{ {f: ok for f, ok in same.items()} }; largest absolute gaps "
            f"{ {k: v for k, v in gaps.items() if v} or 'none'}")
        if differ:
            raise AssertionError(f"[3f] (b) and (c) differ in {differ}: gaps {gaps}")

        # (d), resumed after RESUME_YEAR, against (b)
        res_d = run["d"]["res"]
        off = [k for k in res_b.agent
               if not np.array_equal(res_d.agent[k], res_b.agent[k][1:])]
        if off:
            raise AssertionError(f"[3f] (d) resumed differs from (b) in {off}")
        np.testing.assert_allclose(res_d.state_hourly_net_mw, res_b.state_hourly_net_mw[1:],
                                   rtol=CHUNK_HOURLY_RTOL, atol=CHUNK_HOURLY_ATOL,
                                   err_msg="[3f] (d) vs (b) state-hourly")
        ck_same = {}
        for y in years[1:]:
            with open(os.path.join(work, "b-ckpt", str(y), checkpoint.CARRY_FILE),
                      "rb") as fb, open(os.path.join(work, "d-ckpt", str(y),
                                                     checkpoint.CARRY_FILE), "rb") as fd:
                ck_same[y] = fb.read() == fd.read()
        if not all(ck_same.values()):
            raise AssertionError(f"[3f] (d)'s checkpoints differ from (b)'s: {ck_same}")
        hourly_gap = float(np.max(np.abs(res_d.state_hourly_net_mw
                                         - res_b.state_hourly_net_mw[1:])))
        log(f"    (d) resumed after {RESUME_YEAR}: {res_d.years} per agent bit for bit "
            f"with (b) ({len(res_b.agent)} fields), checkpoints {ck_same}, "
            f"state-hourly largest gap {hourly_gap} MW")

        # (b)'s compact quantization against its collected float32
        keep = sim_b.host_mask > 0
        ao = export.load_surface(os.path.join(work, "b"), "agent_outputs")
        fin = export.load_surface(os.path.join(work, "b"), "finance_series")
        dev = torch.device(device)
        worst = {}
        codes_equal = True
        for yi, y in enumerate(years):
            rows = ao["year"] == y
            q_names = [f for f, q in zip(export.AGENT_OUTPUT_FIELDS,
                                         export._AGENT_OUTPUT_QUANT) if q]
            fields = [res_b.agent[f][yi] for f in q_names] + [res_b.agent["cash_flow"][yi]]
            got = [ao[f][rows] for f in q_names] + [fin["cash_flow"][rows]]
            cq, cs, _ = export._quantize_i16([torch.from_numpy(x) for x in fields])
            gq, gs, _ = export._quantize_i16([torch.from_numpy(x).to(dev) for x in fields])
            for f, x, g, q, s, q2, s2 in zip(q_names + ["cash_flow"], fields, got, cq, cs,
                                             gq, gs):
                codes_equal &= bool(torch.equal(q, q2.cpu()) and torch.equal(s, s2.cpu()))
                want = (q.numpy().astype(np.float32) * s.numpy())[keep]
                if not np.array_equal(g, want):
                    raise AssertionError(f"[3f] (b) {f} {y}: the file is not the CPU's "
                                         "quantization of the collected values")
                m = np.abs(x).max(axis=0) if x.ndim > 1 else np.abs(x).max()
                err = np.abs(g - x[keep])
                if not np.all(err <= m * QUANT_BOUND):
                    raise AssertionError(f"[3f] (b) {f} {y}: quantization error "
                                         f"{err.max()} over max|x|/65532")
                worst[f] = max(worst.get(f, 0.0), float(np.max(err / np.maximum(m, 1e-30))))
            for f in export._EXACT_FIELDS:
                if not np.array_equal(ao[f][rows], res_b.agent[f][yi][keep]):
                    raise AssertionError(f"[3f] (b) exact field {f} {y} differs from "
                                         "the collected float32")
        if not codes_equal:
            raise AssertionError("[3f] the card's int16 codes differ from the CPU's")
        log(f"    (b) compact quantization: every value within max|x|/65532 of the "
            f"collected float32 (largest error / max|x|, bound {1 / 65532:.3e}: "
            f"{ {f: float(f'{v:.3e}') for f, v in worst.items()} }); the files are the "
            f"CPU's int16 codes of the collected values, and the {device} codes on them "
            f"equal the CPU's; the {len(export._EXACT_FIELDS)} exact fields equal "
            "the collected float32")

        # launches, walls, bytes, seconds
        if whole_per_year is not None:
            k = sim_b.table.n_agents // sim_b._agent_chunk if sim_b._agent_chunk else 1
            per = 2 if sim_b._agent_chunk and sim_b.with_hourly else 1
            for tag, r in run.items():
                ny = len(r["res"].years)
                want = {"dispatch": per * k * ny,
                        **{key: k * whole_per_year[key] * ny
                           for key in ("month", "month_signed")}}
                got = {key: r["launches"][key] for key in want}
                if got != want:
                    raise AssertionError(f"[3f] ({tag}) launches {got}, {want} expected")
        walls = {tag: r["wall"] for tag, r in run.items()}
        ratios = {tag: w / walls["a"] for tag, w in walls.items()}
        stats = run["b"]["stats"]
        ex_b = run["b"]["exporter"]
        fetched = list(ex_b.payload_bytes)
        written = {y: _year_bytes(os.path.join(work, "b"), y) for y in years}
        ckpt_bytes = _dir_bytes(os.path.join(work, "b-ckpt", str(years[-1])))
        save = run["b"]["timings"].get("ckpt_save", {})
        save_c = run["c"]["timings"]
        t0 = time.perf_counter()
        checkpoint.restore_year(os.path.join(work, "b-ckpt"), sim_b.table.n_agents,
                                RESUME_YEAR, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        log(f"    walls s: (a) no consumer {walls['a']:.4f}, (b) pipeline + export + "
            f"checkpoint + collect {walls['b']:.4f}, (c) serialized + export + "
            f"checkpoint {walls['c']:.4f}, (d) resumed ({len(res_d.years)} year) "
            f"{walls['d']:.4f}; ratios to (a) {ratios}")
        log("    year_step timer (main thread; the serialized path's ends in a "
            "synchronize) s: " + "; ".join(
                f"({t}) {r['timings'].get('year_step', {}).get('total', 0.0):.4f} over "
                f"{len(r['res'].years)}" for t, r in run.items()))
        log(f"    (b) hostio_stats {stats}")
        log(f"    bytes a year: the export's device payload (fetched) {fetched}, all "
            f"of (b)'s fetches {stats['d2h_bytes'] / len(years):.0f} (collect, export, "
            f"checkpoint, health); surfaces written {written}; a checkpoint "
            f"{ckpt_bytes}")
        log(f"    checkpoint save s: (b) {save}, (c) {save_c.get('ckpt_save')}; "
            f"restore of {RESUME_YEAR} onto {device} {restore_s:.4f} s; exporter host s "
            f"(b) {ex_b.seconds:.4f}, (c) {run['c']['exporter'].seconds:.4f}; "
            f"(c)'s timers {save_c}")
        fetch = fetch_seconds(fetched[0], device)
        log(f"    the fetch stage alone on an idle {device}: {fetched[0]} bytes (the "
            f"export's payload) to new pinned buffers {fetch['cold']:.4f} s, to cached "
            f"ones {fetch['warm']:.4f} s ({fetched[0] / fetch['warm'] / 1e9:.2f} GB/s)")
        del run, sim_b
        trace = trace_outputs_year(presets, RunConfig, os.path.join(work, "t"), **kw)
        return dict(walls=walls, ratios=ratios, stats=stats, fetched=fetched,
                    written=written, ckpt_bytes=ckpt_bytes, restore_s=restore_s,
                    same=same, fetch=fetch, trace=trace)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# [3g]: resilience on the card
# ---------------------------------------------------------------------------

#: [3g] (a) and (c): one model year of national-all-sector; (b): three
#: model years of [3c]'s world in [3c]'s chunk
RESIL_END_YEAR = 2014
DRILL_WORLD = "ercot-all-sector"
DRILL_END_YEAR = 2018
#: (c): an explicit chunk past the card's memory (~475 KB a chunk row
#: measured at national width, PERF.md section 7: ~124 GB)
OOM_CHUNK = 262144
#: (c): the OOM halving's floor (the supervisor's default)
OOM_MIN_CHUNK = 128
#: on a card the state-hourly aggregate sums with atomics (index_add_),
#: so two runs of a year match there at [3c]'s tolerance (the drills'
#: APPROX_RTOL / APPROX_ATOL), and byte for byte in every other surface
DRILL_APPROX = ("state_hourly",)
#: (d): the captured operands' first agent rows each kernel runs on, the
#: row whose load turns NaN on NAN_HOURS of its lanes and the row whose
#: load turns +Inf on one
NAN_AGENTS = 64
NAN_ROW, NAN_HOURS, INF_ROW = 1, 3, 4
#: (d): the first launches held, (label, capture path, capture key, kind)
NAN_KERNELS = (("month imports", "main", "month", "month"),
               ("month signed", "main", "month_signed", "month"),
               ("stream imports", "gated", "stream", "stream"),
               ("pair", "switch", "month_pair", "pair"))


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _column_gaps(dir_a: str, dir_b: str, rels) -> dict:
    """Per partition in ``rels``, the columns of two run directories that
    differ: {column: (elements that differ, max |a - b|)}."""
    import os

    import numpy as np

    out = {}
    for rel in rels:
        with np.load(os.path.join(dir_a, rel)) as za, np.load(os.path.join(dir_b, rel)) as zb:
            gaps = {}
            for k in za.files:
                a, b = za[k], zb[k]
                if a.dtype.kind in "fc":
                    diff = a != b
                    if diff.any():
                        gaps[k] = (int(diff.sum()), float(np.max(np.abs(a - b))))
                elif not np.array_equal(a, b):
                    gaps[k] = (int((a != b).sum()), None)
        out[rel] = gaps
    return out


def _world(world, econ_years=None):
    """A drill world, with its cash-flow horizon cut to ``econ_years``
    where given."""
    import dataclasses

    return world if econ_years is None else dataclasses.replace(world,
                                                               econ_years=econ_years)


def _exported_run(world, pop, cfg, rc, run_dir: str, report=None):
    """One model run of ``pop`` under ``rc`` with the exporter writing
    ``run_dir``; the Simulation (built under ``report`` when given) and its
    build seconds."""
    from dgen_tpu_torch.io import export

    t0 = time.perf_counter()
    sim = world.runner(pop, cfg, prequarantine=report)(rc)
    _sync(world.device)
    build_s = time.perf_counter() - t0
    ex = export.RunExporter(run_dir, sim.host_agent_id, sim.host_mask, device=sim.device)
    sim.run(callback=ex, collect=False)
    return sim, build_s


def containment(presets, RunConfig, *, name=NATIONAL, n_agents=None, device="cuda",
                workdir: str, knobs=None, econ_years=None) -> dict:
    """[3g] (a): load-time containment at ``name``'s full width for
    RESIL_END_YEAR's model year. The clean population validates clean and
    comes back as the same objects; the population built with
    ``ingest_corrupt_row`` injected quarantines exactly the corrupt rows
    with the JAX package's reasons, and its exported files equal, byte for
    byte (the state-hourly aggregate at [3c]'s tolerance), a
    clean-population run under the same report (the JAX drill's ingest
    contract); with ``bank_corrupt_row@1`` injected the inputs are refused
    with the JAX package's error, more agents referencing the row than
    ``MAX_QUARANTINE``. ``knobs``: RunConfig fields of every run;
    ``econ_years`` cuts the cash-flow horizon (the CPU tests'). Raises on
    any miss; returns the figures."""
    import os

    import torch

    from dgen_tpu_torch.resilience import faults, quarantine
    from dgen_tpu_torch.resilience.drill import compare_run_dirs, preset_world

    rc = RunConfig(**(knobs or {}))
    world = _world(preset_world(name, device=device), econ_years)
    cfg = world.scenario(RESIL_END_YEAR, name=name)
    n = int(n_agents or presets.PRESETS[name].default_agents)
    pop = world.make_population(n)
    n_real = int((pop.table.mask > 0).sum())
    _sync(device)
    t0 = time.perf_counter()
    rep = quarantine.validate_population(pop.table, pop.profiles, pop.tariffs)
    validate_s = time.perf_counter() - t0
    back = quarantine.apply_quarantine(pop.table, pop.profiles, rep)
    if not rep.is_clean or back[0] is not pop.table or back[1] is not pop.profiles:
        raise AssertionError(f"[3g] (a) the clean population did not validate clean "
                             f"or came back as other objects: {rep.summary()}")
    with faults.injected("ingest_corrupt_row@1:corrupt") as reg:
        pop_c = world.make_population(n)
    rows = [int(r) % n_real for r in faults.corrupt_rows()]
    want = {rows[0]: ["nonfinite:customers_in_bin"], rows[1]: ["index:tariff_idx"]}
    d_c, d_b = os.path.join(workdir, "ingest"), os.path.join(workdir, "ingest_baseline")
    sim_c, build_c = _exported_run(world, pop_c, cfg, rc, d_c)
    q = sim_c.quarantine_report
    got = {a: q.reasons_for(a) for a in q.ids}
    validation_c = sim_c.validation_s
    del sim_c, pop_c
    if reg.fired("ingest_corrupt_row") != 1 or got != want:
        raise AssertionError(f"[3g] (a) the corrupt build quarantined {got}, {want} "
                             "expected")
    sim_b, build_b = _exported_run(world, pop, cfg, rc, d_b, report=q)
    validation_b = sim_b.validation_s
    del sim_b
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    cmp = compare_run_dirs(d_b, d_c, approx=DRILL_APPROX)
    if not cmp["ok"]:
        raise AssertionError(f"[3g] (a) the contained run's files differ from the "
                             f"clean run's under the same report: {cmp}")
    # a bank row that more agents reference than the cap: refused
    row = int(faults.corrupt_rows()[0]) % int(pop.profiles.load.shape[0])
    refs = int(((pop.table.load_idx == row) & (pop.table.mask > 0)).sum())
    cap = quarantine.MAX_QUARANTINE
    with faults.injected("bank_corrupt_row@1:corrupt"):
        try:
            world.runner(pop, cfg)(rc)
        except ValueError as e:
            refusal = str(e)
        else:
            refusal = None
    if refusal is None or refs <= cap or "refusing" not in refusal or \
            f"more than {cap} of {n_real} agents (first overflow at " \
            f"'bank:load[{row}]')" not in refusal:
        raise AssertionError(f"[3g] (a) bank row {row} ({refs} referencing agents, "
                             f"cap {cap}) was not refused with the JAX package's error: "
                             f"{refusal}")
    log(f"[3g] (a) {name} at {n_real} agents, {RESIL_END_YEAR}: validation of the clean "
        f"population {validate_s:.4f} s alone (the same objects back); in the builds "
        f"{validation_c:.4f} s (ingest-corrupt, build {build_c:.3f} s) and "
        f"{validation_b:.4f} s (clean under the report, build {build_b:.3f} s); "
        f"quarantined {got}; {cmp['compared']} files equal the clean run's under the "
        f"same report ({len(cmp['approx_equal'])} state-hourly at [3c]'s tolerance, "
        f"the rest byte for byte); bank row {row} ({refs} agents, cap {cap}) refused: "
        f"{refusal[:96]}...")
    return dict(validate_s=validate_s, validation_s=[validation_c, validation_b],
                build_s=[build_c, build_b], quarantined=got, compare=cmp,
                bank_refs=refs)


def drills(RunConfig, *, name=DRILL_WORLD, n_agents=CHUNK_AGENTS, chunk=CHUNK_ROWS,
           end_year=DRILL_END_YEAR, device="cuda", workdir: str, sites=None,
           fast=False, knobs=None, econ_years=None) -> dict:
    """[3g] (b): the fault drill and the quarantine drill on ``name``'s
    world, ``n_agents`` in chunks of ``chunk``, to ``end_year``. Every
    fault site fires, the supervisor recovers it and the files equal the
    clean run's (byte for byte; state-hourly at [3c]'s tolerance; within
    the OOM tolerance under ``year_step_oom``, whose chunk halves) with
    the manifest verifying; the quarantine drill's rounds hold (ingest,
    bank, and unless ``fast`` the sentinel's). ``sites`` limits the fault
    sites; ``knobs``: further RunConfig fields; ``econ_years`` cuts the
    cash-flow horizon (the CPU tests'). Raises on any miss; returns both
    records."""
    import os

    from dgen_tpu_torch.resilience import quarantine
    from dgen_tpu_torch.resilience.drill import DRILL_SPECS, preset_world, run_drill
    from dgen_tpu_torch.resilience.quarantinedrill import run_quarantine_drill

    world = _world(preset_world(name, device=device), econ_years)
    rc = RunConfig(agent_chunk=chunk, **(knobs or {}))
    specs = tuple(s for s in DRILL_SPECS if sites is None or s[0] in sites)
    t0 = time.perf_counter()
    rec = run_drill(os.path.join(workdir, "faults"), n_agents=n_agents,
                    end_year=end_year, specs=specs, world=world, run_config=rc,
                    approx=DRILL_APPROX)
    fault_wall = time.perf_counter() - t0
    log(f"[3g] (b) fault drill, {name} at {n_agents} agents in chunks of {chunk}, "
        f"{len(world.scenario(end_year).model_years)} model years: clean run "
        f"{rec['clean_wall_s']} s; {fault_wall:.3f} s in all")
    for site, r in rec["sites"].items():
        log(f"    {site} ({r['spec']}): fired {r['fired']}, retries {r['retries']}, "
            f"recovery {r['recovery_wall_s']} s, site wall {r['drill_wall_s']} s, "
            f"degradations {r['degradations']}, {r['npz']['compared']} files "
            f"compared ({len(r['npz']['approx_equal'])} at [3c]'s tolerance), "
            f"verify {r['verify_ok']}: {'ok' if r['ok'] else 'FAILED'}")
    oom = rec["sites"].get("year_step_oom")
    if not rec["ok"] or (oom is not None and oom["final_agent_chunk"] != chunk // 2):
        raise AssertionError(f"[3g] (b) the fault drill failed: {json.dumps(rec)}")
    t0 = time.perf_counter()
    qrec = run_quarantine_drill(os.path.join(workdir, "quarantine"), n_agents=n_agents,
                                end_year=end_year, fast=fast, world=world,
                                run_config=rc, approx=DRILL_APPROX)
    for rnd, r in qrec["rounds"].items():
        log(f"    quarantine drill {rnd}: {json.dumps(r)}")
    bank = qrec["rounds"].get("bank", {})
    if not qrec["ok"] or not 0 < bank.get("n_quarantined", 0) <= quarantine.MAX_QUARANTINE:
        raise AssertionError(f"[3g] (b) the quarantine drill failed: {json.dumps(qrec)}")
    log(f"    quarantine drill: {time.perf_counter() - t0:.3f} s, rounds "
        f"{sorted(qrec['rounds'])} ok")
    return dict(faults=rec, quarantine=qrec, fault_wall_s=fault_wall)


def real_oom(presets, RunConfig, *, name=NATIONAL, n_agents=None, chunk=OOM_CHUNK,
             min_chunk=OOM_MIN_CHUNK, device="cuda", workdir: str, inject=None,
             knobs=None, econ_years=None) -> dict:
    """[3g] (c): ``run_supervised`` on ``name``'s full width for
    RESIL_END_YEAR's model year with an explicit ``agent_chunk=chunk``
    the card cannot hold. The run must succeed after one or more ``oom``
    degradations (on the card real ``torch.OutOfMemoryError``s; ``inject``
    names a fault spec where there is none to be had, as on the CPU),
    with the card's allocated bytes after each failed attempt back at
    their level before it, and its per-agent outputs within the OOM
    tolerance of a run at the automatic chunk (whether they are bit for
    bit is logged). Both runs are collected and compared per agent
    (:func:`stage_gaps`): an agent whose sizing or market results differ
    fails the phase, whatever the export codes show. ``knobs``: further
    RunConfig fields; ``econ_years`` cuts the cash-flow horizon (the CPU
    tests'). Raises on any miss; returns the figures."""
    import contextlib
    import os
    import types

    import torch

    from dgen_tpu_torch.resilience import faults
    from dgen_tpu_torch.resilience.drill import compare_run_dirs, preset_world
    from dgen_tpu_torch.resilience.supervisor import OOM, RetryPolicy, run_supervised

    world = _world(preset_world(name, device=device), econ_years)
    cfg = world.scenario(RESIL_END_YEAR, name=name)
    pop = world.make_population(int(n_agents or presets.PRESETS[name].default_agents))
    runner = world.runner(pop, cfg)
    rows = []       # the latest attempt's row keys (a held sim would hold its tensors)

    def make_sim(rc):
        sim = runner(rc)
        rows[:] = [types.SimpleNamespace(host_agent_id=sim.host_agent_id.copy(),
                                         host_mask=sim.host_mask.copy())]
        return sim

    policy = RetryPolicy(max_retries=4, backoff_base_s=0.01, min_agent_chunk=min_chunk)
    d_oom, d_auto = os.path.join(workdir, "oom"), os.path.join(workdir, "auto")
    ctx = faults.injected(inject) if inject else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        res_oom, rep = run_supervised(
            make_sim, RunConfig(agent_chunk=chunk, **(knobs or {})), run_dir=d_oom,
            collect=True, policy=policy)
    rows_oom = rows[0]
    oom_wall = time.perf_counter() - t0
    chunks = [chunk] + [int(d.rsplit(" ", 1)[1]) for d in rep.degradations]
    fails = rep.attempts
    real = device != "cpu" and inject is None
    if not rep.succeeded or not fails or any(a.error_class != OOM for a in fails):
        raise AssertionError(f"[3g] (c) no recovery by chunk halving: {rep.to_json()}")
    if real and not all(a.error.startswith("OutOfMemoryError") for a in fails):
        raise AssertionError(f"[3g] (c) an attempt failed on something other than a "
                             f"torch.OutOfMemoryError: {[a.error for a in fails]}")
    leaked = [(a.device_bytes_before, a.device_bytes_after) for a in fails
              if a.device_bytes_after != a.device_bytes_before]
    if leaked:
        raise AssertionError(f"[3g] (c) allocated bytes after a failed attempt differ "
                             f"from before it (before, after): {leaked}")
    t0 = time.perf_counter()
    res_auto, rep_auto = run_supervised(make_sim, RunConfig(**(knobs or {})),
                                        run_dir=d_auto, collect=True, policy=policy)
    auto_wall = time.perf_counter() - t0
    rows_auto = rows[0]
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    close = compare_run_dirs(d_auto, d_oom, numeric=True, approx=DRILL_APPROX)
    bits = compare_run_dirs(d_auto, d_oom)
    if rep_auto.retries or not close["ok"]:
        raise AssertionError(f"[3g] (c) the recovered outputs are not within the OOM "
                             f"tolerance of the automatic chunk's: {close}")
    log(f"[3g] (c) {name}, {RESIL_END_YEAR}, agent_chunk {chunk}: chunks tried {chunks}; "
        f"failed attempts' walls s {[round(a.wall_s, 4) for a in fails]} "
        f"({[a.error[:60] for a in fails]}); allocated bytes before / after each "
        f"failed attempt {[(a.device_bytes_before, a.device_bytes_after) for a in fails]}; "
        f"supervised run {oom_wall:.3f} s (recovery {rep.recovery_wall_s:.3f} s); the "
        f"automatic chunk's run {auto_wall:.3f} s; per-agent outputs within the OOM "
        f"tolerance ({close['compared']} files); bit for bit: "
        f"{'all' if bits['ok'] else 'all but ' + str(bits['mismatched'])}")
    gaps = _column_gaps(d_auto, d_oom, bits["mismatched"])
    if gaps:
        log(f"    [3g] (c) columns that differ (elements, max |difference|): {gaps}")
    per_agent = chunk_gaps_checked((rows_oom, res_oom), (rows_auto, res_auto),
                                   chunks[-1])
    return dict(chunks=chunks, fail_walls=[a.wall_s for a in fails],
                bytes=[(a.device_bytes_before, a.device_bytes_after) for a in fails],
                oom_wall_s=oom_wall, auto_wall_s=auto_wall, bit_for_bit=bits["ok"],
                mismatched=bits["mismatched"], gaps=gaps, per_agent=per_agent)


def chunk_gaps_checked(run_chunk: tuple, run_auto: tuple, chunk: int) -> dict:
    """[3g] (c)'s per-agent check of a run at ``chunk`` rows a chunk
    against one at the automatic chunk, each ``(sim, res)`` collected:
    :func:`stage_gaps` of the two, logged. Raises when an agent's sizing
    or market result differs (the section 2 contract: a row's result does
    not depend on the rows that share its launch); the export's int16
    codes may differ through the column's scale. Returns the record."""
    rec = stage_gaps(run_chunk, run_auto)
    log(f"    [3g] (c) per agent, float32 by agent_id ({rec['agents']} agents), "
        f"agent_chunk {chunk} against the automatic: first stage that differs "
        f"{rec['first_stage']}")
    for stage, r in rec["stages"].items():
        log(f"      {stage}: {r['agents_differ']} agents differ; per field "
            f"{json.dumps(r['fields'])}"
            + (f"; scales (chunk, automatic) {json.dumps(r['scales'])}"
               if "scales" in r else ""))
    if rec["first_stage"] in ("sizing", "market"):
        raise AssertionError(f"[3g] (c) a row's {rec['first_stage']} result depends on "
                             f"the chunk: {json.dumps(rec['stages'])}")
    return rec


def resilience(presets, RunConfig, *, device="cuda", containment_kw=None,
               drills_kw=None, oom_kw=None, workdir=None) -> dict:
    """[3g]: (a) :func:`containment`, (b) :func:`drills` and (c)
    :func:`real_oom`, in a temporary directory the phase removes; (d)
    runs in [9] on the paths' captured operands
    (:func:`nan_through_kernels`). Logs the phase's wall."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="dgen-3g-", dir=workdir)
    try:
        out = {
            "a": containment(presets, RunConfig, device=device, workdir=work,
                             **(containment_kw or {})),
            "b": drills(RunConfig, device=device, workdir=work, **(drills_kw or {})),
            "c": real_oom(presets, RunConfig, device=device, workdir=work,
                          **(oom_kw or {})),
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[3g] resilience phase (a)-(c): {out['wall_s']:.3f} s")
    return out


def nan_through_kernels(captures: dict, bk, n_agents: int = NAN_AGENTS) -> dict:
    """[3g] (d): the month imports, month signed, stream and pair kernels
    on copies of their first launches' operands (the first ``n_agents``
    rows), agent NAN_ROW's load NaN on NAN_HOURS of its real lanes and
    agent INF_ROW's +Inf on one, against the plain versions on the same
    operands: the NaN, +Inf and -Inf positions of every output must be
    equal, exactly, the kernel's import sums non-finite at all, and the
    finite values within [9]'s tolerance. Raises on any miss."""
    import torch

    fns = {"month": (bk.month_sums, bk.month_sums_plain),
           "stream": (bk.stream_sums, bk.month_sums_plain),
           "pair": (bk.month_pair_sums, bk.month_pair_sums_plain)}
    out = {}
    for label, path, key, kind in NAN_KERNELS:
        full = captures[path][key]
        rows = full[0].shape[0]
        n = min(n_agents, rows)
        args = [a[:n].contiguous() if isinstance(a, torch.Tensor) and a.ndim
                and a.shape[0] == rows else a for a in full]
        load = args[0].clone()
        real = torch.nonzero(load[NAN_ROW] != 0).flatten()
        load[NAN_ROW, real[torch.linspace(0, real.numel() - 1, NAN_HOURS).long()]] = \
            float("nan")
        load[INF_ROW, torch.nonzero(load[INF_ROW] != 0).flatten()[0]] = float("inf")
        args[0] = load
        kernel, plain = fns[kind]
        got, ref = kernel(*args), plain(*args)
        worst, n_bad = 0.0, 0
        for i, (g, r) in enumerate(zip(got, ref)):
            for what in (torch.isnan, torch.isposinf, torch.isneginf):
                if not torch.equal(what(g), what(r)):
                    raise AssertionError(
                        f"[3g] (d) {label}: output {i}'s {what.__name__} positions "
                        f"differ from the plain version's ({int(what(g).sum())} vs "
                        f"{int(what(r).sum())})")
            fin = torch.isfinite(r)
            n_bad += int((~fin).sum())
            scale = torch.where(fin, r.abs(), torch.zeros_like(r)).reshape(n, -1).amax(1)
            tol = RTOL * r.abs() + ATOL_FRAC * scale.reshape((n,) + (1,) * (r.ndim - 1))
            diff = torch.where(fin, (g - r).abs() - tol, torch.zeros_like(r))
            worst = max(worst, float(diff.max()))
        if torch.isfinite(got[0]).all() or worst > 0:
            raise AssertionError(f"[3g] (d) {label}: the NaN did not reach the import "
                                 f"sums, or finite sums differ beyond the tolerance "
                                 f"(worst excess {worst})")
        out[label] = n_bad
        log(f"    [3g] (d) {label}: {n_bad} non-finite sums over {n} agents, every NaN, "
            f"+Inf and -Inf at the plain version's positions; finite sums within rtol "
            f"{RTOL} and {ATOL_FRAC} x the agent's max|plain|")
    return out


def golden_curves(res, mask, ids) -> dict:
    """A run's metrics of the golden contract (tests/test_golden_e2e.py):
    national curves, cash-flow totals, the id-weighted adoption checksum,
    state-hourly net and absolute MWh, and the final system-size
    histogram."""
    import numpy as np

    s = res.summary(mask)
    sh = res.state_hourly_net_mw
    return {
        "years": [int(y) for y in res.years],
        "adopters": s["adopters"],
        "system_kw_cum": s["system_kw_cum"],
        "batt_kwh_cum": s["batt_kwh_cum"],
        "cash_flow_total": [float((cf * mask[:, None]).sum())
                            for cf in res.agent["cash_flow"]],
        "adoption_checksum": float((res.agent["number_of_adopters"][-1] * mask
                                    * (ids % 97 + 1)).sum()),
        "state_hourly_net_mwh": sh.sum(axis=2),
        "state_hourly_abs_mwh": np.abs(sh).sum(axis=2),
        "kw_histogram": np.histogram((res.agent["system_kw"][-1] * mask)[mask > 0],
                                     bins=KW_BINS)[0].tolist(),
    }


def check_golden(curves: dict, golden: dict, what: str) -> dict:
    """Holds ``curves`` to the pinned ``golden`` under the golden contract:
    every metric the golden file pins, GOLDEN_EXACT ones equal, curves
    within GOLDEN_RTOL and the state-hourly MWh within GOLDEN_RTOL and
    GOLDEN_HOURLY_ATOL (``np.testing.assert_allclose``'s rule). Returns
    each metric's worst relative error (|port - golden| over |golden|,
    floored at the metric's atol, or at 1e-12) and, for the exact
    metrics, the count of entries that differ; raises naming every
    metric outside its bound."""
    import numpy as np

    worst, failed = {}, []
    for key, ref in golden.items():
        if key not in curves:
            failed.append(f"{key} not computed")
            continue
        if key in GOLDEN_EXACT:
            got, ref = list(curves[key]), list(ref)
            worst[key] = sum(a != b for a, b in zip(got, ref)) + abs(len(got) - len(ref))
            if worst[key]:
                failed.append(f"{key} {got} != {ref}")
            continue
        if key not in GOLDEN_CURVES + GOLDEN_HOURLY:
            failed.append(f"{key} is outside the contract")
            continue
        got = np.asarray(curves[key], np.float64)
        ref = np.asarray(ref, np.float64)
        if got.shape != ref.shape:
            failed.append(f"{key} of shape {got.shape}, golden {ref.shape}")
            continue
        atol = GOLDEN_HOURLY_ATOL if key in GOLDEN_HOURLY else 0.0
        diff = np.abs(got - ref)
        worst[key] = float(np.max(diff / np.maximum(np.abs(ref), atol or 1e-12)))
        if np.any(diff > atol + GOLDEN_RTOL * np.abs(ref)):
            failed.append(f"{key} (worst relative error {worst[key]:.3e}, rtol "
                          f"{GOLDEN_RTOL}, atol {atol})")
    if failed:
        raise AssertionError(f"{what}: the golden contract fails: " + "; ".join(failed))
    return worst


def golden_run(sim, tag: str, n_years: int) -> dict:
    """Every model year of a golden world through :func:`run_path` (launch
    counts set to 0 before and read after), its walls logged, and one
    more first year whose first launches are held against the plain
    versions (:func:`held_year`)."""
    run = run_path(sim)
    run.pop("capture")
    ys = run["year_s"]
    if len(run["res"].years) != n_years:
        raise AssertionError(f"[3e] {tag}: {len(run['res'].years)} model years, "
                             f"{n_years} expected")
    log(f"[3e] {tag}: {run['n_real']} agents ({sim.table.n_agents} rows) x "
        f"{n_years} years, knobs {run_knobs(sim.run_config)}; run wall "
        f"{run['wall']:.3f} s, first year {ys[0]:.4f} s, the {len(ys) - 1} carry "
        f"years {sum(ys[1:]):.4f} s ({min(ys[1:]):.4f}-{max(ys[1:]):.4f} s each); "
        f"launches {run['launches']}"
        + (f"; on narrow streams {run['narrow']}" if run["narrow"] else ""))
    held_year(sim, f"3e {tag}", run["launches"])
    return run


def run_knobs(rc) -> list:
    """The gated and bank knobs a RunConfig turns on."""
    return [k for k in ("daylight_compact", "pack_once", "stream_segments",
                        "bf16_banks", "quant_banks") if getattr(rc, k)]


def golden_fixtures(RunConfig) -> None:
    """[3e]: both golden fixtures on the card with the kernels, through the
    calls a user makes: golden #1 loaded from the committed package
    (``io.package.load_population``) and run through
    ``RunConfig.from_env``, held to golden_adoption.json, its gated run to
    the default run's curves and its bf16 and int8 runs to the 2%
    envelope; golden #2, the cap flip, held to golden_capflip.json. Each
    run's launch counts are asserted and its first launches held against
    the plain versions. Every contract is checked before the phase
    raises, so one run reports both fixtures."""
    import os

    import numpy as np

    from dgen_tpu_torch.config import ScenarioConfig
    from dgen_tpu_torch.io import package
    from dgen_tpu_torch.models import scenario
    from dgen_tpu_torch.models.simulation import Simulation

    root = os.path.dirname(os.path.abspath(__file__))
    failures = []

    def hold(curves, golden_file, what):
        with open(os.path.join(root, golden_file)) as f:
            golden = json.load(f)
        try:
            worst = check_golden(curves, golden, what)
        except AssertionError as e:
            failures.append(str(e))
            log(f"    FAILED {e}")
        else:
            log(f"    {what} holds {golden_file} (rtol {GOLDEN_RTOL}, state-hourly "
                f"atol {GOLDEN_HOURLY_ATOL}); worst relative error per metric "
                f"(exact metrics: entries that differ) {worst}")

    # --- golden #1: the committed package, 19 model years ---
    t0 = time.perf_counter()
    pop = package.load_population(os.path.join(root, GOLDEN_PKG), pad_multiple=32,
                                  device="cuda")
    load_s = time.perf_counter() - t0
    table = pop.table
    cfg = ScenarioConfig(name="golden", start_year=2014, end_year=2050,
                         anchor_years=())
    inputs = scenario.uniform_inputs(
        cfg, n_groups=table.n_groups, n_regions=pop.profiles.wholesale.shape[0],
        overrides={"attachment_rate": np.full(table.n_groups, GOLDEN_ATTACHMENT,
                                              np.float32)},
        n_states=table.n_states, device="cuda")
    log(f"[3e] golden #1: {GOLDEN_PKG} loaded on the card in {load_s:.3f} s "
        f"({int(table.mask.sum())} agents, {table.n_agents} rows, "
        f"{pop.tariffs.n_tariffs} tariffs, states {pop.states})")
    n_years = len(cfg.model_years)
    # agents whose NEM limit is 0 price under net billing, so the sizing
    # rounds launch the import sums and the battery run the signed sums:
    # on the month kernel, or with stream_segments the stream kernel
    month = ("month", "month_signed")
    stream = ("stream", "stream_signed")
    for tag, knobs, (kernels, other) in (
            ("default", {}, (month, stream)), ("gated", GATED, (stream, month)),
            ("bf16", BF16, (month, stream)), ("int8", QUANT, (stream, month))):
        sim = Simulation(table, pop.profiles, pop.tariffs, inputs, cfg,
                         RunConfig.from_env(sizing_iters=8, **knobs), with_hourly=True)
        if not sim._net_billing or sim._rate_switch:
            raise AssertionError(f"[3e] golden #1: net billing {sim._net_billing}, "
                                 f"rate switch {sim._rate_switch}")
        run = golden_run(sim, f"golden #1 {tag}", n_years)
        need_launches(f"[3e] golden #1 {tag}", run["launches"], kernels + ("dispatch",),
                      zero=("month_pair", "dot", "dot_signed") + other)
        if tag == "default":
            hold(golden_curves(run["res"], sim.host_mask, sim.host_agent_id),
                 GOLDEN_JSON, "golden #1 on the card")
            default = run["res"].summary(sim.host_mask)
            continue
        gap = curves_gap(run["res"].summary(sim.host_mask), default)
        bound = GOLDEN_GATED_RTOL if tag == "gated" else BANK_CURVE_RTOL
        log(f"    national curves within {gap:.3e} (relative) of the default "
            f"run's (bound {bound})")
        if gap > bound:
            failures.append(f"golden #1 {tag}: curves {gap:.3e} from the default "
                            f"run's, bound {bound}")

    # --- golden #2: the cap flip ---
    def capflip_sim(caps=None):
        from dgen_tpu_torch.io import synth

        cfg = ScenarioConfig(name="capflip", start_year=2014, end_year=2050,
                             storage_enabled=True)
        cpop = synth.generate_population(CAPFLIP_AGENTS, states=list(CAPFLIP_STATES),
                                         seed=11, pad_multiple=32,
                                         rate_switch_frac=0.5, device="cuda")
        overrides = {"attachment_rate": np.full(cpop.table.n_groups,
                                                GOLDEN_ATTACHMENT, np.float32)}
        if caps is not None:
            overrides["nem_cap_kw"] = np.tile(caps.astype(np.float32),
                                              (len(cfg.model_years), 1))
        cin = scenario.uniform_inputs(cfg, n_groups=cpop.table.n_groups,
                                      n_regions=cpop.n_regions, overrides=overrides,
                                      device="cuda")
        return Simulation(cpop.table, cpop.profiles, cpop.tariffs, cin, cfg,
                          RunConfig.from_env(sizing_iters=8), with_hourly=True)

    sim0 = capflip_sim()
    pre = golden_run(sim0, "golden #2 uncapped pre-run", n_years)
    final_kw = state_kw_by_year(pre["res"], sim0)[-1]
    populated = np.zeros(sim0.table.n_states, bool)
    populated[np.unique(sim0.table.state_idx.cpu().numpy()[sim0.host_mask > 0])] = True
    if not (final_kw[populated] > 0).all():
        raise AssertionError(f"[3e] the uncapped pre-run did not adopt in every "
                             f"populated state: {final_kw[populated]}")
    caps = np.where(populated, final_kw * CAP_FRACTION, 1e30)
    sim = capflip_sim(caps)
    if not (sim._net_billing and sim._rate_switch):
        raise AssertionError("[3e] finite caps must open net billing in the "
                             "rate-switch capflip world")
    run = golden_run(sim, "golden #2 capped", n_years)
    need_launches("[3e] golden #2", run["launches"], ("month_pair", "dispatch"))
    log(f"    golden #2 month kernel (imports) launches: {run['launches']['month']}")
    curves = golden_curves(run["res"], sim.host_mask, sim.host_agent_id)
    curves["nem_allowed"] = counts = nem_allowed_per_year(sim, run["res"])
    log(f"    NEM-eligible agents a year {counts}; caps {caps[populated].tolist()} kW")
    adopters = curves["adopters"]
    drops = [i for i in range(1, len(counts)) if counts[i] < counts[i - 1]]
    if not (counts[0] > 0 and drops and adopters[-1] > adopters[drops[0]]):
        failures.append(f"golden #2: the caps did not bind mid-run with adoption "
                        f"going on after the flip (allowed {counts})")
    hold(curves, CAPFLIP_JSON, "golden #2 on the card")
    if failures:
        raise AssertionError("[3e] " + " | ".join(failures))


def state_kw_by_year(res, sim):
    """[n_years, n_states] cumulative installed kW of the real agents."""
    import numpy as np

    kw = res.agent["system_kw_cum"] * sim.host_mask[None, :]
    st = sim.table.state_idx.cpu().numpy()
    out = np.zeros((kw.shape[0], sim.table.n_states), np.float64)
    for yi in range(kw.shape[0]):
        np.add.at(out[yi], st, kw[yi])
    return out


def nem_allowed_per_year(sim, res) -> list:
    """Per-year count of NEM-eligible real agents through the year step's
    own predicate, its cap gate fed last year's installed capacity
    (tests/test_golden_capflip.py)."""
    import numpy as np

    from dgen_tpu_torch.models.simulation import _nem_allowed_arrays

    t = sim.table
    host = {k: getattr(t, k).cpu().numpy() for k in
            ("state_idx", "nem_first_year", "nem_sunset_year", "nem_kw_limit")}
    state_kw = state_kw_by_year(res, sim)
    years = sim.inputs.years.cpu().numpy()
    caps = sim.inputs.nem_cap_kw.cpu().numpy()
    counts = []
    for yi, yr in enumerate(years):
        last = (np.zeros(t.n_states, np.float32) if yi == 0
                else state_kw[yi - 1].astype(np.float32))
        allowed = _nem_allowed_arrays(host["state_idx"], host["nem_first_year"],
                                      host["nem_sunset_year"], host["nem_kw_limit"],
                                      caps[yi], np.float32(yr), last)
        counts.append(int((allowed & (sim.host_mask > 0)).sum()))
    return counts


def dot_path(presets) -> tuple:
    """One model year at DOT_AGENTS through year_step with the month
    engine and with sizing_impl="dot" from the same carry; returns the
    dot run's launches and first-launch operands, the largest relative
    gap of the national sums, and both runs' national sums."""
    import numpy as np

    from dgen_tpu_torch.models.simulation import year_step
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops import dispatch

    sim, _, _ = presets.build("ercot-all-sector", n_agents=DOT_AGENTS,
                              end_year=2014, device="cuda")
    mask = sim.host_mask

    def national(out) -> dict:
        return {k: np.array([float((getattr(out, f).cpu().numpy() * mask).sum())])
                for k, f in (("adopters", "number_of_adopters"),
                             ("system_kw_cum", "system_kw_cum"),
                             ("batt_kwh_cum", "batt_kwh_cum"))}

    def one_year(impl: str):
        kwargs = dict(sim.step_kwargs(True), sizing_impl=impl)
        return year_step(sim.table, sim.profiles, sim.tariffs, sim.inputs,
                         sim.init_carry(), 0, **kwargs)[1]

    ref = national(one_year("auto"))
    bk.CAPTURE = {}
    bk.reset_launches()
    dispatch.reset_launches()
    try:
        with first_dispatch(bk.CAPTURE):
            dot = national(one_year("dot"))
    finally:
        launches = {**bk.LAUNCHES, **dispatch.LAUNCHES}
        capture, bk.CAPTURE = bk.CAPTURE, None
    return launches, capture, curves_gap(dot, ref), dot, ref


# ---------------------------------------------------------------------------
# [3h]: the tariff-clustered national world
# ---------------------------------------------------------------------------

#: [3g] (c)'s per-agent comparison of two chunks: the fields compared, by
#: the stage that computes them: the sizing result, then the market step;
#: the export's int16 codes are the third stage (the quantized ones of
#: these fields)
STAGE_FIELDS = (("sizing", ("system_kw", "npv", "payback_period", "batt_kwh")),
                ("market", ("number_of_adopters",)))


def keyed_rows(sim, res, fields, year_idx: int = 0) -> dict:
    """{"ids": the real (mask 1) rows' agent ids in ascending order, field:
    those rows' values of ``year_idx``} from a collected run."""
    import numpy as np

    keep = sim.host_mask > 0
    ids = sim.host_agent_id[keep]
    order = np.argsort(ids, kind="stable")
    out = {"ids": ids[order]}
    for f in fields:
        out[f] = res.agent[f][year_idx][keep][order]
    return out


def export_codes(sim, res, fields, year_idx: int = 0) -> dict:
    """The exporter's int16 codes and scales of ``fields`` (its
    ``_quantize_i16`` over every row of the table, as the exporter takes
    them), keyed like :func:`keyed_rows`."""
    import numpy as np
    import torch

    from dgen_tpu_torch.io.export import _quantize_i16

    cols = [torch.from_numpy(np.ascontiguousarray(res.agent[f][year_idx])) for f in fields]
    qs, scales, _ = _quantize_i16(cols)
    keep = sim.host_mask > 0
    order = np.argsort(sim.host_agent_id[keep], kind="stable")
    out = {"ids": sim.host_agent_id[keep][order]}
    for f, q, s in zip(fields, qs, scales):
        out[f] = q.numpy()[keep][order]
        out[f + ".scale"] = float(s)
    return out


def agent_gaps(a: dict, b: dict, fields) -> dict:
    """Per field of two :func:`keyed_rows` records: the agents whose values
    differ (bit for bit), the largest absolute and relative differences.
    Raises when the two cover other agents."""
    import numpy as np

    if not np.array_equal(a["ids"], b["ids"]):
        raise AssertionError("the two runs cover different agents")
    out = {}
    for f in fields:
        x = np.asarray(a[f]).astype(np.float64)
        y = np.asarray(b[f]).astype(np.float64)
        diff = np.asarray(a[f]) != np.asarray(b[f])
        gap = np.abs(x - y)
        den = np.maximum(np.abs(x), np.abs(y))
        rel = np.where(den > 0, gap / np.where(den > 0, den, 1.0), 0.0)
        out[f] = {"differ": int(diff.sum()), "max_abs": float(gap.max(initial=0.0)),
                  "max_rel": float(rel.max(initial=0.0))}
    return out


def stage_gaps(run_a: tuple, run_b: tuple) -> dict:
    """[3g] (c)'s comparison of two collected runs ``(sim, res)`` of the same
    world: per stage of :data:`STAGE_FIELDS` and the export's int16 codes,
    the per-field gaps (:func:`agent_gaps`), the agents that differ in any
    field of the stage, and ``first_stage``, the first stage in that order
    where an agent differs (None where none does)."""
    import numpy as np

    fields = [f for _, fs in STAGE_FIELDS for f in fs]
    ka, kb = keyed_rows(*run_a, fields), keyed_rows(*run_b, fields)
    from dgen_tpu_torch.io.export import _EXACT_FIELDS

    quant = [f for f in fields if f not in _EXACT_FIELDS]
    ca, cb = export_codes(*run_a, quant), export_codes(*run_b, quant)
    out = {"agents": int(len(ka["ids"])), "stages": {}, "first_stage": None}
    stages = list(STAGE_FIELDS) + [("export codes", tuple(quant))]
    for stage, fs in stages:
        src_a, src_b = (ca, cb) if stage == "export codes" else (ka, kb)
        gaps = agent_gaps(src_a, src_b, fs)
        any_diff = np.zeros(len(ka["ids"]), bool)
        for f in fs:
            any_diff |= np.asarray(src_a[f]) != np.asarray(src_b[f])
        rec = {"fields": gaps, "agents_differ": int(any_diff.sum())}
        if stage == "export codes":
            rec["scales"] = {f: (ca[f + ".scale"], cb[f + ".scale"]) for f in fs}
        out["stages"][stage] = rec
        if out["first_stage"] is None and rec["agents_differ"]:
            out["first_stage"] = stage
    return out


#: (a), (b): the mixed national world (models.synth, the "mixed" corpus)
MIXED_AGENTS = 1_048_576
MIXED_SEED = 0
MIXED_END_YEAR = 2016         # 2 model years
#: (b): clustered against unclustered per agent, at the JAX package's
#: tolerance for it (tests/test_tariffcluster.py:172, :229)
CLUSTER_RTOL = CLUSTER_ATOL = 1e-5
CLUSTER_FIELDS = ("system_kw_cum", "number_of_adopters", "npv", "batt_kwh_cum")
#: (b): fields every masked row (chunk padding and cluster filler) keeps
#: at zero
MASKED_ZERO_FIELDS = ("new_adopters", "number_of_adopters", "system_kw_cum")
#: (c): a mixed world of [3c]'s size, clustered in [3c]'s chunk against
#: clustered whole, in the default world and [3c]'s gated int8 world
MIXED_CHUNK_AGENTS = CHUNK_AGENTS
CLUSTER_CHUNK_WORLDS = {"default": {}, "gated int8": CHUNK_WORLDS["gated int8"][0]}


@contextlib.contextmanager
def count_by_p(counts: dict):
    """Inside the block, each bucket-sums kernel launch (a call on card
    tensors) adds one to ``counts["<kernel>@P<p>"]`` (``_signed`` for the
    signed month and stream launches); the calls run as they would."""
    from dgen_tpu_torch.ops import billkernels as bk

    wrappers = {key: getattr(bk, fn) for key, (fn, _) in HELD_SUMS.items()}

    def counted(key):
        kernel = wrappers[key]

        def run(*args):
            pair = key == "month_pair"
            if args[0].device.type == "cuda":
                name = key + ("_signed" if not pair and args[7] else "")
                name += f"@P{args[8] if pair else args[6]}"
                counts[name] = counts.get(name, 0) + 1
            return kernel(*args)
        return run

    for key, (fn, _) in HELD_SUMS.items():
        setattr(bk, fn, counted(key))
    try:
        yield counts
    finally:
        for key, (fn, _) in HELD_SUMS.items():
            setattr(bk, fn, wrappers[key])


def mixed_sim(pop, knobs: dict, *, end_year: int, device="cuda", agent_chunk=None,
              econ_years: int = 25, attachment_rate=None):
    """A Simulation of ``pop`` (a loaded package or a generated world) as
    the national preset runs: storage and the state-hourly aggregate on,
    uniform scenario inputs (every group's battery attachment rate at
    ``attachment_rate`` where given), ``knobs`` on the RunConfig."""
    import numpy as np

    from dgen_tpu_torch.config import RunConfig, ScenarioConfig
    from dgen_tpu_torch.models.scenario import uniform_inputs
    from dgen_tpu_torch.models.simulation import Simulation

    cfg = ScenarioConfig(name="mixed-national", start_year=2014, end_year=end_year,
                         storage_enabled=True, anchor_years=())
    overrides = None if attachment_rate is None else {
        "attachment_rate": np.full(pop.table.n_groups, attachment_rate, np.float32)}
    inputs = uniform_inputs(cfg, n_groups=pop.table.n_groups,
                            n_regions=int(pop.profiles.wholesale.shape[0]),
                            overrides=overrides, device=device)
    return Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                      RunConfig(agent_chunk=agent_chunk, **knobs), with_hourly=True,
                      econ_years=econ_years, device=device)


def keyed_years(sim, res, fields) -> dict:
    """{"ids": the real rows' agent ids ascending, field: [years, agents]}."""
    import numpy as np

    keep = sim.host_mask > 0
    ids = sim.host_agent_id[keep]
    order = np.argsort(ids, kind="stable")
    out = {"ids": ids[order]}
    for f in fields:
        out[f] = res.agent[f][:, keep][:, order]
    return out


def clustered_parity(run_c: tuple, run_u: tuple, *, rtol=CLUSTER_RTOL,
                     atol=CLUSTER_ATOL, fields=CLUSTER_FIELDS) -> dict:
    """[3h] (b)'s checks of a clustered run against an unclustered one of
    the same world, each ``(sim, res)`` collected: the clustered layout
    holds every real agent of the unclustered table exactly once; every
    field of ``fields`` agrees per agent by agent id within ``rtol`` /
    ``atol``; every masked row of the clustered table (chunk padding and
    cluster filler) keeps MASKED_ZERO_FIELDS at zero. Raises
    AssertionError on a miss; returns the largest gaps."""
    import numpy as np

    (sc, rc_), (su, ru) = run_c, run_u
    ids_c = sc.host_agent_id[sc.host_mask > 0]
    ids_u = su.host_agent_id[su.host_mask > 0]
    if len(np.unique(ids_c)) != len(ids_c) or not np.array_equal(
            np.sort(ids_c), np.sort(ids_u)):
        missing = np.setdiff1d(ids_u, ids_c)
        raise AssertionError(
            f"[3h] the cluster layout does not hold every agent once: "
            f"{len(ids_c)} real rows ({len(np.unique(ids_c))} distinct) for "
            f"{len(ids_u)} agents, {len(missing)} missing (first {missing[:5].tolist()})")
    kc, ku = keyed_years(sc, rc_, fields), keyed_years(su, ru, fields)
    gaps = {}
    for f in fields:
        np.testing.assert_allclose(kc[f], ku[f], rtol=rtol, atol=atol,
                                   err_msg=f"[3h] clustered vs unclustered {f}")
        d = np.abs(kc[f].astype(np.float64) - ku[f])
        gaps[f] = {"max_abs": float(d.max(initial=0.0)),
                   "differ": int((kc[f] != ku[f]).sum())}
    masked = sc.host_mask == 0
    for f in MASKED_ZERO_FIELDS:
        bad = int(np.count_nonzero(rc_.agent[f][:, masked]))
        if bad:
            raise AssertionError(f"[3h] {bad} values of {f} on masked rows of the "
                                 "clustered table are not zero")
    return {"agents": int(len(ids_c)), "masked_rows": int(masked.sum()), "fields": gaps}


def mixed_world(n_agents: int, workdir: str, *, seed=MIXED_SEED, device="cuda") -> dict:
    """[3h] (a): the mixed world generated on ``device`` by the port's
    generator, saved with int8 banks (``save_world``), verified clean
    (``verify_world``), loaded back (``load_population``; its agent columns
    must equal the generated table's), and its cluster report; logged.
    Returns the loaded population and the record."""
    import os

    import torch

    from dgen_tpu_torch.io import package
    from dgen_tpu_torch.models import synth
    from dgen_tpu_torch.ops import tariffcluster

    spec = synth.NationalSpec(n_agents=n_agents, tariff_mix="mixed", seed=seed)
    t0 = time.perf_counter()
    world = synth.generate_world(spec, device=device)
    _sync(device)
    rec = {"generate_s": time.perf_counter() - t0}
    pkg = os.path.join(workdir, "mixed-world")
    t0 = time.perf_counter()
    manifest = synth.save_world(spec, pkg)
    rec["save_s"] = time.perf_counter() - t0
    rec["bytes"] = _dir_bytes(pkg)
    t0 = time.perf_counter()
    problems = synth.verify_world(pkg)
    rec["verify_s"] = time.perf_counter() - t0
    if problems:
        raise AssertionError(f"[3h] (a) verify_world found {problems}")
    t0 = time.perf_counter()
    pop = package.load_population(pkg, device=device)
    _sync(device)
    rec["load_s"] = time.perf_counter() - t0
    differ = [c for c in package.AGENT_COLUMNS
              if not torch.equal(getattr(pop.table, c), getattr(world.table, c))]
    if differ or pop.table.n_agents != world.table.n_agents:
        raise AssertionError(f"[3h] (a) the loaded table differs from the generated "
                             f"one in {differ}")
    del world
    report = tariffcluster.cluster_report(
        pop.tariffs, pop.table.tariff_idx.cpu().numpy(), pop.table.mask.cpu().numpy())
    rec["report"] = report
    log(f"[3h] (a) mixed world NationalSpec(n_agents={n_agents}, tariff_mix='mixed', "
        f"seed={seed}): generated on {device} in {rec['generate_s']:.3f} s; "
        f"save_world (int8 banks) {rec['save_s']:.3f} s, {rec['bytes']} bytes "
        f"written; verify_world clean in {rec['verify_s']:.3f} s; loaded on {device} "
        f"in {rec['load_s']:.3f} s, agent columns equal to the generated table's; "
        f"residential shape mix {manifest['tariff_shape_mix']['residential_histogram']}")
    log(f"    cluster report: {report['n_clusters']} signatures over "
        f"{report['n_tariffs']} tariffs (global pad {report['global_pad']}); "
        + "; ".join(f"(metering {c['metering']}, P {c['n_periods']}, T {c['n_tiers']}): "
                    f"{c['n_agents']} agents, {c['n_rates']} rates"
                    for c in report["clusters"])
        + f"; modeled lane savings {report['modeled_lane_savings']}")
    return {"pop": pop, **rec}


def layout_line(sim) -> str:
    lay = sim._cluster_layout
    return (f"{len(lay.clusters)} segments "
            + str([(c.metering, c.n_periods, c.n_tiers, c.seg_len, c.net_billing)
                   for c in lay.clusters])
            + f" (metering, P, T, seg_len, net billing), {sim.table.n_agents} rows, "
            f"{sim.cluster_filler_rows} filler rows "
            f"({sim.cluster_filler_rows / sim.table.n_agents:.4f} of the table)")


def clustered_national(pop, *, end_year=MIXED_END_YEAR, device="cuda", knobs=None,
                       econ_years: int = 25) -> dict:
    """[3h] (b): ``pop`` run clustered and unclustered under the automatic
    chunk for the model years to ``end_year``, each counted (launches, and
    on a card the bucket-sums launches by P and the dispatch launches a
    year), then held per agent by :func:`clustered_parity`. On a card,
    one more first year of each run holds its first launches against the
    plain versions, the clustered run's at each P. Logs the walls, the
    layout and the filler share; returns the record."""
    import torch

    runs = {}
    for tag, cluster in (("clustered", True), ("unclustered", False)):
        if device == "cuda":
            torch.cuda.empty_cache()
        sim = mixed_sim(pop, dict(knobs or {}, cluster_tariffs=cluster),
                        end_year=end_year, device=device, econ_years=econ_years)
        if cluster and sim._cluster_layout is None:
            raise AssertionError("[3h] (b) the clustered run built no cluster layout")
        with count_by_p({}) as by_p:
            res, launches, secs = counted_run(sim)
        check_outputs(res, sim)
        years = len(res.years)
        log(f"[3h] (b) {tag}: {int(sim.host_mask.sum())} agents, {sim.table.n_agents} "
            f"rows, chunk {sim._agent_chunk} x {years} years {res.years}; per-year s "
            f"{[round(t, 3) for t in secs]}; launches a year "
            f"{per_year(launches, years)}; by P a year {per_year(by_p, years)}")
        if cluster:
            log(f"    [3h] (b) layout: {layout_line(sim)}")
        if device == "cuda":
            if launches["dispatch"] != dispatch_per_year(sim) * years:
                raise AssertionError(f"[3h] (b) {tag}: {launches['dispatch']} dispatch "
                                     f"launches, {dispatch_per_year(sim) * years} expected")
            if cluster and not {"month@P1", "month@P2"} <= set(by_p):
                raise AssertionError(f"[3h] (b) the clustered run launched the month "
                                     f"kernel at {sorted(by_p)}, not at P = 1 and 2")
            held_year(sim, f"3h {tag}", by_p if cluster else launches, by_p=cluster)
        runs[tag] = (sim, res, secs, launches, by_p)
    rec = clustered_parity(runs["clustered"][:2], runs["unclustered"][:2])
    sim_c = runs["clustered"][0]
    rec.update(years=list(runs["clustered"][1].years),
               walls={k: v[2] for k, v in runs.items()},
               by_p={k: per_year(v[4], len(v[1].years)) for k, v in runs.items()},
               rows=sim_c.table.n_agents, filler=sim_c.cluster_filler_rows,
               segments=[c.seg_len for c in sim_c._cluster_layout.clusters])
    log(f"    [3h] (b) clustered vs unclustered per agent by agent_id within rtol "
        f"{CLUSTER_RTOL} / atol {CLUSTER_ATOL} over {rec['agents']} agents; masked rows "
        f"({rec['masked_rows']}) inert; largest gaps {json.dumps(rec['fields'])}")
    return rec


def cluster_chunk_invariance(n_agents=MIXED_CHUNK_AGENTS, chunk=CHUNK_ROWS, *,
                             end_year=CHUNK_END_YEAR, device="cuda",
                             worlds=CLUSTER_CHUNK_WORLDS, seed=MIXED_SEED,
                             knobs=None, econ_years: int = 25) -> dict:
    """[3h] (c): a mixed world of ``n_agents`` generated on ``device``, run
    clustered in chunks of ``chunk`` rows and clustered whole in each of
    ``worlds``; every CHUNK_FIELDS value equal per agent by agent id, bit
    for bit. The default world's whole run keeps its first launches
    (:func:`run_path`), for [9]'s rows at P = 1. Raises on a difference
    or a chunked run that did not stream; returns the record."""
    import numpy as np

    from dgen_tpu_torch.models import synth

    pop = synth.generate_world(synth.NationalSpec(
        n_agents=n_agents, tariff_mix="mixed", seed=seed), device=device)
    out = {}
    for world, wknobs in worlds.items():
        runs = {}
        for tag, c in (("chunked", chunk), ("whole", 0)):
            sim = mixed_sim(pop, dict(wknobs, **(knobs or {}), cluster_tariffs=True),
                            end_year=end_year, device=device, agent_chunk=c,
                            econ_years=econ_years)
            if device == "cuda":
                run = run_path(sim)
                capture = run.pop("capture")
                if world == "default" and tag == "whole":
                    out["capture"] = capture
                del capture
            else:
                res, launches, secs = counted_run(sim)
                run = dict(res=res, launches=launches, year_s=secs)
            runs[tag] = (sim, run["res"])
            log(f"[3h] (c) {world}, clustered {tag}: {int(sim.host_mask.sum())} agents, "
                f"chunk {sim._agent_chunk}, {layout_line(sim)}; per-year s "
                f"{[round(t, 3) for t in run['year_s']]}; launches "
                f"{per_year(run['launches'], len(run['res'].years))} a year")
        if runs["chunked"][0]._agent_chunk != chunk:
            raise AssertionError(f"[3h] (c) {world}: the chunked run did not stream")
        kc = keyed_years(*runs["chunked"], CHUNK_FIELDS)
        kw = keyed_years(*runs["whole"], CHUNK_FIELDS)
        if not np.array_equal(kc["ids"], kw["ids"]):
            raise AssertionError(f"[3h] (c) {world}: the two layouts hold other agents")
        differ = {f: int((kc[f] != kw[f]).sum()) for f in CHUNK_FIELDS}
        if any(differ.values()):
            raise AssertionError(f"[3h] (c) {world}: clustered chunked differs from "
                                 f"clustered whole per agent: {differ}")
        log(f"    [3h] (c) {world}: clustered in chunks of {chunk} equals clustered "
            f"whole bit for bit per agent ({len(kc['ids'])} agents, {CHUNK_FIELDS})")
        out[world] = differ
    return out


def p1_launches(b: dict) -> dict:
    """:func:`p1_rows`' launch counts: the month kernel's launches at P = 1
    over [3h] (b)'s clustered run."""
    by_p, years = b["by_p"]["clustered"], len(b["years"])
    return {"bucket_sums_month_p1": int(round(by_p.get("month@P1", 0) * years)),
            "bucket_sums_month_signed_p1": int(round(by_p.get("month_signed@P1", 0)
                                                     * years))}


def mixed_clusters(*, workdir=None) -> dict:
    """[3h]: (a) :func:`mixed_world` at MIXED_AGENTS, (b)
    :func:`clustered_national` on it and (c)
    :func:`cluster_chunk_invariance`, in a temporary directory the phase
    removes. Logs the phase's wall; returns (c)'s first launches at P = 1
    and the records."""
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="dgen-3h-", dir=workdir)
    try:
        a = mixed_world(MIXED_AGENTS, work)
        b = clustered_national(a.pop("pop"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    c = cluster_chunk_invariance()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"[3h] tariff-clustered phase (a)-(c): {wall:.3f} s")
    return {"a": a, "b": b, "c": c, "wall_s": wall}


# ---------------------------------------------------------------------------
# [3i]: sweeps and ensembles on the card
# ---------------------------------------------------------------------------

#: (a): national-all-sector's 2014, S = 2: the preset's inputs, and the
#: same with no ITC in any year (one model year since [3n] took the room
#: of the second; (b) and (c) run carry years)
SWEEP_END_YEAR = 2014
#: the per-agent fields the two modes of a sweep or an ensemble, and a
#: sweep and its single runs, must give bit for bit (by agent_id)
SWEEP_FIELDS = ("system_kw", "npv", "payback_period", "number_of_adopters", "batt_kwh")
#: (b): [3c]'s world, S = 3 ITC levels over 2 model years (3 until [3o])
SWEEP_ITCS = (0.30, 0.10, 0.0)
SWEEP_SMALL_END_YEAR = 2016
#: (c): E = 8 members under DEFAULT_DRAWS, a cohort of 2,048 rows that
#: enters in 2015 (alive from the 2016 model year), 2 model years
ENS_MEMBERS = 8
ENS_COHORT_ROWS = 2048
ENS_COHORT_YEAR = 2015.0
#: (c): the device quantiles against numpy's on the members' curves
QUANTILE_RTOL = 1e-6


def by_agent(res, host_agent_id, host_mask, fields=SWEEP_FIELDS) -> dict:
    """{field: [Y, real agents]} of one run's collected outputs, the
    columns ordered by agent_id."""
    import numpy as np

    real = np.flatnonzero(host_mask > 0)
    order = real[np.argsort(host_agent_id[real], kind="stable")]
    return {f: res.agent[f][:, order] for f in fields}


def check_same_members(a, b, tag: str, fields=SWEEP_FIELDS) -> int:
    """Raises unless every run of ``a`` equals the same run of ``b`` bit
    for bit per agent (by agent_id) in ``fields``; ``a`` and ``b`` are
    (runs, host_agent_id, host_mask). Returns the values compared."""
    import numpy as np

    runs_a, ids_a, mask_a = a
    runs_b, ids_b, mask_b = b
    if len(runs_a) != len(runs_b):
        raise AssertionError(f"[{tag}] {len(runs_a)} runs against {len(runs_b)}")
    n = 0
    for i, (ra, rb) in enumerate(zip(runs_a, runs_b)):
        if list(ra.years) != list(rb.years):
            raise AssertionError(f"[{tag}] run {i}: years {ra.years} against {rb.years}")
        xa, xb = by_agent(ra, ids_a, mask_a, fields), by_agent(rb, ids_b, mask_b, fields)
        ids = np.sort(ids_a[mask_a > 0])
        if not np.array_equal(ids, np.sort(ids_b[mask_b > 0])):
            raise AssertionError(f"[{tag}] run {i}: the two hold other agents")
        for f in fields:
            va, vb = xa[f].view(np.int32), xb[f].view(np.int32)
            bad = (va != vb).reshape(va.shape[0], va.shape[1], -1).any(axis=(0, 2))
            if bad.any():
                raise AssertionError(
                    f"[{tag}] run {i}, {f}: {int(bad.sum())} agents differ (first: agent "
                    f"{int(ids[np.flatnonzero(bad)[0]])})")
            n += va.size
    return n


def check_shared_banks(sweep, grown_bytes) -> int:
    """Raises unless every sibling of ``sweep`` (a SweepSimulation) holds
    the base's table, profile banks and tariffs themselves, and the
    siblings grew the card's allocated bytes (``grown_bytes``; None off a
    card) by less than the smallest bank tensor. Returns that size."""
    import torch

    from dgen_tpu_torch.tree import leaf_paths

    base = sweep.base
    banks = leaf_paths(base.profiles)
    smallest = min(t.numel() * t.element_size() for t in banks.values())
    for i, sim in enumerate(sweep.sims):
        for name in ("table", "profiles", "tariffs"):
            mine, theirs = leaf_paths(getattr(sim, name)), leaf_paths(getattr(base, name))
            if set(mine) != set(theirs) or any(
                    not isinstance(t, torch.Tensor) or t.data_ptr() != theirs[k].data_ptr()
                    for k, t in mine.items()):
                raise AssertionError(f"[3i] sibling {i} holds its own copy of the {name}")
    if grown_bytes is not None and grown_bytes >= smallest:
        raise AssertionError(f"[3i] the siblings grew the card's allocated bytes by "
                             f"{grown_bytes}, a bank's worth ({smallest})")
    return smallest


def member_curves(res, ens) -> dict:
    """{metric: [E, Y]} national curves of an ensemble's collected
    members, reduced on the run's device by ``ensemble.stats.
    member_aggregates`` over each year's ``[E, N]`` outputs and alive
    mask, as the run reduced them."""
    import types

    import numpy as np
    import torch

    from dgen_tpu_torch.ensemble import stats as estats

    table = ens.base.table
    curves = {m: [] for m in estats.METRIC_FIELDS}
    for yi, year in enumerate(res[0].years):
        outs = types.SimpleNamespace(**{
            f: torch.from_numpy(np.stack([r.agent[f][yi] for r in res.runs])).to(table.mask.device)
            for f in estats.METRIC_FIELDS.values()})
        nat, _ = estats.member_aggregates(outs, ens._alive(year), table.state_idx,
                                          n_states=table.n_states)
        for m, v in nat.items():
            curves[m].append(v.cpu().numpy())
    return {m: np.stack(v, axis=1) for m, v in curves.items()}


def check_quantiles(stats, curves: dict, rtol: float = QUANTILE_RTOL) -> float:
    """Raises unless the ensemble's national quantiles equal numpy's
    (``quantiles_np``) of the members' curves within ``rtol``; returns the
    largest relative gap."""
    import numpy as np

    from dgen_tpu_torch.ensemble.stats import quantiles_np

    worst = 0.0
    for m, c in curves.items():
        want = quantiles_np(c, stats.quantiles).transpose(1, 0)
        got = stats.national[m]
        gap = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want), 1e-30)
        gap = float(np.where(want == got, 0.0, gap).max())
        if gap > rtol:
            raise AssertionError(f"[3i] (c) {m} quantiles {got.tolist()} against numpy's "
                                 f"{want.tolist()}: relative gap {gap:.3e} > {rtol}")
        worst = max(worst, gap)
    return worst


def _itc(inputs, v: float):
    import dataclasses

    import torch

    return dataclasses.replace(inputs, itc_fraction=torch.full_like(inputs.itc_fraction, v))


def _counted_sweep_run(sweep, **kw) -> tuple:
    """``sweep.run(**kw)`` with the launch counts set to 0 before and read
    after, no operands captured; (results, launches, wall seconds)."""
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops import dispatch

    bk.CAPTURE = None
    bk.reset_launches()
    dispatch.reset_launches()
    _sync(sweep.device)
    t0 = time.perf_counter()
    res = sweep.run(**kw)
    _sync(sweep.device)
    return res, {**bk.LAUNCHES, **dispatch.LAUNCHES}, time.perf_counter() - t0


def national_sweep(presets, whole_per_year: dict, single_rate: float, *, name=NATIONAL,
                   n_agents=None, end_year=SWEEP_END_YEAR, device="cuda",
                   econ_years=25, knobs=None) -> dict:
    """[3i] (a): ``name`` at its full width (``n_agents``: the preset's),
    S = 2 (the preset's inputs, and no ITC), run planned on the card's
    memory (one vmap group, chunked) and with ``max_vmap_scenarios=1``
    (loop mode), both collected; each scenario's SWEEP_FIELDS equal bit
    for bit by agent_id. Logs the plan, the modeled step bytes beside the
    measured peak, the banks' bytes and the siblings' growth of the
    allocated bytes, each scenario-year's wall, agent-years/s beside the
    single run's ``single_rate``, and the launch counts, held as [3d]
    holds them; one more first year holds the vmap run's first launches,
    at S x chunk rows, against the plain versions."""
    import torch

    from dgen_tpu_torch.config import RunConfig
    from dgen_tpu_torch.sweep import MODE_LOOP, MODE_VMAP, SweepSimulation, sweep_year_step
    from dgen_tpu_torch.sweep.driver import group_step_kwargs, stacked_carry
    from dgen_tpu_torch.utils import timing

    cuda = torch.device(device).type == "cuda"
    pop, cfg, inputs, hourly, _ = presets.world(name, n_agents, end_year=end_year,
                                                device=device)
    members = [inputs, _itc(inputs, 0.0)]
    s = len(members)
    rc = RunConfig(async_host_io=False, **(knobs or {}))
    out = {}
    for mode, kw in ((MODE_VMAP, {}), (MODE_LOOP, dict(max_vmap_scenarios=1))):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sweep = SweepSimulation(pop.table, pop.profiles, pop.tariffs, members, cfg, rc,
                                with_hourly=hourly, econ_years=econ_years, device=device,
                                labels=["preset", "no_itc"], **kw)
        build_s = time.perf_counter() - t0
        group = sweep.plan.groups[0]
        if [g.mode for g in sweep.plan.groups] != [mode]:
            raise AssertionError(f"[3i] (a) plan {sweep.plan.groups}, one {mode} group "
                                 "expected")
        if cuda and mode == MODE_VMAP and not sweep.base._agent_chunk:
            raise AssertionError("[3i] (a) the planned vmap group does not stream")
        smallest = check_shared_banks(sweep, sweep.sibling_bytes)
        timing.reset_timings()
        res, launches, wall = _counted_sweep_run(sweep, collect=True)
        years = len(res[0].years)
        k = n_chunks(sweep.base)
        walls = (timing.timing_samples("sweep_year_step", "group0") if mode == MODE_VMAP
                 else [t for lab in sweep.labels
                       for t in timing.timing_samples("year_step", lab)])
        n_real = int(sweep.base.host_mask.sum())
        rate = s * n_real * years / sum(walls)
        peak = torch.cuda.max_memory_allocated() if cuda else None
        log(f"[3i] (a) {name} {mode}: {n_real} agents x {s} scenarios x {years} years, plan "
            f"{[(g.mode, g.n_scenarios, g.net_billing) for g in sweep.plan.groups]}, chunk "
            f"{sweep.base._agent_chunk} ({k} chunks, {sweep.base.table.n_agents} rows, "
            f"{s if mode == MODE_VMAP else 1} x chunk rows a launch); built in {build_s:.3f} s; "
            f"{'group' if mode == MODE_VMAP else 'scenario'}-year walls "
            f"{[round(t, 4) for t in walls]} s, run wall {wall:.3f} s; {rate:.1f} "
            f"agent-years/s (S x N x years / the year walls) beside [3d]'s single run "
            f"{single_rate:.1f}; modeled step {sweep.modeled_step_bytes(group) / 2**30:.2f} "
            f"GiB, measured peak allocated "
            f"{'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}; bank_bytes_shared "
            f"{sweep.bank_bytes_shared}, the siblings grew the allocated bytes by "
            f"{sweep.sibling_bytes} (smallest bank {smallest}); launches "
            f"{per_year(launches, s * years)} a scenario-year")
        if cuda:
            width = s if mode == MODE_VMAP else 1
            runs = years * (1 if mode == MODE_VMAP else s)
            if launches["dispatch"] != dispatch_per_year(sweep.base) * runs:
                raise AssertionError(f"[3i] (a) {mode}: {launches['dispatch']} dispatch "
                                     f"launches, {dispatch_per_year(sweep.base) * runs} expected")
            for key in ("month", "month_signed"):
                if launches[key] != k * whole_per_year[key] * runs:
                    raise AssertionError(f"[3i] (a) {mode}: {launches[key]} {key} launches, "
                                         f"{k * whole_per_year[key] * runs} expected")
            log(f"    [3i] (a) {mode}: {launches['month'] / (s * years):g} month, "
                f"{launches['month_signed'] / (s * years):g} signed and "
                f"{launches['dispatch'] / (s * years):g} dispatch launches a scenario-year "
                f"({width} scenario(s) a launch)")
            if mode == MODE_VMAP:
                base = sweep.base

                def first_year():
                    return sweep_year_step(base.table, base.profiles, base.tariffs,
                                           sweep.group_inputs(group), stacked_carry(base, s),
                                           0, **group_step_kwargs(base, group.net_billing,
                                                                  True))

                t0 = time.perf_counter()
                held_year(base, "3i (a) vmap", launches, step=first_year)
                log(f"    [3i] (a) the held first year: {time.perf_counter() - t0:.3f} s")
        out[mode] = (res.runs, sweep.base.host_agent_id, sweep.base.host_mask)
        del sweep, res
    n = check_same_members(out[MODE_VMAP], out[MODE_LOOP], "3i (a) vmap vs loop")
    log(f"    [3i] (a) vmap and loop mode equal bit for bit by agent_id: {n} values of "
        f"{list(SWEEP_FIELDS)}")
    return {"compared": n}


def sweeps_vs_singles(presets, *, workdir: str, name="ercot-all-sector",
                      n_agents=CHUNK_AGENTS, end_year=SWEEP_SMALL_END_YEAR, device="cuda",
                      worlds=("default", "gated int8"), econ_years=25,
                      knobs=None) -> dict:
    """[3i] (b): ``name`` at ``n_agents`` with batteries allocated, S = 3
    ITC levels (SWEEP_ITCS) over ``end_year``'s model years, in each of
    ``worlds`` (CHUNK_WORLDS): the planned vmap sweep equals each
    scenario's own ``Simulation.run`` bit for bit per agent (the
    state-hourly aggregate within [3c]'s tolerance, atomics on a card);
    a loop-mode sweep exporting as it runs, under the supervisor with
    ``sweep_scenario@2`` injected, resumes at (scenario, year), and its
    agent_outputs and finance_series files equal a clean loop sweep's
    byte for byte, its state_hourly within [3c]'s tolerance."""
    import os

    import numpy as np
    import torch

    from dgen_tpu_torch.config import RunConfig
    from dgen_tpu_torch.models.simulation import Simulation
    from dgen_tpu_torch.resilience import faults
    from dgen_tpu_torch.resilience.supervisor import RetryPolicy, Supervisor
    from dgen_tpu_torch.sweep import MODE_VMAP, SweepSimulation

    cuda = torch.device(device).type == "cuda"
    out = {}
    for world in worlds:
        world_knobs, _, kernels = CHUNK_WORLDS[world]
        pop, cfg, inputs, hourly, _ = presets.world(name, n_agents, end_year=end_year,
                                                    device=device,
                                                    attachment_rate=CHUNK_ATTACHMENT)
        members = [_itc(inputs, v) for v in SWEEP_ITCS]
        labels = [f"itc{v:g}" for v in SWEEP_ITCS]
        rc = RunConfig(**world_knobs, **(knobs or {}))

        def sweep_of(**kw):
            return SweepSimulation(pop.table, pop.profiles, pop.tariffs, members, cfg, rc,
                                   with_hourly=hourly, econ_years=econ_years,
                                   device=device, labels=labels, **kw)

        vmap = sweep_of()
        if [g.mode for g in vmap.plan.groups] != [MODE_VMAP]:
            raise AssertionError(f"[3i] (b) {world}: plan {vmap.plan.groups}")
        res_v, launches, wall = _counted_sweep_run(vmap, collect=True)
        chunk_rows = vmap.base._agent_chunk or vmap.base.table.n_agents
        if cuda:
            need_launches(f"[3i] (b) {world} vmap", launches, kernels)
        t0 = time.perf_counter()
        singles = []
        for m in members:
            sim = Simulation(pop.table, pop.profiles, pop.tariffs, m, cfg, rc,
                             with_hourly=hourly, econ_years=econ_years, device=device)
            singles.append(sim.run())
        single_s = time.perf_counter() - t0
        ids, mask = vmap.base.host_agent_id, vmap.base.host_mask
        fields = tuple(res_v[0].agent)
        n = check_same_members((res_v.runs, ids, mask),
                               (singles, sim.host_agent_id, sim.host_mask),
                               f"3i (b) {world} vmap vs single runs", fields)
        ids, mask = sim.host_agent_id, sim.host_mask
        del sim
        for i, single in enumerate(singles):
            if hourly:
                np.testing.assert_allclose(
                    res_v[i].state_hourly_net_mw, single.state_hourly_net_mw,
                    rtol=CHUNK_HOURLY_RTOL, atol=CHUNK_HOURLY_ATOL,
                    err_msg=f"[3i] (b) {world} scenario {i} state-hourly")
        del vmap, singles

        clean_dir = os.path.join(workdir, f"{world}-clean")
        clean = sweep_of(max_vmap_scenarios=1).run(collect=True, run_dir=clean_dir)
        run_dir = os.path.join(workdir, f"{world}-supervised")
        ckpt_dir = os.path.join(workdir, f"{world}-ckpt")
        loop = sweep_of(max_vmap_scenarios=1)

        def attempt(ctx):
            return loop.run(collect=True, checkpoint_dir=ckpt_dir, resume=ctx.resume,
                            run_dir=run_dir)

        t0 = time.perf_counter()
        with faults.injected("sweep_scenario@2") as reg:
            sup_res, report = Supervisor(RetryPolicy(backoff_base_s=0.001)).run(attempt, rc)
        sup_s = time.perf_counter() - t0
        if reg.fired("sweep_scenario") != 1 or report.retries != 1:
            raise AssertionError(f"[3i] (b) {world}: the fault fired "
                                 f"{reg.fired('sweep_scenario')} times, "
                                 f"{report.retries} retries")
        if [r.years for r in sup_res.runs] != [[]] + [clean[0].years] * (len(members) - 1):
            raise AssertionError(f"[3i] (b) {world}: the resumed sweep ran "
                                 f"{[r.years for r in sup_res.runs]}")
        n += check_same_members((sup_res.runs[1:], ids, mask), (clean.runs[1:], ids, mask),
                                f"3i (b) {world} resumed vs clean", fields)
        files = same_sweep_files(clean_dir, run_dir, labels, f"3i (b) {world}")
        log(f"[3i] (b) {world} ({sorted(world_knobs) or 'no knobs'}): {int(mask.sum())} agents x "
            f"{len(members)} scenarios x {len(res_v[0].years)} years: the vmap sweep "
            f"({wall:.3f} s, launches {per_year(launches, len(res_v[0].years))} a year, "
            f"{len(members)} x {chunk_rows} rows a launch) equals the single runs "
            f"({single_s:.3f} s) bit for bit per agent; the supervised loop sweep "
            f"({sup_s:.3f} s, {report.retries} retry, {reg.fired('sweep_scenario')} "
            f"sweep_scenario fault) resumed at (scenario {labels[1]}, year "
            f"{clean[1].years[0]}); {files['same']} files byte for byte, "
            f"{files['approx']} state_hourly within rtol {CHUNK_HOURLY_RTOL}/atol "
            f"{CHUNK_HOURLY_ATOL}; {n} per-agent values compared")
        out[world] = {"compared": n, **files}
        del clean, sup_res, loop
        if cuda:
            torch.cuda.empty_cache()
    return out


def same_sweep_files(dir_a: str, dir_b: str, labels, tag: str) -> dict:
    """Raises unless two sweeps' export directories hold the same
    partitions, agent_outputs and finance_series byte for byte and
    state_hourly within [3c]'s tolerance; {"same": n, "approx": n}."""
    import os

    import numpy as np

    same = approx = 0
    for label in labels:
        for surface in ("agent_outputs", "finance_series", "state_hourly"):
            sub = os.path.join(f"scenario={label}", surface)
            if not os.path.isdir(os.path.join(dir_a, sub)):
                continue
            names = sorted(os.listdir(os.path.join(dir_a, sub)))
            if names != sorted(os.listdir(os.path.join(dir_b, sub))):
                raise AssertionError(f"[{tag}] {sub}: partitions differ")
            for part in names:
                pa, pb = os.path.join(dir_a, sub, part), os.path.join(dir_b, sub, part)
                if surface == "state_hourly":
                    with np.load(pa) as za, np.load(pb) as zb:
                        np.testing.assert_allclose(
                            zb["net_load_mw"], za["net_load_mw"], rtol=CHUNK_HOURLY_RTOL,
                            atol=CHUNK_HOURLY_ATOL, err_msg=f"[{tag}] {sub}/{part}")
                    approx += 1
                    continue
                with open(pa, "rb") as fa, open(pb, "rb") as fb:
                    if fa.read() != fb.read():
                        raise AssertionError(f"[{tag}] {sub}/{part} differs: "
                                             f"{_column_gaps(dir_a, dir_b, [os.path.join(sub, part)])}")
                same += 1
    return {"same": same, "approx": approx}


def ensemble_phase(*, presets, name="ercot-all-sector", n_agents=CHUNK_AGENTS,
                   end_year=SWEEP_SMALL_END_YEAR, device="cuda", members=ENS_MEMBERS,
                   cohort_rows=ENS_COHORT_ROWS, workdir: str, econ_years=25,
                   knobs=None) -> dict:
    """[3i] (c): ``name`` at ``n_agents`` with batteries allocated, E =
    ``members`` under DEFAULT_DRAWS and a cohort of ``cohort_rows`` rows
    entering in ENS_COHORT_YEAR, over ``end_year``'s model years: vmap
    (planned) and loop mode give the same members bit for bit by agent_id;
    the device quantiles equal numpy's of the members' curves (rtol
    QUANTILE_RTOL); E = 1 with zero draws equals ``Simulation.run`` bit
    for bit; and a vmap run killed in its last year and resumed gives
    the same national quantiles bit for bit (the state ones, summed with
    atomics on a card, within [3c]'s tolerance)."""
    import os

    import numpy as np
    import torch

    from dgen_tpu_torch.config import RunConfig
    from dgen_tpu_torch.ensemble import (
        DEFAULT_DRAWS,
        CohortSchedule,
        DrawSpec,
        EnsembleSimulation,
    )
    from dgen_tpu_torch.ensemble import driver as edriver
    from dgen_tpu_torch.models.simulation import Simulation
    from dgen_tpu_torch.sweep import MODE_LOOP, MODE_VMAP

    pop, cfg, inputs, hourly, _ = presets.world(name, n_agents, end_year=end_year,
                                                device=device,
                                                attachment_rate=CHUNK_ATTACHMENT)
    entry = np.zeros(pop.table.n_agents, np.float32)
    alive = np.flatnonzero(pop.table.mask.cpu().numpy() > 0)
    entry[alive[-cohort_rows:]] = ENS_COHORT_YEAR
    schedule = CohortSchedule(entry)
    rc = RunConfig(**(knobs or {}))

    def ens_of(**kw):
        kw.setdefault("n_members", members)
        kw.setdefault("draws", DEFAULT_DRAWS)
        return EnsembleSimulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg, rc,
                                  seed=0, with_hourly=hourly, econ_years=econ_years,
                                  device=device, **kw)

    out, walls = {}, {}
    for mode, kw in ((MODE_VMAP, {}), (MODE_LOOP, dict(max_vmap_members=1))):
        ens = ens_of(entry_year=schedule, **kw)
        if ens.mode != mode:
            raise AssertionError(f"[3i] (c) {ens.mode} mode, {mode} expected")
        _sync(device)
        t0 = time.perf_counter()
        res = ens.run(collect=True)
        _sync(device)
        walls[mode] = (time.perf_counter() - t0, ens.base._agent_chunk)
        if mode == MODE_VMAP:
            gap = check_quantiles(res.quantiles, member_curves(res, ens))
            stats_v = res.quantiles
        out[mode] = (res.runs, ens.base.host_agent_id, ens.base.host_mask)
        del ens, res
    n = check_same_members(out[MODE_VMAP], out[MODE_LOOP], "3i (c) vmap vs loop")
    del out

    ref = Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg, rc,
                     with_hourly=hourly, econ_years=econ_years, device=device)
    ref_res = ref.run()
    one = ens_of(n_members=1, draws=DrawSpec())
    one_res = one.run(collect=True)
    fields = tuple(ref_res.agent)
    n += check_same_members(([ref_res], ref.host_agent_id, ref.host_mask),
                            (one_res.runs, one.base.host_agent_id, one.base.host_mask),
                            "3i (c) E = 1 vs Simulation.run", fields)
    del ref, ref_res, one, one_res

    # a vmap run killed in its last model year, resumed from its
    # checkpoints and stats sidecar
    ckpt = os.path.join(workdir, "ensemble-ckpt")
    step, calls = edriver.ensemble_year_step, []
    kill_at = len(cfg.model_years)

    def dying_step(*args, **kw):
        calls.append(1)
        if len(calls) == kill_at:
            raise RuntimeError("[3i] (c) killed")
        return step(*args, **kw)

    edriver.ensemble_year_step = dying_step
    try:
        ens_of(entry_year=schedule).run(checkpoint_dir=ckpt)
        raise AssertionError("[3i] (c) the killed run was not killed")
    except RuntimeError as e:
        if "killed" not in str(e):
            raise
    finally:
        edriver.ensemble_year_step = step
    resumed = ens_of(entry_year=schedule).run(checkpoint_dir=ckpt, resume=True)
    if [r.years for r in resumed.runs] != [list(stats_v.years[kill_at - 1:])] * members:
        raise AssertionError(f"[3i] (c) the resumed run ran {resumed.runs[0].years}")
    for m, v in stats_v.national.items():
        if not np.array_equal(resumed.quantiles.national[m], v):
            raise AssertionError(f"[3i] (c) the resumed run's national {m} quantiles "
                                 "differ from the uninterrupted run's")
    # the state sums add with atomics on a card (index_add_)
    for m, v in stats_v.state.items():
        np.testing.assert_allclose(resumed.quantiles.state[m], v, rtol=CHUNK_HOURLY_RTOL,
                                   atol=CHUNK_HOURLY_ATOL,
                                   err_msg=f"[3i] (c) resumed state {m} quantiles")
    band = stats_v.band("adopters")
    log(f"[3i] (c) ensemble {name}: {int(pop.table.mask.sum())} agents, E = {members} "
        f"(DEFAULT_DRAWS), {schedule.n_cohort_rows} cohort rows entering "
        f"{schedule.counts_by_year()}, years {list(stats_v.years)}: vmap "
        f"{walls[MODE_VMAP][0]:.3f} s (chunk {walls[MODE_VMAP][1]}, {members} x chunk rows "
        f"a launch), loop {walls[MODE_LOOP][0]:.3f} s (chunk {walls[MODE_LOOP][1]}); the "
        f"members equal bit for bit by agent_id, and E = 1 with zero draws equals "
        f"Simulation.run ({n} values); device quantiles within {gap:.3e} (relative) of "
        f"numpy's; killed in year {kill_at} and resumed: the same national quantiles "
        f"bit for bit, the state ones within rtol {CHUNK_HOURLY_RTOL}; adopters "
        f"band {({k: [round(float(x), 3) for x in v] for k, v in band.items()})}")
    return {"compared": n, "quantile_gap": gap}


def sweeps(presets, whole_per_year: dict, single_rate: float, *, workdir=None) -> dict:
    """[3i]: (a) :func:`national_sweep`, (b) :func:`sweeps_vs_singles`
    and (c) :func:`ensemble_phase`, in a temporary directory the phase
    removes; logs the phase's wall."""
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    a = national_sweep(presets, whole_per_year, single_rate)
    torch.cuda.empty_cache()
    walls = [time.perf_counter() - t0]
    work = tempfile.mkdtemp(prefix="dgen-3i-", dir=workdir)
    try:
        b = sweeps_vs_singles(presets, workdir=work)
        torch.cuda.empty_cache()
        walls.append(time.perf_counter() - t0 - sum(walls))
        c = ensemble_phase(presets=presets, workdir=work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    walls.append(wall - sum(walls))
    log(f"[3i] sweeps and ensembles (a)-(c): {wall:.3f} s ((a) {walls[0]:.3f}, (b) "
        f"{walls[1]:.3f}, (c) {walls[2]:.3f})")
    return {"a": a, "b": b, "c": c, "wall_s": wall}


# ---------------------------------------------------------------------------
# [3j]: the per-agent oracle, the analysis side and the differentiable twin
# ---------------------------------------------------------------------------

#: [3j] (a): the oracle's golden-section iterations and the fast path's
#: candidates (tests/test_sizing.py::test_fast_path_matches_slow_path runs
#: both at 14), and that test's tolerances
ORACLE_ITERS = 14
ORACLE_KW_RTOL = 6e-3
ORACLE_NPV_RTOL, ORACLE_NPV_ATOL = 2e-3, 10.0
ORACLE_PAYBACK_ATOL = 0.21
ORACLE_BILL_RTOL, ORACLE_BILL_ATOL = 1e-3, 1.0
#: [3j] (a): rows sized alone, held bit for bit to the same rows of the
#: whole table's oracle
ORACLE_ALONE_ROWS = 64
#: [3j] (b): Newton's temperature and the oracle's iterations beside it
#: (tests/test_grad.py:114); the hard objective's grid columns
NEWTON_TAU = 0.1
NEWTON_ORACLE_ITERS = 20
OBJECTIVE_GRID_K = 6
#: [3j] (b): the hard objective on the kernels against the plain sums:
#: rtol 1e-4 of the NPV plus 1e-4 x the flow scale (25 years of the
#: no-system bill), tests/test_torch_sizing.py's bound
OBJECTIVE_RTOL = 1e-4
#: [3j] (d): the rollout-loss gradient through the dispatch kernel against
#: the same gradient through the plain loop
GRAD_DISPATCH_RTOL = 1e-5
#: [3j] (e): rows of the card's analysis held to the port's CPU result at
#: rtol 1e-5 (the same float32 maxima and recursion; sums in another
#: order), atol 1e-3
ANALYSIS_CPU_ROWS = 256
ANALYSIS_RTOL = 1e-5
#: [3j] (f): the soft run's model years (2014, 2016)
SOFT_END_YEAR = 2016
#: [3j] (c)-(d): the twin's world (calibrate.CHECK_N_AGENTS, the CLI's
#: default)
TWIN_AGENTS = 64


def _launch_counts() -> dict:
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops import dispatch

    return {**bk.LAUNCHES, **dispatch.LAUNCHES}


def _reset_counts() -> None:
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops import dispatch

    bk.reset_launches()
    dispatch.reset_launches()


def _host(t):
    return t.detach().cpu().numpy()


def _timed(fn):
    """(fn(), seconds ending in a synchronize)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _reset_peak() -> int:
    """Resets the card's peak memory statistic; the bytes held now."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_from(base: int) -> int:
    """Bytes allocated above ``base`` at the peak since the last reset."""
    import torch

    return torch.cuda.max_memory_allocated() - base


def _oracle_at(envs, kw, n_periods: int, years: int):
    """The oracle's outputs (``sizing.oracle_outputs``) at the sizes
    ``kw``, chunk by chunk of ``oracle_chunk_rows``: another path's sizes
    priced by the oracle's hourly engine."""
    import torch

    from dgen_tpu_torch.ops import sizing
    from dgen_tpu_torch.tree import tree_map

    chunk = sizing.oracle_chunk_rows(years)
    parts = [sizing.oracle_outputs(tree_map(lambda t: t[r0:r0 + chunk], envs),
                                   kw[r0:r0 + chunk], n_periods, years, keep_hourly=False)
             for r0 in range(0, kw.shape[0], chunk)]
    return tree_map(lambda *ts: torch.cat(ts), *parts)


def oracle_fast_vs_slow(sim, envs, card: str) -> dict:
    """[3j] (a): ``size_agents(fast=False)`` (ORACLE_ITERS golden-section
    iterations, agent chunks) against the fast path on the first model
    year of ``sim``'s world, at tests/test_sizing.py:117-128's bounds:
    sizes, NPV and payback of every agent; both first-year bills at the
    same size (the oracle's hourly engine repricing the fast path's
    sizes), the bills at each path's own size counted and logged. The
    launch counts are set to 0 before the two runs and read after; the
    first launches' operands (the fast path's bucket sums, the oracle's
    first dispatch) are kept for [9]. ORACLE_ALONE_ROWS rows sized alone
    equal their rows of the whole run bit for bit."""
    import numpy as np
    import torch

    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops import sizing
    from dgen_tpu_torch.tree import tree_map

    p, years = sim.tariffs.max_periods, sim.econ_years
    m = sim.host_mask > 0
    capture, slow_cap = {}, {}
    bk.CAPTURE = capture
    _reset_counts()
    try:
        with first_dispatch(capture):
            fast, fast_s = _timed(lambda: sizing.size_agents(
                envs, p, years, n_iters=ORACLE_ITERS, keep_hourly=False,
                net_billing=sim._net_billing))
        fast_launches = _launch_counts()
        base = _reset_peak()
        with first_dispatch(slow_cap):
            slow, slow_s = _timed(lambda: sizing.size_agents(
                envs, p, years, n_iters=ORACLE_ITERS, keep_hourly=False, fast=False))
        peak = _peak_from(base)
    finally:
        launches = _launch_counts()
        bk.CAPTURE = None
    capture["dispatch"] = slow_cap["dispatch"]
    chunk = sizing.oracle_chunk_rows(years)
    n = envs.load.shape[0]
    oracle_dispatch = launches["dispatch"] - fast_launches["dispatch"]
    if oracle_dispatch != -(-n // chunk):
        raise AssertionError(f"[3j] (a) the oracle launched {oracle_dispatch} "
                             f"dispatch kernels for {-(-n // chunk)} chunks")
    need_launches("[3j] (a)", launches, ("month", "month_signed", "dispatch"))

    def held(name, got, ref, rtol, atol) -> tuple:
        g, r = _host(got)[m], _host(ref)[m]
        bad = np.abs(g - r) > atol + rtol * np.abs(r)
        return int(bad.sum()), float(np.abs(g - r).max())

    gaps = {}
    for name, rtol, atol in (("system_kw", ORACLE_KW_RTOL, 0.0),
                             ("npv", ORACLE_NPV_RTOL, ORACLE_NPV_ATOL),
                             ("payback_period", 0.0, ORACLE_PAYBACK_ATOL)):
        bad, gap = held(name, getattr(fast, name), getattr(slow, name), rtol, atol)
        if bad:
            raise AssertionError(f"[3j] (a) {name}: {bad} agents outside rtol {rtol}, "
                                 f"atol {atol} (largest gap {gap:.4g})")
        gaps[name] = gap
    same_size = _oracle_at(envs, fast.system_kw, p, years)
    own = {}
    for name in ("first_year_bill_with_system", "first_year_bill_with_batt"):
        bad, gap = held(name, getattr(fast, name), getattr(same_size, name),
                        ORACLE_BILL_RTOL, ORACLE_BILL_ATOL)
        if bad:
            raise AssertionError(f"[3j] (a) {name} at the same size: {bad} agents "
                                 f"outside rtol {ORACLE_BILL_RTOL}, atol "
                                 f"{ORACLE_BILL_ATOL} (largest gap {gap:.4g})")
        gaps[name + "_same_size"] = gap
        own[name] = held(name, getattr(fast, name), getattr(slow, name),
                         ORACLE_BILL_RTOL, ORACLE_BILL_ATOL)
    alone = sizing.size_agents(tree_map(lambda t: t[:ORACLE_ALONE_ROWS], envs), p, years,
                               n_iters=ORACLE_ITERS, keep_hourly=False, fast=False)
    for name in ("system_kw", "npv", "first_year_bill_with_batt"):
        if not torch.equal(getattr(alone, name), getattr(slow, name)[:ORACLE_ALONE_ROWS]):
            raise AssertionError(f"[3j] (a) {ORACLE_ALONE_ROWS} rows sized alone differ "
                                 f"from their rows of the whole oracle run in {name}")
    log(f"[3j] (a) the per-agent oracle (size_agents(fast=False), {ORACLE_ITERS} "
        f"golden-section iterations) against the fast path ({ORACLE_ITERS} candidates), "
        f"first model year of ercot-all-sector at {int(m.sum())} agents, {years} "
        f"analysis years ({card}): fast {fast_s:.3f} s, oracle {slow_s:.3f} s in "
        f"chunks of {chunk} rows ({oracle_dispatch} dispatch launches), "
        f"max_memory_allocated {(peak + base) / 2**30:.2f} GiB ({peak / 2**30:.2f} over "
        f"the {base / 2**30:.2f} GiB held before); launches {launches}")
    log(f"    within tests/test_sizing.py's bounds on every agent: system_kw "
        f"(rtol {ORACLE_KW_RTOL}) gap {gaps['system_kw']:.4g} kW, npv (rtol "
        f"{ORACLE_NPV_RTOL}, atol {ORACLE_NPV_ATOL}) {gaps['npv']:.4g}, payback (atol "
        f"{ORACLE_PAYBACK_ATOL}) {gaps['payback_period']:.4g}; both first-year bills at "
        f"the same size (rtol {ORACLE_BILL_RTOL}, atol {ORACLE_BILL_ATOL}) "
        f"{gaps['first_year_bill_with_system_same_size']:.4g} and "
        f"{gaps['first_year_bill_with_batt_same_size']:.4g}; at each path's own size "
        f"{own['first_year_bill_with_system'][0]} and "
        f"{own['first_year_bill_with_batt'][0]} agents outside that bound (largest "
        f"gaps {own['first_year_bill_with_system'][1]:.4g} and "
        f"{own['first_year_bill_with_batt'][1]:.4g}: the sizes' grid gap times the "
        f"bill's slope); {ORACLE_ALONE_ROWS} rows alone equal their rows bit for bit")
    return dict(fast=fast, slow=slow, launches=launches, capture=capture,
                fast_s=fast_s, slow_s=slow_s, chunk=chunk, peak=peak, own=own, gaps=gaps)


def newton_vs_oracle(sim, envs, flow, card: str) -> dict:
    """[3j] (b): ``newton_size`` (soft, NEWTON_TAU) against
    ``size_agents(fast=False, n_iters=NEWTON_ORACLE_ITERS)``: every agent
    within ``reference_xatol`` and inside its bracket, fewer fallbacks
    than agents; no bucket-sums kernel launches in soft mode (the plain
    differentiable sums), none of the dispatch kernel (Newton runs no
    battery). Then the hard objective (``make_npv_objective``) on an
    OBJECTIVE_GRID_K-column grid through the month kernel, forward only,
    against the plain sums."""
    import numpy as np
    import torch

    from dgen_tpu_torch.grad import newton
    from dgen_tpu_torch.ops import sizing

    p, years = sim.tariffs.max_periods, sim.econ_years
    _reset_counts()
    base = _reset_peak()
    res, newton_s = _timed(lambda: newton.newton_size(
        envs, p, years, soft_tau=NEWTON_TAU, net_billing=sim._net_billing))
    peak = _peak_from(base)
    newton_launches = _launch_counts()
    need_launches("[3j] (b) Newton", newton_launches, (),
                  zero=("month", "month_signed", "month_pair", "stream", "stream_signed",
                        "dot", "dot_signed", "dispatch"))
    _reset_counts()
    oracle, oracle_s = _timed(lambda: sizing.size_agents(
        envs, p, years, n_iters=NEWTON_ORACLE_ITERS, keep_hourly=False, fast=False))
    oracle_dispatch = _launch_counts()["dispatch"]
    kw, lo, hi = _host(res.system_kw), _host(res.lo), _host(res.hi)
    xatol = _host(newton.reference_xatol(res.lo, res.hi))
    diff = np.abs(kw - _host(oracle.system_kw))
    n = kw.shape[0]
    fallback = int(_host(res.fallback).sum())
    if not np.all(diff <= xatol):
        raise AssertionError(f"[3j] (b) {int((diff > xatol).sum())} agents outside "
                             f"xatol (largest gap {diff.max():.4g} kW)")
    if not (np.all(kw >= lo - 1e-5) and np.all(kw <= hi + 1e-5)):
        raise AssertionError("[3j] (b) a Newton size left its bracket")
    if fallback >= n:
        raise AssertionError(f"[3j] (b) {fallback} fallbacks of {n} agents")

    f_k, o_lo, o_hi = sizing.make_npv_objective(envs, p, years,
                                                net_billing=sim._net_billing, impl="auto")
    f_p = sizing.make_npv_objective(envs, p, years, net_billing=sim._net_billing)[0]
    grid = o_lo[:, None] + (o_hi - o_lo)[:, None] * sizing._unit_grid(
        OBJECTIVE_GRID_K, o_lo.device)[None, :]
    _reset_counts()
    with torch.no_grad():
        v_k, kernel_s = _timed(lambda: f_k(grid))
        grid_launches = _launch_counts()
        v_p, plain_s = _timed(lambda: f_p(grid))
    need_launches("[3j] (b) the hard objective on the kernels", grid_launches,
                  ("month",))
    gap = np.abs(_host(v_k) - _host(v_p))
    bound = OBJECTIVE_RTOL * np.abs(_host(v_p)) + OBJECTIVE_RTOL * flow[:, None]
    if not np.all(gap <= bound):
        raise AssertionError(f"[3j] (b) the hard objective on the kernels differs from "
                             f"the plain sums' for {int((gap > bound).sum())} values")
    log(f"[3j] (b) newton_size (soft, tau {NEWTON_TAU}) against the oracle "
        f"({NEWTON_ORACLE_ITERS} iterations) at {n} rows ({card}): Newton "
        f"{newton_s:.3f} s in chunks of {newton.newton_chunk_rows(years)} rows, peak "
        f"{peak / 2**30:.2f} GiB, bucket-sums kernel launches 0 (soft mode prices on the "
        f"plain differentiable sums; launches {newton_launches}); oracle {oracle_s:.3f} "
        f"s, {oracle_dispatch} dispatch launches; every agent within xatol (largest gap "
        f"{diff.max():.4g} kW, smallest xatol {xatol.min():.4g}), inside its bracket, "
        f"{fallback} fallbacks of {n}")
    log(f"    the hard objective on a {OBJECTIVE_GRID_K}-column grid: month kernel "
        f"{kernel_s:.3f} s ({grid_launches['month']} launches), plain sums "
        f"{plain_s:.3f} s, within rtol {OBJECTIVE_RTOL} + {OBJECTIVE_RTOL} x the flow "
        f"(largest gap {gap.max():.4g})")
    return dict(newton_s=newton_s, oracle_s=oracle_s, peak=peak,
                max_gap_kw=float(diff.max()), fallback=fallback)


def twin_workloads(card: str) -> dict:
    """[3j] (c) the gradcheck of the smooth objective on the CLI's 8-agent
    world; (d) the calibration's recovery (``recover_pq(64, steps=5,
    method="gn")``), ``solve_incentive`` at the CLI's defaults, and one
    rollout-loss gradient (the CHECK_* world against its seeded-truth
    targets, at the identity start, fit_mms on) through the dispatch kernel
    and again through ``dispatch_battery_plain``, equal within
    GRAD_DISPATCH_RTOL: no gradient is dropped at the kernel."""
    import math

    import numpy as np
    import torch

    from dgen_tpu_torch.grad import calibrate, policy
    from dgen_tpu_torch.grad.__main__ import CHECK_GRAD_RTOL, CHECK_PQ_RTOL, gradcheck
    from dgen_tpu_torch.ops import dispatch

    gc, gc_s = _timed(lambda: gradcheck(n_agents=8, seed=7, tau=NEWTON_TAU,
                                        device="cuda"))
    if not gc["ok"] or not gc["max_rel_err"] < CHECK_GRAD_RTOL:
        raise AssertionError(f"[3j] (c) gradcheck failed: {gc}")
    log(f"[3j] (c) gradcheck(8 agents, seed 7, tau {NEWTON_TAU}) on the card: max "
        f"relative error {gc['max_rel_err']:.3e} < {CHECK_GRAD_RTOL} "
        f"({gc_s:.3f} s, {card})")

    cal, cal_s = _timed(lambda: calibrate.recover_pq(TWIN_AGENTS, steps=5, method="gn",
                                                     device="cuda"))
    curve = cal["loss_curve"]
    if not (cal["rel_err_p"] <= CHECK_PQ_RTOL and cal["rel_err_q"] <= CHECK_PQ_RTOL
            and curve[-1] < curve[0]):
        raise AssertionError(f"[3j] (d) recover_pq: {cal}")
    pol, pol_s = _timed(lambda: policy.solve_incentive(
        TWIN_AGENTS, target_uplift=1.25, steps=6, soft_tau=NEWTON_TAU, seed=7,
        device="cuda"))
    if not (0.0 < pol["incentive_frac"] <= policy.MAX_INCENTIVE_FRAC
            and np.isfinite(pol["final_adopters"])
            and pol["final_adopters"] > pol["baseline_adopters"]):
        raise AssertionError(f"[3j] (d) solve_incentive: {pol}")
    log(f"[3j] (d) recover_pq({TWIN_AGENTS}, steps=5, gn): rel_err_p {cal['rel_err_p']:.3e}, "
        f"rel_err_q {cal['rel_err_q']:.3e} (bound {CHECK_PQ_RTOL}), loss "
        f"{curve[0]:.4g} -> {curve[-1]:.4g} in {cal_s:.3f} s; solve_incentive (CLI "
        f"defaults: {TWIN_AGENTS} agents, uplift 1.25, 6 steps): incentive "
        f"{pol['incentive_frac']:.4f}, adopters {pol['baseline_adopters']:.4g} -> "
        f"{pol['final_adopters']:.4g} (target {pol['target_adopters']:.4g}, rel miss "
        f"{pol['rel_miss']:.3e}, converged {pol['converged']}) in {pol_s:.3f} s ({card})")

    pop, inputs, step_kw, n_years = calibrate.build_world(TWIN_AGENTS, device="cuda")
    roll = calibrate.make_rollout(pop.table, pop.profiles, pop.tariffs, n_years=n_years,
                                  step_kw=step_kw)
    dev = pop.table.mask.device
    truth = {"log_p": torch.tensor(math.log(1.6), device=dev),
             "log_q": torch.tensor(math.log(0.7), device=dev)}
    with torch.no_grad():
        targets = roll(calibrate.apply_params(inputs, truth))
    loss = calibrate.make_loss(roll, inputs, targets)

    def grad_once():
        leaves = {k: v.requires_grad_(True)
                  for k, v in calibrate.init_params(fit_mms=True, device=dev).items()}
        val = loss(leaves)
        grads = torch.autograd.grad(val, list(leaves.values()))
        return float(val.detach()), torch.stack(grads)

    _reset_counts()
    (v_k, g_k), k_s = _timed(grad_once)
    k_launches = _launch_counts()["dispatch"]
    kernel = dispatch.dispatch_battery
    dispatch.dispatch_battery = (lambda load, gen, bkw, bkwh, rt, impl="scan":
                                 dispatch.dispatch_battery_plain(load, gen, bkw, bkwh, rt))
    try:
        _reset_counts()
        (v_p, g_p), p_s = _timed(grad_once)
        p_launches = _launch_counts()["dispatch"]
    finally:
        dispatch.dispatch_battery = kernel
    if k_launches == 0 or p_launches != 0:
        raise AssertionError(f"[3j] (d) dispatch launches {k_launches} with the kernel, "
                             f"{p_launches} with the plain loop")
    if not (torch.isfinite(g_k).all() and g_k.abs().sum() > 0
            and torch.allclose(g_k, g_p, rtol=GRAD_DISPATCH_RTOL, atol=0.0)
            and abs(v_k - v_p) <= GRAD_DISPATCH_RTOL * abs(v_p)):
        raise AssertionError(f"[3j] (d) the rollout-loss gradient through the dispatch "
                             f"kernel {g_k.tolist()} differs from the plain loop's "
                             f"{g_p.tolist()}")
    log(f"    one rollout-loss gradient (CHECK_* world, {n_years} years, d/d(log_p, "
        f"log_q, mms_elast) = {[round(x, 6) for x in g_k.tolist()]}) through the dispatch "
        f"kernel ({k_launches} launches, {k_s:.3f} s) and the plain loop ({p_s:.3f} s): "
        f"equal within rtol {GRAD_DISPATCH_RTOL} (largest gap "
        f"{float((g_k - g_p).abs().max()):.3e})")
    return dict(gradcheck=gc["max_rel_err"], rel_err_p=cal["rel_err_p"],
                rel_err_q=cal["rel_err_q"], cal_s=cal_s, policy_s=pol_s)


def analysis_checks(sim, envs, sized, card: str) -> dict:
    """[3j] (e): ``demand_charge_audit`` over (a)'s sized outputs (the
    oracle's), with tests/test_demand.py:183-187's flat demand charge on
    every tariff spec; ``dispatch_diagnostics`` and ``summarize_dispatch``
    of the battery run at those sizes. Finite, padding priced 0, every
    real agent priced, baseline >= pv_only; the first ANALYSIS_CPU_ROWS
    rows equal the port's CPU result (plain dispatch loop) within
    ANALYSIS_RTOL."""
    import numpy as np
    import torch

    from dgen_tpu_torch import analysis
    from dgen_tpu_torch.io import synth
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops import dispatch, sizing
    from dgen_tpu_torch.tree import tree_map

    specs = [dict(s) for s in synth.make_tariff_specs()]
    for s in specs:
        s["demand"] = {"d_flat_prices": [[5.0] * 12], "d_flat_levels": [[1e9] * 12]}
    table, profiles = sim.table, sim.profiles
    if profiles.load_scale is not None or sim.tariffs.n_tariffs != len(specs):
        raise AssertionError("[3j] (e) the world's banks are not the synthetic corpus")
    sizes = dict(system_kw=sized.system_kw, batt_kw=sized.batt_kw,
                 batt_kwh=sized.batt_kwh, batt_rt_eff=envs.batt_rt_eff)

    def audit_of(tbl, prof, lkpc, sz):
        return analysis.demand_charge_audit(tbl, prof, specs, lkpc, **sz)

    def diags_of(load, gen, sell, sz):
        dr = dispatch.dispatch_battery(load, gen, sz["batt_kw"], sz["batt_kwh"],
                                       sz["batt_rt_eff"])
        return analysis.dispatch_diagnostics(load, gen, dr, sell, batt_kw=sz["batt_kw"])

    audit, audit_s = _timed(lambda: audit_of(table, profiles, envs.load_kwh_per_customer,
                                             sizes))
    load = envs.load.float()
    gen = envs.gen_per_kw * (sized.system_kw * sizing.INV_EFF)[:, None]
    sell = bk.sell_rate_hourly(envs.tariff, envs.ts_sell)
    diags, diag_s = _timed(lambda: diags_of(load, gen, sell, sizes))
    summary = analysis.summarize_dispatch(diags, table.mask)
    m = _host(table.mask)
    for k, v in audit.items():
        v = _host(v)
        if not (np.all(np.isfinite(v)) and np.all(v[m == 0] == 0.0)
                and v[m > 0].min() > 0.0):
            raise AssertionError(f"[3j] (e) audit {k}: non-finite, padding priced or an "
                                 "agent unpriced")
    if not np.all(_host(audit["pv_only"]) <= _host(audit["baseline"]) + 1e-4):
        raise AssertionError("[3j] (e) a PV-only demand charge above the baseline's")
    d = {k: _host(v) for k, v in diags.items()}
    if not (all(np.all(np.isfinite(v)) for v in d.values())
            and np.all((d["capture_mid_frac"] >= 0) & (d["capture_mid_frac"] <= 1 + 1e-6))
            and np.all(d["pv_to_batt_total_kwh"] <= d["surplus_total_kwh"] + 1e-3)):
        raise AssertionError("[3j] (e) dispatch diagnostics out of their bounds")

    rows = slice(0, ANALYSIS_CPU_ROWS)
    cpu = lambda tree: tree_map(lambda t: t[rows].cpu(), tree)  # noqa: E731
    sizes_c = {k: v[rows].cpu() for k, v in sizes.items()}
    audit_c = audit_of(cpu(table), tree_map(lambda t: t.cpu(), profiles),
                       envs.load_kwh_per_customer[rows].cpu(), sizes_c)
    diags_c = diags_of(load[rows].cpu(), gen[rows].cpu(), sell[rows].cpu(), sizes_c)
    for name, card_out, cpu_out in (("audit", audit, audit_c), ("diagnostics", diags,
                                                                 diags_c)):
        for k in cpu_out:
            got, ref = _host(card_out[k])[rows], _host(cpu_out[k])
            if not np.allclose(got, ref, rtol=ANALYSIS_RTOL, atol=1e-3):
                raise AssertionError(f"[3j] (e) {name} {k}: the card's first "
                                     f"{ANALYSIS_CPU_ROWS} rows differ from the CPU's")
    log(f"[3j] (e) demand_charge_audit over (a)'s sized outputs ({int(m.sum())} agents, "
        f"a flat $5/kW demand charge on every tariff): {audit_s:.3f} s; mean "
        f"$/customer-year baseline {float(_host(audit['baseline'])[m > 0].mean()):.2f}, "
        f"pv_only {float(_host(audit['pv_only'])[m > 0].mean()):.2f}, with_batt "
        f"{float(_host(audit['with_batt'])[m > 0].mean()):.2f}; dispatch_diagnostics "
        f"{diag_s:.3f} s, capture_mid_frac {summary['capture_mid_frac']:.4f}, "
        f"pv_to_batt {summary['pv_to_batt_total_kwh']:.4g} kWh; finite, padding 0, "
        f"baseline >= pv_only; the first {ANALYSIS_CPU_ROWS} rows equal the CPU's "
        f"within rtol {ANALYSIS_RTOL} ({card})")
    return dict(audit_s=audit_s, diag_s=diag_s)


def soft_year(presets, RunConfig, main_run: dict, card: str) -> dict:
    """[3j] (f): ``RunConfig(soft_boundaries=True)`` runs the main path's
    world to SOFT_END_YEAR: no bucket-sums kernel launches (the soft sums
    are the plain differentiable ones), the dispatch kernel once a year,
    finite outputs. The main path's years run hard again after it equal
    its outputs bit for bit per agent, with its launch counts; the soft
    first year's national sums are logged beside the hard one's (the
    later years' trajectories depend on the run's end year)."""
    import numpy as np

    from dgen_tpu_torch.presets import year_timer

    def run(rc, end_year):
        s = presets.build("ercot-all-sector", n_agents=MAIN_AGENTS, end_year=end_year,
                          device="cuda", run_config=rc)[0]
        seconds = []
        _reset_counts()
        with year_timer(s, seconds):
            res = s.run()
        return s, res, _launch_counts(), seconds

    ssim, sres, s_launches, s_seconds = run(RunConfig(soft_boundaries=True),
                                            SOFT_END_YEAR)
    check_outputs(sres, ssim)
    years = len(sres.years)
    need_launches("[3j] (f) soft years", s_launches, ("dispatch",),
                  zero=("month", "month_signed", "month_pair", "stream", "stream_signed",
                        "dot", "dot_signed"))
    if s_launches["dispatch"] != dispatch_per_year(ssim) * years:
        raise AssertionError(f"[3j] (f) {s_launches['dispatch']} dispatch launches")
    hsim, hres, h_launches, h_seconds = run(RunConfig(), MAIN_END_YEAR)
    main_res = main_run["res"]
    for k, v in hres.agent.items():
        if not np.array_equal(v, main_res.agent[k]):
            raise AssertionError(f"[3j] (f) the hard years after the soft run differ from "
                                 f"the main path's in {k}")
    for k in ("month", "month_signed", "dispatch"):
        if h_launches[k] != main_run["launches"][k]:
            raise AssertionError(f"[3j] (f) hard {k} launches {h_launches[k]}, the main "
                                 f"path's {main_run['launches'][k]}")
    soft_1, hard_1 = (r.summary(s.host_mask) for r, s in ((sres, ssim), (hres, hsim)))
    gap = curves_gap({k: v[:1] for k, v in soft_1.items()},
                     {k: v[:1] for k, v in hard_1.items()})
    log(f"[3j] (f) RunConfig(soft_boundaries=True) at {MAIN_AGENTS} agents, "
        f"{years} years: per-year s {[round(x, 3) for x in s_seconds]} (hard "
        f"{[round(x, 3) for x in h_seconds]}) ({card}); launches {s_launches}; the "
        f"first year's national sums {gap:.3e} (relative) from the hard run's; the "
        f"main path's years run hard after it equal [3]'s bit for bit, with its launch "
        f"counts")
    return dict(soft_s=s_seconds, hard_s=h_seconds, curves_gap=gap)


def oracle_and_twin(presets, RunConfig, sim, main_run: dict, card: str) -> dict:
    """[3j]: (a) :func:`oracle_fast_vs_slow`, (b) :func:`newton_vs_oracle`,
    (c)-(d) :func:`twin_workloads`, (e) :func:`analysis_checks` and (f)
    :func:`soft_year`, on the main path's world (``sim``, ercot-all-sector
    at MAIN_AGENTS agents) and its first model year's economics; logs
    the phase's wall. Returns (a)'s launch counts and first-launch
    operands for the kernels line."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    envs = year0_envs(sim)
    a = oracle_fast_vs_slow(sim, envs, card)
    flow = 25.0 * np.abs(_host(a["slow"].first_year_bill_without_system))
    b = newton_vs_oracle(sim, envs, flow, card)
    torch.cuda.empty_cache()
    cd = twin_workloads(card)
    e = analysis_checks(sim, envs, a["slow"], card)
    torch.cuda.empty_cache()
    f = soft_year(presets, RunConfig, main_run, card)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"[3j] the oracle, the analysis side and the twin (a)-(f): {wall:.3f} s ({card})")
    return dict(launches=a["launches"], capture=a["capture"], wall=wall, b=b, cd=cd,
                e=e, f=f)


#: [3k]: the serving stack. (a) national-all-sector's full width, every
#: bucket of ServeConfig(); SERVE_HELD agents spread over the states held
#: bit for bit across the buckets; SERVE_PRODUCERS threads x
#: SERVE_PER_PRODUCER single-agent requests through a Microbatcher
SERVE_STEADY = 20
SERVE_HELD = 512
SERVE_PRODUCERS = 8
SERVE_PER_PRODUCER = 64
SERVE_OVERRIDE = {"scale": {"itc_fraction": 0.5}}
#: (b)-(c): the main path's world with ingest_corrupt_row injected (as
#: [3g] (a) corrupts one), the surface built at this bucket over these
#: model years
SERVE_SURFACE_BUCKET = 64
SERVE_SURFACE_YEARS = (0, 1)
#: (d): the rate-switch world of [5] and the mixed twin of [3h] (c)
SERVE_CLUSTER_AGENTS = MIXED_CHUNK_AGENTS


def _library_events() -> dict:
    from dgen_tpu_torch.ops import _build

    return dict(_build.EVENTS)


def _answers_equal(a: dict, b: dict) -> int:
    """Rows of two answer dicts that differ in any field's bits."""
    import numpy as np

    bad = np.zeros(a["agent_id"].shape[0], dtype=bool)
    for f, v in a.items():
        w = b[f]
        if v.dtype != w.dtype or v.shape != w.shape:
            return int(bad.size)
        bad |= (np.ascontiguousarray(v).reshape(len(v), -1).view(np.uint8)
                != np.ascontiguousarray(w).reshape(len(w), -1).view(np.uint8)).any(axis=1)
    return int(bad.sum())


def _spread_rows(sim, n: int):
    """``n`` real rows of ``sim`` spread evenly over its rows sorted by
    state (every state the table holds, each about evenly)."""
    import numpy as np

    real = np.flatnonzero(sim.host_mask > 0)
    state = sim.table.state_idx.cpu().numpy()[real]
    by_state = real[np.argsort(state, kind="stable")]
    pick = np.linspace(0, len(by_state) - 1, n).round().astype(np.int64)
    return by_state[pick].astype(np.int32)


def _timed_query(engine, rows, year_idx=0, **kw):
    """(answers, seconds) of one query; the answers' host copy ends it."""
    t0 = time.perf_counter()
    out = engine.query_rows(rows, year_idx, **kw)
    return out, time.perf_counter() - t0


def serve_buckets(engine, rows_pool, *, device="cuda", steady=SERVE_STEADY,
                  capture_at=(1, 64)) -> dict:
    """[3k] (a): each bucket of ``ServeConfig().buckets`` warmed (its first
    launch's wall), then ``steady`` queries of other rows of ``rows_pool``
    (p50, p99), the launches of one query and of the steady queries, and
    the bytes allocated beyond the placed Simulation at the peak. The
    first steady query at each bucket of ``capture_at`` keeps its kernels'
    first-launch operands. Returns per-bucket records and the captures."""
    import numpy as np
    import torch

    from dgen_tpu_torch.config import ServeConfig
    from dgen_tpu_torch.ops import billkernels as bk

    base = torch.cuda.memory_allocated() if device == "cuda" else 0
    rng = np.random.default_rng(0)
    out, captures = {}, {}
    for b in ServeConfig().buckets:
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine.warmup([b])
        first_s = time.perf_counter() - t0
        walls = []
        _reset_counts()
        for i in range(steady):
            rows = rng.choice(rows_pool, size=b, replace=b > len(rows_pool)).astype(np.int32)
            keep = i == 0 and b in capture_at
            if keep:
                bk.CAPTURE = captures.setdefault(b, {})
            try:
                with (first_dispatch(bk.CAPTURE) if keep else contextlib.nullcontext()):
                    _, s = _timed_query(engine, rows, bucket=b)
            finally:
                bk.CAPTURE = None
            walls.append(s)
        launches = _launch_counts()
        peak = (torch.cuda.max_memory_allocated() - base) if device == "cuda" else 0
        out[b] = dict(first_s=first_s, p50_s=float(np.percentile(walls, 50)),
                      p99_s=float(np.percentile(walls, 99)), launches=launches,
                      per_query={k: v / steady for k, v in launches.items() if v},
                      peak_bytes=int(peak))
    return dict(buckets=out, captures=captures)


def serve_bit_for_bit(engine, rows) -> tuple:
    """[3k] (a): ``rows`` at bucket=None (one launch of all of them) and
    at every bucket (chunks of that many rows); the rows that differ in
    any bit of any field, per bucket. Returns (the bucket=None answers,
    {bucket: differing rows})."""
    import numpy as np

    from dgen_tpu_torch.config import ServeConfig

    ref = engine.query_rows(rows, 0)
    differ = {}
    for b in ServeConfig().buckets:
        parts = [engine.query_rows(rows[i:i + b], 0, bucket=b)
                 for i in range(0, len(rows), b)]
        got = {f: np.concatenate([p[f] for p in parts]) for f in ref}
        differ[b] = _answers_equal(got, ref)
    return ref, differ


def serve_producers(engine, rows, ref: dict, *, producers=SERVE_PRODUCERS,
                    per_producer=SERVE_PER_PRODUCER) -> dict:
    """[3k] (a): ``producers`` threads each submit ``per_producer``
    single-agent requests (agents of ``rows``, in turn) through one
    Microbatcher; every request resolves once, to its agent's row of
    ``ref`` bit for bit, and the counts balance. Returns the figures
    (sustained queries a second among them)."""
    import threading

    import numpy as np

    from dgen_tpu_torch.config import ServeConfig
    from dgen_tpu_torch.serve.batcher import Microbatcher, QueueFullError

    ids = engine.sim.host_agent_id[rows]
    n = producers * per_producer
    bat = Microbatcher(engine, ServeConfig(max_wait_ms=2.0, max_queue=n, port=0))
    futures, lock, rejected = {}, threading.Lock(), []
    gate = threading.Barrier(producers)

    def produce(t):
        gate.wait()
        for k in range(per_producer):
            req = t * per_producer + k
            while True:
                try:
                    f = bat.submit([int(ids[req % len(ids)])])
                except QueueFullError:
                    rejected.append(req)
                    time.sleep(0.001)
                    continue
                with lock:
                    if req in futures:
                        raise AssertionError(f"[3k] (a) request {req} accepted twice")
                    futures[req] = f
                break

    threads = [threading.Thread(target=produce, args=(t,)) for t in range(producers)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600.0)
    try:
        bad = 0
        for req, f in futures.items():
            got = f.result(600.0)
            j = req % len(ids)
            if int(got["agent_id"][0]) != int(ids[j]) or _answers_equal(
                    got, {k: v[j:j + 1] for k, v in ref.items()}):
                bad += 1
        wall = time.perf_counter() - t0
    finally:
        bat.close()
    stats = bat.stats()
    if len(futures) != n or stats["requests"] != n or stats["rows"] != n \
            or stats["queue_depth"] != 0 or stats["rejected"] != len(rejected):
        raise AssertionError(f"[3k] (a) the batcher lost or duplicated requests: "
                             f"{len(futures)} accepted of {n}, {stats}")
    if bad:
        raise AssertionError(f"[3k] (a) {bad} of {n} batched answers differ from "
                             "the engine's")
    return dict(requests=n, wall_s=wall, qps=n / wall, batches=stats["batches"],
                occupancy=stats["batch_occupancy"], rejected=len(rejected),
                latency_ms=stats.get("latency_ms"))


def serve_national(presets, card: str, *, name=NATIONAL, n_agents=None, device="cuda",
                   held=SERVE_HELD, steady=SERVE_STEADY, producers=SERVE_PRODUCERS,
                   per_producer=SERVE_PER_PRODUCER) -> dict:
    """[3k] (a): a ServeEngine over ``name`` at full width (2 model years);
    :func:`serve_buckets`, the share of the whole-table
    ``starting_state_kw`` in a bucket, :func:`serve_bit_for_bit` on
    ``held`` agents spread over the states, :func:`serve_producers`, an
    override that moves NPV, and no kernel-library build or load after
    warmup. Raises on any miss; returns the figures and the captures."""
    import numpy as np
    import torch

    from dgen_tpu_torch.models.simulation import starting_state_kw
    from dgen_tpu_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    sim, _, _ = presets.build(name, n_agents=n_agents, end_year=NATIONAL_END_YEAR,
                              device=device)
    engine = ServeEngine(sim)
    build_s = time.perf_counter() - t0
    rows = _spread_rows(sim, held)
    log(f"[3k] (a) ServeEngine over {name}: {engine.n_agents} agents "
        f"({sim.table.n_agents} rows), years {engine.years}, built in {build_s:.3f} s; "
        f"{held} agents spread over {len(np.unique(sim.table.state_idx.cpu().numpy()[rows]))} "
        f"states held")
    a = serve_buckets(engine, rows, device=device, steady=steady)
    warm = _library_events()
    for b, r in a["buckets"].items():
        log(f"    bucket {b}: first launch {r['first_s'] * 1e3:.3f} ms, steady p50 "
            f"{r['p50_s'] * 1e3:.3f} ms p99 {r['p99_s'] * 1e3:.3f} ms over {steady} "
            f"queries ({b / r['p50_s']:.1f} agents/s at p50); launches a query "
            f"{r['per_query']}; {r['peak_bytes'] / 2**20:.1f} MiB allocated beyond the "
            f"placed Simulation at the peak ({card})")
        if device == "cuda":
            need_launches(f"[3k] (a) bucket {b}", r["launches"],
                          ("month", "month_signed", "dispatch"))
    # the whole-table term of every bucket
    if device == "cuda":
        ms = time_ms(lambda: starting_state_kw(sim.table, sim.inputs), reps=21)
        p50 = a["buckets"][64]["p50_s"] * 1e3
        log(f"    starting_state_kw over the whole table ({sim.inputs.starting_kw.shape[0]} "
            f"groups): {ms:.4f} ms a bucket, {ms / p50:.5f} of bucket 64's p50 "
            f"{p50:.3f} ms")
        a["starting_state_kw_ms"] = ms
    ref, differ = serve_bit_for_bit(engine, rows)
    log(f"    {held} agents at bucket=None and at every bucket: rows differing in any "
        f"bit of any field {differ}")
    if any(differ.values()):
        raise AssertionError(f"[3k] (a) answers depend on the bucket: {differ}")
    p = serve_producers(engine, rows, ref, producers=producers, per_producer=per_producer)
    log(f"    Microbatcher: {producers} producers x {per_producer} single-agent "
        f"requests, none lost or duplicated, each equal to the engine's answer bit "
        f"for bit; {p['batches']} batches, occupancy {p['occupancy']}, "
        f"{p['rejected']} refused and retried; {p['qps']:.1f} queries/s sustained "
        f"over {p['wall_s']:.3f} s; latency {p['latency_ms']} ({card})")
    ovr = engine.query_rows(rows[:64], 0, inputs=engine.inputs_for(SERVE_OVERRIDE),
                            bucket=64)
    base = {k: v[:64] for k, v in ref.items()}
    if not (np.all(ovr["npv"] <= base["npv"] + 1e-6) and np.any(ovr["npv"] < base["npv"] - 1.0)):
        raise AssertionError("[3k] (a) the ITC override did not lower NPV")
    end = _library_events()
    log(f"    override {SERVE_OVERRIDE}: NPV lower for "
        f"{int((ovr['npv'] < base['npv']).sum())} of 64 agents; kernel library "
        f"builds and loads since warmup {({k: end[k] - warm[k] for k in end})}")
    if end != warm:
        raise AssertionError(f"[3k] (a) the kernel library was built or loaded after "
                             f"warmup: {warm} -> {end}")
    a.update(bit_for_bit=differ, producers=p, build_s=build_s)
    del engine, sim
    return a


def _http(port, method, path, body=None, conn=None, headers=None):
    """(status, will_close, Retry-After, payload) of one request."""
    import http.client

    c = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    blob = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
    c.request(method, path, body=blob, headers=headers or {})
    r = c.getresponse()
    raw = r.read()
    if conn is None:
        c.close()
    return r.status, r.will_close, r.getheader("Retry-After"), (json.loads(raw) if raw else None)


def serve_http(engine, card: str) -> dict:
    """[3k] (b): the HTTP server on ``engine`` (a world with quarantined
    agents): /readyz 503 before warmup and 200 after; /query rows equal
    the engine's at the batch's bucket; 400, 404, 413, 422, 503 (full
    queue, draining) and 504 where the JAX package answers them; a
    keep-alive connection survives the refusals; /metricz shows latency,
    occupancy and no kernel-library build since warmup; the drain.
    Raises on any miss; returns the figures."""
    import numpy as np

    from dgen_tpu_torch.config import ServeConfig
    from dgen_tpu_torch.serve.server import ServeApp, drain, rows_to_json, start_in_thread

    qid = engine.sim.quarantine_report.ids[0]
    ids = [int(a) for a in engine.sim.host_agent_id[_spread_rows(engine.sim, 5)]]
    app = ServeApp(engine, ServeConfig(port=0), defer_warmup=True)
    srv = start_in_thread(app)
    port = srv.server_address[1]
    seen = {}
    try:
        seen["readyz_cold"] = _http(port, "GET", "/readyz")[0]
        t0 = time.perf_counter()
        app.warmup_now()
        warm_s = time.perf_counter() - t0
        seen["readyz_warm"] = _http(port, "GET", "/readyz")[0]
        if (seen["readyz_cold"], seen["readyz_warm"]) != (503, 200):
            raise AssertionError(f"[3k] (b) /readyz {seen}")
        body = {"agent_ids": ids, "year": engine.years[1], "overrides": SERVE_OVERRIDE,
                "cash_flow": True}
        code, _, _, got = _http(port, "POST", "/query", body)
        want = rows_to_json(engine.query(ids, year=engine.years[1],
                                         overrides=SERVE_OVERRIDE, bucket=8), True)
        if code != 200 or got["results"] != want:
            raise AssertionError(f"[3k] (b) /query answered {code}, rows equal: "
                                 f"{got and got['results'] == want}")
        probes = {
            "unknown id": ({"agent_ids": [10 ** 9]}, 400),
            "non-integral id": ({"agent_ids": [ids[0] + 0.5]}, 400),
            "off-grid year": ({"agent_ids": ids[:1], "year": 1999}, 400),
            "bad override": ({"agent_ids": ids[:1], "overrides": {"set": {"nope": 1}}}, 400),
            "quarantined": ({"agent_ids": [qid]}, 422),
        }
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        for what, (b, want_code) in probes.items():
            code, closes, _, payload = _http(port, "POST", "/query", b, conn=conn)
            seen[what] = code
            if code != want_code or closes:
                raise AssertionError(f"[3k] (b) {what}: {code} {payload}")
        code, closes, _, _ = _http(port, "POST", "/queryy", b'{"agent_ids": [1]}', conn=conn)
        code2, _, _, after = _http(port, "POST", "/query", {"agent_ids": ids[:1]}, conn=conn)
        conn.close()
        if code != 404 or closes or code2 != 200 or after["results"][0]["agent_id"] != ids[0]:
            raise AssertionError(f"[3k] (b) keep-alive after refusals: {code} {code2}")
        code, closes, _, _ = _http(port, "POST", "/query", b"",
                                   headers={"Content-Length": str(2 << 20)})
        if code != 413 or not closes:
            raise AssertionError(f"[3k] (b) oversize body: {code}, closes {closes}")
        _, _, _, m = _http(port, "GET", "/metricz")
        if m["steady_state_compiles"] != 0 or not m["batches"] or \
                not 0 < m["batch_occupancy"] <= 1 or m["latency_ms"]["p50"] > m["latency_ms"]["p99"]:
            raise AssertionError(f"[3k] (b) /metricz {m}")
        _, _, _, h = _http(port, "GET", "/healthz")
        log(f"[3k] (b) HTTP on {engine.n_agents} agents (quarantined {list(engine.sim.quarantine_report.ids)}): "
            f"/readyz {seen['readyz_cold']} before warmup, {seen['readyz_warm']} after "
            f"({warm_s:.3f} s, boot {h['boot']}); /query rows equal the engine's at "
            f"bucket 8; refusals {{{', '.join(f'{k}: {v}' for k, v in seen.items() if 'readyz' not in k)}}}, "
            f"404 and 413 too, keep-alive survives them; /metricz latency "
            f"{m['latency_ms']}, occupancy {m['batch_occupancy']}, steady_state_compiles "
            f"{m['steady_state_compiles']} ({card})")
    finally:
        idle = drain(app, srv, timeout=30.0)
        srv.server_close()
    if not idle:
        raise AssertionError("[3k] (b) the drain timed out")
    # a full queue, the request deadline and the drain's refusal, on a
    # batcher whose lone request waits for company past its deadline
    cfg = ServeConfig(port=0, max_queue=1, max_wait_ms=60_000.0, request_timeout_s=1.0,
                      warmup=False)
    app = ServeApp(engine, cfg)
    srv = start_in_thread(app)
    port = srv.server_address[1]
    try:
        late = _http(port, "POST", "/query", {"agent_ids": ids[:1]})
        full = _http(port, "POST", "/query", {"agent_ids": ids[:1]})
        app.begin_drain()
        draining = _http(port, "POST", "/query", {"agent_ids": ids[:1]})
        ready = _http(port, "GET", "/readyz")
    finally:
        idle = drain(app, srv, timeout=30.0)
        srv.server_close()
    if (late[0], full[0], full[2], draining[0], ready[0]) != (504, 503, "1", 503, 503) \
            or not draining[3].get("draining") or not idle:
        raise AssertionError(f"[3k] (b) deadline/full/draining: {late} {full} {draining} "
                             f"{ready} idle {idle}")
    log(f"    a lone request past its deadline 504; the queue it holds full 503 "
        f"(Retry-After {full[2]}); draining 503 and /readyz {ready[0]}; both servers "
        f"drained")
    return dict(codes=seen, warm_s=warm_s, metricz=m)


def serve_layers(engine, workdir: str, card: str) -> dict:
    """[3k] (c): the answer surface built at SERVE_SURFACE_BUCKET over
    SERVE_SURFACE_YEARS (its wall logged), its lookups equal the engine's
    at that bucket bit for bit, a stale copy refused with its reason and
    the engine answering in its place, and the same override asked twice:
    from the engine, then from the result cache, bit for bit. Raises on
    any miss; returns the figures."""
    import os
    import shutil

    import numpy as np

    from dgen_tpu_torch.config import ServeConfig
    from dgen_tpu_torch.serve.batcher import Microbatcher
    from dgen_tpu_torch.serve.engine import ServeEngine, override_key
    from dgen_tpu_torch.serve.resultcache import ResultCache
    from dgen_tpu_torch.serve.surface import (
        AnswerSurface,
        build_surface,
        load_and_attach,
        provenance_key,
    )

    bucket = SERVE_SURFACE_BUCKET
    d = os.path.join(workdir, "surface")
    t0 = time.perf_counter()
    header = build_surface(engine, d, bucket, year_indices=SERVE_SURFACE_YEARS)
    build_s = time.perf_counter() - t0
    surf = AnswerSurface.load(d, engine)
    rows = _spread_rows(engine.sim, bucket)
    differ = {yi: _answers_equal(surf.lookup(rows, yi),
                                 engine.query_rows(rows, yi, bucket=bucket))
              for yi in SERVE_SURFACE_YEARS}
    if any(differ.values()):
        raise AssertionError(f"[3k] (c) surface lookups differ from the engine: {differ}")
    stale = os.path.join(workdir, "stale")
    shutil.copytree(d, stale)
    hpath = os.path.join(stale, "table.json")
    with open(hpath) as f:
        meta = json.load(f)
    meta["meta"]["provenance"]["config_hash"] = "0" * 12
    with open(hpath, "w") as f:
        json.dump(meta, f)
    eng = ServeEngine(engine.sim)
    reason = load_and_attach(eng, stale)
    bat = Microbatcher(eng, ServeConfig(max_wait_ms=2.0, port=0))
    try:
        ids = [int(a) for a in engine.sim.host_agent_id[rows[:2]]]
        got = bat.query(ids, year=engine.years[0], timeout=600.0)
        stats = bat.stats()
    finally:
        bat.close()
    if reason is None or "config_hash" not in reason or stats["batches"] != 1 \
            or _answers_equal(got, surf.lookup(rows[:2], 0)):
        raise AssertionError(f"[3k] (c) the stale surface: {reason} {stats}")
    eng = ServeEngine(engine.sim)
    cache = ResultCache(os.path.join(workdir, "cache"), provenance_key(eng))
    eng.attach_result_cache(cache)
    key, inputs = override_key(SERVE_OVERRIDE), eng.inputs_for(SERVE_OVERRIDE)
    first = eng.query_rows(rows, 1, inputs=inputs, bucket=bucket, key=key)
    second = eng.query_rows(rows, 1, inputs=inputs, bucket=bucket, key=key)
    cs = cache.stats()
    if cs["stores"] != 1 or cs["hits"] != 1 or _answers_equal(first, second):
        raise AssertionError(f"[3k] (c) the result cache: {cs}")
    log(f"[3k] (c) answer surface at bucket {bucket} over year indices "
        f"{list(SERVE_SURFACE_YEARS)} of {header['columns']['agent_id']['shape'][1]} rows "
        f"built in {build_s:.3f} s ({card}); lookups equal the engine's at bucket "
        f"{bucket} bit for bit; a stale copy refused ({reason}) and the engine answered "
        f"in its place; the same override twice: engine then cache, bit for bit "
        f"({ {k: cs[k] for k in ('stores', 'hits', 'misses')} })")
    return dict(build_s=build_s, refused=reason, cache=cs)


def year0_against_year_step(engine, card: str) -> dict:
    """[3k], logged: the engine's year-0 answers (bucket 64) beside the
    first ``year_step`` outputs of the same world for the same rows."""
    import numpy as np
    import torch

    sim = engine.sim
    rows = _spread_rows(sim, SERVE_HELD)
    ans = {k: [] for k in ("system_kw", "npv")}
    for i in range(0, len(rows), 64):
        out = engine.query_rows(rows[i:i + 64], 0, bucket=64)
        for k in ans:
            ans[k].append(out[k])
    with torch.no_grad():
        _, outs = sim.step(sim.init_carry(), 0, first_year=True)
    rec = {}
    for k, parts in ans.items():
        a = np.concatenate(parts)
        b = getattr(outs, k).cpu().numpy()[rows]
        rec[k] = dict(identical=int((a.view(np.uint32) == b.view(np.uint32)).sum()),
                      of=len(rows), max_abs_gap=float(np.abs(a - b).max()))
    log(f"[3k] logged: year-0 answers against the world's first year_step for the same "
        f"{len(rows)} agents: {rec} ({card})")
    return rec


@contextlib.contextmanager
def _query_banks(banks: list):
    """Inside the block, each serving query bucket appends to ``banks``
    whether it ran against the full tariff bank (no cluster's compact
    bank and row indices); the buckets run as they would."""
    from dgen_tpu_torch.serve import engine as engine_mod

    program = engine_mod.query_program

    def noted(table, profiles, tariffs, inputs, idx, year_idx, **kw):
        banks.append(kw.get("cluster_tidx") is None)
        return program(table, profiles, tariffs, inputs, idx, year_idx, **kw)

    engine_mod.query_program = noted
    try:
        yield banks
    finally:
        engine_mod.query_program = program


def serve_switch_and_clusters(presets, card: str, *, device="cuda",
                              switch_agents=SWITCH_AGENTS,
                              cluster_agents=SERVE_CLUSTER_AGENTS) -> dict:
    """[3k] (d): the rate-switch world (the pair kernel launches inside a
    bucket; its first launches kept), and the mixed twin of [3h] (c)
    clustered and unclustered: mono-cluster buckets launch the month
    kernel at the cluster's P (1 and 2 among them) and equal the
    unclustered engine's answers bit for bit by agent id; a mixed bucket
    takes the full bank. Raises on any miss; returns the figures and the
    rate-switch bucket's captures."""
    import numpy as np

    from dgen_tpu_torch.models import synth
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.serve.engine import ServeEngine

    sw, _, _ = presets.build("ercot-all-sector", n_agents=switch_agents,
                             end_year=SWITCH_END_YEAR, rate_switch_frac=0.4, device=device)
    if not sw._rate_switch:
        raise AssertionError("[3k] (d) the rate-switch world has no switch")
    eng = ServeEngine(sw)
    eng.warmup([64])
    capture = {}
    _reset_counts()
    bk.CAPTURE = capture
    try:
        with first_dispatch(capture):
            eng.query_rows(_spread_rows(sw, 64), 0, bucket=64)
    finally:
        bk.CAPTURE = None
    switch_launches = _launch_counts()
    if device == "cuda":
        need_launches("[3k] (d) rate-switch bucket", switch_launches,
                      ("month_pair", "dispatch"))
    del eng, sw

    pop = synth.generate_world(synth.NationalSpec(
        n_agents=cluster_agents, tariff_mix="mixed", seed=MIXED_SEED), device=device)
    sims = {c: mixed_sim(pop, dict(cluster_tariffs=c), end_year=CHUNK_END_YEAR,
                         device=device, agent_chunk=0) for c in (True, False)}
    engines = {c: ServeEngine(s) for c, s in sims.items()}
    layout = sims[True]._cluster_layout
    ids_of = sims[True].host_agent_id
    real = sims[True].host_mask > 0
    cid = layout.cluster_of_rows()
    by_p, mono = {}, {}
    for ci, spec in enumerate(layout.clusters):
        rows = np.flatnonzero((cid == ci) & real)
        if len(rows) >= 16 and spec.n_periods not in mono:
            mono[spec.n_periods] = rows[:16].astype(np.int32)
    if not {1, 2} <= set(mono):
        raise AssertionError(f"[3k] (d) no single- and two-period clusters: {sorted(mono)}")
    differ, banks = {}, []

    def routed(rows):
        """The clustered engine's answers for ``rows`` (bucket 16), noting
        whether the bucket ran against the full bank."""
        with _query_banks(banks):
            return engines[True].query_rows(rows, 0, bucket=16)

    for p, rows in sorted(mono.items()):
        counts = {}
        with count_by_p(counts):
            got = routed(rows)
        want = engines[False].query(ids_of[rows].tolist(), bucket=16)
        differ[p] = _answers_equal(got, want)
        by_p[p] = counts
        if banks[-1] or (device == "cuda" and counts.get(f"month@P{p}", 0) == 0) or any(
                k.startswith("month") and not k.endswith(f"@P{p}") for k in counts):
            raise AssertionError(f"[3k] (d) a P = {p} cluster's bucket launched {counts}, "
                                 f"full bank {banks[-1]}")
    ps = sorted(mono)
    mixed_rows = np.concatenate([mono[1][:8], mono[2][:8]])
    counts = {}
    with count_by_p(counts):
        got = routed(mixed_rows)
    want = engines[False].query(ids_of[mixed_rows].tolist(), bucket=16)
    full_p = sims[True].tariffs.max_periods
    if not banks[-1] or (device == "cuda" and not counts.get(f"month@P{full_p}")) \
            or _answers_equal(got, want):
        raise AssertionError(f"[3k] (d) the mixed bucket launched {counts}, full bank "
                             f"{banks[-1]}")
    if any(differ.values()):
        raise AssertionError(f"[3k] (d) clustered answers differ from unclustered: {differ}")
    log(f"[3k] (d) rate-switch world ({switch_agents} agents): one bucket of 64 launched "
        f"{ {k: v for k, v in switch_launches.items() if v} }; mixed twin "
        f"({cluster_agents} agents, {layout.n_clusters} clusters): mono-cluster buckets "
        f"at P {ps} launched {by_p} on their clusters' banks and equal the unclustered "
        f"engine's answers bit for bit (rows differing {differ}); a mixed bucket "
        f"launched {counts} on the full bank (P = {full_p}) and equals too ({card})")
    return dict(switch_launches=switch_launches, switch_capture=capture, by_p=by_p,
                mixed=counts)


def serving(presets, card: str, *, device="cuda", national=None, main_agents=MAIN_AGENTS,
            switch_agents=SWITCH_AGENTS, cluster_agents=SERVE_CLUSTER_AGENTS) -> dict:
    """[3k]: (a) :func:`serve_national`, (b) :func:`serve_http` and (c)
    :func:`serve_layers` on the main path's world with ingest_corrupt_row
    injected, the logged year-0 comparison, and (d)
    :func:`serve_switch_and_clusters`; logs the phase's wall. ``national``:
    keywords of (a) (the CPU rehearsal's sizes). Returns the serve paths'
    launches and first-launch operands for the kernels line."""
    import tempfile

    from dgen_tpu_torch.resilience import faults
    from dgen_tpu_torch.serve.engine import ServeEngine

    import torch

    t0 = time.perf_counter()
    a = serve_national(presets, card, device=device, **(national or {}))
    if device == "cuda":
        torch.cuda.empty_cache()
    with faults.injected("ingest_corrupt_row@1:corrupt"):
        sim, _, _ = presets.build("ercot-all-sector", n_agents=main_agents,
                                  end_year=MAIN_END_YEAR, device=device)
    engine = ServeEngine(sim)
    b = serve_http(engine, card)
    with tempfile.TemporaryDirectory() as work:
        c = serve_layers(engine, work, card)
    y0 = year0_against_year_step(engine, card)
    del engine, sim
    d = serve_switch_and_clusters(presets, card, device=device,
                                  switch_agents=switch_agents,
                                  cluster_agents=cluster_agents)
    wall = time.perf_counter() - t0
    log(f"[3k] the serving stack (a)-(d): {wall:.3f} s ({card})")
    runs = {}
    for bucket in (1, 64):
        runs[f"serve{bucket}"] = dict(launches=a["buckets"][bucket]["launches"],
                                      capture=a["captures"][bucket])
    runs["serve_switch"] = dict(launches=d["switch_launches"], capture=d["switch_capture"])
    return dict(runs=runs, a=a, b=b, c=c, d=d, year0=y0, wall=wall)


#: [3l]: the serving fleet. (a) FLEET_REPLICAS replicas of the serve CLI's
#: synthetic population at national width (each its own CUDA context,
#: table and banks on the one card), one killed and one hung under
#: closed-loop load; (b) the layers round and (c) the scale drill on
#: FLEET_SMALL_AGENTS (the surface's build wall scales with the rows)
FLEET_AGENTS = 1_048_576
FLEET_SMALL_AGENTS = 8192
FLEET_REPLICAS = 2
FLEET_BUCKET = 8
FLEET_REQUESTS = 80
FLEET_CLIENTS = 4
FLEET_STEADY = 400
#: the surface of (b) and (c): year 0 (every zero-override plan of the
#: drill's load asks year 0) at [3k] (c)'s bucket
FLEET_SURFACE = dict(surface_bucket=64, surface_years=[0])
#: the single-process batcher's queries/s in [3k] (a) on the same card
#: (PERF.md §5), logged beside the fleet's
FLEET_SINGLE_QPS = 1428.1


def _gib(n) -> str:
    return "not measured" if n is None else f"{n / 2**30:.2f} GiB"


def _fleet_gate(tag: str, rec: dict, device: str) -> None:
    """Raise unless the drill record ``rec`` passed, naming what missed; on
    the card every replica must have launched the kernels."""
    if not rec["ok"]:
        keys = ("answered", "mismatches", "client_failures", "recovered_full_strength",
                "steady_state_compiles", "kill", "hang", "breakers", "latency_s",
                "layers", "steady", "replica_logs_tail")
        raise AssertionError(f"{tag} the fleet drill failed: "
                             f"{ {k: rec.get(k) for k in keys} }")
    if device == "cuda":
        for i, launches in rec["replica_kernel_launches"].items():
            if not all((launches or {}).get(k) for k in ("month", "month_signed",
                                                           "dispatch")):
                raise AssertionError(f"{tag} replica {i} launched no kernel: {launches}")


def _fleet_lines(tag: str, rec: dict, card: str) -> None:
    free = rec["card_free_bytes"]
    per = (None if free["before_spawn"] is None or free["all_up"] is None
           else (free["before_spawn"] - free["all_up"]) / rec["replicas"])
    log(f"    {rec['replicas']} replicas x {rec['agents']} agents, bucket "
        f"{rec['bucket']} ({max(rec['bucket'], 16)} rows launched); boot walls "
        f"(spawn to READY) {rec['boot_wall_s']} s; kill {rec['kill']['spec']}: exit 77 "
        f"{rec['kill']['exit_77_seen']}, recovered in {rec['kill']['recovery_s']} s, the "
        f"restart's boot wall {rec['kill']['restart_boot_wall_s']} s, its boot report "
        f"{rec['kill']['restart_boot']}; hang {rec['hang']}; breakers {rec['breakers']}")
    log(f"    card free: before the spawn {_gib(free['before_spawn'])}, every replica up "
        f"{_gib(free['all_up'])} ({_gib(per)} a replica), once the killed replica's exit "
        f"was seen {_gib(free['after_kill'])}, recovered {_gib(free['recovered'])}")
    lat = rec["latency_s"]
    log(f"    {rec['answered']} of {rec['requests']} answered, each equal to the oracle "
        f"bit for bit (mismatches {rec['mismatches']}), 503 retries "
        f"{rec['retries_503']}; client p50 {lat['p50']} s, p99 {lat['p99']} s (bound "
        f"{lat['p99_bound_s']}), {rec['qps_through_faults']} queries/s through the "
        f"kill and the hang; front {rec['front']}; builds and loads since warmup "
        f"{rec['steady_state_compiles']}; the replicas' kernel launches "
        f"{rec['replica_kernel_launches']} ({card})")
    if rec.get("steady"):
        st = rec["steady"]
        log(f"    healed fleet: {st['answered']} of {st['requests']} requests, "
            f"{FLEET_CLIENTS} closed-loop clients through the front, {st['qps']} "
            f"queries/s over {st['wall_s']} s ([3k] (a)'s single-process batcher: "
            f"{FLEET_SINGLE_QPS}), latency {st['latency_s']} s, mismatches "
            f"{st['unchecked']} ({card})")
    if rec.get("layers"):
        log(f"    layers: surface built in {rec['surface_build_s']} s; {rec['layers']}")


def serving_fleet(card: str, *, device="cuda", agents=FLEET_AGENTS,
                  small_agents=FLEET_SMALL_AGENTS, requests=FLEET_REQUESTS,
                  steady=FLEET_STEADY, drill_kw=None) -> dict:
    """[3l]: (a) ``run_fleet_drill`` at ``agents`` with the kill and the hang,
    then ``steady`` requests through the healed fleet, the in-process
    oracle's launches counted under the ``fleet`` path (its first launches
    kept); (b) the layers round and (c) ``run_scale_drill`` at
    ``small_agents``. The card's memory is released and logged before the
    spawn. ``drill_kw``: settings laid over the fleet drills' (the CPU
    rehearsal's timeouts). Raises on any miss; returns the fleet path's
    launches and captures and the records."""
    import gc

    import torch

    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.resilience.fleetdrill import run_fleet_drill, run_scale_drill

    drill_kw = dict(drill_kw or {})
    t0 = time.perf_counter()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        log(f"[3l] the serving fleet: card free {free / 2**30:.2f} of "
            f"{total / 2**30:.2f} GiB before the spawn, this process's allocator "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved ({card})")
    capture = {}
    _reset_counts()
    bk.CAPTURE = capture
    try:
        with first_dispatch(capture):
            a = run_fleet_drill(replicas=FLEET_REPLICAS, agents=agents,
                                requests=requests, clients=FLEET_CLIENTS,
                                bucket=FLEET_BUCKET, steady_requests=steady,
                                device=device, **drill_kw)
    finally:
        bk.CAPTURE = None
        launches = _launch_counts()
    log(f"[3l] (a) run_fleet_drill: the oracle (an in-process ServeEngine) warmed in "
        f"{a['oracle_warmup_s']} s; drill wall {a['drill_wall_s']} s; the oracle's "
        f"launches (the fleet path) {({k: v for k, v in launches.items() if v})}")
    _fleet_lines("[3l] (a)", a, card)
    _fleet_gate("[3l] (a)", a, device)
    if device == "cuda":
        need_launches("[3l] (a) the fleet oracle", launches,
                      ("month", "month_signed", "dispatch"))
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    b = run_fleet_drill(replicas=FLEET_REPLICAS, agents=small_agents, requests=requests,
                        clients=FLEET_CLIENTS, bucket=FLEET_BUCKET, layers=True,
                        device=device, **FLEET_SURFACE, **drill_kw)
    log(f"[3l] (b) run_fleet_drill(layers=True) at {small_agents} agents: drill wall "
        f"{b['drill_wall_s']} s")
    _fleet_lines("[3l] (b)", b, card)
    _fleet_gate("[3l] (b)", b, device)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    c = run_scale_drill(agents=small_agents, bucket=FLEET_BUCKET, device=device,
                        **FLEET_SURFACE)
    log(f"[3l] (c) run_scale_drill at {small_agents} agents: ok {c['ok']}; 1 -> 2 -> 1 "
        f"(ups {c['scale_ups']}, downs {c['scale_downs']}; the added replica's boot "
        f"wall {c['scale_up_boot_wall_s']} s; the retired one's exit codes "
        f"{c['retired_exit_codes']}); the cached answer byte-identical "
        f"{c['cache_answer_byte_identical']}, result cache {c['result_cache']}; "
        f"ledger {[e['event'] for e in c['supervisor_events']]}; drill wall "
        f"{c['drill_wall_s']} s ({card})")
    if not c["ok"]:
        raise AssertionError(f"[3l] (c) the scale drill failed: {c}")
    wall = time.perf_counter() - t0
    log(f"[3l] the serving fleet (a)-(c): {wall:.3f} s ({card})")
    return dict(launches=launches, capture=capture, a=a, b=b, c=c, wall=wall)


# ---------------------------------------------------------------------------
# [3m]: reference-format inputs on the card
# ---------------------------------------------------------------------------

#: the committed reference-format input root (written by its generator,
#: tests/torch_fixtures/reference_inputs/make_reference_inputs.py)
INPUT_ROOT = ("tests", "torch_fixtures", "reference_inputs", "dgen_os", "input_data")
#: (a): what the ingest must read from the root, not default
INGESTED = {"data_sources": ("itc", "nem_caps"), "market_curves": ("mms", "bass")}
#: (b): the rows of the national run's first launches kept for [9]'s rows
#: (a chunk's first rows: a whole chunk's streams would stay pinned)
INGEST_CAPTURE_ROWS = MAIN_AGENTS
#: (c): the ingested preset on the card against the CPU
INGEST_SMALL_AGENTS = 512
INGEST_SMALL_END_YEAR = 2018      # 3 model years
#: (c): per-agent fields held at tests/test_torch_slice.py's bounds (rtol
#: 1e-3, atol 1e-4 x the field's largest magnitude)
INGEST_AGENT_FIELDS = ("system_kw", "npv", "first_year_bill_with_system",
                       "first_year_bill_without_system")
INGEST_AGENT_RTOL = 1e-3
INGEST_AGENT_ATOL_FRAC = 1e-4
#: (d): battery allocation in a tariff-clustered world, per agent
BATT_FIELDS = ("new_batt_adopters", "batt_adopters_cum", "batt_kwh_cum",
               "number_of_adopters")


def input_root() -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), *INPUT_ROOT)


@contextlib.contextmanager
def blocked_modules(names=("pandas", "pyarrow", "jax", "jaxlib", "dgen_tpu")):
    """Inside the block, importing any of ``names`` raises ImportError;
    raises at once if one of them is already loaded."""
    loaded = [n for n in names if sys.modules.get(n) is not None]
    if loaded:
        raise AssertionError(f"[3m] already loaded: {loaded}")
    saved = {n: sys.modules[n] for n in names if n in sys.modules}
    for n in names:
        sys.modules[n] = None
    try:
        yield
    finally:
        for n in names:
            sys.modules.pop(n, None)
        sys.modules.update(saved)


def ingest_on_card(root: str, card: str, device="cuda") -> dict:
    """[3m] (a): ``scenario_inputs_from_reference`` (national-all-sector's
    configuration and preference) and ``wholesale_profile_bank`` on the
    committed root, onto the card, with pandas, pyarrow, jax and the JAX
    package unimportable; logs the wall, the files and the provenance and
    raises unless every source in INGESTED reads ``ingested``."""
    import os

    from dgen_tpu_torch.config import ScenarioConfig
    from dgen_tpu_torch.io import synth
    from dgen_tpu_torch.presets import PRESETS

    p = PRESETS[NATIONAL]
    cfg = ScenarioConfig(name=p.name, start_year=p.start_year, end_year=p.end_year,
                         storage_enabled=p.storage_enabled, anchor_years=())
    with blocked_modules():
        from dgen_tpu_torch.io import reference_inputs

        t0 = time.perf_counter()
        inputs, meta = reference_inputs.scenario_inputs_from_reference(
            root, cfg, list(synth.STATES), prefer={"load_growth": p.load_growth_scenario},
            device=device)
        _sync(device)
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bank = reference_inputs.wholesale_profile_bank(meta, root)
        bank_s = time.perf_counter() - t0
    files = {k: os.path.basename(v) for k, v in meta["files"].items()}
    log(f"[3m] (a) ingest of the committed input root on the card, pandas, pyarrow, "
        f"jax and the JAX package unimportable: scenario_inputs_from_reference "
        f"{ingest_s:.4f} s ({len(cfg.model_years)} model years, {len(meta['regions'])} "
        f"regions), wholesale_profile_bank {bank_s:.4f} s {list(bank.shape)}; files "
        f"{files}; data_sources {meta['data_sources']}; market_curves "
        f"{meta['market_curves']} ({card})")
    off = {f"{k}.{s}": meta[k][s] for k, srcs in INGESTED.items() for s in srcs
           if meta[k][s] != "ingested"}
    if off:
        raise AssertionError(f"[3m] (a) not ingested: {off}")
    if inputs.nem_cap_kw.device.type != device:
        raise AssertionError(f"[3m] (a) the ingested inputs are not on {device}")
    return dict(ingest_s=ingest_s, bank_s=bank_s, files=files)


def ingested_national(presets, root: str, card: str, single_rate=None, *,
                      n_agents=None, device="cuda") -> dict:
    """[3m] (b): national-all-sector on the committed root at its full width
    for NATIONAL_END_YEAR's model years under the automatic chunk,
    collect=False; the national sums, the battery adopters allocated and
    the real agents whose state's NEM cap closed in year 2 (the year
    step's gate on year 1's installed kW) reduced on the card each year.
    Raises unless the world is the ingested one, every sum is finite,
    batteries are allocated in every year, an agent is capped in year 2
    and the kernels launched as [3d] counts them; one more first year
    holds the first launches against the plain versions (:func:`held_year`).
    Returns the run's launch counts, its first launches (cut to
    INGEST_CAPTURE_ROWS rows) and its figures."""
    import torch

    from dgen_tpu_torch.models.market import segment_sum
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops import dispatch

    cuda = device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    sim, _, meta = presets.build(NATIONAL, n_agents=n_agents, end_year=NATIONAL_END_YEAR,
                                 device=device, input_root=root)
    _sync(device)
    build_s = time.perf_counter() - t_start
    k = n_chunks(sim)
    n_real = int(sim.host_mask.sum())
    srcs = {**meta["data_sources"], **meta["market_curves"]}
    log(f"[3m] (b) {NATIONAL} on the input root at {n_real} agents, {len(sim.years)} "
        f"model years {sim.years}: {sim.table.n_agents} rows, auto chunk "
        f"{sim._agent_chunk} ({k} chunks), {sim.profiles.wholesale.shape[0]} regions, "
        f"net billing {sim._net_billing}; built in {build_s:.3f} s; sources {srcs}")
    if set(srcs.values()) != {"ingested"} or sim.profiles.wholesale.shape[0] != 9:
        raise AssertionError(f"[3m] (b) the run is not on the ingested world: {srcs}")
    mask, table, inputs = sim.table.mask, sim.table, sim.inputs
    sums = []

    def national(year, yi, outs):
        sh = outs.state_hourly_net_mw
        row = [(outs.number_of_adopters * mask).sum(), (outs.system_kw_cum * mask).sum(),
               (outs.batt_kwh_cum * mask).sum(), (outs.new_batt_adopters * mask).sum(),
               sh.sum(), torch.isfinite(sh).all().float()]
        if yi + 1 < len(sim.years):
            state_kw = segment_sum(outs.system_kw_cum, table.state_idx.long(),
                                   table.n_states)
            closed = (state_kw >= inputs.nem_cap_kw[yi + 1])[table.state_idx.long()]
            row.append((closed.float() * mask).sum())
        sums.append((year, torch.stack(row).cpu().tolist()))

    capture = bk.RowSliceCapture(INGEST_CAPTURE_ROWS)
    bk.CAPTURE = capture
    bk.reset_launches()
    dispatch.reset_launches()
    try:
        with first_dispatch(capture):
            rec = presets.timed_run(sim, meta, t_start, build_s, callback=national)
    finally:
        bk.CAPTURE = None
        launches = {**bk.LAUNCHES, **dispatch.LAUNCHES}
    ys = rec["year_s"]
    rate = n_real * len(ys) / sum(ys)
    log(f"    per-year s {ys}, {rate:.1f} agent-years/s over the run's years"
        + (f" (the synthetic world's [3d] run: {single_rate:.1f})" if single_rate else "")
        + f"; launches {launches} ({per_year(launches, len(ys))} a year); peak "
        f"allocated {torch.cuda.max_memory_allocated() / 2**30 if cuda else 0:.2f} GiB; "
        f"health {sim.health_report} ({card})")
    log(f"    national sums a year (adopters, system kW, battery kWh, battery adopters "
        f"allocated, state-hourly MW sum, state-hourly all finite, real agents whose "
        f"state's NEM cap is closed the next year): {sums}")
    for year, row in sums:
        if not all(math.isfinite(v) for v in row) or row[5] != 1.0:
            raise AssertionError(f"[3m] (b) non-finite national sums in {year}: {row}")
        if not row[3] > 0:
            raise AssertionError(f"[3m] (b) no battery adopters allocated in {year}")
    if not sums[0][1][6] > 0:
        raise AssertionError("[3m] (b) no agent's NEM cap closes in the second year")
    if not sim.health_report["clean"]:
        raise AssertionError(f"[3m] (b) health breaches: {sim.health_report}")
    if cuda:
        if launches["dispatch"] != dispatch_per_year(sim) * len(ys):
            raise AssertionError(f"[3m] (b) {launches['dispatch']} dispatch launches")
        need_launches("[3m] (b)", launches, ("month", "month_signed", "dispatch"))
        held_year(sim, "3m", launches)
        del sim
        torch.cuda.empty_cache()
    return dict(launches=launches, capture=dict(capture), year_s=ys, rate=rate,
                sums=sums, build_s=build_s)


def ingested_card_vs_cpu(presets, RunConfig, root: str, card: str, *,
                         n_agents=INGEST_SMALL_AGENTS, device="cuda") -> dict:
    """[3m] (c): national-all-sector on the committed root at
    INGEST_SMALL_AGENTS for 3 model years on the card and on the CPU (the
    plain versions), ``sizing_iters=4``: the national curves within
    CURVE_RTOL, the integer battery adopters equal per agent (the golden
    contract of [3e]), INGEST_AGENT_FIELDS per agent at
    tests/test_torch_slice.py's bounds. Raises on a miss."""
    import numpy as np

    out = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        sim, _, _ = presets.build(NATIONAL, n_agents=n_agents, device=dev,
                                  end_year=INGEST_SMALL_END_YEAR, input_root=root,
                                  run_config=RunConfig(sizing_iters=4))
        res = sim.run()
        out[dev] = (sim, res, time.perf_counter() - t0)
    (g_sim, g_res, g_s), (c_sim, c_res, c_s) = out[device], out["cpu"]
    mask = c_sim.host_mask
    gc_, cc = g_res.summary(mask), c_res.summary(mask)
    for key in ("adopters", "system_kw_cum", "batt_kwh_cum", "new_adopters"):
        np.testing.assert_allclose(gc_[key], cc[key], rtol=CURVE_RTOL,
                                   err_msg=f"[3m] (c) card vs CPU {key}")
    units = g_res.agent["new_batt_adopters"]
    if not np.array_equal(units, c_res.agent["new_batt_adopters"]):
        raise AssertionError("[3m] (c) battery adopters differ between the card and "
                             "the CPU")
    gaps = {}
    for f in INGEST_AGENT_FIELDS:
        ref = c_res.agent[f]
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(g_res.agent[f], ref, rtol=INGEST_AGENT_RTOL,
                                   atol=INGEST_AGENT_ATOL_FRAC * scale,
                                   err_msg=f"[3m] (c) card vs CPU {f}")
        gaps[f] = float(np.max(np.abs(g_res.agent[f] - ref)))
    log(f"[3m] (c) {NATIONAL} on the input root at {n_agents} agents x "
        f"{len(c_res.years)} years, card {g_s:.3f} s vs CPU {c_s:.3f} s: curves within "
        f"rtol {CURVE_RTOL} (adopters {gc_['adopters'].tolist()} vs "
        f"{cc['adopters'].tolist()}), battery adopters equal per agent "
        f"({units.sum(axis=1).tolist()} a year), {INGEST_AGENT_FIELDS} per agent within "
        f"rtol {INGEST_AGENT_RTOL} / atol {INGEST_AGENT_ATOL_FRAC} x max|CPU| "
        f"(largest absolute gaps {gaps}) ({card})")
    return dict(card_s=g_s, cpu_s=c_s, gaps=gaps)


def clustered_batteries(card: str, *, n_agents=MIXED_CHUNK_AGENTS, device="cuda",
                        attachment_rate=CHUNK_ATTACHMENT, econ_years: int = 25) -> dict:
    """[3m] (d): a mixed world of ``n_agents`` (``NationalSpec(tariff_mix=
    "mixed", seed=MIXED_SEED)``) run clustered and unclustered for
    CHUNK_END_YEAR's model years with every group's battery attachment
    rate at ``attachment_rate``: BATT_FIELDS per agent by agent_id. Raises
    if a battery unit moves between the layouts or no battery is
    allocated; returns the count of differing values a field."""
    import numpy as np

    from dgen_tpu_torch.models import synth

    pop = synth.generate_world(synth.NationalSpec(
        n_agents=n_agents, tariff_mix="mixed", seed=MIXED_SEED), device=device)
    runs = {}
    for tag, cluster in (("clustered", True), ("unclustered", False)):
        sim = mixed_sim(pop, dict(cluster_tariffs=cluster), end_year=CHUNK_END_YEAR,
                        device=device, econ_years=econ_years,
                        attachment_rate=attachment_rate)
        res, _, secs = counted_run(sim)
        check_outputs(res, sim)
        runs[tag] = keyed_years(sim, res, BATT_FIELDS)
        log(f"[3m] (d) mixed world of {int(sim.host_mask.sum())} agents, {tag}, "
            f"attachment rate {attachment_rate}: {sim.table.n_agents} rows, per-year s "
            f"{[round(t, 3) for t in secs]}, battery adopters a year "
            f"{runs[tag]['new_batt_adopters'].sum(axis=1).tolist()}")
    kc, ku = runs["clustered"], runs["unclustered"]
    if not np.array_equal(kc["ids"], ku["ids"]):
        raise AssertionError("[3m] (d) the two layouts hold other agents")
    differ = {f: int((kc[f] != ku[f]).sum()) for f in BATT_FIELDS}
    gaps = {f: float(np.max(np.abs(kc[f].astype(np.float64) - ku[f]))) for f in BATT_FIELDS}
    log(f"    [3m] (d) clustered vs unclustered per agent by agent_id over "
        f"{len(kc['ids'])} agents: values that differ {differ}, largest absolute gaps "
        f"{gaps} ({card})")
    if not kc["new_batt_adopters"].sum() > 0:
        raise AssertionError("[3m] (d) no battery adopters allocated")
    if differ["new_batt_adopters"] or differ["batt_adopters_cum"]:
        raise AssertionError(f"[3m] (d) battery units move with the cluster layout: "
                             f"{differ}")
    return dict(differ=differ, gaps=gaps)


def reference_inputs_phase(presets, RunConfig, card: str, single_rate=None, *,
                           device="cuda", national_agents=None,
                           small_agents=INGEST_SMALL_AGENTS,
                           mixed_agents=MIXED_CHUNK_AGENTS) -> dict:
    """[3m]: reference-format inputs on the card, (a)-(d) on the committed
    input root; logs the phase's wall. Returns (b)'s launches and first
    launches (the ``ingest`` path) and the records. The sizes are the
    phase's own unless given (a CPU rehearsal's)."""
    import torch

    t0 = time.perf_counter()
    root = input_root()
    a = ingest_on_card(root, card, device=device)
    b = ingested_national(presets, root, card, single_rate, n_agents=national_agents,
                          device=device)
    c = ingested_card_vs_cpu(presets, RunConfig, root, card, n_agents=small_agents,
                             device=device)
    if device == "cuda":
        torch.cuda.empty_cache()
    d = clustered_batteries(card, n_agents=mixed_agents, device=device)
    if device == "cuda":
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"[3m] reference-format inputs (a)-(d): {wall:.3f} s ({card})")
    return dict(launches=b.pop("launches"), capture=b.pop("capture"), a=a, b=b, c=c,
                d=d, wall=wall)


# ---------------------------------------------------------------------------
# [3n]: the multi-rank run
# ---------------------------------------------------------------------------

#: (a): a world of one rank over NCCL against the plain Simulation
RANKS_SMALL_AGENTS = 32_768
#: (b): each of the two ranks' hand-set chunk, two ranks sharing one card
#: (the footprint model, which over-counts ~1.6x, sizes a 1,048,576-agent
#: run's chunk at 87,424 rows for a whole 80 GB card; a rank has half)
RANKS_CHUNK = 32_768
#: (b) runs [3d]'s first model year only since [3o] (a) holds two ranks
#: sharing the card against both of [3d]'s years (a depth cut for time)
RANKS_SHARED_END_YEAR = 2014
#: what [3d]'s kept dict holds beside the per-agent outputs
NATIONAL_KEPT_META = ("agent_id", "mask", "years", "first_year_s")
#: (c): the run outputs and the 2 -> 1 resume
RANKS_OUTPUT_AGENTS = 131_072
RANKS_OUTPUT_CHUNK = 16_384
RANKS_RESUME_YEAR = 2014
#: (a), (c): batteries allocated
RANKS_ATTACH = 0.4
#: the rows of rank 0's first launches kept for [9]'s rows
RANKS_CAPTURE_ROWS = MAIN_AGENTS
#: seconds a rank process may take
RANKS_TIMEOUT_S = 300
#: the JAX package's per-agent bound for a sharded run
#: (tests/test_simulation.py:90), and for the state-hourly aggregate
RANKS_RTOL, RANKS_ATOL = 5e-4, 1e-3
RANKS_HOURLY_RTOL, RANKS_HOURLY_ATOL = 5e-4, 1e-4
#: carry leaves and the YearOutputs field each equals after a year
CARRY_FIELDS = {"market.adopters_cum": "number_of_adopters",
                "market.system_kw_cum": "system_kw_cum",
                "market.batt_kw_cum": "batt_kw_cum",
                "market.batt_kwh_cum": "batt_kwh_cum",
                "market.market_share": "market_share",
                "market.max_market_share": "max_market_share",
                "market.market_value": "market_value",
                "batt_adopters_cum": "batt_adopters_cum"}


def free_card(device) -> None:
    """Release the card's cached blocks (for the rank processes that share
    it); no-op off a card."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def spawn_ranks(tag: str, work: str, world: int, args: list, env_extra=None,
                rank_args=None, module="dgen_tpu_torch.parallel.launch",
                argv=()) -> list:
    """``world`` processes of the port's rank entry point (``python -m
    dgen_tpu_torch.parallel.launch``, or ``module``) on a localhost
    rendezvous (``parallel.launch.spawn_local_ranks``), ``args`` (and
    ``argv``) their arguments and ``rank_args[r]`` rank r's own; returns
    each rank's JSON record. A rank that fails, or outlives
    RANKS_TIMEOUT_S, fails the phase: every rank is then stopped and the
    failed one's log tail raised."""
    import os

    from dgen_tpu_torch.parallel.launch import spawn_local_ranks

    phase = "[3n]" if module.endswith("launch") else "[3o]"
    try:
        recs = spawn_local_ranks([sys.executable, "-m", module, *args, *argv], world, work,
                                 cwd=os.path.dirname(os.path.abspath(__file__)),
                                 env=env_extra, rank_args=rank_args,
                                 timeout_s=RANKS_TIMEOUT_S)
    except RuntimeError as e:
        raise AssertionError(f"{phase} {tag}: {e}") from None
    for rec in recs:
        if rec["imports_jax"] or rec["imports_dgen_tpu"]:
            raise AssertionError(f"{phase} {tag}: rank {rec['rank']} imported jax")
    return recs


def ranks_by_id(paths) -> dict:
    """The ranks' collected outputs (``--collect``) sorted by agent id."""
    import numpy as np

    from dgen_tpu_torch.parallel.launch import COLLECT_FIELDS

    parts = [np.load(p) for p in paths]
    ids = np.concatenate([p["agent_id"] for p in parts])
    o = np.argsort(ids, kind="stable")
    out = {"agent_id": ids[o], "years": parts[0]["years"]}
    for f in COLLECT_FIELDS:
        out[f] = np.concatenate([p[f] for p in parts], axis=1)[:, o]
    if "state_hourly_net_mw" in parts[0].files:
        out["state_hourly_net_mw"] = parts[0]["state_hourly_net_mw"]
    return out


def sim_by_id(res_agent: dict, host_agent_id, host_mask) -> dict:
    """A run's per-agent outputs ([years, N] host arrays) over its real
    agents, sorted by agent id."""
    import numpy as np

    from dgen_tpu_torch.parallel.launch import COLLECT_FIELDS

    keep = np.asarray(host_mask) > 0
    ids = np.asarray(host_agent_id)[keep].astype(np.int64)
    o = np.argsort(ids, kind="stable")
    return {"agent_id": ids[o], **{f: np.asarray(res_agent[f])[:, keep][:, o]
                                   for f in COLLECT_FIELDS if f in res_agent}}


def ranks_parity(tag: str, got: dict, want: dict, bit_for_bit: bool = False) -> int:
    """Per-agent parity by agent id at the JAX package's sharded bound
    (or bit for bit), battery units equal; returns the count of values
    that are not bit-equal. Raises on a miss."""
    import numpy as np

    from dgen_tpu_torch.parallel.launch import COLLECT_FIELDS

    if not np.array_equal(got["agent_id"], want["agent_id"]):
        raise AssertionError(f"[3n] {tag}: the ranks' agents are not the run's")
    for f in ("new_batt_adopters", "batt_adopters_cum"):
        if not np.array_equal(got[f], want[f]):
            raise AssertionError(f"[3n] {tag}: a battery unit moved ({f})")
    differ = 0
    for f in COLLECT_FIELDS:
        a, b = np.asarray(got[f]), np.asarray(want[f])
        if a.shape != b.shape:
            raise AssertionError(f"[3n] {tag}: {f} {a.shape} against {b.shape}")
        n = int((a.view(np.uint32) != b.view(np.uint32)).sum())
        differ += n
        if bit_for_bit and n:
            raise AssertionError(f"[3n] {tag}: {n} values of {f} not bit-equal")
        if not np.allclose(a, b, rtol=RANKS_RTOL, atol=RANKS_ATOL):
            worst = float(np.max(np.abs(a - b)))
            raise AssertionError(f"[3n] {tag}: {f} outside rtol {RANKS_RTOL} atol "
                                 f"{RANKS_ATOL} (largest gap {worst})")
    return differ


def ranks_one_nccl(presets, work: str, card: str, *, n_agents=RANKS_SMALL_AGENTS,
                   device="cuda") -> dict:
    """[3n] (a): a world of one rank over NCCL (national-all-sector at
    RANKS_SMALL_AGENTS, 2 years, batteries allocated) against the plain
    Simulation in this process, per agent bit for bit: with one rank the
    year step runs no collective."""
    import os

    import torch

    t0 = time.perf_counter()
    out = os.path.join(work, "a.npz")
    (rec,) = spawn_ranks("(a)", os.path.join(work, "a"), 1, [
        "--preset", NATIONAL, "--agents", str(n_agents), "--device", device,
        "--end-year", str(NATIONAL_END_YEAR), "--attachment-rate", str(RANKS_ATTACH),
        "--no-export", "--no-checkpoint", "--collect", out])
    backend = "nccl" if device == "cuda" else "gloo"
    if rec["backend"] != backend:
        raise AssertionError(f"[3n] (a) a world of one rank on a device of its own "
                             f"took {rec['backend']}, not {backend}")
    sim, _, _ = presets.build(NATIONAL, n_agents=n_agents,
                              end_year=NATIONAL_END_YEAR, attachment_rate=RANKS_ATTACH,
                              device=device)
    res = sim.run()
    differ = ranks_parity("(a)", ranks_by_id([out]),
                          sim_by_id(res.agent, sim.host_agent_id, sim.host_mask),
                          bit_for_bit=True)
    for key in ("month", "month_signed", "dispatch"):
        if device == "cuda" and not rec["launches"][key]:
            raise AssertionError(f"[3n] (a) the rank launched no {key} kernel")
    del sim, res
    free_card(device)
    wall = time.perf_counter() - t0
    log(f"[3n] (a) one rank over {rec['backend']} on {rec['device']}: {rec['agents']} "
        f"agents, years {rec['years']} in {rec['year_s']} s, launches "
        f"{rec['launches']}; per agent against the plain Simulation: {differ} values "
        f"not bit-equal; {wall:.1f} s ({card})")
    return dict(rec=rec, wall=wall)


def ranks_shared_card(work: str, national: dict, card: str, *,
                      chunk=RANKS_CHUNK, device="cuda") -> dict:
    """[3n] (b): two ranks sharing the card over gloo, national-all-sector
    at its full width (524,288 agents a rank), [3d]'s first model year
    (RANKS_SHARED_END_YEAR), RANKS_CHUNK rows a chunk set by hand; each
    rank's per-year wall, peak allocated bytes and launches, a
    first-year rate (agents over the slower rank's wall) beside [3d]'s
    first year's (a record: two ranks on one card share its SMs), and
    the per-agent outputs against
    [3d]'s single-process run of the same world (``national``), by agent
    id at the JAX package's bound, battery units equal. Rank 0 keeps its
    first launches (RANKS_CAPTURE_ROWS rows) for [9]."""
    import os

    import numpy as np
    import torch

    t0 = time.perf_counter()
    cuda = device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() if cuda else 0
    paths = [os.path.join(work, f"b{r}.npz") for r in range(2)]
    cap_path = os.path.join(work, "b_capture.pt")
    recs = spawn_ranks("(b)", os.path.join(work, "b"), 2, [
        "--preset", NATIONAL, "--end-year", str(RANKS_SHARED_END_YEAR),
        "--agents", str(int(np.sum(national["mask"] > 0))), "--device", device,
        "--no-export", "--no-checkpoint"],
        {"DGEN_TPU_AGENT_CHUNK": str(chunk)},
        rank_args={0: ["--collect", paths[0], "--capture", cap_path,
                       "--capture-rows", str(RANKS_CAPTURE_ROWS)],
                   1: ["--collect", paths[1]]})
    for rec in recs:
        if rec["backend"] != "gloo" or rec["device"] != ("cuda:0" if cuda else "cpu"):
            raise AssertionError(f"[3n] (b) rank {rec['rank']} on {rec['device']} "
                                 f"over {rec['backend']}: two ranks share cuda:0 over gloo")
        for key in ("month", "month_signed", "dispatch"):
            if cuda and not rec["launches"][key]:
                raise AssertionError(f"[3n] (b) rank {rec['rank']} launched no {key}")
    n_years = len(recs[0]["years"])
    ref = sim_by_id({f: np.stack(national[f])[:n_years] for f in national
                     if f not in NATIONAL_KEPT_META},
                    national["agent_id"], national["mask"])
    got = ranks_by_id(paths)
    differ = ranks_parity("(b)", got, ref)
    n_real = sum(r["agents"] for r in recs)
    if n_years != 1:
        raise AssertionError(f"[3n] (b) ran {n_years} years; its rate is a first year's")
    rate = n_real / max(r["year_s"][0] for r in recs)
    single_rate = n_real / national["first_year_s"]
    total = sum(int(np.asarray(ref[f]).size) for f in ref if f != "agent_id")
    for rec in recs:
        log(f"[3n] (b) rank {rec['rank']} of 2 over {rec['backend']} on "
            f"{rec['device']}: {rec['agents']} agents in {rec['rows']} rows, chunk "
            f"{rec['agent_chunk']}, years {rec['years']} in {rec['year_s']} s (run "
            f"{rec['run_s']} s, built in {rec['build_s']} s), peak allocated "
            f"{(rec['max_memory_allocated'] or 0) / 2**30:.2f} GiB (modeled step "
            f"{rec['modeled_step_bytes'] / 2**30:.2f} GiB), launches {rec['launches']}")
    log(f"    both ranks: {n_real} agents, {rate:.1f} agent-years/s in the first year "
        f"(the slower rank's wall; a record, not a claim: the ranks share the card's "
        f"SMs) beside [3d]'s first year's {single_rate:.1f} in this run; {held / 2**30:.2f} GiB of this "
        f"process's earlier phases held on the card; per agent against [3d]: "
        f"{differ} of {total} values not bit-equal, every "
        f"battery unit equal ({card})")
    capture = {k: tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in v)
               for k, v in torch.load(cap_path).items()}
    launches = {}
    for rec in recs:
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return dict(recs=recs, rate=rate, differ=differ, launches=launches,
                capture=capture, wall=time.perf_counter() - t0)


def ranks_outputs(presets, RunConfig, work: str, card: str, *,
                  n_agents=RANKS_OUTPUT_AGENTS, chunk=RANKS_OUTPUT_CHUNK,
                  device="cuda") -> dict:
    """[3n] (c): two ranks at RANKS_OUTPUT_AGENTS (batteries allocated,
    RANKS_OUTPUT_CHUNK-row chunks) with exports and checkpoints: the union
    of their ``year=<Y>-p<rank>`` parts against the single-process export
    row for row (JAX's bound, full-precision float32 on both sides), and a
    year the two ranks checkpointed resumed by one process: the restored
    carry equal to the ranks' outputs of that year bit for bit by agent
    id, the resumed year within the bound of the ranks'."""
    import os

    import numpy as np
    import torch

    from dgen_tpu_torch.io import export
    from dgen_tpu_torch.io.synth import STATES
    from dgen_tpu_torch.parallel import elastic
    from dgen_tpu_torch.tree import leaf_paths

    t0 = time.perf_counter()
    if device == "cuda":
        # this process's own peak (its Simulations' memory checks read it)
        torch.cuda.reset_peak_memory_stats()
    run_dir = os.path.join(work, "c", "run")
    paths = [os.path.join(work, f"c{r}.npz") for r in range(2)]
    recs = spawn_ranks("(c)", os.path.join(work, "c"), 2, [
        "--preset", NATIONAL, "--agents", str(n_agents), "--device", device,
        "--end-year", str(NATIONAL_END_YEAR), "--attachment-rate", str(RANKS_ATTACH),
        "--run-dir", run_dir], {"DGEN_TPU_AGENT_CHUNK": str(chunk)},
        rank_args={r: ["--collect", paths[r]] for r in range(2)})
    got = ranks_by_id(paths)
    rc = RunConfig(agent_chunk=chunk)

    def build():
        return presets.build(NATIONAL, n_agents=n_agents,
                             end_year=NATIONAL_END_YEAR, attachment_rate=RANKS_ATTACH,
                             run_config=rc, device=device)[0]

    sim = build()
    one_dir = os.path.join(work, "c", "single")
    exporter = export.RunExporter(one_dir, agent_id=sim.host_agent_id, mask=sim.host_mask,
                                  state_names=list(STATES), compact=False, device=sim.device)
    res = sim.run(callback=exporter)
    single = sim_by_id(res.agent, sim.host_agent_id, sim.host_mask)
    differ = ranks_parity("(c) outputs", got, single)
    # the export parts' union against the single-process export, row for row
    part_differ, rows = 0, 0
    for surface in ("agent_outputs", "finance_series"):
        names = sorted(os.listdir(os.path.join(run_dir, surface)))
        want_names = [f"year={y}-p{r}.npz" for y in sim.years for r in range(2)]
        if names != want_names:
            raise AssertionError(f"[3n] (c) {surface} parts {names}")
        a = export.load_surface(run_dir, surface)
        b = export.load_surface(one_dir, surface)
        ka = np.lexsort((a["agent_id"], a["year"]))
        kb = np.lexsort((b["agent_id"], b["year"]))
        for c in a:
            if c == "energy_value":
                continue
            x, y = a[c][ka], b[c][kb]
            if x.shape != y.shape:
                raise AssertionError(f"[3n] (c) {surface}.{c}: {x.shape} rows "
                                     f"against {y.shape}")
            if x.dtype.kind == "f":
                part_differ += int((x.view(np.uint32) != y.view(np.uint32)).sum())
                if not np.allclose(x, y, rtol=RANKS_RTOL, atol=RANKS_ATOL):
                    raise AssertionError(f"[3n] (c) {surface}.{c} outside the bound")
            elif not np.array_equal(x, y):
                raise AssertionError(f"[3n] (c) {surface}.{c} differs")
        rows += len(ka)
    ha = export.load_surface(run_dir, "state_hourly")["net_load_mw"]
    hb = export.load_surface(one_dir, "state_hourly")["net_load_mw"]
    if not np.allclose(ha, hb, rtol=RANKS_HOURLY_RTOL, atol=RANKS_HOURLY_ATOL):
        raise AssertionError("[3n] (c) the state-hourly surface outside its bound")
    # the ranks' checkpoint resumed by one process
    ckpt_dir = os.path.join(run_dir, "ckpt")
    if not elastic.is_sharded(ckpt_dir, RANKS_RESUME_YEAR):
        raise AssertionError("[3n] (c) the ranks wrote no per-rank checkpoint parts")
    del sim, res, exporter
    free_card(device)
    sim = build()
    n_global = sim.table.n_agents
    _, carry = elastic.restore_resharded(ckpt_dir, n_global, RANKS_RESUME_YEAR,
                                         device=device, rows=sim.agent_rows)
    leaves = {k.lstrip("."): v.cpu().numpy() for k, v in leaf_paths(carry).items()}
    yi = list(got["years"]).index(RANKS_RESUME_YEAR)
    restored = sim_by_id({f: leaves[k][None] for k, f in CARRY_FIELDS.items()},
                         sim.host_agent_id, sim.host_mask)
    for k, f in CARRY_FIELDS.items():
        if not np.array_equal(restored[f][0], got[f][yi]):
            raise AssertionError(f"[3n] (c) the restored {k} is not the ranks' {f} of "
                                 f"{RANKS_RESUME_YEAR} bit for bit")
    res2 = sim.run(checkpoint_dir=ckpt_dir, resume=True, resume_year=RANKS_RESUME_YEAR)
    resumed_years = res2.years
    if resumed_years != [y for y in sim.years if y > RANKS_RESUME_YEAR]:
        raise AssertionError(f"[3n] (c) the resume ran {resumed_years}")
    resumed = sim_by_id(res2.agent, sim.host_agent_id, sim.host_mask)
    tail = {"agent_id": got["agent_id"], **{f: got[f][yi + 1:] for f in got
                                            if f not in ("agent_id", "years",
                                                         "state_hourly_net_mw")}}
    resume_differ = ranks_parity("(c) resume", resumed, tail)
    del sim, res2, carry
    free_card(device)
    wall = time.perf_counter() - t0
    log(f"[3n] (c) two ranks at {sum(r['agents'] for r in recs)} agents, chunk "
        f"{recs[0]['agent_chunk']}, years {recs[0]['years']} ({[r['year_s'] for r in recs]}"
        f" s): per agent against one process {differ} values not bit-equal; the "
        f"export parts' union against the single-process export: {rows} rows, "
        f"{part_differ} float values not bit-equal, state-hourly within rtol "
        f"{RANKS_HOURLY_RTOL}; the {RANKS_RESUME_YEAR} checkpoint of 2 ranks restored "
        f"by one process bit for bit ({len(CARRY_FIELDS)} carry leaves against the "
        f"ranks' outputs), its resumed {resumed_years} within the bound of the ranks' "
        f"({resume_differ} values not bit-equal); {wall:.1f} s ({card})")
    return dict(recs=recs, differ=differ, part_differ=part_differ,
                resume_differ=resume_differ, wall=wall)


def multi_rank(presets, RunConfig, national: dict, card: str) -> dict:
    """[3n]: the multi-rank run on one card, (a)-(c), in a temporary
    directory it removes. Returns (b)'s launches and first launches for
    [9], and the figures."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="dgen-ranks-")
    try:
        a = ranks_one_nccl(presets, work, card)
        b = ranks_shared_card(work, national, card)
        c = ranks_outputs(presets, RunConfig, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"[3n] the multi-rank run (a)-(c): {wall:.3f} s ({card})")
    return dict(launches=b.pop("launches"), capture=b.pop("capture"), a=a, b=b, c=c,
                wall=wall)


# ---------------------------------------------------------------------------
# [3o]: the rank gang
# ---------------------------------------------------------------------------

#: (a): the gang's ranks, the kill, the gang's limits
GANG_RANKS = 2
GANG_KILL = "gang_worker_kill@2:kill"
GANG_TIMEOUT_S = 600
#: (b): the sweep on two ranks
GANG_SWEEP_AGENTS = 32_768
GANG_SWEEP_ITC = "0.3,0.0"


def gang_national(national: dict, card: str, work: str, *,
                  device="cuda") -> dict:
    """[3o] (a): national-all-sector at its full width (the agents of
    [3d]'s run, ``national``) for 2 model years as a gang of GANG_RANKS
    ranks sharing the card under the GangSupervisor, each rank's chunk
    automatic (its share of the card), rank 1 killed at its second year's
    export: the supervisor must tear the gang down and relaunch it from
    the merged manifest frontier (2014), the ranks resuming from the 2014
    checkpoint parts. The merged export (every rank's ``year=<Y>-p<r>``
    parts) must equal [3d]'s per-agent bits in both years, every battery
    unit equal, and ``GangManifest.verify`` be clean. Logs the detection
    wall, the teardown and relaunch walls, each rank's peak allocated
    bytes against its budget, and the card's free memory before the first
    spawn and before the relaunch. Rank 0 of the final attempt keeps its
    first launches (RANKS_CAPTURE_ROWS rows) for [9]."""
    import os

    import numpy as np
    import torch

    from dgen_tpu_torch.config import GangConfig
    from dgen_tpu_torch.io.export import AGENT_OUTPUT_FIELDS
    from dgen_tpu_torch.resilience.gang import GangCrashLoop, GangSupervisor
    from dgen_tpu_torch.resilience.gangdrill import _read_rows
    from dgen_tpu_torch.resilience.manifest import GangManifest
    from dgen_tpu_torch.resilience.supervisor import RetryPolicy

    t0 = time.perf_counter()
    free_card(device)
    run_dir = os.path.join(work, "gang")
    cap_path = os.path.join(work, "gang_capture.pt")
    years = [int(y) for y in national["years"]]
    n_real = int(np.sum(national["mask"] > 0))

    def env_for(i, attempt):
        env = {}
        if i == 0:
            env.update(DGEN_GANG_CAPTURE=cap_path,
                       DGEN_GANG_CAPTURE_ROWS=str(RANKS_CAPTURE_ROWS))
        if i == 1 and attempt == 0:
            env["DGEN_TPU_FAULTS"] = GANG_KILL
        return env

    sup = GangSupervisor(
        run_dir, years,
        config=GangConfig(n_processes=GANG_RANKS, platform=torch.device(device).type,
                          boot_timeout_s=GANG_TIMEOUT_S, stall_timeout_s=GANG_TIMEOUT_S,
                          poll_interval_s=0.1, max_restarts=2),
        policy=RetryPolicy(backoff_base_s=0.05), env_for=env_for,
        worker_env={"DGEN_PRESET": NATIONAL, "DGEN_AGENTS": str(n_real),
                    "DGEN_END_YEAR": str(years[-1])},
        gang_dir=os.path.join(work, "gang-ranks"))

    def tail(i):
        path = os.path.join(sup.gang_dir, f"worker-{i}.log")
        with open(path, "rb") as f:
            return f.read()[-2500:].decode("utf-8", "replace")

    try:
        rep = sup.run()
    except GangCrashLoop as e:
        raise AssertionError(f"[3o] (a) {e} | rank 0: {tail(0)} | rank 1: {tail(1)}") from e
    wall = time.perf_counter() - t0

    died = rep.attempts[0] if rep.attempts else None
    if not (rep.succeeded and rep.restarts == 1 and died.reason == "worker_exit"
            and died.worker == 1 and died.exit_code == 77):
        raise AssertionError(f"[3o] (a) the gang did not recover from the kill once: "
                             f"{rep.to_json()} | rank 0: {tail(0)} | rank 1: {tail(1)}")
    done = sorted(rep.done, key=lambda d: d["process"])
    for d in done:
        if d["imports_jax"] or d["imports_dgen_tpu"]:
            raise AssertionError(f"[3o] (a) rank {d['process']} imported jax")
        if d["resumed_after"] != years[0] or d["years_run"] != years[1:]:
            raise AssertionError(f"[3o] (a) rank {d['process']} resumed after "
                                 f"{d['resumed_after']}, ran {d['years_run']}")
        for key in ("month", "month_signed", "dispatch"):
            if device == "cuda" and not d["launches"][key]:
                raise AssertionError(f"[3o] (a) rank {d['process']} launched no {key}")
    verify = GangManifest(run_dir).verify()
    if not verify.ok or verify.years_complete != years:
        raise AssertionError(f"[3o] (a) the merged manifest: {verify.to_json()}")
    ref = sim_by_id({f: np.stack(national[f]) for f in national
                     if f not in NATIONAL_KEPT_META},
                    national["agent_id"], national["mask"])
    differ = total = 0
    d_out = os.path.join(run_dir, "agent_outputs")
    for yi, y in enumerate(years):
        got = _read_rows([os.path.join(d_out, n) for n in sorted(os.listdir(d_out))
                          if n.startswith(f"year={y}-p") and n.endswith(".npz")])
        if not np.array_equal(got["agent_id"], ref["agent_id"]):
            raise AssertionError(f"[3o] (a) {y}: the parts' agents are not [3d]'s")
        for f in AGENT_OUTPUT_FIELDS:
            a, b = np.asarray(got[f], np.float32), np.asarray(ref[f][yi], np.float32)
            n = int((a.view(np.uint32) != b.view(np.uint32)).sum())
            differ += n
            total += a.size
            if f in ("new_batt_adopters", "batt_adopters_cum") and n:
                raise AssertionError(f"[3o] (a) {y}: a battery unit moved ({f})")
    if differ:
        raise AssertionError(f"[3o] (a) {differ} of {total} exported values differ "
                             f"from [3d]'s bits")
    gib = lambda b: "n/a" if b is None else f"{b / 2**30:.2f} GiB"
    log(f"[3o] (a) the gang at {n_real} agents x {years}: {GANG_RANKS} ranks sharing "
        f"the card over {done[0].get('backend')}, rank 1 killed ({GANG_KILL}): "
        f"detected in <= {died.detect_s} s (the gap since the last poll that saw it "
        f"alive), teardown {died.teardown_s} s, the killed attempt {died.wall_s:.3f} s; "
        f"relaunch wall (detection to every rank's first year) {rep.relaunch_wall_s} s, "
        f"recovery wall {rep.recovery_wall_s:.3f} s; the gang {wall:.3f} s in all ({card})")
    log(f"    card free before the first spawn {[gib(b) for b in rep.card_free_before or []]}, "
        f"before the relaunch "
        f"{[(gib(b), c['waited_s']) for c in rep.card_free_relaunch for b in c['free'] or []]}"
        f" (free, seconds waited)")
    for d in done:
        log(f"    rank {d['process']}: {d['agents']} agents in {d['rows']} rows, automatic "
            f"chunk {d['agent_chunk']}, resumed after {d['resumed_after']}, ran "
            f"{d['years_run']} in {d['run_s']} s; peak allocated "
            f"{gib(d['max_memory_allocated'])} against its budget "
            f"{gib(d['memory_budget_bytes'])} (0.8 of its share "
            f"{gib(d['card_share_bytes'])}; modeled step {gib(d['modeled_step_bytes'])}); "
            f"launches {d['launches']}")
    log(f"    merged export against [3d]: {differ} of {total} values not bit-equal, "
        f"every battery unit equal; merged manifest verify ok, years {verify.years_complete}")
    capture = {k: tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in v)
               for k, v in torch.load(cap_path).items()}
    launches = {}
    for d in done:
        for k, v in d["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return dict(report=rep.to_json(), launches=launches, capture=capture, wall=wall,
                differ=differ)


def gang_sweep(card: str, work: str, *, n_agents=GANG_SWEEP_AGENTS, device="cuda") -> dict:
    """[3o] (b): the sweep CLI (``python -m dgen_tpu_torch.sweep``) as two
    ranks sharing the card: national-all-sector at ``n_agents``, 2 model
    years, S = 2 (ITC 0.3 and 0), batteries attached at RANKS_ATTACH; the
    gathered results (rank 0's ``--collect``) against the single-process
    sweep of the same world in this process, per agent id, bit for bit."""
    import os

    import numpy as np

    from dgen_tpu_torch.sweep import SweepSimulation
    from dgen_tpu_torch.sweep import __main__ as cli

    t0 = time.perf_counter()
    free_card(device)
    argv = ["--preset", NATIONAL, "--agents", str(n_agents), "--end-year",
            str(NATIONAL_END_YEAR), "--itc", GANG_SWEEP_ITC, "--attachment-rate",
            str(RANKS_ATTACH), "--device", device]
    out = os.path.join(work, "sweep.npz")
    recs = spawn_ranks("(b) sweep", os.path.join(work, "sweep"), GANG_RANKS, [],
                       rank_args={0: ["--collect", out]}, module="dgen_tpu_torch.sweep",
                       argv=argv)
    if any(r.get("groups") and any(g["mode"] != "loop" for g in r["groups"]) for r in recs):
        raise AssertionError(f"[3o] (b) the ranked sweep did not loop: {recs}")
    ranked_s = time.perf_counter() - t0
    args = cli.parser().parse_args(argv)
    pop, cfg, members, labels, with_hourly = cli.build_sweep(args, device)
    from dgen_tpu_torch.config import RunConfig

    res = SweepSimulation(pop.table, pop.profiles, pop.tariffs, members, cfg,
                          RunConfig(sizing_iters=args.sizing_iters), with_hourly=with_hourly,
                          labels=labels, device=device).run()
    del pop
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    differ = total = 0
    for s in range(len(members)):
        a = sim_by_id({k.split("/", 1)[1]: v for k, v in got.items()
                       if k.startswith(f"{s}/")}, got["agent_id"], got["mask"])
        b = sim_by_id(res.runs[s].agent, res.host_agent_id, res.host_mask)
        if not np.array_equal(a["agent_id"], b["agent_id"]):
            raise AssertionError(f"[3o] (b) scenario {s}: the ranks' agents differ")
        for f in b:
            if f == "agent_id":
                continue
            n = int((np.asarray(a[f]).view(np.uint32)
                     != np.asarray(b[f]).view(np.uint32)).sum())
            differ += n
            total += np.asarray(b[f]).size
    if differ:
        raise AssertionError(f"[3o] (b) {differ} of {total} values of the ranked sweep "
                             f"differ from the single-process sweep's bits")
    for r in recs:
        for key in ("month", "month_signed", "dispatch"):
            if device == "cuda" and not r["launches"][key]:
                raise AssertionError(f"[3o] (b) rank {r['rank']} launched no {key}")
    wall = time.perf_counter() - t0
    log(f"[3o] (b) the sweep CLI on {GANG_RANKS} ranks sharing the card: {NATIONAL} at "
        f"{n_agents} agents x {cfg.model_years}, S = {len(members)} ({labels}), the "
        f"scenario-major loop (chunk {recs[0].get('agent_chunk')}), {ranked_s:.3f} s with "
        f"the ranks' boot; against the single-process sweep: {differ} of {total} "
        f"per-agent values not bit-equal; launches a rank "
        f"{[r['launches'] for r in recs]}; {wall:.3f} s ({card})")
    return dict(recs=recs, differ=differ, wall=wall)


def rank_gang(national: dict, card: str) -> dict:
    """[3o]: (a) the gang at national width through a killed rank and (b)
    the sweep on two ranks, in a temporary directory it removes. Returns
    (a)'s launches and first launches for [9], and the figures."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="dgen-gang-")
    try:
        a = gang_national(national, card, work)
        b = gang_sweep(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"[3o] the rank gang (a)-(b): {wall:.3f} s ({card})")
    return dict(launches=a.pop("launches"), capture=a.pop("capture"), a=a, b=b, wall=wall)


def main(argv=None) -> int:
    import argparse
    import os

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "parent"),
        help="another checkout whose sums_variant and sums_monthdot kernels "
             "[9] times against this one's (skipped where absent)")
    args = ap.parse_args(argv)
    parent_root = args.parent
    t_script = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the smoke run needs a GPU", file=sys.stderr)
        return 2
    try:
        from dgen_tpu_torch import presets
        from dgen_tpu_torch.config import RunConfig
        from dgen_tpu_torch.ops import _build
        from dgen_tpu_torch.ops import billkernels as bk
        from dgen_tpu_torch.ops import microkernels as mk
        from dgen_tpu_torch.ops.tariff import HOURS
        from dgen_tpu_torch.tools import kernel_microbench as tool
    except ImportError as e:
        print(f"the dgen_tpu_torch package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[1] device: {dev_name} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    path, secs, build_log = _build.build()
    log(f"[2] built {path} from {len(_build.sources())} sources in {secs:.1f} s")
    for row in _build.kernel_resources(build_log):
        log(f"    {row['kernel']}: {row['registers']} registers, "
            f"{row['spill_bytes']} bytes spilled, {row['smem_bytes']} bytes static "
            "shared memory")
    _build.library()

    def build(n_agents, end_year, knobs=None, **kw):
        return presets.build("ercot-all-sector", n_agents=n_agents,
                             end_year=end_year, device="cuda",
                             run_config=RunConfig(**(knobs or {})), **kw)[0]

    phase_s = {}
    t_lap = [time.perf_counter()]

    def lap() -> float:
        t = time.perf_counter()
        t_lap.append(t)
        return round(t - t_lap[-2], 1)

    runs = {}
    # --- 3: the main path ---
    sim = build(MAIN_AGENTS, MAIN_END_YEAR)
    if not sim._net_billing or sim._rate_switch:
        raise AssertionError("the preset world does not take the kernel paths")
    torch.cuda.reset_peak_memory_stats()
    runs["main"] = run = run_path(sim)
    report_path("3", "main path ercot-all-sector", run)
    need_launches("main path", run["launches"], ("month", "month_signed", "dispatch"))
    main_curve = run["res"].summary(sim.host_mask)
    if not main_curve["adopters"][-1] > 0:
        raise AssertionError("no national adoption on the main path")
    log(f"    adopters {main_curve['adopters'].tolist()}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the first launches' "
        f"operands held from the first year on), modeled year step "
        f"{sim.modeled_step_bytes / 2**30:.2f} GiB")

    # the port on the card against the port on the CPU (plain versions)
    small = dict(n_agents=64, end_year=2016)
    for knobs in ({}, GATED, BF16, QUANT):
        rc = RunConfig(sizing_iters=4, **knobs)
        gpu_sim, _, _ = presets.build("ercot-all-sector", device="cuda",
                                      run_config=rc, **small)
        cpu_sim, _, _ = presets.build("ercot-all-sector", device="cpu",
                                      run_config=rc, **small)
        g_curve = gpu_sim.run().summary(gpu_sim.host_mask)
        c_curve = cpu_sim.run().summary(cpu_sim.host_mask)
        for k in ("adopters", "system_kw_cum", "batt_kwh_cum"):
            np.testing.assert_allclose(g_curve[k], c_curve[k], rtol=CURVE_RTOL,
                                       err_msg=f"card vs CPU {k} {knobs}")
        log(f"    card vs CPU at 64 agents x 2 years {sorted(knobs) or 'default'}: "
            f"curves agree within rtol {CURVE_RTOL} (adopters "
            f"{g_curve['adopters'].tolist()} vs {c_curve['adopters'].tolist()})")

    phase_s["3"] = lap()
    # --- 3c: the streaming year step against the whole table ---
    chunked_vs_whole(presets, RunConfig)

    phase_s["3c"] = lap()
    # --- 3d: national-all-sector at its full width ---
    main_years = len(runs["main"]["res"].years)
    whole_per_year = {k: runs["main"]["launches"][k] / main_years
                      for k in ("month", "month_signed")}
    national = {}
    single_rate = national_path(presets, whole_per_year, keep=national)
    torch.cuda.empty_cache()

    phase_s["3d"] = lap()
    # --- 3e: both golden fixtures on the card ---
    golden_fixtures(RunConfig)
    torch.cuda.empty_cache()

    phase_s["3e"] = lap()
    # --- 3f: the run outputs at national-all-sector's full width ---
    run_outputs(presets, RunConfig, whole_per_year)
    pipeline_ab(presets, RunConfig)
    torch.cuda.empty_cache()

    phase_s["3f"] = lap()
    # --- 3g: resilience on the card ((d) runs in [9]) ---
    resilience(presets, RunConfig)
    torch.cuda.empty_cache()

    phase_s["3g"] = lap()
    # --- 3h: the tariff-clustered mixed national world ---
    mixed = mixed_clusters()

    phase_s["3h"] = lap()
    # --- 3i: sweeps and ensembles ---
    sweeps(presets, whole_per_year, single_rate)

    phase_s["3i"] = lap()
    # --- 3j: the per-agent oracle, the analysis side and the twin ---
    oracle = oracle_and_twin(presets, RunConfig, sim, runs["main"], card)
    runs["oracle"] = dict(launches=oracle["launches"], capture=oracle["capture"])

    phase_s["3j"] = lap()
    # --- 3k: the serving stack ---
    serve = serving(presets, card)
    runs.update(serve["runs"])
    torch.cuda.empty_cache()

    phase_s["3k"] = lap()
    # --- 3l: the serving fleet ---
    fleet = serving_fleet(card)
    runs["fleet"] = dict(launches=fleet["launches"], capture=fleet["capture"])
    torch.cuda.empty_cache()

    phase_s["3l"] = lap()
    # --- 3m: reference-format inputs ---
    ingest = reference_inputs_phase(presets, RunConfig, card, single_rate)
    runs["ingest"] = dict(launches=ingest["launches"], capture=ingest["capture"])
    torch.cuda.empty_cache()

    phase_s["3m"] = lap()
    # --- 3n: the multi-rank run ---
    ranks = multi_rank(presets, RunConfig, national, card)
    runs["ranks"] = dict(launches=ranks["launches"], capture=ranks["capture"])
    torch.cuda.empty_cache()

    phase_s["3n"] = lap()
    # --- 3o: the rank gang ---
    gang = rank_gang(national, card)
    runs["gang"] = dict(launches=gang["launches"], capture=gang["capture"])
    del national
    torch.cuda.empty_cache()

    phase_s["3o"] = lap()
    # --- 4: the gated main path ---
    gsim = build(MAIN_AGENTS, MAIN_END_YEAR, GATED)
    lay = gsim._daylight
    if lay is None:
        raise AssertionError("the preset's generation bank did not compact")
    log(f"[4] daylight layout: {lay.n_lanes} compacted lanes (months "
        f"{list(lay.seg_lens)}), {lay.uniform().n_lanes} uniform "
        f"({lay.uniform().seg_lens[0]} per month) of {HOURS} hours")
    runs["gated"] = run = run_path(gsim)
    report_path("4", "gated main path (daylight_compact, pack_once, "
                "stream_segments)", run)
    need_launches("gated main path", run["launches"],
                  ("stream", "stream_signed", "dispatch"),
                  zero=("month", "month_signed", "dot", "dot_signed"))
    gap = curves_gap(run["res"].summary(gsim.host_mask), main_curve)
    if gap > CURVE_RTOL:
        raise AssertionError(f"gated curves differ from the main path's by {gap:.3e}")
    log(f"    national curves within {gap:.3e} (relative) of the main path's")
    if run["capture"]["stream"][0].shape[1] != lay.uniform().n_lanes:
        raise AssertionError("the stream kernel did not run the uniform lanes")

    phase_s["4"] = lap()
    # --- 5: the rate-switch paths ---
    for key, knobs, title in (("switch", None, "rate-switch path"),
                              ("switch_gated", GATED, "gated rate-switch path")):
        rs = build(SWITCH_AGENTS, SWITCH_END_YEAR, knobs, rate_switch_frac=0.4)
        if not rs._rate_switch:
            raise AssertionError("the rate-switch world has no switch")
        runs[key] = run = run_path(rs)
        report_path("5", title, run)
        need_launches(title, run["launches"], ("month_pair", "dispatch"),
                      zero=("month", "stream"))
    if runs["switch_gated"]["capture"]["month_pair"][0].shape[1] == HOURS:
        raise AssertionError("the gated pair kernel ran full-hour lanes")

    phase_s["5"] = lap()
    # --- 6: daylight_compact alone, and the same world without it ---
    dsim = build(DAYLIGHT_AGENTS, 2014, dict(daylight_compact=True))
    runs["daylight"] = run = run_path(dsim)
    report_path("6", "daylight path (daylight_compact alone)", run)
    need_launches("daylight path", run["launches"],
                  ("month", "month_signed", "dispatch"),
                  zero=("stream", "stream_signed"))
    if run["capture"]["month"][0].shape[1] != dsim._daylight.n_lanes:
        raise AssertionError("the daylight path's month kernel ran full-hour lanes")
    full = run_path(build(DAYLIGHT_AGENTS, 2014))
    full.pop("capture")
    gap = curves_gap(run["res"].summary(dsim.host_mask),
                     full["res"].summary(dsim.host_mask))
    if gap > CURVE_RTOL:
        raise AssertionError(f"daylight curves differ from full-hour by {gap:.3e}")
    log(f"    national curves within {gap:.3e} (relative) of the same world "
        f"without daylight_compact")

    phase_s["6"] = lap()
    # --- 7: the dot engine ---
    dot_launches, dot_capture, dot_gap, dot_c, ref_c = dot_path(presets)
    runs["dot"] = dict(launches=dot_launches, capture=dot_capture)
    log(f"[7] dot path: {DOT_AGENTS} agents x 1 year through "
        f"year_step(sizing_impl='dot'); launches {dot_launches}; national sums "
        f"within {dot_gap:.3e} (relative) of the month engine's (adopters "
        f"{dot_c['adopters'].tolist()} vs {ref_c['adopters'].tolist()})")
    need_launches("dot path", dot_launches, ("dot", "dot_signed"),
                  zero=("month", "month_signed", "stream"))
    if dot_launches["dispatch"] != 1:
        raise AssertionError(f"dot path: {dot_launches['dispatch']} dispatch kernel "
                             "launches in one model year")
    if dot_gap > DOT_CURVE_RTOL:
        raise AssertionError(f"dot curves differ by {dot_gap:.3e} > {DOT_CURVE_RTOL}")

    phase_s["7"] = lap()
    # --- 8: the micro-benchmark path ---
    log(f"[8] micro-benchmark path: kernel_microbench.run({MICRO_AGENTS}), every "
        f"default variant (the tool's own lines follow)")
    runs["micro"] = run = micro_path(tool, bk)
    log(f"    {len(run['out']['variants'])} variants in {run['wall']:.3f} s; "
        f"launches {run['launches']}")
    log(f"    every parity line within its kind's tolerance (rtol "
        f"{tool.PARITY_RTOL}, atol {tool.ATOL_FRAC} x the agent's max|lib|); "
        f"an unknown name refused: {run['refusal']}; month launches on int8 "
        f"codes (quant): {run['narrow'].get('month/int8', 0)}")
    need_launches("micro-benchmark path", run["launches"],
                  ("variant", "monthmask", "monthmask_g", "monthdot",
                   "monthdot_pre", "mnet", "mnet_hi", "month", "stream"),
                  zero=("month_signed", "month_pair", "stream_signed", "dot",
                        "dot_signed"))
    if not run["narrow"].get("month/int8"):
        raise AssertionError("the quant variant launched no month kernel on int8")

    phase_s["8"] = lap()
    # --- 8b: the bf16 and int8 bank paths ---
    for key, knobs, title, kernel, dtype in (
            ("bf16", BF16, "bf16-banks path (bf16_banks)", "month", "bfloat16"),
            ("quant", QUANT, "int8-banks path (quant_banks, pack_once, "
             "stream_segments)", "stream", "int8")):
        bsim = build(MAIN_AGENTS, MAIN_END_YEAR, knobs)
        runs[key] = run = run_path(bsim)
        report_path("8b", title, run)
        need_launches(title, run["launches"], (kernel, kernel + "_signed", "dispatch"),
                      zero=("dot", "dot_signed")
                      + (("month", "month_signed") if kernel == "stream" else
                         ("stream", "stream_signed")))
        narrow = run["narrow"].get(f"{kernel}/{dtype}", 0)
        if narrow != run["launches"][kernel]:
            raise AssertionError(f"{title}: {narrow} of {run['launches'][kernel]} "
                                 f"{kernel} launches on {dtype} streams")
        gap = curves_gap(run["res"].summary(bsim.host_mask), main_curve)
        log(f"    {narrow} {kernel} launches on {dtype} streams; national curves "
            f"within {gap:.3e} (relative) of the float32 main path's (bound "
            f"{BANK_CURVE_RTOL}); modeled year step "
            f"{bsim.modeled_step_bytes / 2**30:.2f} GiB (float32: "
            f"{sim.modeled_step_bytes / 2**30:.2f} GiB)")
        if gap > BANK_CURVE_RTOL:
            raise AssertionError(f"{title}: curves differ from the float32 main "
                                 f"path's by {gap:.3e} > {BANK_CURVE_RTOL}")
        del bsim

    phase_s["8b"] = lap()
    # --- 9: the kernels on the paths' operands ---
    log(f"[9] kernels vs plain versions on the first launch's operands (rtol "
        f"{RTOL}, {DOT_RTOL} for the TF32 tensor-core kernels, {BF16_RTOL:.4e} "
        f"for bf16 sums, atol {ATOL_FRAC} x the agent's max|plain|) "
        f"and times (median of 5 CUDA-event launches after a warm-up, {PLAIN_REPS} "
        f"for a plain version after the check's call):")
    captures = {k: v["capture"] for k, v in runs.items()}
    hour_lanes = {k: v.get("hour_lanes") for k, v in runs.items()}
    micro_library = micro_library_ms(captures["micro"]["variant"], mk)
    rows = check_and_time(captures, kernel_specs(bk, mk), hour_lanes, micro_library)
    parent_ab(captures["micro"]["variant"], parent_root)
    monthdot_month_ab(captures["micro"]["variant"], mk)
    log("  A/Bs, not in the kernels line: the month kernel on the stream kernel's "
        "operands (the gated path launches no month kernel), and the narrow rows' "
        "kernels on float32 copies of their operands (equal operations):")
    float32_copies(captures)
    ab = check_and_time(captures, ab_specs(bk), hour_lanes)[0]
    log("  the redesigned kernels on their paths' own operands against the month "
        "kernel, bit for bit (same_bits) and timed, not in the kernels line:")
    staging_ab(captures)
    dot_month_ab(captures)
    log("  the battery dispatch kernel on every model path's first dispatch:")
    dispatch_every_path(captures)
    log(f"  the month kernel on the main path's first launches, at P = {AB_PERIODS} "
        "too (seeded period map), at each count of scales a thread, not in the "
        "kernels line:")
    month_kernel_ab(captures["main"]["month"], captures["main"]["month_signed"])
    log("  settings of sums_variant beside its base row, not in the kernels line:")
    check_variant_forms(captures["micro"]["variant"], mk, tool)
    log("  [3g] (d) NaN and +Inf loads through the staged kernels on copies of "
        "their first launches' operands, against the plain versions:")
    nan_through_kernels(captures, bk)
    log("  [3h] the month kernel at P = 1 on a single-period cluster's first "
        "launches (a clustered run's), not in the kernels line:")
    p1_rows(mixed["c"].pop("capture"), bk, p1_launches(mixed["b"]))
    oracle_dispatch = captures["oracle"]["dispatch"]
    serve_dispatch = {k: captures[k]["dispatch"] for k in ("serve1", "serve64", "fleet",
                                                            "ingest", "ranks", "gang")}
    del captures
    for v in runs.values():
        v.pop("capture", None)
    torch.cuda.empty_cache()
    ms = {r["name"]: r["ms"] for r in rows}
    log(f"    on the stream kernel's operands: month kernel {ab['ms']:.3f} ms, "
        f"stream kernel {ms['bucket_sums_stream']:.3f} ms")
    log("  the battery dispatch kernel on the main path's first-year dispatch "
        "(rebuilt at a system sized to each agent's load):")
    drow = dispatch_row(dispatch_operands(sim)[1], runs["main"]["launches"]["dispatch"])
    ms["battery_dispatch"] = drow["ms"]
    log("  the battery dispatch kernel on [3j] (a)'s first oracle dispatch (one "
        "agent chunk of the per-agent oracle):")
    orow = dispatch_row(oracle_dispatch, runs["oracle"]["launches"]["dispatch"])
    orow.update(name="battery_dispatch_3j", path="oracle")
    del oracle_dispatch
    srows = []
    for key, ops in serve_dispatch.items():
        log({"fleet": "  the battery dispatch kernel on [3l] (a)'s first oracle dispatch "
                      "(the fleet path, a bucket of 8 launching 16 rows):",
             "ingest": f"  the battery dispatch kernel on [3m] (b)'s first dispatch (the "
                       f"ingest path; a chunk's first {INGEST_CAPTURE_ROWS} rows):",
             "ranks": f"  the battery dispatch kernel on [3n] (b)'s rank 0's first "
                      f"dispatch (two ranks sharing the card; a chunk's first "
                      f"{RANKS_CAPTURE_ROWS} rows):",
             "gang": f"  the battery dispatch kernel on [3o] (a)'s rank 0's first "
                     f"dispatch of the relaunched attempt (a chunk's first "
                     f"{RANKS_CAPTURE_ROWS} rows):"}.get(
            key, f"  the battery dispatch kernel on [3k] (a)'s first dispatch at bucket "
                 f"{key[5:]} (the serving path):"))
        r = dispatch_row(ops, runs[key]["launches"]["dispatch"])
        r.update(name=f"battery_dispatch_{key}", path=key)
        srows.append(r)
    del serve_dispatch
    log("  the first year's sizing call, broken down:")
    for tag, s, knobs, names in (
            ("main", sim, {}, ("bucket_sums_month",) * 2 + ("bucket_sums_month_signed",)),
            ("gated", gsim, dict(impl="stream", daylight=lay, pack_once=True),
             ("bucket_sums_stream",) * 2 + ("bucket_sums_stream_signed",))):
        parts = breakdown(s, knobs, sum(ms[n] for n in names + ("battery_dispatch",)))
        log(f"    {tag}: first-year sizing call {parts['sizing_s']:.3f} s with the "
            f"dispatch kernel, {parts['sizing_plain_dispatch_s']:.3f} s with the plain "
            f"loop in its place; alone, the dispatch kernel {parts['dispatch_s']:.4f} s "
            f"and the plain loop {parts['dispatch_plain_s']:.3f} s; the year's four "
            f"kernel launches (three bucket sums, one dispatch), as the sum of their "
            f"isolated medians, {parts['kernel_medians_s']:.4f} s")

    phase_s["9"] = lap()
    # --- 9c: one carry year of the default and the gated path, traced ---
    profile_year(sim, f"default path, {MAIN_AGENTS} agents")
    profile_year(gsim, f"gated path, {MAIN_AGENTS} agents")

    phase_s["9c"] = lap()
    # --- 10: the kernel line, the card, the result ---
    path_launches = {k: {**v["launches"], **v.get("narrow", {})}
                     for k, v in runs.items()}
    specs = kernel_specs(bk, mk)
    kernels = []
    for r in rows:
        path_key, key = specs[r["name"]][0]
        kernels.append(dict(
            name=r["name"], route="cuda", source=r["source"],
            replaces=r["replaces"], launches=path_launches[path_key][key],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            shape_n_r_lanes=list(r["shape"]), hour_lanes=r["work_lanes"],
            path=path_key,
        ))
    kernels += [drow, orow, *srows]
    if any(k["launches"] == 0 for k in kernels):
        raise AssertionError(f"a kernel of its path never launched: {kernels}")
    log(f"[10] script wall {time.perf_counter() - t_script:.1f} s; each phase's wall "
        f"(s, phase: its code in main, its A/Bs and rows in [9]) {phase_s}")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
