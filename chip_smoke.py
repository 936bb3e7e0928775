#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (spartacus_surface_tpu_torch) on one GPU.

    python3 chip_smoke.py              # build, check, run the paths
    python3 chip_smoke.py --profile    # ... then time and trace the slice
    python3 chip_smoke.py --parallel-only   # build, then the parallel phase alone
    python3 chip_smoke.py --auto-only   # build, then the auto and corners phases
    python3 chip_smoke.py --shapes-only # build, then the shapes phase alone
    python3 chip_smoke.py --graphs-only # build, then the graphs phase alone
    python3 chip_smoke.py --divergence-only  # build, then the k1_divergence phase alone

Phases, one JSON line each (failures make the script exit nonzero before the
final line):
  1. build   - nvcc builds csrc/*.cu for sm_90a (the layer factory, the SW
     and LW sweeps, the roofline probes), one nvcc per source, all started
     together (ptxas register/spill report).
  2. kernel_vs_plain - each kernel against its plain PyTorch version on the
     same operands: the layer factory K1 (structured) and K1d (dense; the
     1-stream systems), each in its SW and its LW calls, K2 SW up-sweep, K3
     fused SW down-sweep, K4 LW up-sweep, K5 fused LW down-sweep, captured
     from spartacus_sw + spartacus_lw for (nreg, nstream) in (1,2) (2,4)
     (3,4) (2,8) and (1,1) (2,1) (3,1) at 1024 columns x 8 layers x 2
     bands, in float32 and float64; the LW solve runs once on the uniform
     example fields and once on LW fields drawn per column, layer and band.
     Tolerances: K1 and K1d float32 elementwise rtol 2e-4 / atol 2e-5;
     per-field max|diff| / max(1, max|plain|) <= 3e-5 (K2, K3, K4) and 2e-4
     (K5) in float32; <= 1e-9 for all in float64.  A non-finite value in
     either result fails the comparison.
  3. slice   - run_radsurf (SW + LW, as the JAX bench's step) on the CUDA
     device, kernel route against the plain scan route, in float32 and
     float64, at
       headline: 16,384 VegetatedUrban columns (nreg=2, ns=4 SW and LW) x
         8 layers x 1 band, plus 512 Flat, 256 SimpleUrban and 256
         InfiniteStreet;
       rami5_shape: 1,024 Forest columns (nreg=3, ns=4 SW and LW) x 62
         layers x 14 bands;
       rami5_ns1: the same at 1 stream (SW on K1d at nd = ndir = 3,
         888,832 elements in one launch; LW on K1 at nd = 3).
     Checks: field-normalized error (bench.py's metric) <= 3e-4 (SW) /
     2.5e-3 (LW) in f32, 1e-9 in f64; finite outputs of the expected
     shapes; the SW and LW energy budgets close (LW: on the layered and flat
     columns; the simple-urban LW solve keeps the reference's ground
     emissivity in its wall-wall term and does not conserve exactly); every
     kernel of the path launched in the kernel-route run (K1 in both modes;
     at rami5_ns1 K1d in SW mode and K1 in LW mode);
     and each kernel's results in that run against its plain version on the
     same operands, at the tolerances of phase 2.  Also prints each route's
     wall seconds (first call, after synchronize) and peak device memory.
  k1_divergence - the order K1 and K1d take their elements in, on every
     factory call (SW and LW mode) of three float32 run_radsurf calls: the
     headline, rami5_shape and the benchmark's urban_mix.f32 input set (all
     six tile types, half of the columns at night).  Per call: the doubling
     counts of tools.roofline.doubling_steps (mean, range) and the order
     pass's window (the card's resident teams); the share of the doubling
     steps that a warp's teams and a block's teams (teams per block from
     layer_kernel.factory_config) run that their elements need, as the
     elements come and in the launch's order (window by window, longest
     first); CUDA-event ms of the wrapper's
     ordered launch (the order pass and its argsort included), of the
     order pass and argsort alone, and of the launch as the elements come
     (the identity order).  Checks: the order pass's counts are
     doubling_steps' (one step off only at a step's edge, within the
     operands' rounding), and the ordered and the identity launch agree bit
     for bit.
  cli - the offline CLI, driver.main.main([namelist, input, output,
     --precision single|double, --timings]) in this process, on an input
     file written by utils/inputs.write_example_input (16,384 layered
     columns: 8,192 VegetatedUrban, 4,096 Forest, 4,096 Urban; plus 512
     Flat, 256 SimpleUrban, 256 InfiniteStreet; 8 layers, 1 band) for two
     namelists: cli_ns4 (4 streams, 2 forest and 1 urban vegetation
     regions: K1 in SW and LW mode, K2-K5) and cli_ns1 (the same at 1
     stream, with flux profiles and spectral fluxes saved: K1d for every SW
     solve and the Urban LW, K1 for the other LW solves, K2-K5).  Checks:
     exit code 0; every kernel of the path launched; each captured factory
     call (K1, K1d) and sweep call against its plain version; the output
     file against one built in this process from the scan route (read,
     run_radsurf(route="scan"), scale and sum, save), every variable
     field-normalized <= 3e-4 (SW) / 2.5e-3 (LW) in f32, 1e-9 in f64; the
     energy budgets of the run as in phase 3.  Prints the CLI's region
     walls (read_input / radsurf / save).
  graphs - the compiled programs (utils/graphs.py: spartacus_sw /
     spartacus_lw on the kernel route and run_radsurf's device core, a CUDA
     graph per key, captured at the second call and replayed after) against
     their eager runs under graphs.disabled(), the graphs cleared before
     each run: the headline solve check's step (spartacus_sw +
     spartacus_lw, 16,384 x 8 x 1, nreg 2, AUTO chunk; checks.SHAPES) in
     float32 and float64, the nreg3 one (8,192 columns, nreg 3) and the
     rami5 one (1,024 x 62 x 14, nreg 3) in float32, run_radsurf at
     rami5_ns1 (SW on K1d) and at the headline's mixed tiles in float32;
     and the CLI (cli_ns4, single precision) streamed in
     GRAPH_CLI_CHUNK-column chunks, run eagerly and three times with
     graphs.  Checks: no synchronizing CUDA operation in
     the eager call (sync_sites: such an operation would stop a capture);
     the captured call's outputs
     bit-equal to the eager call's, a field that is not within GRAPH_TOL
     (named in the line); the path's kernels counted in one replay (the
     counters set to 0 just before it, read just after); the CLI's output
     files bit-equal (else within GRAPH_TOL), its last run replaying every
     chunk with no capture, every kernel of the path counted.  Prints per
     run: capture_s and the capture call's wall, walls of graph and eager
     calls in turns (GRAPH_ROUNDS rounds of graph, eager, eager, graph:
     median, min, max), one torch.profiler trace of each mode (host launch
     calls, device launches, busy ms, idle share), each mode's peak device
     memory above the inputs, and the graphs' pool (reserved and free GiB);
     the CLI's radsurf region walls in turns.  Then urban_mix_host
     (host_arrays_run): run_radsurf on the benchmark's urban_mix.f32 host
     arrays with one intra-op thread, kept arrays (copied straight from
     their pages) against fresh copies (packed) in turns, walls, the share
     moved straight and the registrations.  Every other phase runs its
     calls as a user would, through the graphs, and keeps the graphs the
     earlier phases left; a call whose kernel calls are held against their
     plain versions (Capture, CompareEach) runs eagerly.  The grad and
     shapes phases start with the graphs cleared (graphs.clear()), as in a
     process of their own, and so does the auto phase's ballast (memory
     another process took first).
  parallel - streamed, meshed and multi-process runs (parallel/), each with
     the launch counters set to 0 just before it and read just after (K1-K5
     must launch on every path), every line with the card's name and power
     limit:
       stream_equal: parallel.streaming.stream_columns(run_radsurf, chunk
         65,536, depth 2) on the headline's tile mix repeated 16 times
         (278,528 columns: every chunk holds every tile type; 4 chunks and a
         16,384-column tail), float32 and float64, against one run_radsurf
         call on the same arrays: field-normalized <= 1e-5 (float32; cuBLAS
         picks its algorithms by batch size) / 1e-12 (float64); the energy
         budgets reduced on the card per chunk within phase 3's bars; no
         synchronizing CUDA operation in the streamed run
         (torch.cuda.set_sync_debug_mode("warn"): each one's Python frames
         are printed; the mode does not report torch.cuda.synchronize,
         which a graph's capture calls once per key: the run's captures are
         printed); one shot's warm wall (median of 3, its outputs
         fetched to the host as the stream's are) and columns/s.
       stream_scale: the headline's mix repeated 64 times (1,114,112
         columns: 17 chunks), float32 and float64: finite outputs of the expected
         shape, the budgets of every column, the peak device memory of the
         run (<= 3 x that of one one-shot call on the first 65,536 columns),
         the warm wall (float32 median of 3, float64 one warm run) and
         columns/s against stream_equal's one shot; in float32 one
         torch.profiler trace: the copies' device ms and the share of it
         that overlaps kernel time (must be > 0).
       mesh: run_radsurf(mesh=[cuda:0, cuda:0]) at the headline against the
         unsharded call, float32 and float64, at stream_equal's bars; each
         shard launches K1-K5, so every count doubles; both warm walls.
       multiprocess: the CLI (cli_ns4 input and namelist of the cli phase)
         as 2 processes on the one card (gloo on a free port of 127.0.0.1),
         single precision with --keep-shards, then double, then double with
         --stream-chunk 4096: exit codes, each process's slice and the merge
         line, the merged file against the cli phase's single-process file
         (field-normalized <= 1e-5 in float32, every variable rtol / atol
         1e-12 in float64), the shards gone (kept with --keep-shards, and
         then merged again by `python -m
         spartacus_surface_tpu_torch.driver.merge` to the same file), each
         process's K1-K5 launches, its wall and its radsurf line.
  auto - the automatic chunks (column_chunk = -1, the CLI's automatic
     --stream-chunk), sized from the card by the working-set model
     (utils/device_memory.py, dispatch.working_set_bytes), every line with
     the card's name and power limit:
       model: the model's one-shot prediction against the measured
         max_memory_allocated of one warm kernel-route run_radsurf call
         (column_chunk 0; above what was allocated before it; eager, under
         graphs.disabled()) at the headline, rami5_shape and rami5_ns1,
         float32 and float64: each measured / predicted within AUTO_RATIO.
       sweep: warm walls (median, min, max of 5) and peaks of the kernel
         route at the AUTO_SWEEP column chunks, float32 and float64, and
         whether a chunk beats the whole batch by more than both walls'
         spread (printed, not held: it decides whether AUTO gets a
         throughput target).
       auto_equal: column_chunk -1 against 0 at the headline, at
         stream_equal's bars, with the chunks AUTO picked.
       squeeze: a ballast tensor leaves a budget (device_budget) of
         AUTO_SQUEEZE of the model's one-shot prediction for the cli phase's
         input (cli_ns4, float64), the allocator's reserve growth of each
         run printed; then driver.main.main with no
         --stream-chunk: exit code 0, the automatic stream line in its log,
         its peak less the ballast within the budget, the output file equal
         to the cli phase's double file (every variable rtol / atol 1e-12),
         K1-K5 launched; the CLI again, capturing its chunks' graphs (exit
         code 0, the same file, K1-K5 launched, its peak printed); then,
         with the graphs the CLI captured still held,
         run_radsurf(column_chunk=-1) on the headline in float64: the
         graphs released for its eager run, every chunk picked > 0, the peak less the ballast within
         the budget, equal to the unsqueezed call at auto_equal's bar, K1-K5
         launched.  With the ballast freed, both paths run again at the
         chunks picked under it, every kernel call captured and held
         against its plain version at the phase-2 bars.
       capture_footprint: one run_radsurf call at column_chunk 0 on the
         headline's mix x FOOTPRINT_REPEATS (696,320 columns) in float64,
         then the same call captured: the graph pool's growth over the
         eager call's peak less its inputs within CAPTURE_FACTOR
         (utils/device_memory.py; AUTO plans a solve on CUDA for that
         multiple of its transient).
       production: stream_scale's 1,114,112 columns in float64, the
         footprint's graph still held: the CLI's automatic stream chunk for
         them (printed), and one run_radsurf call at column_chunk -1:
         finite, K1-K5 launched, its peak against the model of the chunks
         it picked (dispatch._plan's need and inputs) within AUTO_RATIO;
         the same call twice more, the second captured and the third
         replayed, each with the chunks of the first.
  corners - utils/inputs.corner_grid (the JAX package's fuzz corner values
     as 500 columns x 2 layers of 5 m) through spartacus_sw and
     spartacus_lw, kernel route against scan route, float32 and float64,
     for CORNER_CONFIGS (nreg 3 urban, 2 urban, 2 forest, 1); the kernels
     of the path launched.  Budget-only columns: those the scan route
     cannot resolve in float32 (its float32 answer departs from its float64
     one by more than phase 3's float32 bar) and those whose layer factory
     takes CORNER_MAX_DOUBLINGS doubling steps or more (low sun through
     thick layers: rounding grows 2x a step).  On every other column the
     per-column field-normalized error is held to phase 3's bars: in
     float64 the kernel route against the scan route, in float32 the
     kernel route's distance from the float64 scan route less the float32
     scan route's own.  Budgets, every column: the kernel route's residual
     within phase 3's bar wherever the scan route's is within half of it,
     and in float64 within the bar of the scan route's everywhere (both
     leak where a region sits at or below its minimum fraction, as the JAX
     package does).  Each kernel's captured calls against their plain
     versions are printed, not held: the budget-only elements' doubling
     steps amplify rounding past the phase-2 bars.
  demo - driver.test_kernels.main(["all", "--device", "cuda"]): the
     1-stream, 2-region SW operators on K1d and the LW ones on K1; exit code
     0 (its Schur-vs-brute-force self-check at 1e-10 in f64), K1d and K1
     launched, and the demo's own factory calls (SW on K1d, LW on K1)
     against their plain versions on the same operands, every output field,
     <= 1e-9 in f64.
  grad - the gradient of run_radsurf with respect to a veg_ext tensor, of
     the JAX test's loss (sum of sw_norm_dir ground_net + sum of
     lw_internal top_net, tests/test_autodiff.py:129), on the kernel route
     (solver._KernelRouteGrad: the kernels forward, the scan route
     recomputed per column chunk backward, column_chunk = GRAD_CHUNK) at
     the headline and on the cli_ns1-shaped columns (the cli phase's tile
     mix and 1-stream namelist, through run_radsurf: K1d forward), float32
     and float64.  Checks: every kernel of the path launched in one step
     and each captured kernel call against its plain version (the phase-2
     bars); the kernel route's gradient against the scan route's (whose
     step keeps its whole graph, all columns) at 1e-9 relative in float64
     and GRAD_AGREE_F32 in float32 (max|diff| / max|scan|); finite; the
     autograd graph freed after the step (nothing left allocated but the
     allocator's blocks of the gradient and the loss, read from its
     snapshot, and what a graph captured in the step keeps in the graph
     cache); in float64 a directional central
     difference of the kernel route's loss (step FD_STEP along a seeded
     normal v) against <grad, v> within 5e-4 relative
     (tests/test_autodiff.py:104).  Prints each step's launches, peak
     device memory (kernel-route step; scan-route step) and the warm walls
     (median of 3) of a forward-only call and of forward + backward, and
     their ratio.
  retrieval - examples/retrieval.run([]) on the card at its defaults (64
     columns, 4 layers, 200 Adam steps): the misfit must fall below 1e-2 of
     its first value (tests/test_retrieval_example.py:61) with K1, K2 and
     K3 launched; prints the seconds a step takes and the final mean
     |veg_ext - truth|.
  assoc - SolverOptions(associative_sweeps=True) on the kernel route (K1,
     then the plain associative sweeps) against the sequential kernel route
     (K1-K5), SW and LW, float32 and float64, at ASSOC_SHAPES: a deep
     canopy (8 Forest columns, nreg 3, ns 4, 1,024 thin layers, 1 band) and
     the headline (16,384 VegetatedUrban columns, nreg 2, ns 4, 8 layers),
     on utils/inputs.example_arrays' seeded fields (as phase 3).
     Checks: K1 in both modes launched and K2-K5 not on the associative
     route, K1-K5 on the sequential one; field-normalized error <= 3e-4
     (SW) / 2.5e-3 (LW) in float32, 1e-9 in float64; the associative
     route's energy budgets within phase 3's bars.  Prints both routes'
     warm walls (median of 3) and peak device memory.
  roofline - the roofline tool's main path, tools.roofline.main(
     ["--cols-per-sec", <headline rate>]) with the probe counters set to 0
     just before it and read just after (K6 and K7 must launch); K6
     (chained FMA, float32 and float64) and K7 (o = x + 1 over 512 MB)
     against their plain versions on the tool's seeded operands (K6 rtol
     1e-4 in float32, since fma rounds once a step where mul + add rounds
     twice, and 1e-12 in float64; K7 torch.equal, into a new tensor and
     into a preallocated one); the measured FMA
     ceilings and HBM bandwidth, each a share of the H100's published
     peak (67 / 34 TFLOP/s, 3.35 TB/s), which must lie in [0.5, 1.05];
     K7 against its library call torch.add(x, 1.0, out=o), both writing
     the same preallocated o, both timed the same two ways, each in turns
     (kernel, library, library, kernel): the tool's event_ms (20
     back-to-back launches after a warm-up, median of 3) and the
     kernel-only device time of one torch.profiler trace of 20 calls;
     the SM clock and power
     draw nvidia-smi reads while each probe runs; every kernel row's
     FLOPs and compulsory bytes (tools.roofline.kernel_work on the timed
     call's operands) and its bound, whose share of the measured time must
     not exceed 1.05; and the whole-solve roofline: warm walls (median of 3
     calls) of the float32 headline and rami5_shape kernel routes as
     layered columns/s against solve_work_model's ceiling at the run's own
     mean doubling counts.
  4. profile (--profile only) - for each slice run: warm wall seconds of
     both routes (median, min, max of 5 calls), and one torch.profiler trace
     of a warm kernel-route call: device launches, device busy ms (union of
     the device intervals), the device idle share of the call, and each
     kernel's device ms; the same trace of one headline step of the grad
     phase, float32 and float64.
  shapes - each spartacus_surface_tpu_torch.checks.SHAPES entry once, in
     its order and at its full shape (the build check, kernel-vs-scan
     parity on the four configs in float32 and float64, mesh parity, nreg
     3, rami5 and its float64 twin, the CLI on 50,048 columns, a gradient
     step, 1,048,576 columns, the headline in float64 and float32), with
     the launch counters set to 0 just before each and read just after
     (K1-K5 must launch in each; checks.cli also holds the CLI's own count,
     which its subprocess prints under --timings), and every kernel call of
     the solve and gradient entries (SHAPES_COMPARED) held against its
     plain version on the same operands at phase 2's bars.  Fails on an
     entry that raises (its line holds the error), a kernel not launched or
     one that disagrees.  One line an entry with its findings, launches and
     kernel errors, then one with the phase's seconds.
Phase 3 also prints the factory's launch shape for each run (K1, or K1d
at rami5_ns1's SW: team size, teams and threads per block, slab and shared
bytes per block, resident blocks and teams per SM, registers, waves;
layer_kernel.factory_config), and a `sweeps` line: K2-K5 timed on that
run's operands with their FLOPs, bytes, bound and share, and their launch
shapes (sweep_kernels.up_config for K2 and K4, down_config for K3 and K5).
A `k1d` line for rami5_ns1 and for the CLI's cli_ns1 run, float32 and
float64: K1d's SW call (rami5_ns1: its one SW call; cli_ns1: its largest)
and its LW call (cli_ns1 only) timed with CUDA events against their plain
versions, with FLOPs, bytes, bound, share and K1d's launch shape.
Then the per-kernel summary line {"kernels": [...]} (K1-K5: launches
counted over the headline float32 run of phase 3, ms / plain_ms timed with
CUDA events on that run's operands, the K1 row also with K1's launch shape
at the headline, SW and LW; K2-K5 also ms, FLOPs, bytes, bound and share
at the rami5 shape in float32 (*_rami5), and their launch shapes at both
shapes;
K1d: launches over the cli_ns1 single
run, timed on its largest SW call and its LW call; the LW calls as
launches_lw / ms_lw / plain_ms_lw; on both calls its launch shape and its
kernel's own device ms (device_ms, share_device: the wrapper's ms of a
small call is mostly host work; null where three profiler traces in a row
caught no device event); its SW call at rami5_ns1 (float32) as
*_rami5; K6 and K7: launches over the roofline
tool's run, timed on its operands, K6's float64 as *_f64, K7 and its
library call both with event_ms and the profiler; every row with
flops, bytes, bound_ms, bound_by and share, the factory rows also
bound_ms_lw and share_lw; library_ms for K7 only: no single PyTorch call
computes K1-K6), the card's name and power limit from nvidia-smi, and the
final {"ok": true, "device": {...}} line.

Inputs are random from fixed numpy seeds (spartacus_surface_tpu_torch/utils/
inputs.py); the CLI's files are written under build/chip_smoke_cli/.
Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ENTRY_CONFIGS = ((1, 2), (2, 4), (3, 4), (2, 8))  # (nreg, nstream)
ONE_STREAM_CONFIGS = ((1, 1), (2, 1), (3, 1))  # the factory is K1d here
SOURCES = ("layer_factory", "sw_sweeps", "lw_sweeps", "roofline_probes")  # csrc/<name>.cu
# (name, source, TPU kernel replaced, device symbol, solver wrappers, which
# factory calls: "structured" (K1), "dense" (K1d) or None for every call)
KERNELS = (
    ("K1 layer_factory", "spartacus_surface_tpu_torch/csrc/layer_factory.cu",
     "spartacus_surface_tpu/ops/pallas_layer.py:788", "layer_factory_kernel",
     ("layer_factory", "lw_layer_factory"), "structured"),
    ("K2 sw_up_sweep", "spartacus_surface_tpu_torch/csrc/sw_sweeps.cu",
     "spartacus_surface_tpu/ops/pallas_sweep.py:783", "sw_up_kernel",
     ("sw_up_sweep",), None),
    ("K3 sw_down_sweep_both", "spartacus_surface_tpu_torch/csrc/sw_sweeps.cu",
     "spartacus_surface_tpu/ops/pallas_sweep.py:842", "sw_down_kernel",
     ("sw_down_sweep_both",), None),
    ("K4 lw_up_sweep", "spartacus_surface_tpu_torch/csrc/lw_sweeps.cu",
     "spartacus_surface_tpu/ops/pallas_sweep.py:964", "lw_up_kernel",
     ("lw_up_sweep",), None),
    ("K5 lw_down_sweep_both", "spartacus_surface_tpu_torch/csrc/lw_sweeps.cu",
     "spartacus_surface_tpu/ops/pallas_sweep.py:1020", "lw_down_kernel",
     ("lw_down_sweep_both",), None),
    ("K1d layer_factory_dense",
     "spartacus_surface_tpu_torch/csrc/layer_factory.cu",
     "spartacus_surface_tpu/ops/pallas_layer.py:268",
     "layer_factory_dense_kernel", ("layer_factory", "lw_layer_factory"),
     "dense"),
)
# the probe kernels of the roofline tool: (name, source, TPU kernel replaced)
PROBES = (("K6 fma_chain", "spartacus_surface_tpu_torch/csrc/roofline_probes.cu",
           "tools/roofline.py:39"),
          ("K7 copy_add", "spartacus_surface_tpu_torch/csrc/roofline_probes.cu",
           "tools/roofline.py:83"))
WRAPPERS = ("layer_factory", "lw_layer_factory", "sw_up_sweep",
            "sw_down_sweep_both", "lw_up_sweep", "lw_down_sweep_both")
SWEEPS = WRAPPERS[2:]  # K2-K5
# {kernel: the device symbol a trace names it with}
TRACED = {kname: sym for kname, _, _, sym, _, _ in KERNELS}
UP_SWEEPS = {"sw_up_sweep": "sw_sweeps", "lw_up_sweep": "lw_sweeps"}  # K2, K4
DOWN_SWEEPS = {"sw_down_sweep_both": "sw_sweeps", "lw_down_sweep_both": "lw_sweeps"}  # K3, K5
# a team kernel's launch shape as printed (cuda_build.team_config's fields)
SHAPE_FIELDS = {"team_size": "team_size", "teams_per_block": "elements_per_block",
                "threads_per_block": "threads_per_block", "slab_bytes": "slab_bytes",
                "smem_per_block": "smem_per_block", "blocks_per_sm": "blocks_per_sm",
                "resident_per_sm": "resident_per_sm", "registers": "registers",
                "waves": "waves"}
# the launch counters a run must raise: a 4-stream path, and a 1-stream one
PATH_4 = ("K1", "K2", "K3", "K4", "K5", "K1 LW mode")
PATH_1 = PATH_4 + ("K1d", "K1d LW mode")
PATH_R5_1 = PATH_4 + ("K1d",)  # rami5_ns1: SW on K1d (nd = 3), LW on K1
# tile types of layered columns (forest, urban, vegetated urban), and the
# work model's (nreg, nstream, layers, bands) of each slice run
LAYERED = (1, 2, 3)
SOLVE_MODELS = {"headline": (2, 4, 8, 1), "rami5_shape": (3, 4, 62, 14)}
CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
# (tile code, columns) of the headline and of the cli phase's input file;
# the headline's configuration
HEADLINE_TILES = ((3, 16384), (0, 512), (4, 256), (5, 256))
CLI_TILES = ((3, 8192), (1, 4096), (2, 4096), (0, 512), (4, 256), (5, 256))
HEADLINE_CONFIG = dict(n_vegetation_region_urban=1, n_stream_sw_urban=4,
                       n_stream_lw_urban=4, nsw=1, nlw=1)
CLI_NAMELIST = """&radsurf
  n_stream_sw_forest = {ns}, n_stream_sw_urban = {ns},
  n_stream_lw_forest = {ns}, n_stream_lw_urban = {ns},
  n_vegetation_region_forest = 2, n_vegetation_region_urban = 1,
  nsw = 1, nlw = 1,{extra}
/
&radsurf_driver
  do_conservation_check = .true.,
  iverbose = 2,
/
"""
# float32 per-field bar of each sweep kernel (tests/test_pallas_sweep.py:25,
# 94); K1 is held elementwise
# grad phase: the kernel route's column chunk (each chunk's backward
# recomputes its own scan graph), the float32 bar of its gradient against
# the scan route's (the same computation, cuBLAS's batch-size-dependent
# algorithms apart), and the step of the float64 central difference
GRAD_CHUNK = 8192
GRAD_AGREE_F32 = 1e-4
FD_STEP = 1e-5
# assoc phase: (columns, layers, tile code, nreg, urban, dz scale) at
# nstream 4, 1 band;
# the deep canopy's layers thinned to a ~28 m canopy
ASSOC_SHAPES = {"deep_canopy": (8, 1024, 1, 3, False, 0.005),  # Forest
                "headline": (16384, 8, 3, 2, True, 1.0)}  # VegetatedUrban
SWEEP_TOL_F32 = {"sw_up_sweep": 3e-5, "sw_down_sweep_both": 3e-5,
                 "lw_up_sweep": 3e-5, "lw_down_sweep_both": 2e-4}
# parallel phase: the column chunk and in-flight depth of the streamed runs,
# the headline's tile mix repeated for stream_equal and stream_scale, the
# bars of a streamed (or meshed) run against one shot (field-normalized;
# float32 allows for cuBLAS choosing its algorithms by batch size), the
# multi-process runs' input chunk and their time limits
PAR_CHUNK, PAR_DEPTH = 65536, 2
PAR_REPEATS = {"stream_equal": 16, "stream_scale": 64}
PAR_TOL = {"float32": 1e-5, "float64": 1e-12}
PAR_MP_STREAM_CHUNK = 4096
PAR_MP_TIMEOUT = 600  # seconds a CLI process may take; barriers: 300
# a CLI process of the multi-process runs: driver.main.main, then the launch
# counts of K1-K5 in that process on a line of its own
PAR_CHILD = """
import json, sys
from spartacus_surface_tpu_torch.driver import main
from spartacus_surface_tpu_torch.ops import layer_kernel as LK
from spartacus_surface_tpu_torch.ops import lw_sweep_kernels as LSK
from spartacus_surface_tpu_torch.ops import sweep_kernels as SK
rc = main.main(sys.argv[1:])
print("LAUNCHES " + json.dumps({
    "K1": LK.layer_factory.launches, "K2": SK.sw_up_sweep.launches,
    "K3": SK.sw_down_sweep_both.launches, "K4": LSK.lw_up_sweep.launches,
    "K5": LSK.lw_down_sweep_both.launches,
    "K1 LW mode": LK.lw_layer_factory.launches}), flush=True)
sys.exit(rc)
"""
# auto phase: the working-set model's bounds on measured / predicted peak,
# the column chunks of the sweep, the ballast's target budget as a share of
# the cli_ns4 float64 input's one-shot prediction; corners: the grid's
# (nreg, nstream, urban) configurations
AUTO_RATIO = (0.67, 1.10)
AUTO_SWEEP = {"headline": (0, 2048, 8192), "rami5_shape": (0, 256, 512)}
AUTO_SQUEEZE = 0.5
# the headline's mix repeated this many times (696,320 columns) for the
# auto phase's capture_footprint: a one-shot float64 call of 36.6 GiB
FOOTPRINT_REPEATS = 40
# shapes phase: the checks.SHAPES entries held to the plain versions
SHAPES_COMPARED = ("nreg3", "rami5", "rami5_f64", "grad", "capacity", "headline_f64",
                   "headline")
CORNER_CONFIGS = ((3, 4, True), (2, 4, True), (2, 4, False), (1, 4, True))
# graphs phase: rounds of (graph, eager, eager, graph) timed calls, the
# streamed CLI run's column chunk (the cli input's tile blocks make 4
# chunks of one VegetatedUrban shape, 2 of Forest, 2 of Urban, then a
# ragged mixed one), and the bar of a field that is not bit-equal (the
# loosest of phase 2's per-field bars)
GRAPH_ROUNDS = 10
GRAPH_CLI_CHUNK = 2048
GRAPH_TOL = {"float32": 2e-4, "float64": 1e-9}
# corner columns whose layer factory takes this many doubling steps or more
# (tools.roofline.doubling_steps) are held to their budgets only
CORNER_MAX_DOUBLINGS = 16
FAILURES = []
GiB = 2**30


def emit(**record):
    print(json.dumps(record), flush=True)


def check(ok, what):
    if not ok:
        FAILURES.append(what)
    return bool(ok)


def check_launched(counted, path, tag):
    """Fail unless every kernel of `path` has launches in `counted`."""
    return check(all(counted[k] > 0 for k in path),
                 f"{tag}: a kernel of the path was not launched {counted}")


def pieces(r, g, double=True, n=1 << 27):
    """Two fields in matching pieces of at most n elements (flattened where
    their shapes agree, whole where they broadcast), float64 unless
    double is false, so that comparing fields of 10 GiB (a 1M-column
    call's) takes temporaries of 1 GiB."""
    if r.shape != g.shape or r.numel() <= n:
        yield (r.double(), g.double()) if double else (r, g)
        return
    r, g = r.reshape(-1), g.reshape(-1)
    for i in range(0, r.numel(), n):
        rs, gs = r[i:i + n], g[i:i + n]
        yield (rs.double(), gs.double()) if double else (rs, gs)


def field_err(ref, got):
    """Worst per-field max|got - ref| / max(1, max|ref|, max|got|); inf if
    either side holds a non-finite value."""
    worst = 0.0
    for r, g in zip(ref, got):
        top, diff = 1.0, 0.0
        for rs, gs in pieces(r, g):
            if not (rs.isfinite().all() and gs.isfinite().all()):
                return math.inf
            top = max(top, rs.abs().max().item(), gs.abs().max().item())
            diff = max(diff, (rs - gs).abs().max().item())
        worst = max(worst, diff / top)
    return worst


class Capture:
    """Record the operands and results of every call of the kernel wrappers
    that a module (the solver, or the kernel demo) calls,
    {wrapper name: [(args, kwargs, result), ...]} (the wrappers themselves
    run unchanged, and the calls inside run eagerly: graphs.disabled())."""

    def __init__(self, module):
        self.module, self.calls = module, {n: [] for n in WRAPPERS}

    def __enter__(self):
        from spartacus_surface_tpu_torch.utils import graphs

        # the calls watched run eagerly (a replay calls no wrapper)
        self.eager = graphs.disabled()
        self.eager.__enter__()
        self.saved = {n: getattr(self.module, n) for n in WRAPPERS
                      if hasattr(self.module, n)}
        for name, fn in self.saved.items():
            def rec(*a, _n=name, _fn=fn, **k):
                out = _fn(*a, **k)
                self.record(_n, a, k, out)
                return out
            setattr(self.module, name, rec)
        return self

    def record(self, name, a, k, out):
        self.calls[name].append((a, k, out))

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)
        self.eager.__exit__(*exc)


class CompareEach(Capture):
    """A Capture that holds each call against its plain version as it
    returns (compare_call) and keeps only {wrapper name: [(kwargs,
    max_abs_err, passed, the first operand's shape, its dtype)]}, so that a call's
    operands and results go when the solve lets them go."""

    def __init__(self, module, plains):
        super().__init__(module)
        self.plains = plains

    def record(self, name, a, k, out):
        import torch

        err, ok = compare_call(name, self.plains[name], a, k, out, a[0].dtype == torch.float32)
        self.calls[name].append((k, err, ok, list(a[0].shape),
                                 str(a[0].dtype).removeprefix("torch.")))


def max_abs_diff(ref, got):
    """max|got - ref| over the fields; NaN counts as inf."""
    return max((gs - rs).abs().nan_to_num(nan=math.inf).max().item()
               for r, g in zip(ref, got) for rs, gs in pieces(r, g, double=False))


def plain_versions(LK, SK, LSK):
    """{wrapper name: its plain PyTorch version}."""
    return {"layer_factory": LK.layer_factory_plain,
            "lw_layer_factory": LK.lw_layer_factory_plain,
            "sw_up_sweep": SK.sw_up_sweep_plain,
            "sw_down_sweep_both": SK.sw_down_sweep_plain,
            "lw_up_sweep": LSK.lw_up_sweep_plain,
            "lw_down_sweep_both": LSK.lw_down_sweep_plain}


def compare_call(name, plain, a, k, got, f32):
    """(max_abs_err, passed) of one captured kernel result against the plain
    version on the same operands."""
    import torch

    ref = plain(*a, **k)
    if isinstance(ref, dict):  # K1: the factory's named outputs
        names = list(ref)
        ref, got = [ref[n] for n in names], [got[n] for n in names]
        if f32:
            ok = (field_err(ref, got) < math.inf
                  and all(torch.allclose(gs, rs, rtol=2e-4, atol=2e-5)
                          for r, g in zip(ref, got)
                          for rs, gs in pieces(r, g, double=False)))
            return max_abs_diff(ref, got), ok
    return max_abs_diff(ref, got), field_err(ref, got) <= (
        SWEEP_TOL_F32[name] if f32 else 1e-9)


def runs_on(factory, k, LK):
    """Whether a call with keyword arguments k runs on the kernel of KERNELS
    whose factory field is `factory` (LW factory calls have ndir = 1)."""
    if factory is None:
        return True
    return LK.is_structured(k["nd"], k.get("ndir", 1)) == (factory == "structured")


def compare_kernels(calls, dtype, LK, SK, LSK):
    """Per kernel of KERNELS, (max_abs_err, passed) over every captured call
    of its wrappers that ran on it, against the plain versions on the same
    operands; (None, None) for a kernel with no call."""
    import torch

    plains = plain_versions(LK, SK, LSK)
    out = []
    for *_, names, factory in KERNELS:
        res = [compare_call(n, plains[n], a, k, got, dtype == torch.float32)
               for n in names for a, k, got in calls.get(n, ())
               if runs_on(factory, k, LK)]
        out.append((max(e for e, _ in res), all(ok for _, ok in res))
                   if res else (None, None))
    return out


def mean_doubling_steps(calls, kernel, RL):
    """Mean doubling count per element over the captured calls of a factory
    wrapper (tools.roofline.doubling_steps)."""
    steps = [RL.doubling_steps(kernel, *a, **k) for a, k, _ in calls]
    return sum(float(x.sum()) for x in steps) / sum(x.numel() for x in steps)


def launch_shape(config, suffix=""):
    """A team kernel's launch shape under SHAPE_FIELDS' names."""
    return {f"{name}{suffix}": config[key] for key, name in SHAPE_FIELDS.items()}


def time_ms(fn, reps=3):
    """Device ms per call of `reps` back-to-back calls after a warm-up call
    that is still running when the window opens (so the first call's host
    work is not inside it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(fn, calls=20, symbol="", tries=3):
    """Kernel-only device ms per call: the summed durations of the device
    kernels (those whose name holds `symbol`) of one torch.profiler trace of
    `calls` calls, over `calls`.  A trace that caught none of them (the
    profiler's device tracing now and then returns no device event) is
    taken again, up to `tries` traces; None (not measured) after that."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                 and symbol in e.name)
        if us > 0:
            return us / 1e3 / calls
    return None


def factory_launch(kernel, a, k, RL):
    """[g0, g1, g2, g3, dz] and the launch keywords of the factory launch
    behind a layer_factory or lw_layer_factory call (tools.roofline)."""
    *ops, ndir, int_direct = RL._factory_call(kernel, a, k)
    return ops, dict(nd=k["nd"], ndir=ndir, n_double=k["n_double"], int_direct=int_direct)


def useful_share(steps, group):
    """The share of the doubling steps that groups of `group` consecutive
    elements run that the elements need: sum K over the sum of each
    group's largest K (1.0 where no element takes a step)."""
    n = steps.numel() // group * group
    most = steps[:n].reshape(-1, group).amax(1).sum() * group if n else 0
    return float(steps[:n].sum() / most) if most else 1.0


def factory_divergence(kernel, a, k, LK, lib, stream):
    """One factory call's doubling counts and its order: the counts of
    tools.roofline.doubling_steps (mean, range) and the order pass's window,
    the useful doubling share of a warp's and of a block's teams (from those
    counts) as the elements come and in the launch's order, and the device
    ms (CUDA events) of the wrapper's ordered launch (the order pass and its
    argsort included), of the order pass and argsort alone, and of the
    launch as the elements come (the identity order).  A failure unless the
    order pass's counts are doubling_steps' (one step off only where the
    float64 norm lies within the operands' rounding of a step's edge,
    2^-16 of a step in log2) and the ordered and the identity launch agree
    bit for bit."""
    import torch

    from spartacus_surface_tpu_torch.tools import roofline as RL

    ops, kw = factory_launch(kernel, a, k, RL)
    L, _, B = ops[1].shape
    n = L * B
    cfg = LK.factory_config(lib, kw["nd"], kw["ndir"], n, ops[1].dtype)
    window = LK.order_window(cfg, n)
    keys_of = lambda: LK.order_keys(lib, *ops, nd=kw["nd"], ndir=kw["ndir"],
                                    n_double=kw["n_double"], window=window, stream=stream)
    keys = keys_of()
    order = LK.element_order(keys)
    steps = RL.doubling_steps(kernel, *a, **k).reshape(-1)
    counts = LK.doubling_counts(keys).reshape(-1).to(steps)
    log2 = torch.log2(RL.doubling_ratio(kernel, *a, **k).reshape(-1))
    off = counts != steps
    edge = ((log2 - log2.round()).abs() < 2**-16) & ((counts - steps).abs() == 1)
    check(bool((edge | ~off).all()),
          f"k1_divergence: {kernel} nd={kw['nd']}: the order pass counts "
          f"{int((off & ~edge).sum())} elements' doubling steps unlike doubling_steps")
    ident = torch.arange(n, device=keys.device)
    per_warp = 32 // cfg["team_size"]
    got = LK.launch(lib, *ops, chunk=0, stream=stream, **kw)
    ref = LK.launch_ordered(lib, *ops, ident, stream=stream, **kw)
    check(all(torch.equal(got[x], ref[x]) for x in ref),
          f"k1_divergence: {kernel} nd={kw['nd']}: the ordered launch differs from the identity's")
    del got, ref
    res = dict(
        elements=n, nd=kw["nd"], ndir=kw["ndir"], team_size=cfg["team_size"],
        teams_per_block=cfg["teams_per_block"], window=window, mean_steps=float(steps.mean()),
        min_steps=int(steps.min()), max_steps=int(steps.max()),
        counts_off_by_rounding=int(off.sum()),
        useful_warp_as_they_come=useful_share(steps, per_warp),
        useful_block_as_they_come=useful_share(steps, cfg["teams_per_block"]),
        useful_warp_ordered=useful_share(steps[order], per_warp),
        useful_block_ordered=useful_share(steps[order], cfg["teams_per_block"]),
        ms_ordered=time_ms(lambda: LK.launch(lib, *ops, chunk=0, stream=stream, **kw)),
        ms_order_pass=time_ms(lambda: LK.element_order(keys_of())),
        ms_as_they_come=time_ms(lambda: LK.launch_ordered(lib, *ops, ident, stream=stream,
                                                          **kw)))
    res["ordered_over_as_they_come"] = res["ms_ordered"] / res["ms_as_they_come"]
    return res


# the benchmark's urban_mix input set that the k1_divergence phase times
DIVERGENCE_SEED = 1618033921


def divergence_phase(dev):
    """Phase k1_divergence (see the module docstring): every factory call
    (K1, K1d; SW and LW mode) of three float32 run_radsurf calls, the
    headline, the rami5 shape and the benchmark's urban_mix.f32 input set
    (all six tile types, half of the columns at night), through
    factory_divergence; one line a call."""
    import numpy as np
    import torch

    from benchmark import generate as GEN
    from benchmark import run as BR
    from spartacus_surface_tpu_torch.models import solver
    from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
    from spartacus_surface_tpu_torch.ops import cuda_build
    from spartacus_surface_tpu_torch.ops import layer_kernel as LK
    from spartacus_surface_tpu_torch.utils.config import Config
    from spartacus_surface_tpu_torch.utils.inputs import example_arrays

    lib, stream = cuda_build.load("layer_factory"), cuda_build.stream(dev)
    slices, cell = slice_shapes(), BR.load_cell("urban_mix.f32")
    runs = {name: (slices[name][3], lambda name=name: example_arrays(
                C=len(slices[name][0]), L=slices[name][1], S=slices[name][2],
                dtype=np.float32, i_representation=slices[name][0]))
            for name in ("headline", "rami5_shape")}
    runs["urban_mix"] = (cell.config["radsurf"], lambda: GEN.input_set(
        cell.config, cell.traffic, DIVERGENCE_SEED, 0))
    for run, (cfg, arrays) in runs.items():
        config = Config(**dict(cfg, do_lw=True)).consolidate()
        with Capture(solver) as cap:
            run_radsurf(config, arrays(), dev)
        torch.cuda.synchronize()
        for kernel in ("layer_factory", "lw_layer_factory"):
            for i, (a, k, _) in enumerate(cap.calls[kernel]):
                emit(phase="k1_divergence", run=run, dtype="float32", kernel=kernel, call=i,
                     **factory_divergence(kernel, a, k, LK, lib, stream))
        del cap
        torch.cuda.empty_cache()


def clocks_during(fn, seconds=2.0):
    """The SM clock (MHz) and power draw (W) nvidia-smi reads every 100 ms
    while fn runs again and again on the card for `seconds`: medians and
    the sample count, or None where nvidia-smi gives no sample."""
    import torch

    try:
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    samples = []
    for line in out.splitlines():
        with contextlib.suppress(ValueError):
            samples.append([float(v) for v in line.split(",")][:2])
    if not samples:
        return None
    return {"sm_mhz": statistics.median(m for m, _ in samples),
            "power_w": statistics.median(w for _, w in samples),
            "samples": len(samples)}


def graph_pools():
    """Bytes of the CUDA graphs' pool segments on the card: (reserved, free)."""
    import torch

    segs = [g for g in torch.cuda.memory_snapshot() if tuple(g["segment_pool_id"]) != (0, 0)]
    return (sum(g["total_size"] for g in segs),
            sum(g["total_size"] - g["allocated_size"] for g in segs))


def wall_of(fn):
    """(host seconds of fn() to a synchronize, its result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def wall_seconds(fn, reps=5):
    """(median, min, max) host seconds of warm calls, each ending in a
    synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), min(walls), max(walls)


def group_err(out_s, out_k, groups):
    """field_err over every field of the given result groups."""
    keys = [(g, k) for g in groups for k in out_s[g]]
    return field_err([out_s[g][k] for g, k in keys],
                     [out_k[g][k] for g, k in keys]), keys


def nc_vars(path):
    """{name: float64 values} of a NetCDF3 file."""
    import numpy as np
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as f:
        return {k: np.array(v[:], np.float64) for k, v in f.variables.items()}


def nc_field_err(ref, got, names):
    """Worst field-normalized error over the named variables; inf if one is
    missing from either file or non-finite."""
    import numpy as np

    worst = 0.0
    for k in names:
        if k not in got or got[k].shape != ref[k].shape:
            return math.inf
        r, g = ref[k], got[k]
        if not (np.isfinite(r).all() and np.isfinite(g).all()):
            return math.inf
        worst = max(worst, np.abs(r - g).max() / max(1.0, np.abs(r).max()))
    return worst


def sync_sites(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): (its result, for
    each synchronizing CUDA operation it issued its 8 innermost Python
    frames as path:line, innermost first, a path under PyTorch's package as
    torch/..., one in this repo relative to it).  The mode reports the
    operations that synchronize as a side effect, not torch.cuda.synchronize
    (which a CUDA graph's capture calls, utils/graphs.py, once per key)."""
    import traceback
    import warnings

    import torch

    roots = ((Path(torch.__file__).resolve().parent, "torch"),
             (Path(__file__).resolve().parent, ""))
    sites = []

    def where(f):
        path = Path(f.filename).resolve()
        for root, prefix in roots:
            if path.is_relative_to(root):
                return "/".join(p for p in (prefix, str(path.relative_to(root))) if p)
        return path.name

    def show(message, category, filename, lineno, file=None, line=None):
        # PyTorch's own warning on entering the mode is not a sync
        if "called a synchronizing CUDA operation" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if not f.filename.endswith("warnings.py")]
            sites.append(" < ".join(f"{where(f)}:{f.lineno}" for f in frames[:-9:-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return res, sites


def copy_overlap(fn):
    """One torch.profiler trace of fn(): the device ms of the host<->device
    copies (by direction) and of the kernels, and the share of the copies'
    time that overlaps kernel time (None: the trace caught no copy)."""
    import bisect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    copies = [(n, t0, t1) for n, t0, t1 in spans if n.startswith("Memcpy")]
    union = []  # the kernels' busy intervals, merged
    for t0, t1 in sorted((t0, t1) for n, t0, t1 in spans
                         if not n.startswith(("Memcpy", "Memset"))):
        if union and t0 <= union[-1][1]:
            union[-1][1] = max(union[-1][1], t1)
        else:
            union.append([t0, t1])
    starts = [a for a, _ in union]
    overlaps = []  # each copy's us under kernel time
    for _, t0, t1 in copies:
        k, o = max(0, bisect.bisect_right(starts, t0) - 1), 0.0
        while k < len(union) and union[k][0] < t1:
            o += max(0.0, min(t1, union[k][1]) - max(t0, union[k][0]))
            k += 1
        overlaps.append(o)
    copy_us = sum(t1 - t0 for _, t0, t1 in copies)
    by_dir = {d: sum(t1 - t0 for n, t0, t1 in copies if d in n) / 1e3
              for d in ("HtoD", "DtoH", "DtoD")}
    overlap_by_dir = {d: sum(o for (n, _, _), o in zip(copies, overlaps) if d in n)
                      / 1e3 / by_dir[d] if by_dir[d] else None for d in by_dir}
    return dict(copy_ms=copy_us / 1e3, copy_ms_by_direction=by_dir,
                copies=len(copies), kernel_busy_ms=sum(b - a for a, b in union) / 1e3,
                device_events=len(spans),
                copy_overlap_share=sum(overlaps) / copy_us if copy_us else None,
                copy_overlap_share_by_direction=overlap_by_dir)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cli_processes(nproc, argv):
    """The CLI as nproc processes of PAR_CHILD on a free port of 127.0.0.1:
    [(exit code, stdout, stderr, wall seconds, K1-K5 launches)] by rank."""
    repo = Path(__file__).resolve().parent
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(repo))
    procs = []
    for pid in range(nproc):
        t0 = time.perf_counter()
        procs.append((t0, subprocess.Popen(
            [sys.executable, "-c", PAR_CHILD, *map(str, argv),
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(nproc),
             "--process-id", str(pid), "--barrier-timeout", "300"],
            cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    out = []
    for t0, p in procs:
        try:
            so, se = p.communicate(timeout=PAR_MP_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        wall = time.perf_counter() - t0
        line = next((ln for ln in so.splitlines() if ln.startswith("LAUNCHES ")), None)
        out.append((p.returncode, so, se, wall,
                    json.loads(line.split(" ", 1)[1]) if line else {}))
    return out


def parallel_phase(dev, headline, cli_files):
    """The parallel phase: stream_equal, stream_scale, mesh, multiprocess
    (see the module docstring).  headline: (tile codes, Config kwargs) of
    the slice phase's headline; cli_files: {"input", "columns", "namelist",
    "single", "double"}: the cli phase's input file and its column count, its
    cli_ns4 namelist and the single-process CLI's output file at each
    precision."""
    import numpy as np
    import torch

    from benchmark.run import card_line
    from spartacus_surface_tpu_torch import checks
    from spartacus_surface_tpu_torch.models.dispatch import (
        TILE_INFINITE_STREET, TILE_SIMPLE_URBAN, TILE_URBAN, TILE_VEGETATED_URBAN,
        run_radsurf)
    from spartacus_surface_tpu_torch.models.flux_utils import (
        budget_residual, budget_with_masks, representation_masks)
    from spartacus_surface_tpu_torch.ops.launches import counts, reset
    from spartacus_surface_tpu_torch.parallel.mesh import make_mesh
    from spartacus_surface_tpu_torch.parallel.streaming import stream_columns
    from spartacus_surface_tpu_torch.utils.config import Config
    from spartacus_surface_tpu_torch.utils.inputs import example_arrays

    from spartacus_surface_tpu_torch.utils import graphs

    card = card_line()
    groups = ("sw_norm_dir", "sw_norm_diff", "lw_internal", "lw_norm")
    dtypes = {"float32": np.float32, "float64": np.float64}
    rep_head, cfg_head = headline
    config = Config(do_lw=True, **cfg_head).consolidate()

    def solve(a):
        """run_radsurf on the card, with each group's per-column budget
        residual reduced there."""
        out = run_radsurf(config, a, dev)
        masks = representation_masks(a["i_representation"], dev)
        out["resid"] = {g: budget_residual(budget_with_masks(out[g], masks)) for g in groups}
        return out

    def streamed(arrays):
        return stream_columns(solve, arrays, PAR_CHUNK, PAR_DEPTH, device=dev)

    def host(out):
        """A run_radsurf result's leaves as CPU tensors, {(group, key): t}."""
        return {(g, k): (v.cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(v))
                for g in (*groups, "bc_out") for k, v in out[g].items()}

    def budget_check(out, arrays, f32, scale, tag):
        """The per-column residuals of a streamed result against the slice
        phase's bars (LW on the columns that conserve), through
        checks.budget_gate: an urban column with a sub-threshold roof
        (checks.sub_threshold_roofs, a leak of the reference's by design) is
        held to the scan route's residual on the same column instead."""
        rep = arrays["i_representation"]
        conserving = ~np.isin(rep, [TILE_SIMPLE_URBAN, TILE_INFINITE_STREET])
        leaky = np.isin(rep, [TILE_URBAN, TILE_VEGETATED_URBAN]) & checks.sub_threshold_roofs(
            arrays["building_fraction"], config.min_building_fraction)
        resid = {g: np.asarray(out["resid"][g], np.float64) * (
            conserving if g.startswith("lw") else 1.0) for g in groups}
        witness = None
        if leaky.any():
            idx = np.flatnonzero(leaky)
            sub = {k: v[idx] for k, v in arrays.items()}
            scan = run_radsurf(config, sub, dev, route="scan")
            masks = representation_masks(sub["i_representation"], dev)
            witness = {g: budget_residual(budget_with_masks(scan[g], masks)).double().cpu().numpy()
                       for g in groups}
        worst, failed = checks.budget_gate(
            resid, leaky, checks.budget_bars("float32" if f32 else "float64", scale), witness)
        for f in failed:
            check(False, f"{tag}: {f}")
        return worst

    def wall(fn, reps=3):
        """Median host seconds of reps calls of fn (already called once),
        each ending in a synchronize."""
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    # ---- stream_equal: streamed == one shot, every tile type in every chunk
    rep = np.tile(rep_head, PAR_REPEATS["stream_equal"])
    one_shot_rate = {}
    for dname, np_dt in dtypes.items():
        f32, tag = dname == "float32", f"stream_equal {dname}"
        arrays = example_arrays(C=len(rep), L=8, S=1, dtype=np_dt, i_representation=rep)
        scale = max(1.0, float(np.abs(arrays["ground_emission"]).max()))
        reset()
        torch.cuda.synchronize()
        before = graphs.stats()
        t0 = time.perf_counter()
        got, syncs = sync_sites(lambda: streamed(arrays))
        t_stream = time.perf_counter() - t0
        graph_stats = {k: graphs.stats()[k] - before[k] for k in ("captures", "releases")}
        c = counts()
        check_launched(c, PATH_4, tag)
        check(not syncs, f"{tag}: the streamed run synchronized the device at {syncs[:10]}")
        ref = run_radsurf(config, arrays, dev)
        ref_h = host(ref)
        del ref
        got_h = host(got)
        err = field_err(list(ref_h.values()), [got_h[k] for k in ref_h])
        check(err <= PAR_TOL[dname], f"{tag}: streamed vs one shot {err:.3e}")
        resid = budget_check(got, arrays, f32, scale, tag)
        del got, got_h, ref_h
        # one shot's rate, its outputs fetched to the host as the stream's are
        fetch = lambda: [t.cpu() for t in host(run_radsurf(config, arrays, dev)).values()]
        w_one = wall(fetch)
        one_shot_rate[dname] = len(rep) / w_one
        emit(phase="parallel", item="stream_equal", dtype=dname, columns=len(rep),
             chunk=PAR_CHUNK, depth=PAR_DEPTH, chunks=-(-len(rep) // PAR_CHUNK),
             field_normalized_err=err, tol=PAR_TOL[dname], max_budget_residual=resid,
             launches=c, sync_sites=syncs, graphs=graph_stats,
             seconds_streamed_first=t_stream,
             one_shot_warm_wall_seconds=w_one, one_shot_cols_per_sec=one_shot_rate[dname],
             torch=torch.__version__, card=card)
        del arrays
        torch.cuda.empty_cache()

    # ---- stream_scale: 64 x the headline
    rep = np.tile(rep_head, PAR_REPEATS["stream_scale"])
    for dname, np_dt in dtypes.items():
        f32, tag = dname == "float32", f"stream_scale {dname}"
        arrays = example_arrays(C=len(rep), L=8, S=1, dtype=np_dt, i_representation=rep)
        scale = max(1.0, float(np.abs(arrays["ground_emission"]).max()))
        # the peak of one one-shot call at the chunk's width
        first = {k: v[:PAR_CHUNK] for k, v in arrays.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        solve(first)
        torch.cuda.synchronize()
        peak_chunk = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = streamed(arrays)
        t_first = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        c = counts()
        check_launched(c, PATH_4, tag)
        finite = all(np.isfinite(v).all() for g in groups for v in got[g].values())
        shapes = got["sw_norm_dir"]["flux_dn_layer_top"].shape == (len(rep), 8, 1)
        check(finite and shapes, f"{tag}: non-finite or misshapen output")
        resid = budget_check(got, arrays, f32, scale, tag)
        check(peak <= 3 * peak_chunk, f"{tag}: peak {peak:.2f} GiB over 3 x {peak_chunk:.2f}")
        del got
        w = wall(lambda: streamed(arrays), reps=3 if f32 else 1)
        record = dict(phase="parallel", item="stream_scale", dtype=dname, columns=len(rep),
                      chunk=PAR_CHUNK, depth=PAR_DEPTH, chunks=-(-len(rep) // PAR_CHUNK),
                      max_budget_residual=resid, launches=c, finite=finite,
                      seconds_first=t_first, warm_wall_seconds=w,
                      cols_per_sec=len(rep) / w,
                      one_shot_cols_per_sec_stream_equal=one_shot_rate[dname],
                      streamed_over_one_shot=len(rep) / w / one_shot_rate[dname],
                      peak_gib=peak, peak_gib_one_shot_chunk=peak_chunk, card=card)
        if f32:  # one traced run, each chunk's solve issue timed on the host
            issue = []  # (host ms issuing a chunk's solve, its kernels done by then)

            def timed_solve(a):
                t0 = time.perf_counter()
                out = solve(a)
                done = torch.cuda.Event()
                done.record()
                issue.append(((time.perf_counter() - t0) * 1e3, done.query()))
                return out

            record.update(copy_overlap(lambda: stream_columns(
                timed_solve, arrays, PAR_CHUNK, PAR_DEPTH, device=dev)))
            record.update(issue_ms_per_chunk=statistics.median(ms for ms, _ in issue),
                          card_drained_at_issue_end=sum(d for _, d in issue) / len(issue))
            check((record["copy_overlap_share"] or 0) > 0,
                  f"{tag}: no copy overlapped a kernel {record['copy_overlap_share']}")
        emit(**record)
        del arrays, first
        torch.cuda.empty_cache()

    # ---- mesh: two shards on the one card against the unsharded call
    mesh = make_mesh(devices=[dev, dev])
    for dname, np_dt in dtypes.items():
        tag = f"mesh {dname}"
        arrays = example_arrays(C=len(rep_head), L=8, S=1, dtype=np_dt,
                                i_representation=rep_head)
        runs = {}
        for name, m in (("unsharded", None), ("mesh", mesh)):
            reset()
            out = run_radsurf(config, arrays, dev, mesh=m)
            torch.cuda.synchronize()
            runs[name] = (host(out), counts(),
                          wall(lambda: run_radsurf(config, arrays, dev, mesh=m)))
            del out
        (ref_h, c1, w1), (got_h, c2, w2) = runs["unsharded"], runs["mesh"]
        err = field_err(list(ref_h.values()), [got_h[k] for k in ref_h])
        check(err <= PAR_TOL[dname], f"{tag}: meshed vs unsharded {err:.3e}")
        check_launched(c2, PATH_4, tag)
        check(all(c2[k] == 2 * c1[k] for k in PATH_4),
              f"{tag}: the shards' launches {c2} are not twice {c1}")
        emit(phase="parallel", item="mesh", dtype=dname, columns=len(rep_head),
             mesh=[str(d) for d in mesh], field_normalized_err=err, tol=PAR_TOL[dname],
             launches_unsharded=c1, launches_mesh=c2, warm_wall_seconds_unsharded=w1,
             warm_wall_seconds_mesh=w2, card=card)
        del arrays, runs, ref_h, got_h
        torch.cuda.empty_cache()

    # ---- multiprocess: the CLI as 2 processes on the one card, merged
    out_dir = Path(cli_files["input"]).parent
    mp_runs = {"single_keep_shards": ("single", ["--keep-shards"]),
               "double": ("double", []),
               "double_stream": ("double", ["--stream-chunk", str(PAR_MP_STREAM_CHUNK)])}
    for mname, (prec, extra) in mp_runs.items():
        tag = f"multiprocess {mname}"
        out_nc = out_dir / f"mp_{mname}.nc"
        procs = run_cli_processes(2, [cli_files["namelist"], cli_files["input"], out_nc,
                                      "--device", dev.type, "--precision", prec, *extra])
        for rc, so, se, _, c in procs:
            check(rc == 0, f"{tag}: exit code {rc}: {se[-2000:]}")
            check_launched(c or {k: 0 for k in PATH_4}, PATH_4, tag)
        logs = [so for _, so, _, _, _ in procs]
        half = -(-cli_files["columns"] // 2)
        check(f"Process 0/2: columns 1 to {half}" in logs[0]
              and f"Process 1/2: columns {half + 1} to {cli_files['columns']}" in logs[1]
              and "Merged 2 output shards" in logs[0], f"{tag}: the process log lines")
        ref = nc_vars(cli_files[prec])
        got = nc_vars(out_nc) if out_nc.exists() else {}
        shards = [Path(f"{out_nc}.p{pid:02d}") for pid in range(2)]
        keep = "--keep-shards" in extra
        check(all(s.exists() == keep for s in shards), f"{tag}: shards left {shards}")
        record = {}
        if prec == "double":
            ok = set(ref) == set(got) and all(
                ref[k].shape == got[k].shape
                and np.allclose(got[k], ref[k], rtol=1e-12, atol=1e-12) for k in ref)
            record["max_abs_diff"] = max((float(np.abs(got[k] - ref[k]).max())
                                          for k in ref if k in got
                                          and got[k].shape == ref[k].shape), default=None)
        else:
            err = nc_field_err(ref, got, list(ref))
            ok = set(ref) == set(got) and err <= PAR_TOL["float32"]
            record["field_normalized_err"] = err
        check(ok, f"{tag}: the merged file differs from the single-process file {record}")
        if keep:  # the standalone merge of the kept shards
            remerged = out_dir / f"mp_{mname}_remerged.nc"
            for pid, s in enumerate(shards):
                Path(f"{remerged}.p{pid:02d}").unlink(missing_ok=True)
                os.link(s, f"{remerged}.p{pid:02d}")
            res = subprocess.run([sys.executable, "-m",
                                  "spartacus_surface_tpu_torch.driver.merge", str(remerged)],
                                 cwd=Path(__file__).resolve().parent, capture_output=True,
                                 text=True, timeout=PAR_MP_TIMEOUT,
                                 env=dict(os.environ, PYTHONPATH=str(
                                     Path(__file__).resolve().parent)))
            again = nc_vars(remerged) if remerged.exists() else {}
            same = res.returncode == 0 and set(again) == set(got) and all(
                np.array_equal(again[k], got[k]) for k in got)
            check(same, f"{tag}: the standalone merge {res.returncode} {res.stderr[-500:]}")
            record["standalone_merge_equal"] = same
        emit(phase="parallel", item="multiprocess", run=mname, processes=2,
             precision=prec, extra=extra, exit_codes=[p[0] for p in procs],
             wall_seconds=[p[3] for p in procs], launches=[p[4] for p in procs],
             elapsed_lines=[next((ln for ln in so.splitlines()
                                  if ln.startswith("Time elapsed")), None) for so in logs],
             shards_left=[s.exists() for s in shards], **record, card=card)


def tiles(spec):
    """The tile codes of a (code, columns) list, in order."""
    import numpy as np

    return np.concatenate([np.full(n, code) for code, n in spec])


def slice_shapes():
    """{run: (tile codes, layers, bands, Config kwargs)} of phase 3."""
    import numpy as np

    return {
        "headline": (tiles(HEADLINE_TILES), 8, 1, HEADLINE_CONFIG),
        "rami5_shape": (
            np.array([1] * 1024), 62, 14,
            dict(n_vegetation_region_forest=2, n_stream_sw_forest=4,
                 n_stream_lw_forest=4, nsw=14, nlw=14)),
        "rami5_ns1": (
            np.array([1] * 1024), 62, 14,
            dict(n_vegetation_region_forest=2, n_stream_sw_forest=1,
                 n_stream_lw_forest=1, nsw=14, nlw=14)),
    }


def cli_files_unchecked():
    """The cli phase's input, cli_ns4 namelist and single-process output
    files at both precisions, written here without the cli phase's checks
    (--parallel-only, --auto-only): the cli_files of parallel_phase."""
    import contextlib

    from spartacus_surface_tpu_torch.driver import main as cli
    from spartacus_surface_tpu_torch.utils.inputs import write_example_input

    CLI_DIR.mkdir(parents=True, exist_ok=True)
    rep_cli, nam = tiles(CLI_TILES), CLI_DIR / "cli_ns4.nam"
    write_example_input(CLI_DIR / "input.nc", rep_cli, L=8, S=1, seed=1)
    nam.write_text(CLI_NAMELIST.format(ns=4, extra=""))
    files = {"input": CLI_DIR / "input.nc", "columns": len(rep_cli), "namelist": nam}
    for prec in ("single", "double"):
        files[prec] = CLI_DIR / f"cli_ns4_{prec}.nc"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main([str(nam), str(files["input"]), str(files[prec]),
                           "--precision", prec, "--stream-chunk", "0"])
        check(rc == 0, f"the single-process CLI's exit code {rc}")
    return files


def auto_phase(dev, slices, cli_files):
    """The auto phase: model, sweep, auto_equal, squeeze, capture_footprint,
    production (see the module docstring).  slices: slice_shapes(); cli_files: as for parallel_phase."""
    import numpy as np
    import torch

    from benchmark.run import card_line
    from spartacus_surface_tpu_torch.driver import main as cli
    from spartacus_surface_tpu_torch.models import dispatch, solver
    from spartacus_surface_tpu_torch.ops import layer_kernel as LK
    from spartacus_surface_tpu_torch.ops import lw_sweep_kernels as LSK
    from spartacus_surface_tpu_torch.ops import sweep_kernels as SK
    from spartacus_surface_tpu_torch.ops.launches import counts, reset
    from spartacus_surface_tpu_torch.parallel.mesh import tree_leaves
    from spartacus_surface_tpu_torch.utils.config import Config
    from spartacus_surface_tpu_torch.utils.device_memory import (
        BUDGET_RESERVE, BUDGET_SHARE, CAPTURE_FACTOR, device_budget)
    from spartacus_surface_tpu_torch.utils import graphs
    from spartacus_surface_tpu_torch.utils.inputs import example_arrays

    card = card_line()
    dtypes = {"float32": np.float32, "float64": np.float64}
    groups = ("sw_norm_dir", "sw_norm_diff", "lw_internal", "lw_norm", "bc_out")

    def arrays_of(sname, dname):
        rep, L, S, _ = slices[sname]
        return example_arrays(C=len(rep), L=L, S=S, dtype=dtypes[dname], i_representation=rep)

    def config_of(sname, chunk):
        return Config(do_lw=True, column_chunk=chunk, **slices[sname][3]).consolidate()

    def host(out):
        return [v.cpu() for g in groups for _, v in sorted(out[g].items())]

    def peak_of(fn):
        """(fn(), the peak bytes allocated during it above those before)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    class Picks:
        """The column chunks _resolve_column_chunk returns while on."""

        def __enter__(self):
            self.fn, self.chunks = solver._resolve_column_chunk, []

            def rec(*a, **k):
                self.chunks.append(self.fn(*a, **k))
                return self.chunks[-1]
            solver._resolve_column_chunk = rec
            return self

        def __exit__(self, *exc):
            solver._resolve_column_chunk = self.fn

    # ---- model: predicted against measured one-shot peaks
    for sname in slices:
        for dname, np_dt in dtypes.items():
            arrays, config = arrays_of(sname, dname), config_of(sname, 0)
            # the model is of an eager call (an earlier phase may hold this
            # key's graph, whose replay allocates nothing; a capture's pool
            # is capture_footprint's)
            with graphs.disabled():
                dispatch.run_radsurf(config, arrays, dev)  # warm: workspaces, caches
                torch.cuda.empty_cache()
                peak = peak_of(lambda: dispatch.run_radsurf(config, arrays, dev))[1]
            rep, L = slices[sname][0], slices[sname][1]
            predicted = dispatch.working_set_bytes(config, rep, L, np.dtype(np_dt).itemsize)
            ratio = peak / predicted
            check(AUTO_RATIO[0] <= ratio <= AUTO_RATIO[1],
                  f"auto model {sname} {dname}: measured / predicted {ratio:.3f}")
            emit(phase="auto", item="model", run=sname, dtype=dname,
                 predicted_gib=predicted / GiB, measured_gib=peak / GiB, ratio=ratio,
                 bounds=AUTO_RATIO, card=card)
            del arrays
            torch.cuda.empty_cache()

    # ---- sweep: warm walls and peaks of the kernel route by column chunk
    for sname, chunks in AUTO_SWEEP.items():
        for dname in dtypes:
            arrays, rows = arrays_of(sname, dname), {}
            for ck in chunks:
                config = config_of(sname, ck)
                med, lo, hi = wall_seconds(lambda: dispatch.run_radsurf(config, arrays, dev))
                peak = peak_of(lambda: dispatch.run_radsurf(config, arrays, dev))[1]
                rows[ck] = dict(median_s=med, min_s=lo, max_s=hi, spread_s=hi - lo,
                                peak_gib=peak / GiB)
            whole = rows[0]
            beats = {ck: whole["median_s"] - r["median_s"] > max(whole["spread_s"], r["spread_s"])
                     for ck, r in rows.items() if ck}
            emit(phase="auto", item="sweep", run=sname, dtype=dname, walls=rows,
                 chunk_beats_whole_batch=beats, card=card)
            del arrays
            torch.cuda.empty_cache()

    # ---- auto_equal: column_chunk -1 against 0 at the headline
    unsqueezed = {}
    for dname in dtypes:
        arrays = arrays_of("headline", dname)
        with Picks() as picks:
            got = host(dispatch.run_radsurf(config_of("headline", -1), arrays, dev))
        ref = host(dispatch.run_radsurf(config_of("headline", 0), arrays, dev))
        err = field_err(ref, got)
        check(err <= PAR_TOL[dname], f"auto_equal {dname}: -1 vs 0 {err:.3e}")
        emit(phase="auto", item="auto_equal", run="headline", dtype=dname,
             field_normalized_err=err, tol=PAR_TOL[dname], chunks_picked=picks.chunks,
             card=card)
        unsqueezed[dname] = ref
        del arrays, got
    torch.cuda.empty_cache()

    # ---- squeeze: a ballast leaves about AUTO_SQUEEZE of the cli_ns4
    # float64 input's one-shot prediction; the CLI with no --stream-chunk,
    # then run_radsurf(column_chunk=-1) at the headline in float64
    nam = cli_files["namelist"]
    cfg_cli = Config.from_namelist(nam).consolidate()
    predicted_cli = dispatch.working_set_bytes(cfg_cli, tiles(CLI_TILES), 8, 8)
    # the ballast stands for memory another process took before this one
    # held any graph: it is placed on a card with no graph pool; the
    # squeezed CLI then captures its graphs in what is left, and the
    # squeezed run_radsurf runs with them held
    graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    device_gib = dict(total=total / GiB, free=free / GiB, cached=cached / GiB,
                      outside_pytorch=(total - free - torch.cuda.memory_reserved(dev)) / GiB)
    ballast = torch.empty(
        int(free + cached - (AUTO_SQUEEZE * predicted_cli + BUDGET_RESERVE) / BUDGET_SHARE),
        dtype=torch.uint8, device=dev)
    held = torch.cuda.memory_allocated()  # the ballast and whatever else is live

    def squeezed(fn):
        """(fn(), the budget before it, its peak less `held`); the growth of
        the allocator's reserve is kept in `reserved`."""
        budget = device_budget(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_reserved()
        out = fn()
        torch.cuda.synchronize()
        reserved.append(torch.cuda.max_memory_reserved() - before)
        return out, budget, torch.cuda.max_memory_allocated() - held

    reserved = []

    out_nc = Path(cli_files["input"]).parent / "auto_squeeze_double.nc"
    argv = [str(nam), str(cli_files["input"]), str(out_nc), "--precision", "double"]
    stdout = io.StringIO()
    reset()
    with contextlib.redirect_stdout(stdout):
        rc, budget, peak = squeezed(lambda: cli.main(argv))
    c = counts()
    line = next((ln for ln in stdout.getvalue().splitlines()
                 if ln.endswith("-column chunks (host pipeline; see --stream-chunk)")), None)
    stream_chunk = int(line.split()[4].split("-")[0]) if line else None
    ref, got = nc_vars(cli_files["double"]), nc_vars(out_nc) if out_nc.exists() else {}
    same = set(ref) == set(got) and all(
        ref[k].shape == got[k].shape and np.allclose(got[k], ref[k], rtol=1e-12, atol=1e-12)
        for k in ref)
    check(rc == 0, f"auto squeeze cli: exit code {rc}")
    check(line is not None, "auto squeeze cli: no automatic stream line in the log")
    check(peak <= budget, f"auto squeeze cli: peak {peak / GiB:.3f} over the budget"
          f" {budget / GiB:.3f} GiB")
    check(same, "auto squeeze cli: the file differs from the cli phase's double file")
    check_launched(c, PATH_4, "auto squeeze cli")
    emit(phase="auto", item="squeeze_cli", exit_code=rc, stream_line=line,
         stream_chunk=stream_chunk, budget_gib=budget / GiB,
         one_shot_predicted_gib=predicted_cli / GiB, peak_less_ballast_gib=peak / GiB,
         reserve_growth_gib=reserved[-1] / GiB, before_ballast_gib=device_gib,
         ballast_gib=ballast.numel() / GiB, same_file_1e12=same, launches=c,
         max_abs_diff=max((float(np.abs(got[k] - ref[k]).max()) for k in ref
                           if k in got and got[k].shape == ref[k].shape), default=None),
         card=card)

    # the CLI once more: its chunks' keys are seen now, so it captures their
    # graphs in the squeezed memory (each chunk holds another mix of tile
    # codes, so no key repeats within one run); its peak counts the graphs'
    # static buffers, which the working-set model does not
    before = graphs.stats()
    stdout2 = io.StringIO()
    reset()
    with contextlib.redirect_stdout(stdout2):
        rc2, budget2, peak2 = squeezed(lambda: cli.main(argv))
    c2 = counts()
    after = graphs.stats()
    got2 = nc_vars(out_nc) if out_nc.exists() else {}
    same2 = set(ref) == set(got2) and all(
        ref[k].shape == got2[k].shape and np.allclose(got2[k], ref[k], rtol=1e-12, atol=1e-12)
        for k in ref)
    check(rc2 == 0, f"auto squeeze cli again: exit code {rc2}")
    check(after["captures"] > before["captures"], "auto squeeze cli again: nothing captured")
    check(same2, "auto squeeze cli again: the file differs from the cli phase's double file")
    check_launched(c2, PATH_4, "auto squeeze cli again")
    emit(phase="auto", item="squeeze_cli_again", exit_code=rc2, budget_gib=budget2 / GiB,
         peak_less_ballast_gib=peak2 / GiB, reserve_growth_gib=reserved[-1] / GiB,
         same_file_1e12=same2, launches=c2,
         **{k: after[k] - before[k] for k in ("captures", "replays", "releases")},
         graphs_held_gib=[b / GiB for b in graphs.held(dev)], card=card)

    # the CLI's graphs stay, holding part of the squeezed memory: the call
    # plans with it (device_budget counts it available) and its eager run
    # gets it back (the cache releases the graphs)
    held_graphs = graphs.stats()
    arrays = arrays_of("headline", "float64")
    reset()
    with Picks() as picks:
        out, budget, peak = squeezed(
            lambda: host(dispatch.run_radsurf(config_of("headline", -1), arrays, dev)))
    c = counts()
    releases = graphs.stats()["releases"] - held_graphs["releases"]
    err = field_err(unsqueezed["float64"], out)
    check(held_graphs["graphs"] > 0, "auto squeeze run_radsurf: the squeezed CLI left no graph")
    check(releases > 0, "auto squeeze run_radsurf: the CLI's graphs were not released")
    check(picks.chunks and all(ck > 0 for ck in picks.chunks),
          f"auto squeeze run_radsurf: chunks {picks.chunks}")
    check(peak <= budget, f"auto squeeze run_radsurf: peak {peak / GiB:.3f} over the"
          f" budget {budget / GiB:.3f} GiB")
    check(err <= PAR_TOL["float64"], f"auto squeeze run_radsurf: vs unsqueezed {err:.3e}")
    check_launched(c, PATH_4, "auto squeeze run_radsurf")
    emit(phase="auto", item="squeeze_run_radsurf", run="headline", dtype="float64",
         chunks_picked=picks.chunks, graphs_held_before=held_graphs["graphs"],
         graph_releases=releases, budget_gib=budget / GiB, peak_less_ballast_gib=peak / GiB,
         reserve_growth_gib=reserved[-1] / GiB,
         field_normalized_err=err, tol=PAR_TOL["float64"], launches=c, card=card)
    del ballast, out
    torch.cuda.empty_cache()

    # ---- the squeezed paths' kernel calls against their plain versions
    # (captured in reruns without the ballast, with the chunks picked
    # under it: a capture keeps every operand alive)
    kernel_errs = {}
    with Capture(solver) as cap:
        dispatch.run_radsurf(config_of("headline", picks.chunks[0]), arrays, dev)
    kernel_errs["run_radsurf"] = compare_kernels(cap.calls, torch.float64, LK, SK, LSK)
    del cap
    if stream_chunk:
        with Capture(solver) as cap, contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv[:2] + [str(out_nc) + ".capture", "--precision", "double",
                                 "--stream-chunk", str(stream_chunk)])
        kernel_errs["cli"] = compare_kernels(cap.calls, torch.float64, LK, SK, LSK)
        del cap
    for tag, res in kernel_errs.items():
        for kern, (e, ok) in zip(KERNELS, res):
            check(ok is not False, f"auto squeeze {tag}: {kern[0]} vs plain {e}")
    emit(phase="auto", item="squeeze_kernels_vs_plain",
         max_abs_err={t: [e for e, _ in r] for t, r in kernel_errs.items()},
         passed={t: [ok for _, ok in r] for t, r in kernel_errs.items()}, card=card)
    del arrays
    torch.cuda.empty_cache()

    # ---- capture_footprint: one run_radsurf call at column_chunk 0 on the
    # headline's mix x FOOTPRINT_REPEATS in float64: its eager peak above
    # its inputs, then the pool its capture takes, within CAPTURE_FACTOR
    rep = np.tile(slices["headline"][0], FOOTPRINT_REPEATS)
    arrays = example_arrays(C=len(rep), L=8, S=1, dtype=np.float64, i_representation=rep)
    config = config_of("headline", 0)
    inputs = sum(x.numel() * x.element_size() for x in tree_leaves(
        dispatch._plan(config, arrays, dev, "kernel", None, host=True)[1]))
    out, eager_peak = peak_of(lambda: dispatch.run_radsurf(config, arrays, dev))
    del out
    torch.cuda.synchronize()
    pool0, before = graph_pools()[0], graphs.stats()
    capture_s, out = wall_of(lambda: dispatch.run_radsurf(config, arrays, dev))
    del out
    pool = graph_pools()[0] - pool0
    captures = graphs.stats()["captures"] - before["captures"]
    ratio = pool / (eager_peak - inputs)
    check(captures == 1, f"auto capture_footprint: {captures} captures")
    check(ratio <= CAPTURE_FACTOR, f"auto capture_footprint: the pool is {ratio:.3f} x the"
          f" eager peak above the inputs, over CAPTURE_FACTOR {CAPTURE_FACTOR}")
    emit(phase="auto", item="capture_footprint", columns=len(rep), dtype="float64",
         eager_peak_gib=eager_peak / GiB, inputs_gib=inputs / GiB, pool_gib=pool / GiB,
         pool_over_eager_peak_less_inputs=ratio, capture_factor=CAPTURE_FACTOR,
         seconds_capture_call=capture_s, card=card)
    del arrays

    # ---- production: the headline's mix x 64 (stream_scale's 1,114,112
    # columns) in float64, the capture_footprint's graph still held: the
    # CLI's automatic stream chunk, and run_radsurf at column_chunk -1
    # three times, its first call against the model of the chunks it picks
    # (dispatch._plan: the inputs and the core's need)
    rep = np.tile(slices["headline"][0], PAR_REPEATS["stream_scale"])
    arrays = example_arrays(C=len(rep), L=8, S=1, dtype=np.float64, i_representation=rep)
    config = config_of("headline", -1)
    budget = device_budget(dev)
    chunk = cli.auto_stream_chunk(config, arrays, len(rep), 1, budget)
    plan, payload = dispatch._plan(config, arrays, dev, "kernel", None, host=True)
    predicted = plan.need + sum(x.numel() * x.element_size() for x in tree_leaves(payload))
    del payload
    reset()
    with Picks() as picks:
        t0 = time.perf_counter()
        out, peak = peak_of(lambda: dispatch.run_radsurf(config, arrays, dev))
        seconds = time.perf_counter() - t0
    c = counts()
    finite = all(bool(torch.isfinite(v).all()) for g in groups for v in out[g].values())
    del out
    check(finite, "auto production: non-finite output")
    check(AUTO_RATIO[0] <= peak / predicted <= AUTO_RATIO[1],
          f"auto production: measured / predicted {peak / predicted:.3f}")
    check_launched(c, PATH_4, "auto production")
    # the same call twice more: the second captures its graph, which holds
    # much of the card, the third plans with that memory counted available
    # (device_budget) and so picks the same chunks and replays the graph
    later = []
    for _ in range(2):
        before, pool0 = graphs.stats(), graph_pools()[0]
        with Picks() as again:
            n_seconds, out = wall_of(lambda: dispatch.run_radsurf(config, arrays, dev))
        del out
        after = graphs.stats()
        later.append(dict(seconds=n_seconds, chunks_picked=again.chunks,
                          pool_growth_gib=(graph_pools()[0] - pool0) / GiB,
                          **{k: after[k] - before[k] for k in ("captures", "replays")}))
    # (a replay's picks are the host plan's alone: an eager or captured
    # core resolves each solve's chunk again, to the same value)
    check(all(r["chunks_picked"] and r["chunks_picked"] == picks.chunks[:len(r["chunks_picked"])]
              for r in later),
          f"auto production: chunks {picks.chunks} then {[r['chunks_picked'] for r in later]}")
    check([(r["captures"], r["replays"]) for r in later] == [(1, 1), (0, 1)],
          f"auto production: the second call did not capture, or the third not replay {later}")
    emit(phase="auto", item="production", columns=len(rep), dtype="float64",
         budget_gib=budget / GiB, auto_stream_chunk=chunk, chunks_picked=picks.chunks,
         predicted_gib=predicted / GiB, measured_gib=peak / GiB, ratio=peak / predicted,
         one_shot_predicted_gib=dispatch.working_set_bytes(config, rep, 8, 8) / GiB,
         seconds_first=seconds, finite=finite, launches=c, later_calls=later,
         graphs_held_gib=[b / GiB for b in graphs.held(dev)], card=card)
    del arrays
    torch.cuda.empty_cache()


def corners_phase(dev):
    """The corners phase: the kernel route against the scan route on
    utils/inputs.corner_grid (see the module docstring)."""
    import torch

    from benchmark.run import card_line
    from spartacus_surface_tpu_torch.models import solver
    from spartacus_surface_tpu_torch.ops import layer_kernel as LK
    from spartacus_surface_tpu_torch.ops import lw_sweep_kernels as LSK
    from spartacus_surface_tpu_torch.ops import sweep_kernels as SK
    from spartacus_surface_tpu_torch.ops.launches import counts, reset
    from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss
    from spartacus_surface_tpu_torch.tools import roofline as RL
    from spartacus_surface_tpu_torch.utils.inputs import corner_grid

    card = card_line()
    fields, _ = corner_grid()
    scale = max(1.0, float(fields["ground_emission"].max()), float(fields["wall_emission"].max()))
    dtypes = {"float32": torch.float32, "float64": torch.float64}

    def solve(dt, lw, route, nreg, ns, urban):
        x = {k: torch.as_tensor(v, dtype=dt, device=dev) for k, v in fields.items()}
        if lw:
            x["air_ssa"] = torch.zeros_like(x["air_ssa"])
        f = solver.spartacus_lw if lw else solver.spartacus_sw
        return f(solver.CanopyInputs(**x), solver.SolverOptions(
            nreg=nreg, nstream=ns, do_urban=urban), LegendreGauss(ns), route=route)

    def column_err(ref, got):
        """Per column, the worst field-normalized error (phase 3's metric,
        each field's scale over all columns); inf where got is not finite."""
        worst = 0.0
        for rd, gd in zip(ref, got):
            for k in rd:
                r, g = rd[k].double(), gd[k].double()
                col = (g - r).abs().reshape(len(r), -1).amax(1) / max(1.0, r.abs().max().item())
                worst = torch.maximum(torch.as_tensor(worst, device=dev),
                                      col.nan_to_num(nan=math.inf))
        return worst

    def residual(out):
        """Per column: absorbed + net out - net in (tests/
        test_solver_conservation.py residual_sw)."""
        r = out["ground_net"].sum(-1) - out["top_net"].sum(-1)
        for k in ("clear_air_abs", "veg_abs", "veg_air_abs", "wall_net", "roof_net"):
            if k in out:
                r = r + out[k].sum((-1, -2))
        return r.double()

    for nreg, ns, urban in CORNER_CONFIGS:
        for lw in (False, True):
            bar32 = 2.5e-3 if lw else 3e-4
            scans = {d: solve(dt, lw, "scan", nreg, ns, urban) for d, dt in dtypes.items()}
            truth = scans["float64"]
            # budget-only: the columns the plain route cannot resolve in
            # float32, and those whose factory doubles CORNER_MAX_DOUBLINGS
            # times or more (rounding grows 2x a step; set below)
            unresolved = column_err(truth, scans["float32"]) > bar32
            budget_only = unresolved
            for dname in ("float64", "float32"):
                dt = dtypes[dname]
                f32 = dt == torch.float32
                tag = (f"corners nreg={nreg} ns={ns} {'urban' if urban else 'forest'}"
                       f" {dname} {'LW' if lw else 'SW'}")
                reset()
                with Capture(solver) as cap:
                    got = solve(dt, lw, "kernel", nreg, ns, urban)
                torch.cuda.synchronize()
                c = counts()
                ref = scans[dname]
                if not f32:  # each column's most doubling steps, float64 operands
                    factory = "lw_layer_factory" if lw else "layer_factory"
                    a, k, _ = cap.calls[factory][0]
                    doublings = RL.doubling_steps(factory, *a, **k).amax(0)
                    budget_only = unresolved | (doublings >= CORNER_MAX_DOUBLINGS)
                # float32: the kernel route within the bar of the plain
                # route's own distance from float64 (a column's float32 answer
                # is rounding noise where the plain route's is); float64: within
                # the bar of the plain route
                err = column_err(truth, got) - (column_err(truth, ref) if f32 else 0.0)
                bar = bar32 if f32 else 1e-9
                held = err[~budget_only].max().item()
                worst = {}
                for k, (rd, gd) in enumerate(zip(ref[:2], got[:2])):
                    s = scale if lw and k == 0 else 1.0
                    b = (1e-4 if f32 else (1e-9 if lw else 1e-10)) * s
                    rs, rk = residual(rd), residual(gd)
                    clear = rs.abs() <= b / 2  # closed in the scan route, with margin
                    worst[k] = dict(
                        kernel_vs_scan=(rk - rs).nan_to_num(nan=math.inf).abs().max().item(),
                        where_scan_closes=(rk[clear].nan_to_num(nan=math.inf).abs().max().item()
                                           if clear.any() else 0.0),
                        scan_open_columns=int((~clear).sum()))
                    # float32: a leaking column's leak is rounding noise in
                    # both routes (at most 9 of 500 columns), so only the
                    # closure is held there
                    check((f32 or worst[k]["kernel_vs_scan"] <= b)
                          and worst[k]["where_scan_closes"] <= b,
                          f"{tag}: budget residuals {worst[k]} (bar {b:.1e})")
                # printed, not held: the budget-only elements' doubling steps
                # amplify rounding past the phase-2 bars (ROADMAP.md Queue C)
                res = compare_kernels(cap.calls, dt, LK, SK, LSK)
                del cap
                path = ("K1 LW mode", "K4", "K5") if lw else ("K1", "K2", "K3")
                check(all(c[k] > 0 for k in path), f"{tag}: launches {c}")
                check(held <= bar, f"{tag}: kernel vs scan route {held:.3e}")
                emit(phase="corners", nreg=nreg, nstream=ns, urban=urban, dtype=dname,
                     band="LW" if lw else "SW", columns=len(fields["cos_sza"]),
                     budget_only_columns=int(budget_only.sum()),
                     f32_unresolved_columns=int(unresolved.sum()),
                     doubling_steps_max=int(doublings.max()),
                     field_normalized_err=held, tol=bar,
                     field_normalized_err_budget_only=err[budget_only].max().item()
                     if budget_only.any() else None,
                     budget_residuals=list(worst.values()),
                     launches={k: c[k] for k in path},
                     kernel_vs_plain_max_abs_err=[e for e, _ in res], card=card)
            del scans


def shapes_phase(dev):
    """The shapes phase (see the module docstring): each checks.SHAPES entry
    once, the launch counters set to 0 just before it and read just after;
    the kernel calls of each entry of SHAPES_COMPARED held against their
    plain versions as they return (CompareEach)."""
    import traceback

    import torch

    from benchmark.run import card_line
    from spartacus_surface_tpu_torch import checks
    from spartacus_surface_tpu_torch.models import solver
    from spartacus_surface_tpu_torch.ops import layer_kernel as LK
    from spartacus_surface_tpu_torch.ops import lw_sweep_kernels as LSK
    from spartacus_surface_tpu_torch.ops import sweep_kernels as SK
    from spartacus_surface_tpu_torch.ops.launches import counts, reset
    from spartacus_surface_tpu_torch.utils import graphs

    graphs.clear()  # as in a process of its own
    plains = plain_versions(LK, SK, LSK)
    t0 = time.perf_counter()
    for name, fn in checks.SHAPES.items():
        tag = f"shapes {name}"
        torch.cuda.empty_cache()
        reset()
        t1, line = time.perf_counter(), dict(phase="shapes", check=name)
        compared = (CompareEach(solver, plains) if name in SHAPES_COMPARED
                    else contextlib.nullcontext())
        try:
            with compared as cap:
                line["findings"] = fn(dev)
        except Exception:
            line["error"] = traceback.format_exc()[-1500:]
        line.update(seconds=time.perf_counter() - t1, launches=counts())
        if check("error" not in line, f"{tag}: {line.get('error')}"):
            check_launched(line["launches"], PATH_4, tag)
            if cap is not None:
                res = {kname: [(e, ok) for n in names for k, e, ok, _, _ in cap.calls[n]
                               if runs_on(factory, k, LK)]
                       for kname, _, _, _, names, factory in KERNELS}
                line["kernels_vs_plain"] = dict(
                    calls={n: len(c) for n, c in cap.calls.items()},
                    max_abs_err={k: max(e for e, _ in r) for k, r in res.items() if r})
                check(any(res.values()) and all(ok for r in res.values() for _, ok in r),
                      f"{tag}: a kernel disagrees with its plain version"
                      f" {line['kernels_vs_plain']['max_abs_err']}")
        emit(**line)
    emit(phase="shapes", seconds=time.perf_counter() - t0, checks=list(checks.SHAPES),
         card=card_line())


def graphs_phase(dev, slices, cli_files):
    """The graphs phase: each compiled program against its eager run under
    graphs.disabled() (see the module docstring).  slices: slice_shapes();
    cli_files: as for parallel_phase."""
    import numpy as np
    import torch

    from benchmark.run import card_line
    from spartacus_surface_tpu_torch import checks, entry
    from spartacus_surface_tpu_torch.driver import main as cli
    from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
    from spartacus_surface_tpu_torch.models.solver import SolverOptions
    from spartacus_surface_tpu_torch.ops.launches import counts, reset
    from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss
    from spartacus_surface_tpu_torch.utils import graphs, profiling
    from spartacus_surface_tpu_torch.utils.config import Config
    from spartacus_surface_tpu_torch.utils.inputs import example_arrays

    card = card_line()
    dtypes = {"float32": np.float32, "float64": np.float64}

    def in_mode(mode, fn):
        """fn as a graph replay ("graph") or eagerly ("eager")."""
        def run():
            with graphs.disabled() if mode == "eager" else contextlib.nullcontext():
                return fn()
        return run

    def differing(ref, got):
        """{output field: field-normalized error} of the fields that are not
        bit-equal; fails a field over GRAPH_TOL."""
        fr, fg = checks.fields_of(ref), checks.fields_of(got)
        check(fr.keys() == fg.keys(), f"graphs: the outputs differ in their fields"
                                      f" {fr.keys() ^ fg.keys()}")
        out = {}
        for k in fr:
            if not torch.equal(fr[k], fg[k]):
                out[k] = field_err([fr[k]], [fg[k]])
        return out

    def solves(C, L, S, nreg, dname):
        """A solve check's step: spartacus_sw + spartacus_lw, AUTO column chunk."""
        opt = SolverOptions(nreg=nreg, nstream=4, do_urban=True, column_chunk=-1)
        lg = LegendreGauss(4)
        sw, lw = entry.canopy_inputs(C, L, S, dtypes[dname], dev, 0)
        return lambda: checks.sw_lw(sw, lw, opt, lg)

    def radsurf(sname, dname):
        rep, L, S, cfg = slices[sname]
        config = Config(do_lw=True, **cfg).consolidate()
        arrays = example_arrays(C=len(rep), L=L, S=S, dtype=dtypes[dname],
                                i_representation=rep)
        return lambda: run_radsurf(config, arrays, dev)

    runs = (("check_headline", "float32", lambda: solves(16384, 8, 1, 2, "float32"), PATH_4),
            ("check_headline", "float64", lambda: solves(16384, 8, 1, 2, "float64"), PATH_4),
            ("check_nreg3", "float32", lambda: solves(8192, 8, 1, 3, "float32"), PATH_4),
            ("check_rami5", "float32", lambda: solves(1024, 62, 14, 3, "float32"), PATH_4),
            ("rami5_ns1", "float32", lambda: radsurf("rami5_ns1", "float32"), PATH_R5_1),
            ("run_radsurf_headline", "float32", lambda: radsurf("headline", "float32"),
             PATH_4))
    for name, dname, make, path in runs:
        tag = f"graphs {name} {dname}"
        graphs.clear()
        step = make()
        _, ref = wall_of(in_mode("eager", step))
        _, syncs = sync_sites(in_mode("eager", step))  # what would stop a capture
        check(not syncs, f"{tag}: the eager call synchronized the device at {syncs[:10]}")
        before = graphs.stats()
        t_first, _ = wall_of(step)  # the key's first call: eager
        t_capture, got = wall_of(step)  # captured, then replayed
        after = graphs.stats()
        captures = after["captures"] - before["captures"]
        check(captures > 0, f"{tag}: nothing was captured")
        diff = differing(ref, got)
        for k, e in diff.items():
            check(e <= GRAPH_TOL[dname], f"{tag}: {k} differs from the eager call by {e:.3e}")
        del ref, got
        reset()
        wall_of(step)  # one replay, counted
        launches = counts()
        check(all(launches[k] > 0 for k in path),
              f"{tag}: a kernel of the path was not launched in a replay {launches}")
        walls = {"graph": [], "eager": []}
        for _ in range(GRAPH_ROUNDS):
            for mode in ("graph", "eager", "eager", "graph"):
                walls[mode].append(wall_of(in_mode(mode, step))[0])
        peaks, traces = {}, {}
        for mode in ("graph", "eager"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            wall_of(in_mode(mode, step))
            peaks[mode] = (torch.cuda.max_memory_allocated() - base) / GiB
            traces[mode] = checks.trace_fields(in_mode(mode, step), f"graphs_{mode}",
                                               kernels=TRACED)
        reserved, free = (b / GiB for b in graph_pools())
        emit(phase="graphs", run=name, dtype=dname, bit_equal=not diff, sync_sites=syncs,
             differing_fields=diff, tol=GRAPH_TOL[dname], captures=captures,
             capture_s=after["capture_s"] - before["capture_s"],
             seconds_first_call=t_first, seconds_capture_call=t_capture,
             launches_one_replay=launches,
             median_ms={m: 1e3 * statistics.median(w) for m, w in walls.items()},
             min_ms={m: 1e3 * min(w) for m, w in walls.items()},
             max_ms={m: 1e3 * max(w) for m, w in walls.items()},
             n={m: len(w) for m, w in walls.items()},
             host_launches={m: t["host_launches"] for m, t in traces.items()},
             device_launches={m: t["device_launches"] for m, t in traces.items()},
             device_busy_ms={m: t["device_busy_ms"] for m, t in traces.items()},
             idle_share={m: t["device_idle_share"] for m, t in traces.items()},
             peak_gib=peaks, pool_reserved_gib=reserved, pool_free_gib=free,
             graphs_held_gib=[b / GiB for b in graphs.held(dev)], card=card)
        del step

    # ---- the CLI streamed in GRAPH_CLI_CHUNK-column chunks (cli_ns4,
    # single precision): eagerly, then three times with graphs (the first
    # run captures the chunk shapes that repeat in it, the second the one
    # that does not, the third replays every chunk)
    graphs.clear()
    out_dir = Path(cli_files["input"]).parent

    def cli_run(out_nc):
        def run():
            profiling.reset()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main([str(cli_files["namelist"]), str(cli_files["input"]),
                               str(out_nc), "--precision", "single", "--stream-chunk",
                               str(GRAPH_CLI_CHUNK), "--timings"])
            check(rc == 0, f"graphs cli: exit code {rc}")
            return profiling.totals().get("radsurf")
        return run

    graph_runs = ("graph1", "graph2", "graph3")
    files = {m: out_dir / f"graphs_cli_{m}.nc" for m in ("eager",) + graph_runs}
    t_eager, _ = wall_of(in_mode("eager", cli_run(files["eager"])))
    per_run = []
    for m in graph_runs:
        before = graphs.stats()
        reset()
        t, radsurf_s = wall_of(cli_run(files[m]))
        after = graphs.stats()
        per_run.append(dict(seconds=t, radsurf_s=radsurf_s, launches=counts(),
                            **{k: after[k] - before[k] for k in ("captures", "replays",
                                                                 "capture_s")}))
    check(per_run[-1]["captures"] == 0 and per_run[-1]["replays"] > 0,
          f"graphs cli: the last run did not replay every chunk {per_run[-1]}")
    check(all(per_run[-1]["launches"][k] > 0 for k in PATH_4),
          f"graphs cli: a kernel of the path was not launched {per_run[-1]['launches']}")
    ref = nc_vars(files["eager"])
    same = {}
    for m in graph_runs:
        got = nc_vars(files[m])
        same[m] = set(ref) == set(got) and all(np.array_equal(ref[k], got[k]) for k in ref)
        if not same[m]:
            err = nc_field_err(ref, got, [k for k in ref if k in got])
            check(err <= GRAPH_TOL["float32"], f"graphs cli {m}: the file differs by {err:.3e}")
            same[m] = {k: float(np.abs(got[k] - ref[k]).max()) for k in ref
                       if k in got and not np.array_equal(ref[k], got[k])}
    walls = {"graph": [], "eager": []}
    for _ in range(3):
        for mode in ("graph", "eager", "eager", "graph"):
            walls[mode].append(in_mode(mode, cli_run(files["graph3"]))())
    emit(phase="graphs", run="cli_ns4_streamed", dtype="float32", chunk=GRAPH_CLI_CHUNK,
         bit_equal_files=same, seconds_eager_run=t_eager, runs=per_run,
         radsurf_median_s={m: statistics.median(w) for m, w in walls.items()},
         radsurf_min_s={m: min(w) for m, w in walls.items()},
         radsurf_max_s={m: max(w) for m, w in walls.items()},
         n={m: len(w) for m, w in walls.items()}, card=card)
    host_arrays_run(card)


def host_arrays_run(card, seed=2645751301):
    """The graphs phase's urban_mix_host run: run_radsurf on the benchmark's
    urban_mix.f32 input sets (524,292 columns, host numpy arrays) with one
    intra-op thread, as benchmark/run.py drives it, in GRAPH_ROUNDS rounds
    of (kept, fresh, fresh, kept) calls: kept passes one of two input sets
    the cache has loaded before, whose fields are copied straight from
    their pages (graphs.Pinned); fresh passes new copies of them (made
    outside the timed call), first sightings that are packed.  Checks: the
    kept calls move >= 98 % of their bytes straight, the fresh calls none,
    both give the same answer."""
    import numpy as np
    import torch

    from benchmark import generate as GEN
    from benchmark.run import load_cell
    from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
    from spartacus_surface_tpu_torch.utils import graphs
    from spartacus_surface_tpu_torch.utils.config import Config

    cell = load_cell("urban_mix.f32")
    config = Config(**cell.config["radsurf"]).consolidate()
    sets = [GEN.input_set(cell.config, cell.traffic, seed, i) for i in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    graphs.clear()
    try:
        for a in sets + sets:  # eager, captured, then each set's first replay
            wall_of(lambda: run_radsurf(config, a, "cuda"))
        walls, moved = {"kept": [], "fresh": []}, {"kept": [0, 0], "fresh": [0, 0]}
        outs = {}
        for r in range(GRAPH_ROUNDS):
            for mode in ("kept", "fresh", "fresh", "kept"):
                kept = sets[r % 2]
                a = kept if mode == "kept" else {k: v.copy() for k, v in kept.items()}
                before = graphs.stats()
                t, out = wall_of(lambda: run_radsurf(config, a, "cuda"))
                after = graphs.stats()
                walls[mode].append(t)
                moved[mode][0] += after["h2d_direct_bytes"] - before["h2d_direct_bytes"]
                moved[mode][1] += after["h2d_bytes"] - before["h2d_bytes"]
                if r == 0:
                    outs[mode] = out
                del a, out
        stats = graphs.stats()
    finally:
        torch.set_num_threads(threads)
    share = {m: d / n for m, (d, n) in moved.items()}
    check(share["kept"] >= 0.98, f"graphs urban_mix_host: kept calls moved {share['kept']:.4f}"
                                 " of their bytes straight")
    check(share["fresh"] == 0, f"graphs urban_mix_host: fresh calls moved {share['fresh']:.4f}"
                               " of their bytes straight")
    diff = [k for g in ("sw_norm_dir", "lw_norm") for k in outs["kept"][g]
            if not torch.equal(outs["kept"][g][k], outs["fresh"][g][k])]
    check(not diff, f"graphs urban_mix_host: kept and fresh calls differ in {diff}")
    emit(phase="graphs", run="urban_mix_host", dtype="float32", seed=seed, threads=1,
         median_ms={m: 1e3 * statistics.median(w) for m, w in walls.items()},
         min_ms={m: 1e3 * min(w) for m, w in walls.items()},
         max_ms={m: 1e3 * max(w) for m, w in walls.items()},
         n={m: len(w) for m, w in walls.items()}, h2d_direct_share=share,
         h2d_mb_a_call=moved["kept"][1] / len(walls["kept"]) / 1e6,
         registrations=stats["registrations"],
         registration_failures=stats["registration_failures"],
         registered_gib=stats["registered_bytes"] / GiB, bit_equal=not diff,
         columns=int(np.asarray(sets[0]["dz"]).shape[0]), card=card)
    graphs.clear()


def alone(dev, phase):
    """One phase alone (--<phase>-only): shapes, divergence, or parallel,
    auto (with corners) or graphs on cli_files_unchecked's files, then a
    line with its seconds."""
    if phase in ("shapes", "divergence"):
        return shapes_phase(dev) if phase == "shapes" else divergence_phase(dev)
    files, t0 = cli_files_unchecked(), time.perf_counter()
    if phase == "parallel":
        parallel_phase(dev, (tiles(HEADLINE_TILES), HEADLINE_CONFIG), files)
    elif phase == "auto":
        auto_phase(dev, slice_shapes(), files)
        corners_phase(dev)
    else:
        graphs_phase(dev, slice_shapes(), files)
    emit(phase=phase, item="seconds", seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--profile", action="store_true",
                      help="also time both routes warm and trace the kernel route")
    args.add_argument("--parallel-only", action="store_true",
                      help="build, then run the parallel phase alone (no kernels line)")
    args.add_argument("--auto-only", action="store_true",
                      help="build, then run the auto and corners phases alone (no kernels line)")
    args.add_argument("--shapes-only", action="store_true",
                      help="build, then run the shapes phase alone (no kernels line)")
    args.add_argument("--graphs-only", action="store_true",
                      help="build, then run the graphs phase alone (no kernels line)")
    args.add_argument("--divergence-only", action="store_true",
                      help="build, then run the k1_divergence phase alone (no kernels line)")
    args = args.parse_args(argv)
    profile = args.profile
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run"
              " needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from benchmark.run import card_line
    from spartacus_surface_tpu_torch.checks import trace_fields
    from spartacus_surface_tpu_torch.driver import main as cli
    from spartacus_surface_tpu_torch.driver import test_kernels as demo
    from spartacus_surface_tpu_torch.driver.read_input import read_input
    from spartacus_surface_tpu_torch.driver.save import save_canopy_fluxes
    from spartacus_surface_tpu_torch.examples import retrieval
    from spartacus_surface_tpu_torch.models import solver
    from spartacus_surface_tpu_torch.models.dispatch import (
        TILE_INFINITE_STREET, TILE_SIMPLE_URBAN, run_radsurf)
    from spartacus_surface_tpu_torch.models.dispatch import _LW_KEYS as LW_KEYS
    from spartacus_surface_tpu_torch.models.dispatch import _SW_KEYS as SW_KEYS
    from spartacus_surface_tpu_torch.models.flux_utils import (
        budget_components, budget_residual)
    from spartacus_surface_tpu_torch.models.simple_spectrum import (
        calc_simple_spectrum_lw)
    from spartacus_surface_tpu_torch.ops import cuda_build
    from spartacus_surface_tpu_torch.ops import layer_kernel as LK
    from spartacus_surface_tpu_torch.ops import lw_sweep_kernels as LSK
    from spartacus_surface_tpu_torch.ops import probe_kernels as PK
    from spartacus_surface_tpu_torch.ops import sweep_kernels as SK
    from spartacus_surface_tpu_torch.ops.launches import counts, reset
    from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss
    from spartacus_surface_tpu_torch.tools import roofline as RL
    from spartacus_surface_tpu_torch.utils import graphs, profiling
    from spartacus_surface_tpu_torch.utils.config import Config, DriverConfig
    from spartacus_surface_tpu_torch.utils.inputs import (
        example_arrays, example_inputs, random_lw_fields, write_example_input)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    dtypes = {"float32": (np.float32, torch.float32),
              "float64": (np.float64, torch.float64)}

    def check_kernels(kernel_errs, tag):
        for (e, ok), kern in zip(kernel_errs, KERNELS):
            if ok is not None:
                check(ok, f"{tag}: {kern[0]} vs plain {e}")

    def budgets(out, rep, f32, emission_scale, tag):
        """Check the SW and LW energy budgets of a run_radsurf result as
        phase 3 does; returns (sw residual, [LW residuals])."""
        resid_sw = max(
            budget_residual(budget_components(out[g], rep)).abs().max().item()
            for g in sw_groups)
        conserving = torch.as_tensor(
            ~np.isin(rep, [TILE_SIMPLE_URBAN, TILE_INFINITE_STREET]), device=dev)
        resid_lw = [
            (budget_residual(budget_components(out[g], rep)).abs()
             * conserving).max().item() for g in lw_groups]
        check(resid_sw <= (1e-4 if f32 else 1e-10),
              f"{tag}: SW energy budget residual {resid_sw:.3e}")
        lw_tols = ((1e-4 * emission_scale,) * 2 if f32 else (1e-9, 1e-10))
        for g, r, tol in zip(lw_groups, resid_lw, lw_tols):
            check(r <= tol, f"{tag}: {g} energy budget residual {r:.3e}")
        return resid_sw, resid_lw

    sw_groups = ("sw_norm_dir", "sw_norm_diff")
    lw_groups = ("lw_internal", "lw_norm")

    # ---- 1. build, one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = dict(zip(SOURCES, pool.map(cuda_build.load, SOURCES)))
    factory_lib = libs["layer_factory"]
    ptxas = {name: [line.split(":", 1)[-1].strip()
                    for line in log.splitlines()
                    if "entry function" in line or "Used" in line
                    or "spill" in line]
             for name, log in cuda_build.build_log.items()}
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds=cuda_build.build_seconds,
         part_seconds={f"{n}:{m or 'main'}": t for (n, m), t in cuda_build.part_seconds.items()},
         ptxas=ptxas)
    only = [p for p in ("shapes", "divergence", "parallel", "auto", "graphs")
            if getattr(args, f"{p}_only")]
    if only:
        alone(dev, only[0])
        print(card_line(), flush=True)
        for f in FAILURES:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1 if FAILURES else 0

    # ---- 2. each kernel against its plain version, 1024 columns x 8 layers
    C2, L2, S2 = 1024, 8, 2
    for nreg, ns in ENTRY_CONFIGS + ONE_STREAM_CONFIGS:
        for dname, (np_dt, dt) in dtypes.items():
            to_dev = lambda d: solver.CanopyInputs(**{
                k: torch.as_tensor(v, device=dev) for k, v in d.items()})
            lw = example_inputs(C=C2, L=L2, S=S2, dtype=np_dt, lw=True)
            opt = solver.SolverOptions(nreg=nreg, nstream=ns, do_urban=True)
            lg = LegendreGauss(ns)
            for fields in ("uniform", "random_lw"):
                with Capture(solver) as cap:
                    if fields == "uniform":
                        solver.spartacus_sw(to_dev(example_inputs(
                            C=C2, L=L2, S=S2, dtype=np_dt)), opt, lg)
                        solver.spartacus_lw(to_dev(lw), opt, lg)
                    else:
                        solver.spartacus_lw(to_dev({**lw, **random_lw_fields(
                            C2, L2, S2, np_dt, seed=nreg * ns)}), opt, lg)
                torch.cuda.synchronize()
                res = compare_kernels(cap.calls, dt, LK, SK, LSK)
                check_kernels(res, f"nreg={nreg} ns={ns} {dname} {fields}")
                emit(phase="kernel_vs_plain", config=f"nreg{nreg}_ns{ns}",
                     dtype=dname, lw_fields=fields,
                     max_abs_err=[r[0] for r in res],
                     passed=[r[1] for r in res])
                del cap

    # ---- 3. the slice through run_radsurf at realistic size, SW + LW
    slices = slice_shapes()
    slice_paths = {"headline": PATH_4, "rami5_shape": PATH_4, "rami5_ns1": PATH_R5_1}
    runs = [(sname, dname, Config(do_lw=True, **cfg).consolidate(), rep, L, S)
            for sname, (rep, L, S, cfg) in slices.items() for dname in dtypes]
    mean_steps = {}  # {slice: [SW, LW] mean doubling steps per factory element}
    sweep_runs = {}  # {(slice, dtype): {sweep wrapper: times, bound, shape}}
    dense_runs = {}  # {(run, dtype): {factory wrapper: K1d's times, bound, shape}}

    def time_dense(tag, dt, calls):
        """K1d's calls {wrapper name: (args, kwargs)} timed against their
        plain versions, with their work, bound and launch shape, and the
        kernel's own device ms (device_ms: the profiler's, without the
        wrapper's allocations and the LW mode's epilogue) and its share;
        emitted as a `k1d` line and kept in dense_runs."""
        plains = plain_versions(LK, SK, LSK)
        res = {}
        for n, (a, k) in calls.items():
            wrapper = getattr(solver, n)
            ms = time_ms(lambda: wrapper(*a, **k))
            flops, nbytes = RL.kernel_work(n, *a, **k)
            device_ms = profiled_ms(lambda: wrapper(*a, **k), symbol=KERNELS[-1][3])
            res[n] = dict(ms=ms, plain_ms=time_ms(lambda: plains[n](*a, **k)),
                          device_ms=device_ms,
                          elements=a[1].shape[0] * a[1].shape[2], nd=k["nd"],
                          ndir=k.get("ndir", 1), flops=flops, bytes=nbytes,
                          **RL.roofline(flops, nbytes, ms, dt),
                          share_device=RL.roofline(flops, nbytes, device_ms, dt).get("share"),
                          **launch_shape(LK.factory_config(
                              factory_lib, k["nd"], k.get("ndir", 1),
                              a[1].shape[0] * a[1].shape[2], dt)))
        dense_runs[tag, str(dt).split(".")[-1]] = res
        emit(phase="k1d", run=tag, dtype=str(dt).split(".")[-1], **res)

    def dense_calls(calls):
        """{wrapper: (args, kwargs)} of K1d's largest SW call and largest LW
        call among the captured calls (absent: none ran on K1d)."""
        out = {}
        for n in ("layer_factory", "lw_layer_factory"):
            dense = [(a, k) for a, k, _ in calls[n] if runs_on("dense", k, LK)]
            if dense:
                out[n] = max(dense, key=lambda c: c[0][1].shape[0] * c[0][1].shape[2])
        return out

    for sname, dname, config, rep, L, S in runs:
        np_dt, dt = dtypes[dname]
        arrays = example_arrays(C=len(rep), L=L, S=S, dtype=np_dt,
                                i_representation=rep)
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with Capture(solver) as cap:
            out_k = run_radsurf(config, arrays, dev)
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        mem_kernel = torch.cuda.max_memory_allocated() / 2**30
        launches = counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out_s = run_radsurf(config, arrays, dev, route="scan")
        torch.cuda.synchronize()
        t_scan = time.perf_counter() - t0
        mem_scan = torch.cuda.max_memory_allocated() / 2**30

        for g in ("sw", "lw"):  # bc_out as two result groups
            out_s[f"bc_{g}"] = {k: v for k, v in out_s["bc_out"].items()
                                if k.startswith(g)}
            out_k[f"bc_{g}"] = {k: v for k, v in out_k["bc_out"].items()
                                if k.startswith(g)}
        err_sw, keys_sw = group_err(out_s, out_k, sw_groups + ("bc_sw",))
        err_lw, keys_lw = group_err(out_s, out_k, lw_groups + ("bc_lw",))
        got = [out_k[g][k] for g, k in keys_sw + keys_lw]
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        shapes = (all(set(out_k[g]) == set(out_s[g])
                      for g in sw_groups + lw_groups)
                  and all(out_k[g][k].shape == out_s[g][k].shape
                          for g, k in keys_sw + keys_lw)
                  and out_k["bc_out"]["sw_albedo"].shape == (len(rep), S)
                  and out_k["bc_out"]["lw_emission"].shape == (len(rep), S))
        f32 = dname == "float32"
        tag = f"{sname} {dname}"
        k1_shape = {}  # the factory's (K1's, or K1d's) launch shape
        for n, mode in (("layer_factory", "sw"), ("lw_layer_factory", "lw")):
            a, k, _ = cap.calls[n][0]
            k1_shape[mode] = launch_shape(LK.factory_config(
                factory_lib, k["nd"], k.get("ndir", 1), a[1].shape[0] * a[1].shape[2], dt))
        emission_scale = max(1.0, float(np.abs(arrays["ground_emission"]).max()))
        resid_sw, resid_lw = budgets(out_k, rep, f32, emission_scale, tag)
        del out_k, out_s, got
        kernel_errs = compare_kernels(cap.calls, dt, LK, SK, LSK)
        check(err_sw <= (3e-4 if f32 else 1e-9),
              f"{tag}: SW kernel route vs scan route {err_sw:.3e}")
        check(err_lw <= (2.5e-3 if f32 else 1e-9),
              f"{tag}: LW kernel route vs scan route {err_lw:.3e}")
        check(finite and shapes, f"{tag}: non-finite or misshapen output")
        check_launched(launches, slice_paths[sname], tag)
        check_kernels(kernel_errs, tag)
        emit(phase="slice", run=sname, dtype=dname, columns=len(rep),
             layers=L, bands=S, sw_field_normalized_err=err_sw,
             lw_field_normalized_err=err_lw, max_sw_budget_residual=resid_sw,
             max_lw_budget_residual=dict(zip(lw_groups, resid_lw)),
             launches=launches,
             kernel_vs_plain_max_abs_err=[e for e, _ in kernel_errs],
             kernel_vs_plain_passed=[ok for _, ok in kernel_errs],
             seconds_kernel_route=t_kernel, seconds_scan_route=t_scan,
             peak_gib_kernel_route=mem_kernel, peak_gib_scan_route=mem_scan,
             finite=finite, shapes_ok=shapes, factory_launch_shape=k1_shape)
        # the sweeps on this run's operands: K2-K5 timed (CUDA events) with
        # their bounds and their launch shapes
        sweeps = {}
        for n in SWEEPS:
            a, k, _ = cap.calls[n][0]
            wrapper = getattr(solver, n)
            flops, nbytes = RL.kernel_work(n, *a, **k)
            ms = time_ms(lambda: wrapper(*a, **k))
            sweeps[n] = dict(ms=ms, flops=flops, bytes=nbytes,
                             **RL.roofline(flops, nbytes, ms, dt))
            if n in UP_SWEEPS:
                sweeps[n].update(launch_shape(SK.up_config(
                    libs[UP_SWEEPS[n]], n, k["nd"], k["ns"], k["nreg"], a[0].shape[2], dt)))
            else:
                sweeps[n].update(launch_shape(SK.down_config(
                    libs[DOWN_SWEEPS[n]], n.replace("_both", ""), k["nd"], k["ns"],
                    k["nreg"], k["do_urban"], k["with_profiles"], a[0].shape[2], dt)))
        sweep_runs[sname, dname] = sweeps
        emit(phase="sweeps", run=sname, dtype=dname, **sweeps)
        if sname == "rami5_ns1":  # K1d at nd = 3 on 888,832 elements
            time_dense(sname, dt, dense_calls(cap.calls))
        if f32:  # each factory element's doubling count, for the roofline
            mean_steps[sname] = [mean_doubling_steps(cap.calls[n], n, RL)
                                 for n in ("layer_factory", "lw_layer_factory")]
        if sname == "rami5_ns1" and f32:
            main_launches_r5 = launches["K1d"]
        if sname == "headline" and f32:  # the main path of K1-K5
            main_launches, errs, main_k1_shape = launches, kernel_errs, k1_shape
            wrappers = {n: getattr(solver, n) for n in WRAPPERS}
            plains = plain_versions(LK, SK, LSK)
            timings, works = {}, {}
            for n in WRAPPERS:
                a, k, _ = cap.calls[n][0]
                timings[n] = (time_ms(lambda: wrappers[n](*a, **k)),
                              time_ms(lambda: plains[n](*a, **k)))
                works[n] = RL.kernel_work(n, *a, **k)
        a = k = None  # no operand of this run stays allocated into the next
        del cap
        torch.cuda.empty_cache()

    divergence_phase(dev)

    # ---- cli: the offline CLI on a seeded input file, two namelists
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    rep_cli = tiles(CLI_TILES)
    input_nc = CLI_DIR / "input.nc"
    write_example_input(input_nc, rep_cli, L=8, S=1, seed=1)
    namelists = {
        "cli_ns4": (CLI_NAMELIST.format(ns=4, extra=""), PATH_4),
        "cli_ns1": (CLI_NAMELIST.format(ns=1, extra=(
            "\n  do_save_flux_profile = .true., do_save_spectral_flux = .true.,")),
            PATH_1),
    }
    record = {}

    def recording_run_radsurf(*a, **k):
        record["out"] = run_radsurf(*a, **k)
        return record["out"]

    cli.run_radsurf = recording_run_radsurf
    for nname, (text, path) in namelists.items():
        nam = CLI_DIR / f"{nname}.nam"
        nam.write_text(text)
        for prec, dname in (("single", "float32"), ("double", "float64")):
            np_dt, dt = dtypes[dname]
            f32 = dname == "float32"
            tag = f"{nname} {dname}"
            out_nc, ref_nc = CLI_DIR / f"{nname}_{prec}.nc", CLI_DIR / f"{nname}_{prec}_ref.nc"
            profiling.reset()
            stdout = io.StringIO()
            reset()
            with Capture(solver) as cap, contextlib.redirect_stdout(stdout):
                rc = cli.main([str(nam), str(input_nc), str(out_nc),
                               "--precision", prec, "--timings"])
            torch.cuda.synchronize()
            launches = counts()
            walls = profiling.totals()
            check(rc == 0, f"{tag}: exit code {rc}")
            check_launched(launches, path, tag)
            kernel_errs = compare_kernels(cap.calls, dt, LK, SK, LSK)
            check_kernels(kernel_errs, tag)
            # the reference file: scan route, scaled, summed and saved here
            config = Config.from_namelist(nam).consolidate()
            data = read_input(str(input_nc), config, DriverConfig.from_namelist(nam))
            calc_simple_spectrum_lw(config, data["arrays"])
            # the energy budgets of the CLI's own run
            emission_scale = max(1.0, float(np.abs(
                data["arrays"]["ground_emission"]).max()))
            resid_sw, resid_lw = budgets(record.pop("out"), rep_cli, f32,
                                         emission_scale, tag)
            solve_arrays, top = cli.prepare(config, data, np_dt, dev)
            sw_flux, lw_flux = cli.scale_and_sum(
                config, run_radsurf(config, solve_arrays, dev, route="scan"), top)
            save_canopy_fluxes(str(ref_nc), config, data["arrays"], sw_flux, lw_flux)
            del sw_flux, lw_flux
            ref, got = nc_vars(ref_nc), nc_vars(out_nc)
            lw_names = [k for k in ref if k.endswith("_lw")]
            sw_names = [k for k in ref if k not in lw_names]
            err_sw = nc_field_err(ref, got, sw_names)
            err_lw = nc_field_err(ref, got, lw_names)
            check(set(ref) == set(got), f"{tag}: output variables {set(ref) ^ set(got)}")
            check(err_sw <= (3e-4 if f32 else 1e-9),
                  f"{tag}: SW output vs scan-route file {err_sw:.3e}")
            check(err_lw <= (2.5e-3 if f32 else 1e-9),
                  f"{tag}: LW output vs scan-route file {err_lw:.3e}")
            emit(phase="cli", namelist=nname, dtype=dname, exit_code=rc,
                 columns=len(rep_cli), layers=8, variables=len(got),
                 sw_field_normalized_err=err_sw, lw_field_normalized_err=err_lw,
                 max_sw_budget_residual=resid_sw,
                 max_lw_budget_residual=dict(zip(lw_groups, resid_lw)),
                 launches=launches,
                 kernel_vs_plain_max_abs_err=[e for e, _ in kernel_errs],
                 kernel_vs_plain_passed=[ok for _, ok in kernel_errs],
                 walls_seconds={k: walls.get(k) for k in ("read_input", "radsurf", "save")},
                 elapsed_line=next((ln for ln in stdout.getvalue().splitlines()
                                    if ln.startswith("Time elapsed")), None))
            if nname == "cli_ns1":  # the main path of K1d
                time_dense(nname, dt, dense_calls(cap.calls))
                if f32:
                    dense_launches = (launches["K1d"], launches["K1d LW mode"])
                    dense_err = kernel_errs[-1][0]
            del cap
            torch.cuda.empty_cache()
    cli.run_radsurf = run_radsurf

    # ---- graphs: each compiled program against its eager run
    t0 = time.perf_counter()
    graphs_phase(dev, slices, {
        "input": input_nc, "columns": len(rep_cli), "namelist": CLI_DIR / "cli_ns4.nam"})
    emit(phase="graphs", item="seconds", seconds=time.perf_counter() - t0)

    # ---- parallel: streamed, meshed and multi-process runs
    t0 = time.perf_counter()
    parallel_phase(dev, (slices["headline"][0], slices["headline"][3]),
                   {"input": input_nc, "columns": len(rep_cli),
                    "namelist": CLI_DIR / "cli_ns4.nam",
                    "single": CLI_DIR / "cli_ns4_single.nc",
                    "double": CLI_DIR / "cli_ns4_double.nc"})
    emit(phase="parallel", item="seconds", seconds=time.perf_counter() - t0)

    # ---- auto: the automatic chunks sized from the card; corners: the
    # degenerate corner grid, kernel route against scan route
    t0 = time.perf_counter()
    auto_phase(dev, slices, {
        "input": input_nc, "columns": len(rep_cli), "namelist": CLI_DIR / "cli_ns4.nam",
        "single": CLI_DIR / "cli_ns4_single.nc", "double": CLI_DIR / "cli_ns4_double.nc"})
    corners_phase(dev)
    emit(phase="auto", item="seconds", seconds=time.perf_counter() - t0)

    # ---- demo: the kernel demonstration on the card
    reset()
    stdout = io.StringIO()
    with Capture(demo) as cap, contextlib.redirect_stdout(stdout):
        rc = demo.main(["all", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = counts()
    check(rc == 0 and "SELF-CHECK PASSED" in stdout.getvalue(),
          f"demo: exit code {rc}")
    check(launches["K1d"] > 0 and launches["K1 LW mode"] > 0,
          f"demo: a factory kernel was not launched {launches}")
    # the demo's own factory calls (SW on K1d, LW on K1) against the plain
    # versions, every output field, float64
    kernel_errs = compare_kernels(cap.calls, torch.float64, LK, SK, LSK)
    demo_errs = {kern[0]: e for kern, e in zip(KERNELS, kernel_errs)
                 if kern[-1] is not None}
    for name, (e, ok) in demo_errs.items():
        check(ok is not None, f"demo: no {name} call was captured")
        check(ok is not False, f"demo: {name} vs plain {e}")
    del cap
    emit(phase="demo", exit_code=rc, launches=launches,
         kernel_vs_plain_max_abs_err={n: e for n, (e, _) in demo_errs.items()},
         kernel_vs_plain_passed={n: ok for n, (_, ok) in demo_errs.items()},
         self_check=next((ln for ln in stdout.getvalue().splitlines()
                          if ln.startswith("Schur vs brute-force")), None))

    # ---- grad: the gradient of run_radsurf at full width, through the
    # kernel route's autograd Function (forward: the kernels; backward: the
    # scan route recomputed per column chunk), against the scan route's own
    # gradient and central differences
    def grad_loss(out):
        """The JAX test's loss (tests/test_autodiff.py:129)."""
        return out["sw_norm_dir"]["ground_net"].sum() + out["lw_internal"]["top_net"].sum()

    def grad_step(config, arrays, veg_ext, route="kernel"):
        """(loss, d loss / d veg_ext) of one step through run_radsurf."""
        x = veg_ext.detach().clone().requires_grad_(True)
        loss = grad_loss(run_radsurf(config, {**arrays, "veg_ext": x}, dev, route=route))
        loss.backward()
        return loss.detach(), x.grad

    def loss_at(config, arrays, veg_ext):
        with torch.no_grad():
            return grad_loss(run_radsurf(config, {**arrays, "veg_ext": veg_ext}, dev)).item()

    graphs.clear()  # the grad phase starts as in a process of its own
    ns1_config = Config.from_namelist(CLI_DIR / "cli_ns1.nam")
    ns1_config.do_lw = True
    grad_cases = {  # name: (tile codes, config, the kernels that must launch)
        "headline": (slices["headline"][0], Config(do_lw=True, **slices["headline"][3]),
                     PATH_4),
        "cli_ns1": (rep_cli, ns1_config, PATH_1),
    }
    for gname, (rep, base, path) in grad_cases.items():
        for dname, (np_dt, dt) in dtypes.items():
            f32, tag = dname == "float32", f"grad {gname} {dname}"
            config = dataclasses.replace(base, column_chunk=GRAD_CHUNK).consolidate()
            arrays = example_arrays(C=len(rep), L=8, S=1, dtype=np_dt, i_representation=rep)
            veg_ext = torch.as_tensor(arrays["veg_ext"], device=dev)
            # one step with its kernels captured: its launches, and its
            # kernels against their plain versions
            reset()
            with Capture(solver) as cap:
                grad_step(config, arrays, veg_ext)
            torch.cuda.synchronize()
            launches = counts()
            check_launched(launches, path, tag)
            kernel_errs = compare_kernels(cap.calls, dt, LK, SK, LSK)
            check_kernels(kernel_errs, tag)
            del cap
            torch.cuda.empty_cache()
            # a second step: its peak memory
            torch.cuda.reset_peak_memory_stats()
            loss_k, g_k = grad_step(config, arrays, veg_ext)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            # the scan route's gradient, its whole graph kept, at full width
            torch.cuda.reset_peak_memory_stats()
            _, g_s = grad_step(dataclasses.replace(config, column_chunk=0), arrays,
                               veg_ext, route="scan")
            torch.cuda.synchronize()
            peak_scan = torch.cuda.max_memory_allocated() / 2**30
            agree = ((g_k - g_s).abs().max() / g_s.abs().max()).item()
            finite = bool(g_k.isfinite().all() and g_s.isfinite().all())
            check(finite and agree <= (GRAD_AGREE_F32 if f32 else 1e-9),
                  f"{tag}: kernel-route gradient vs scan-route gradient {agree:.3e}")
            del g_s
            record = dict(phase="grad", case=gname, dtype=dname, columns=len(rep), layers=8,
                          column_chunk=GRAD_CHUNK, loss=loss_k.item(),
                          grad_rel_err_vs_scan=agree,
                          finite=finite, launches_per_step=launches,
                          kernel_vs_plain_max_abs_err=[e for e, _ in kernel_errs],
                          kernel_vs_plain_passed=[ok for _, ok in kernel_errs],
                          peak_gib_step=peak, peak_gib_scan_route_step=peak_scan)
            if not f32:  # a directional central difference of the kernel route's loss
                v = torch.randn(veg_ext.shape, generator=torch.Generator().manual_seed(3),
                                dtype=dt).to(dev)
                h = FD_STEP
                fd = (loss_at(config, arrays, veg_ext + h * v)
                      - loss_at(config, arrays, veg_ext - h * v)) / (2 * h)
                dot = (g_k * v).sum().item()
                fd_err = abs(fd - dot) / abs(dot)
                check(fd_err <= 5e-4, f"{tag}: finite difference {fd} vs <grad, v> {dot}")
                record.update(fd_directional=fd, grad_dot_v=dot, fd_rel_err=fd_err, fd_step=h)
            fwd = wall_seconds(lambda: loss_at(config, arrays, veg_ext), reps=3)[0]
            step = wall_seconds(lambda: grad_step(config, arrays, veg_ext), reps=3)[0]
            # after those warm steps (the first step of a process leaves the
            # libraries' workspaces, 64 MiB), a step leaves nothing of its
            # graph: only the gradient and the loss it returns, in the
            # allocator's blocks that hold them (a block is 512-byte
            # rounded, or a whole cached block that was not split, up to 1
            # MiB larger); a graph captured in the step keeps its static
            # inputs and packed outputs in the graph cache: counted apart
            def block_bytes(*ts):
                sizes = {b["address"]: b["size"] for seg in torch.cuda.memory_snapshot()
                         for b in seg["blocks"] if b["state"] == "active_allocated"}
                return sum(sizes[t.untyped_storage().data_ptr()] for t in ts)

            held0 = graphs.stats()
            mem0 = torch.cuda.memory_allocated()
            loss, grad = grad_step(config, arrays, veg_ext)
            torch.cuda.synchronize()
            held1 = graphs.stats()
            cached = held1["held_bytes"] - held0["held_bytes"]
            left = torch.cuda.memory_allocated() - mem0 - block_bytes(grad, loss) - cached
            check(left <= 0, f"{tag}: {left} bytes of the step outlived it"
                             f" (graphs: {held0} before, {held1} after)")
            del loss, grad
            record.update(seconds_forward=fwd, seconds_forward_backward=step,
                          step_over_forward=step / fwd, bytes_left_after_step=left,
                          graph_bytes_kept_in_step=cached,
                          captures_in_step=held1["captures"] - held0["captures"],
                          graph_freed_after_step=left <= 0)
            emit(**record)
            del g_k, arrays, veg_ext
            torch.cuda.empty_cache()

    # ---- retrieval: the adjoint retrieval example on the card, at its defaults
    reset()
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        res = retrieval.run([])
    launches = counts()
    losses = res["losses"]
    check(losses[-1] < 1e-2 * losses[0],
          f"retrieval: the misfit fell from {losses[0]:.3e} only to {losses[-1]:.3e}")
    check_launched(launches, ("K1", "K2", "K3"), "retrieval")
    emit(phase="retrieval", steps=len(losses), first_loss=losses[0], last_loss=losses[-1],
         seconds=res["seconds"], seconds_per_step=res["seconds"] / len(losses),
         final_mean_abs_err=res["final_err"], launches=launches,
         output=stdout.getvalue().splitlines())

    # ---- assoc: the associative route on the kernel route (K1 / K1d, then
    # the plain associative sweeps) against the sequential kernel route
    def solver_residual(flux):
        """Per-column energy budget residual of a solver result dict."""
        lay = sum(flux[k].sum((-1, -2)) for k in
                  ("clear_air_abs", "veg_abs", "veg_air_abs", "wall_net", "roof_net")
                  if k in flux)
        return (flux["ground_net"].sum(-1) + lay - flux["top_net"].sum(-1)).abs().max().item()

    for aname, (C, L, code, nreg, urban, dz_scale) in ASSOC_SHAPES.items():
        for dname, (np_dt, dt) in dtypes.items():
            f32, tag = dname == "float32", f"assoc {aname} {dname}"
            # the slice phase's seeded arrays as the solver's SW and LW inputs
            arrays = example_arrays(C=C, L=L, S=1, dtype=np_dt, i_representation=[code] * C)
            arrays["dz"] = arrays["dz"] * dz_scale
            inputs = {mode: solver.CanopyInputs(**{
                f: torch.as_tensor(arrays[k], device=dev) for f, k in keys.items()})
                for mode, keys in (("sw", {**SW_KEYS, "ground_albedo_dir": "ground_albedo_dir"}),
                                   ("lw", LW_KEYS))}
            lg = LegendreGauss(4)

            def solve(assoc):
                opt = solver.SolverOptions(nreg=nreg, nstream=4, do_urban=urban,
                                           associative_sweeps=assoc)
                return (solver.spartacus_sw(inputs["sw"], opt, lg),
                        solver.spartacus_lw(inputs["lw"], opt, lg))

            out, launches, walls, peaks = {}, {}, {}, {}
            for route, assoc in (("associative", True), ("sequential", False)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset()
                out[route] = solve(assoc)
                torch.cuda.synchronize()
                launches[route] = counts()
                peaks[route] = torch.cuda.max_memory_allocated() / 2**30
                walls[route] = wall_seconds(lambda: solve(assoc), reps=3)[0]
            la = launches["associative"]
            check(la["K1"] > 0 and la["K1 LW mode"] > 0
                  and all(la[k] == 0 for k in ("K2", "K3", "K4", "K5")),
                  f"{tag}: the associative route's launches {la}")
            check_launched(launches["sequential"], PATH_4, tag)
            (sw_a, lw_a), (sw_s, lw_s) = out["associative"], out["sequential"]
            keys = lambda res: [(i, k) for i in range(3) for k in res[i]]
            err_sw = field_err([sw_s[i][k] for i, k in keys(sw_s)],
                               [sw_a[i][k] for i, k in keys(sw_s)])
            err_lw = field_err([lw_s[i][k] for i, k in keys(lw_s)],
                               [lw_a[i][k] for i, k in keys(lw_s)])
            check(all(set(a) == set(s) for a, s in zip(sw_a + lw_a, sw_s + lw_s)),
                  f"{tag}: the two routes' output fields differ")
            check(err_sw <= (3e-4 if f32 else 1e-9),
                  f"{tag}: SW associative vs sequential {err_sw:.3e}")
            check(err_lw <= (2.5e-3 if f32 else 1e-9),
                  f"{tag}: LW associative vs sequential {err_lw:.3e}")
            scale = max(1.0, inputs["lw"].ground_emission.abs().max().item())
            resid = {route: [solver_residual(f) for f in sw[:2] + lw[:2]]
                     for route, (sw, lw) in out.items()}
            bars = ([1e-4] * 2 + [1e-4 * scale] * 2 if f32 else [1e-10, 1e-10, 1e-9, 1e-10])
            for r, bar, group in zip(resid["associative"], bars, sw_groups + lw_groups):
                check(r <= bar, f"{tag}: {group} energy budget residual {r:.3e}")
            emit(phase="assoc", shape=aname, dtype=dname, columns=C, layers=L, nreg=nreg,
                 nstream=4, sw_field_normalized_err=err_sw, lw_field_normalized_err=err_lw,
                 budget_residual=resid, launches=launches,
                 warm_wall_seconds=walls, peak_gib=peaks)
            del out, inputs, arrays, sw_a, lw_a, sw_s, lw_s
            torch.cuda.empty_cache()

    # ---- roofline: the tool's main path (K6, K7), each probe against its
    # plain version, the measured ceilings, every kernel's bound, and the
    # whole solve against the work model
    f32 = torch.float32
    walls = {}  # {slice: (layered columns, warm wall s)}, float32 kernel route
    for sname, dname, config, rep, L, S in runs:
        if dname == "float32" and sname in SOLVE_MODELS:
            arrays = example_arrays(C=len(rep), L=L, S=S, dtype=np.float32,
                                    i_representation=rep)
            walls[sname] = (int(np.isin(rep, LAYERED).sum()), wall_seconds(
                lambda: run_radsurf(config, arrays, dev), reps=3)[0])
            del arrays
            torch.cuda.empty_cache()
    cols_per_sec = {sname: n / w for sname, (n, w) in walls.items()}
    PK.fma_chain.launches = PK.copy_add.launches = 0
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        rc = RL.main(["--cols-per-sec", repr(cols_per_sec["headline"])])
    torch.cuda.synchronize()
    probe_launches = {"K6": PK.fma_chain.launches, "K7": PK.copy_add.launches}
    tool_lines = stdout.getvalue().splitlines()
    check(rc == 0, f"roofline: the tool's exit code {rc}")
    check(min(probe_launches.values()) > 0,
          f"roofline: a probe was not launched {probe_launches}")
    report = json.loads(tool_lines[-1])
    emit(phase="roofline", item="tool", exit_code=rc, launches=probe_launches,
         output=tool_lines[:-1])

    probes = {}  # {"K6 float32" | "K6 float64" | "K7": measurements}
    for dname, dt in (("float32", f32), ("float64", torch.float64)):
        x = RL.fma_operands(dt, dev)
        got = PK.fma_chain(x, RL.FMA_B, RL.FMA_C)
        ref = PK.fma_chain_plain(x, RL.FMA_B, RL.FMA_C)
        err = max_abs_diff([ref], [got])
        check(bool(got.isfinite().all()) and torch.allclose(
            got, ref, rtol=1e-4 if dt == f32 else 1e-12, atol=0.0),
            f"roofline: K6 {dname} vs plain {err}")
        probes[f"K6 {dname}"] = dict(
            max_abs_err=err, dtype=dt, flops=RL.fma_flops(x), bytes=2.0 * x.nbytes,
            ms=time_ms(lambda: PK.fma_chain(x, RL.FMA_B, RL.FMA_C)),
            plain_ms=time_ms(lambda: PK.fma_chain_plain(x, RL.FMA_B, RL.FMA_C)),
            clocks=clocks_during(lambda: [PK.fma_chain(x, RL.FMA_B, RL.FMA_C)
                                          for _ in range(100)]))
        del x, got, ref
    x = RL.hbm_operand(dev)
    o = torch.full_like(x, math.nan)
    got, ref = PK.copy_add(x), PK.copy_add_plain(x)
    err = max_abs_diff([ref], [got])
    check(torch.equal(got, ref) and PK.copy_add(x, out=o) is o and torch.equal(o, ref),
          f"roofline: K7 vs plain {err}")
    del got, ref
    # the kernel and the library call write the same preallocated o, timed
    # alike and in turns (kernel, library, library, kernel; the mean of
    # each one's two readings): event_ms, then the kernel-only device time
    # from the profiler
    kernel, library = (lambda: PK.copy_add(x, out=o)), (lambda: torch.add(x, 1.0, out=o))
    turns = {}
    mean = lambda a, b: None if None in (a, b) else (a + b) / 2  # None: not measured
    for how, timer in (("", RL.event_ms), ("_profiler", profiled_ms)):
        k1, l1, l2, k2 = timer(kernel), timer(library), timer(library), timer(kernel)
        turns.update({f"ms{how}": mean(k1, k2), f"library_ms{how}": mean(l1, l2)})
    probes["K7"] = dict(
        max_abs_err=err, dtype=f32, flops=float(x.numel()), bytes=2.0 * x.nbytes, **turns,
        plain_ms=time_ms(lambda: PK.copy_add_plain(x)),
        clocks=clocks_during(lambda: [kernel() for _ in range(100)]))
    del x, o
    torch.cuda.empty_cache()
    emit(phase="roofline", item="probes_vs_plain",
         **{k: {n: v for n, v in p.items() if n != "dtype"} for k, p in probes.items()})

    published = {"fma_float32": RL.PUBLISHED_FMA_PEAK[f32],
                 "fma_float64": RL.PUBLISHED_FMA_PEAK[torch.float64],
                 "hbm": RL.PUBLISHED_HBM_BW}
    measured = {"fma_float32": report["fma_peak"]["float32"],
                "fma_float64": report["fma_peak"]["float64"], "hbm": report["hbm_bw"]}
    shares = {k: measured[k] / published[k] for k in published}
    for k, v in shares.items():
        check(0.5 <= v <= 1.05, f"roofline: the measured {k} ceiling is {v:.3f}"
              " of the published peak (outside [0.5, 1.05])")
    emit(phase="roofline", item="ceilings", card=report["card"], measured=measured,
         published=published, share_of_published=shares)

    def bound(flops, nbytes, ms, dtype=f32):
        return dict(flops=flops, bytes=nbytes, **RL.roofline(flops, nbytes, ms, dtype))

    bounds = {}  # {kernel row: [bound of each timed call]}
    for kname, _, _, _, names, factory in KERNELS:
        if factory == "dense":  # K1d: the cli_ns1 float32 run's calls
            d = dense_runs["cli_ns1", "float32"]
            bounds[kname] = [bound(d[n]["flops"], d[n]["bytes"], d[n]["ms"]) for n in names]
        else:
            bounds[kname] = [bound(*works[n], timings[n][0]) for n in names]
    k1d_r5 = dense_runs["rami5_ns1", "float32"]["layer_factory"]
    bounds["K1d rami5_ns1"] = [bound(k1d_r5["flops"], k1d_r5["bytes"], k1d_r5["ms"])]
    for key, p in probes.items():
        bounds[key] = [bound(p["flops"], p["bytes"], p["ms"], p["dtype"])]
    for kname, bs in bounds.items():
        for b in bs:
            check(b["share"] <= 1.05, f"roofline: {kname} ran in {b['share']:.3f}"
                  " of its bound: its work count is wrong")
    emit(phase="roofline", item="bounds", card=report["card"], bounds=bounds)

    for sname, (nreg, ns, L, S) in SOLVE_MODELS.items():
        k_sw, k_lw = mean_steps[sname]
        flops, nbytes = (S * v for v in RL.solve_work_model(
            nreg, ns, L, K_mean=k_sw, K_mean_lw=k_lw))
        pub = RL.roofline(flops, nbytes)
        meas = RL.roofline(flops, nbytes, fma_peak=measured["fma_float32"],
                           hbm_bw=measured["hbm"])
        ceiling = 1e3 / pub["bound_ms"]
        emit(phase="roofline", item="whole_solve", run=sname, dtype="float32",
             nreg=nreg, nstream=ns, layers=L, bands=S,
             layered_columns=walls[sname][0], warm_wall_seconds=walls[sname][1],
             cols_per_sec=cols_per_sec[sname], mean_doubling_steps_sw_lw=[k_sw, k_lw],
             flops_per_col=flops, bytes_per_col=nbytes,
             ceiling_cols_per_sec=ceiling, bound_by=pub["bound_by"],
             share=cols_per_sec[sname] / ceiling,
             measured_ceiling_cols_per_sec=1e3 / meas["bound_ms"],
             share_of_measured=cols_per_sec[sname] * meas["bound_ms"] / 1e3)

    # ---- 4. warm wall times and a device trace of each slice run
    if profile:
        for sname, dname, config, rep, L, S in runs:
            arrays = example_arrays(C=len(rep), L=L, S=S,
                                    dtype=dtypes[dname][0], i_representation=rep)
            walls = {route: wall_seconds(
                lambda: run_radsurf(config, arrays, dev, route=route))
                for route in ("kernel", "scan")}
            emit(phase="profile", run=sname, dtype=dname,
                 **{f"seconds_{r}_route": w for r, w in walls.items()},
                 **trace_fields(lambda: run_radsurf(config, arrays, dev), kernels=TRACED))
            torch.cuda.empty_cache()
        # one gradient step of the grad phase at the headline
        rep, base, _ = grad_cases["headline"]
        config = dataclasses.replace(base, column_chunk=GRAD_CHUNK).consolidate()
        for dname, (np_dt, _) in dtypes.items():
            arrays = example_arrays(C=len(rep), L=8, S=1, dtype=np_dt, i_representation=rep)
            veg_ext = torch.as_tensor(arrays["veg_ext"], device=dev)
            emit(phase="profile", run="grad headline", dtype=dname,
                 **trace_fields(lambda: grad_step(config, arrays, veg_ext), kernels=TRACED))
            del arrays, veg_ext
            torch.cuda.empty_cache()

    # ---- shapes: each checks.SHAPES entry once, at its full shape
    shapes_phase(dev)

    rows = []
    for (kname, src, rep, _, names, factory), e in zip(KERNELS, errs):
        if factory == "dense":  # K1d: the cli_ns1 float32 run
            d = dense_runs["cli_ns1", "float32"]
            n, n_lw, err = (*dense_launches, dense_err)
            t = {w: (d[w]["ms"], d[w]["plain_ms"]) for w in names}
        else:
            n, n_lw, err, t = (main_launches[kname.split()[0]],
                               main_launches["K1 LW mode"], e[0], timings)
        row = {"name": kname, "route": "cuda", "source": src, "replaces": rep,
               "launches": n, "max_abs_err": err, "ms": t[names[0]][0],
               "plain_ms": t[names[0]][1], **bounds[kname][0], "library_ms": None}
        if names[0] in SWEEPS:  # K2-K5 at the rami5 shape (float32)
            r5 = sweep_runs["rami5_shape", "float32"][names[0]]
            row.update({f"{key}_rami5": r5[key] for key in
                        ("ms", "flops", "bytes", "bound_ms", "bound_by", "share")})
        if names[0] in SWEEPS:  # K2-K5: launch shape
            for sname, sfx in (("headline", ""), ("rami5_shape", "_rami5")):
                r = sweep_runs[sname, "float32"][names[0]]
                row.update({f"{key}{sfx}": r[key] for key in SHAPE_FIELDS.values()})
        if factory == "dense":  # K1d: device ms, launch shape; rami5_ns1's SW call
            for w, sfx in zip(names, ("", "_lw")):
                row.update({f"{key}{sfx}": d[w][key] for key in
                            ("device_ms", "share_device", *SHAPE_FIELDS.values())})
            row.update({f"{key}_rami5": k1d_r5[key] for key in
                        ("ms", "plain_ms", "device_ms", "flops", "bytes", "bound_ms",
                         "bound_by", "share", "share_device", *SHAPE_FIELDS.values())})
            row["launches_rami5"] = main_launches_r5
        if factory == "structured":  # K1's launch shape at the headline
            for mode, c in main_k1_shape.items():
                sfx = "" if mode == "sw" else "_lw"
                row.update({f"{key}{sfx}": v for key, v in c.items()})
        if len(names) > 1:  # the factory: its LW call
            lw = bounds[kname][1]
            row.update(launches_lw=n_lw, ms_lw=t[names[1]][0],
                       plain_ms_lw=t[names[1]][1], flops_lw=lw["flops"],
                       bytes_lw=lw["bytes"], bound_ms_lw=lw["bound_ms"],
                       bound_by_lw=lw["bound_by"], share_lw=lw["share"])
        rows.append(row)
    for (kname, src, rep), key in zip(PROBES, ("K6 float32", "K7")):
        p = probes[key]
        row = {"name": kname, "route": "cuda", "source": src, "replaces": rep,
               "launches": probe_launches[kname.split()[0]],
               "max_abs_err": p["max_abs_err"], "ms": p["ms"], "plain_ms": p["plain_ms"],
               **bounds[key][0], "library_ms": p.get("library_ms")}
        if key == "K7":  # both timed from the profiler too
            row.update(ms_profiler=p["ms_profiler"],
                       library_ms_profiler=p["library_ms_profiler"])
        if key.startswith("K6"):  # its float64 instantiation
            p64, b64 = probes["K6 float64"], bounds["K6 float64"][0]
            row.update(max_abs_err_f64=p64["max_abs_err"], ms_f64=p64["ms"],
                       plain_ms_f64=p64["plain_ms"], flops_f64=b64["flops"],
                       bytes_f64=b64["bytes"], bound_ms_f64=b64["bound_ms"],
                       share_f64=b64["share"])
        rows.append(row)
    emit(kernels=rows)
    print(card_line(), flush=True)
    if FAILURES:
        for f in FAILURES:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
