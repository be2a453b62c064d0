#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``uivr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --quick    # phase 1, then phases 5a and 5b's lane
                                     # checks without times
    python3 chip_smoke.py --sweep    # every phase, with the sweeps and A/B
                                     # runs that chose the persistent kernels

Phases, one JSON line each; any failure exits nonzero before the last line.
K6 (subcell classification) is on by default in every walking kernel; "K6
off" is the same kernel on the same medium without its subcell table, which
must give the same result.  The walking kernels (``volpath_primal``, its
path-state entry, its K7 form, ``volpath_adjoint`` and the DRT term's
walk and NEE) are persistent: lanes take rays from a work counter, a new
one as soon as theirs ends.  The one-ray-per-thread kernels they replaced
run only here, through the wrappers' ``direct=True``, as the A/B baseline
and the bit-for-bit reference on the card.  The plain twins of phases 3, 6
and 9b run after their phase's times are taken, two at a time: every
other one in a worker process (``run_twins``; the worker shares the card,
so nothing is timed meanwhile); those of phase 8 wait for phase 9c, which
runs them in TWIN_WORKERS worker processes at once (``check_step``):

1. device: the card (``nvidia-smi`` name and power limit on a line of its
   own), torch and CUDA versions, and the kernels' nvcc builds (one nvcc
   per source, started together, with the ``--fmad=true`` primal) with
   ptxas' registers and spills, and the native host helpers' g++ build
   (``uivr_tpu_torch/native``); with
   ``--sweep`` also the variants of the persistent kernels
   (PERSIST_VARIANTS: the minimum-blocks bound of ``__launch_bounds__`` at
   3 to 6 beside the package's own, PACKAGE_MIN_BLOCKS).
2. tea (K1): ``tea_kernel`` against the plain ``tea_plain`` on 2**20 random
   (v0, v1) pairs at 5, 6 and 8 rounds; bit for bit.
3. primal (K2 + K3 + K6): ``volpath_primal_kernel`` on 2**16 camera rays at
   random pixels of sensor 0, from the ground-truth grids: janga-smoke and
   dust-devil at full width (envmap, NEE on) and tiny-cube (constant
   emitter) with NEE on and off.  K6 on must equal K6 off on every lane
   (radiance bit for bit, escapes, draws, steps).  Against the plain twin
   (``engine="flat"``) a lane agrees when |dL| <= 1e-4 (1 + |L|) on all
   three channels; janga-smoke and dust-devil need >= 0.90 of lanes,
   tiny-cube >= 0.95, and every channel mean within 2%; janga's rays also
   go through a build with ``--fmad=true``.  K6 must classify MAIN nulls
   on dust-devil, and on janga-sparse (janga's density kept in a central
   block under one global majorant, on/off only) both MAIN nulls and
   SHADOW events in empty subcells.
4. render: ``python -m uivr_tpu_torch.cli.render --scene <s> --sensor 0
   --spp 64`` for janga-smoke and dust-devil (1,785,600 rays each) with
   every launch counter set to 0 just before; the kernels and K6 must have
   launched and the plain twin must not have run.  The EXR is read back
   and checked.  Then three more renders (host clock) and four timed part
   by part with CUDA events (scene set-up, ray generation, kernel,
   reduction), K6 on, off, off, on.
5. the primal kernel at the shape the render gave it (its first chunk of
   2**20 rays), K6 on and off, beside its plain version (janga-smoke; K6
   on and off on dust-devil's chunk too).
5a. persistent: the persistent kernels against the one-ray-per-thread ones
   at the main path's shapes: janga-smoke's render chunk, a truth
   training step's first forward chunk (32,768 pixels x 32 spp), its
   replay and adjoint (x 16 spp: 524,288 rays) and its DRT term's resumed
   primal, dust-devil's render chunk (and janga XML's in phase 9b): every
   lane equal (radiance bit for bit, escapes, draws, steps, K6's counters;
   the adjoint's per-ray outputs bit for bit and its gradients within a
   relative L1 of 1e-4), the lane utilization of both (busy lane-steps
   over 32 x warp iterations; the direct kernel's from its per-lane
   steps), times in turns (direct, persistent, persistent, direct); with
   ``--sweep`` the variants' times and ptxas reports, each equal to the
   package's build.  The persistent kernels' lanes
   equal the twin's wherever phases 3-9b compare the main path's
   kernels with their twins.  Phases 3 and 9b hold the persistent primal
   against the direct one on their random-pixel rays too.  The DRT term on
   the replay's reservoirs (``drt_turns``): the persistent
   ``drt_walk_kernel`` and ``drt_nee_kernel`` against the
   one-thread-per-vertex ones (the walk's t_sel, wsum, found, trips_a, p,
   kept sigma and albedo and K_A, the NEE's nee, trips_b and K_B bit for
   bit; the walk's trips, both lane utilizations and warp iterations;
   both launches timed in DRT_TURN_ROUNDS rounds of turns).
5b. K7 (K-candidate batching).  k7_chunk: the persistent
   ``volpath_primal_k_kernel`` against the one-ray-per-thread
   ``volpath_primal_k_direct_kernel`` at K = 2, 4, 8 on every lane of
   janga's and dust-devil's chunks (radiance bit for bit, escapes, draws,
   steps and the K7 counters), the lane utilization of both and their
   times in turns, K=1's time (median of 3), each K's counters; the K=4
   kernel against the K=4 twin on every lane of janga's chunk and the
   twin's time; ptxas' registers and spills of every K7 instantiation.
   k7_unbiased: janga-smoke and dust-devil, sensor 0 at
   64 spp, under UIVR_KCAND=4 and 1 in turns: K=4 within 4 standard
   errors of K=1 per channel (paired per-pixel test), K7 launched at K=4
   only.
6. adjoint (K4 + K5 + K6): ``volpath_adjoint_kernel`` after one replay
   primal each, K6 on against off (draws, steps and reservoir depth equal
   on every lane, gradients' relative L1 <= 1e-4: atomics reorder the
   sums), and against the twin's adjoint walk on the same rays, seed and
   random dL: janga-smoke, 8,192 random-pixel rays, under
   ``volpathsimple-drt`` and ``volpathsimple-basic`` with shadow RR 0.05;
   tiny-cube, 16,384 rays, NEE on and off (per-lane primary draws, alt
   draws and reservoir depth equal on >= 0.90 of lanes for janga, >= 0.95
   for the cube; gradients' relative L1 <= 1e-2); dust-devil, 8,192 rays,
   K6 on against off only (its twin check is phase 8's).
7. train: ``opt.run_optimization`` with ``volpathsimple-drt`` at full
   width (batch 32,768, 16 adjoint spp, primal factor 64: 33,554,432
   primal and 524,288 adjoint rays a step), grids at full resolution (no
   upsampling), counters set to 0 just before: the kernels and K6
   launched, the twins never ran, parameters changed.  janga-smoke: 3
   iterations, 128^3 grids, references at 64 spp, the .vol checkpoints
   read back; dust-devil: 2 iterations, 256^3 grids, the ``-from-nerf``
   schedule (lr 1e-4, albedo factor 100), references at 16 spp (a cut:
   the step does not depend on them).  Then, for each, ``run_optimization``
   for one step from the ground-truth grids.  ``StepRecorder`` keeps what
   each step did: its seconds, loss and gradients, the inputs and outputs
   of its adjoint and DRT calls, and CUDA events around the pixel draw,
   the step and every kernel launch (``volpath_step.TIMINGS``), which give
   the step's parts.  step_turns: janga's truth step (with ``--sweep``
   also its second iteration from the constant start and dust-devil's and
   janga XML's truth steps) with the one-ray-per-thread kernels and the
   persistent ones in turns.  trace: janga's truth step once more under ``torch.profiler``
   (``utils/profiling.py``): the device's busy and idle share, its longest
   idle gaps, the kernels by device time, and the host calls that waited
   for the device between the forward's launches.  k7_train: janga-smoke
   again under UIVR_KCAND=4, two
   iterations and a truth step (references at 16 spp): per step 32 K7
   launches, a K=1 replay and DRT resume by the counters, check_step
   (phase 8) on the truth step, and the last 65,536 rays of its first
   forward chunk against the K=4 twin keyed by their ray ids.
8. adjoint_step and drt (``check_step``), for janga's first step and
   truth step and dust-devil's truth step: the adjoint call's per-lane
   primary draws, alt draws and reservoir depth on its last 8,192 rays
   against the twin keyed by their ray ids (``lane0``), >= 0.90 of lanes,
   and the step's gradients finite and nonzero; ``drt_backward_kernel``
   against ``volpath_flat._drt_backward_flat`` on all 524,288 reservoirs
   of the step: equal wavefront maxima K_A and K_B, per-lane t_sel, wsum
   and found equal on >= 0.90 of lanes, gradients' relative L1 <= 1e-2;
   and on the same reservoirs phase 5a's ``drt_turns`` and
   ``drt_walk_causes`` (both walks on the vertices in order, shuffled, and
   one per lane: ns per warp iteration; timed at once).  The rest of
   each check, and so its records, comes in phase 9c: the three twins
   (the adjoint slice's replay primal and walk, the DRT term) in worker
   processes (``submit_check``), the DRT kernel in this process
   (``finish_check``), beside 9c's untimed work.  Every twin runs under
   ``torch.inference_mode`` (``twins_without_autograd``): the same ops,
   less host time per op.
9. cli: ``uivr_tpu_torch.cli.reproduce`` on tiny-cube with its default
   stages, ``nerf`` then ``volpathsimple-drt`` (20 iterations at batch 557
   each); each stage's metrics.jsonl must hold losses and its final
   checkpoint must exist.  fd: ``uivr_tpu_torch.cli.fd`` on tiny-cube (spp
   1024, res 16, all three grids) under ``volpathsimple-drt`` and
   ``volpathsimple-basic``, K6 on and off: kernels only, no twin, the same
   FD values and adjoint gradients (relative L1 <= 1e-4); under ``nerf``
   (sigma_t and emission): the NeRF kernels only, correlation >= 0.9.
9a. nerf: the NeRF bootstrap stage of janga-smoke at the reference's width
   (batch 32,768, spp 4, primal factor 1: 131,072 rays a pass, 128 queries
   a ray) on the train phase's references (``phase_nerf``): a step from the
   ground truth, whose ``nerf_primal`` L (relative max abs error <= 1e-5)
   and ``nerf_adjoint`` gradients (relative L1 <= 1e-5) are held against
   the plain version on the step's own inputs, and one from the constant
   start, with their parts (CUDA events: forward, replay, adjoint, Adam,
   projection); the stage through ``cli.reproduce._run_stages`` cut to 25
   iterations (8^3 to 128^3 at 1, 4, 9, 16) with every counter set to 0
   just before (both kernels launched, no plain call on the card, finite
   losses, the final checkpoint); one full-width ``volpathsimple-drt`` step
   of janga-smoke-from-nerf warm-started from it through ``_run_stages``;
   ``cli.render --integrator nerf --spp 64 --checkpoint`` of it; then
   both kernels against their one-ray-per-thread twins (``nerf_*_direct``,
   which only this phase launches) at every grid resolution of the stage
   (janga's truth grids resized to 8^3 ... 128^3, the truth step's rays
   and dL) and at dust-devil's 256^3 truth grids with a dust-devil NeRF
   step's rays (262,144 forward, 131,072 adjoint, dL from a seed): the
   primal bit for bit on every lane, the adjoint's gradients' relative L1
   to the direct kernel's, to a second run of it, and of both to the
   float64 sums of the direct kernel's terms (the redesigned within 1e-5
   of those at every shape; the others are reported), both lane
   utilizations, the adjoints' global atomics a launch (counting builds),
   times in turns (direct, new, new, direct),
   and the L2 probe's random float4 gather and atomic rates at each grid's
   voxel count (``csrc/l2_probe.cu``), which give the rows' L2 model times.
   nerf_large (``phase_nerf_large``): the march kernels' int64_t
   instantiation, which grids of 2^29 voxels and more take.  At 128^3, on
   the truth step's rays and dL: the int64 primal bit-equal to the int32
   kernel on every ray, the int64 adjoint within 1e-5 relative L1 of the
   float64 sums of the direct kernel's terms, both pairs timed in turns
   (int32, int64, int64, int32), ptxas' registers of both instantiations.
   Then a NERF_LARGE_SHAPE grid (2^29 voxels, random grids from a seeded
   generator on the card) and 131,072 rays, three in four through its
   upper half in z (float offsets above 2^30), with every counter set to 0
   just before the wrappers run (``index64`` picked by size): the primal
   on every ray and the adjoint on the first NERF_LARGE_SLICE, which must
   launch the int64 kernels only; the primal bit-equal to the plain march
   on that slice, the adjoint within 1e-5 relative L1 of the plain adjoint
   and of the float64 sums of the direct kernel's terms, the direct
   kernel's own distance to those sums; both kernels' times on every ray,
   their bounds from the voxels the march reads, the phase's seconds and
   the card's peak allocation.
9b. xml: the XML path.  ``write_standins`` writes stand-in assets of the
   shapes janga-smoke's and dust-devil's XML files and scene vars name
   (plumes of 136x264x136 and 256^3 voxels, albedo 128x256x128 noise and a
   256^3 sand colour, ``procedural_sky`` at 1024x2048 as .hdr and 2048x4096
   as .exr) from a seed into a temporary scene directory beside copies of
   the XML files, and ``UIVR_SCENE_DIR`` points the registry there.
   xml_render: ``cli.render --scene janga-smoke --sensor 0 --spp 64`` at
   720x620 (28,569,600 rays): every launch took K3b, no twin ran, the EXR
   reads back.  k3b_primal / k3b_adjoint: ``volpath_primal_kernel`` against
   the twin's deferred mode on 2**16 random-pixel rays of sensor 0 (phase
   3's bar) and ``volpath_adjoint_kernel`` against the deferred adjoint walk
   on 8,192 rays (phase 6's bar).  k3b_chunk: the primal kernel against the
   deferred twin on the render's first chunk (2**20 rays, phase 3's bar),
   the shape its time is taken at.  unbiased: sensor 0 at 256 spp with K3b,
   with K3 (the map without its proxy) and without NEE; per channel the
   paired per-pixel difference's mean over its standard error, K3b against
   the NEE-free image at most 4 (K3 is reported: its full-resolution alias
   table is biased, ROADMAP C2).  xml-train: ``run_optimization`` of
   ``volpathsimple-drt`` at full width from the ``start_from_value`` grids,
   2 iterations and one step from the ground truth, references from
   ``build_ref()`` at 4 spp (a cut: the step does not depend on them);
   every walking launch took K3b, in the main run and in each recorded
   step; ``check_step`` on its truth step (the adjoint slice and the DRT
   term, whose resumed primal takes K3b, against the deferred twins).
   dust-devil: its 4k map (8,388,608 texels), sensor 0 at 64 spp with K3b
   and K3 in turns and without NEE; K3b against the NEE-free image at most
   4 standard errors per channel.  k7_xml: K7 with K3b, 65,536
   random-pixel rays at K=4 against the deferred K=4 twin on every lane,
   the kernel at K=4 and K=1 on the render's first chunk in turns, and the
   render CLI under UIVR_KCAND=4: every launch took K3b and K7, no twin
   ran, the image within 4 standard errors of the K=1 render's.
9c. nested: the nested engine (``integrators/volpathsimple.py``, plain
   PyTorch on the card, the ``volpathsimple-drt-quadratic`` preset).
   unbiased: tiny-cube, max_depth 16, NEE on, tests/test_integrators.py's
   16 fixed pixels x 2,048 rays, 6 seeds: the mean gradients of the
   nested engine's three forms (basic, drt, drt-quadratic) and of the
   kernels' ``volpathsimple-drt`` agree pairwise (median |difference| over
   the scale of the basic mean below 0.03), and the nested primal's image
   lies within 4 standard errors of the kernel's per channel.
   card_vs_cpu: the nested primal on 2**14 random-pixel rays of janga's
   truth grids at max_depth 8, on the card and on the CPU: the final
   counters of the shared sampler, the lane agreement (phase 3's rule,
   >= 0.90 where the counters are equal) and the channel means within 2%.
   times (CUDA events and the host clock, with the wavefront iterations,
   each ending in one host sync): the nested primal on janga's render
   chunk (2**20 rays) at max_depth 64; the quadratic adjoint (with its
   replay) on 524,288 random-pixel rays at max_depth 16, then 64 if the
   time predicted from 16's (iterations grow with the depth squared) stays
   within NESTED_BUDGET_S (8 if 16 does not fit); one ``run_optimization``
   step of janga-smoke from the ground truth at 4,096 pixels x 4 spp
   (primal factor 1) and max_depth 16 under the quadratic preset and under
   ``volpathsimple-drt`` on the kernels; the cuts from the reference's
   settings are listed as ``reduced``.  cli: ``reproduce --integrator
   volpathsimple-drt-quadratic --retries 1`` on tiny-cube (20 iterations
   at batch 256): one child without ``--retries``, exit 0, its initial and
   final checkpoints and finite losses.  The cli child, unbiased's seeds
   (NESTED_SEEDS_HERE here, each other one in a worker) and every
   ``check_step``'s twins (see 8) run together; card_vs_cpu and times run
   alone.
9d. parallel: data parallel (``uivr_tpu_torch.parallel``) at janga-smoke's
   full training width on its truth grids (32,768 pixels of the training
   sensors, 1,024 primal and 16 adjoint spp, max_depth 64, a constant
   reference of 0.25), four render seeds (PARALLEL_SEEDS).  This process
   first takes, alone on the card, the value-and-grad of each of the two
   shards of the first seed with its rank's mixed seeds, and the unsharded
   step of every seed.  (a) two ranks on the one card (gloo: NCCL refuses
   two ranks on one device), spawned by ``parallel.spawn``, run
   ``sharded_loss_and_grad`` for every seed with the counters set to 0
   just before each step: both ranks bit-equal; the first step's loss
   within 1e-6 relative and its gradients within 1e-5 relative L1 of the
   mean of this process's two shards (the atomics' order); the four seeds'
   mean loss within 5% of the unsharded steps' and the mean gradients'
   z-slab sums correlated above 0.85 (tests/test_parallel.py's statistical
   check); every rank's every step launched K1, K2 (and its path-state
   entry), K4 and the four DRT kernels, no direct kernel and no twin; the
   step's host-clock ms on the two ranks (time-sliced on one card, not a
   scaling figure) beside the unsharded step's.  (b) a one-rank NCCL group
   on cuda:0 runs the same step on the first half of the batch, which is
   the parent's shard 0: equal to it within the same tolerances.  (c)
   ``python -m uivr_tpu_torch.cli.reproduce --config tiny-cube --integrator
   volpathsimple-drt --mesh 2 --scale 0.01`` (20 iterations at batch 256),
   started beside (b): exit 0, gloo on both ranks, one metrics file, one
   set of initial and final checkpoints, both ranks' final grids equal
   (the digests each rank prints).  native_loads: janga-smoke's and
   dust-devil's XML presets loaded from ``write_standins``' assets with the
   native helpers and with the Python path asked for (``native._load``
   made to find no compiler): the seconds of each load, ``native.CALLS``
   showing which path ran, and the maps and emitter tables bit-equal.
10. kernels: every kernel of both paths at the shape the main path gives
   it, with its launches, time, plain version's time, bound and agreement;
   K6's row gives the walking kernels' times with K6 on and off at the
   main path's shapes and its counters (MAIN nulls classified, fetches
   avoided); K3b's row (``deferred_nee``) the primal kernel with K3b and
   with K3 on the XML render's first chunk, its error and plain time on
   that chunk; K7's row (``k_candidate_batching``) the K=4 kernel's time
   and bound on janga's chunk with the other K's times, its launches from
   k7_train; the one-ray-per-thread K7 and DRT walk and NEE kernels as
   ``comparison_only`` rows (0 launches on the main path); the NeRF rows
   (``nerf_primal``, ``nerf_adjoint``: launches in the 25-iteration stage,
   times in its truth step, times at every shape of phase 9a, registers
   and times in turns with the int64 kernels; their direct twins as
   ``comparison_only`` rows; ``nerf_primal_i64``, ``nerf_adjoint_i64``:
   launches on nerf_large's large grid, times at 128^3 in turns and on the
   large grid with its bound).  With UIVR_KCAND unset the
   main path must launch no K7 kernel.
   ``launches_per_train_step`` is the counters' growth over the main
   run's first recorded step.
11. the last line: {"ok": true, "device": {...}}.

``bound_ms`` is the larger of the bytes the function must move (each input
read once, each output written once) over 3.35 TB/s and its operations:
float operations over 67 T/s, the H100 SXM's float32 rate outside the
tensor cores (128 lanes a SM, an FMA as two), and the TEA hashes' integer
operations (``TEA_OPS_PER_ROUND`` a round: the instructions of a round
that run on the integer pipe) over the INT32 rate, 64 lanes a SM per
clock x 132 SMs at ``SM_CLOCK_HZ`` (16.7 T/s); the two pipes run side by
side, so the operations take the longer of the two times.  The
walking kernels' operations are counted from this run's per-lane tracking
steps and draws: ``FLOP_PER_STEP`` float operations per tracking event,
and a ``LANE_DRAW_ROUNDS``-round hash per draw (two per event at least,
one more per real collision, four per scatter with NEE).  A wavefront
draw of the delayed DRT term needs an 8-round hash against its vertex,
and its counter's 4-round pre-hash once for all vertices.
``gather_bound_ms`` counts instead the bytes the events fetch: 132 B of
grid and majorant per event (8 B, majorant and subcell bound, for an event
K6 classified), 28 B of envmap per scatter, 36 B per ray.  The training
kernels' bounds (``adjoint_bound``, ``drt_bounds``) follow the same two
rules, from this run's per-lane counters.
"""
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
SM_CLOCK_HZ = 1.98e9      # the H100 SXM's boost clock, at which its peak rates hold
SMS = 132
FP32_OPS_PER_S = 67e12    # 128 FP32 lanes a SM per clock, an FMA as two operations
INT32_OPS_PER_S = 64 * SMS * SM_CLOCK_HZ
FLOP_PER_STEP = 120       # float operations of a tracking event, its draws apart
# integer-pipe instructions of one TEA round as nvcc builds it for sm_90a:
# 2 LEA, 2 LEA.HI and 2 LOP3 (its 4 adds run as VIADD and IMAD.IADD on
# the FMA pipe; cuobjdump -sass of tea(v0, v1, 8))
TEA_OPS_PER_ROUND = 6
LANE_DRAW_ROUNDS = 5      # a walking kernel's per-lane draw (core/rng._DRAW_ROUNDS)
# float operations of one step of the NeRF march (csrc/nerf.cuh), counted
# from its source: the point (9), the corners and weights (43), the
# 4-channel trilinear fma chain (60, an fma as two), scale, activation and
# exp (6), compositing (11); the adjoint's step replaces the compositing
# with the replay's update and the two cotangents (36) and adds 8 corners
# x 4 products and adds (64)
NERF_FLOP_PER_STEP = {"nerf_primal": 129, "nerf_adjoint": 218}
NERF_FLOP_PER_RAY = 40    # the ray's transform, slab test, entry and step
NERF_KERNELS = ("nerf_primal", "nerf_adjoint")
NERF_RES = (8, 16, 32, 64, 128)   # the grid resolutions of the reference's NeRF stage
# phase nerf_large: a (D, H, W) grid of 2^29 voxels, the smallest power of
# two whose float offsets need the kernels' int64_t instantiation, and the
# rays of its slice held against the plain march and float64 sums
NERF_LARGE_SHAPE = (512, 1024, 1024)
NERF_LARGE_SLICE = 8192
# registers of the int32_t NeRF kernels when they were measured (PERF.md)
NERF_I32_REGISTERS = {"nerf_primal": 79, "nerf_adjoint": 153}


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; phase records carry the script's elapsed seconds."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=round(time.perf_counter() - T0, 3))
    print(json.dumps(obj), flush=True)


def bound(n_bytes, n_ops, n_int_ops=0):
    """(least ms, "bytes" or "operations") of n_bytes moved, n_ops float
    and n_int_ops integer operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_ops / FP32_OPS_PER_S, n_int_ops / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tracking_ops(steps, draws):
    """(float, integer) operations of ``steps`` tracking events that
    consumed ``draws`` per-lane draws (at least two an event)."""
    return (FLOP_PER_STEP * steps,
            max(draws, 2 * steps) * LANE_DRAW_ROUNDS * TEA_OPS_PER_ROUND)


def wavefront_ops(draws, counters):
    """Integer operations of ``draws`` wavefront draws over ``counters``
    distinct counters: an 8-round hash each, a 4-round pre-hash each
    counter."""
    return (8 * draws + 4 * counters) * TEA_OPS_PER_ROUND


def cuda_ms(fn, reps):
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_fmad_variant():
    """Start nvcc on the primal kernel with --fmad=true (the default
    contraction) into build/, beside the package's own build."""
    from uivr_tpu_torch.ops import volpath_step as vs
    flags = [f for f in vs.NVCC_FLAGS if f != "--fmad=false"] + ["--fmad=true"]
    out = vs.build_dir() / "libuivr_primal-fmad.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen([vs._nvcc(), *flags, "-o", str(out),
                             str(vs.CSRC / "volpath_primal.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def build_l2_probe():
    """Start nvcc on the L2 probe (``csrc/l2_probe.cu``, not one of the
    package's libraries) into build/, beside the package's own build."""
    from uivr_tpu_torch.ops import volpath_step as vs
    out = vs.build_dir() / "libuivr_l2_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen([vs._nvcc(), *vs.NVCC_FLAGS, "-o", str(out),
                             str(vs.CSRC / "l2_probe.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def load_l2_probe(proc, path):
    """Wait for the probe's build and load it: (ctypes library, nvcc log)."""
    import ctypes
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc l2_probe.cu failed:\n{log}")
    lib = ctypes.CDLL(str(path))
    lib.l2_gather_launch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.l2_atomic_launch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.l2_gather_launch.restype = lib.l2_atomic_launch.restype = ctypes.c_int
    return lib, log


def time_render_parts(st, b, seed, spp):
    """CUDA-event times (ms) of the parts of one full-frame render, in the
    order render_image runs them."""
    import torch
    from uivr_tpu_torch.core import rng
    from uivr_tpu_torch.ops import volpath_step as vs
    from uivr_tpu_torch.render import batched
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    parts = {"scene": 0.0, "rays": 0.0, "kernel": 0.0, "reduce": 0.0}

    def timed(name, fn):
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        parts[name] += ev[0].elapsed_time(ev[1])
        return out

    dev = b.params.sigma_t.device
    scene = timed("scene", lambda: batched._scene(st, b.params, b.emitter, b.cameras,
                                                  b.to_world))
    W, H = st.film_size
    pix_all = torch.stack([torch.arange(W * H, device=dev) % W,
                           torch.arange(W * H, device=dev) // W], dim=-1)
    chunk_pix = (1 << 20) // spp
    for i in range(0, W * H, chunk_pix):
        pix = pix_all[i:i + chunk_pix]
        sidx = torch.zeros(pix.shape[0], dtype=torch.int64, device=dev)
        sub = rng.sample_tea_32(seed + i, 22)[0]
        o, d = timed("rays", lambda: batched._expand_rays(b.cameras, sidx, pix, st.film_size,
                                                          spp, sub))
        L, _ = timed("kernel", lambda: vs.sample_primal_kernel(st.integrator, scene, o, d,
                                                               seed + i))
        timed("reduce", lambda: L.reshape(-1, spp, 3).mean(dim=1).cpu())
    return parts


def ptxas_report(log):
    """{kernel: "registers, spills"} from nvcc -Xptxas -v output."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = []
        elif name and ("registers" in ln or "spill" in ln):
            out[name].append(ln.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def lane_agreement(L, Lref):
    ok = ((L - Lref).abs() <= 1e-4 * (1.0 + Lref.abs())).all(dim=-1)
    return ok.float().mean().item()


def no_cls(sc):
    """The same scene with K6 off: its medium without the subcell table."""
    return sc._replace(medium=sc.medium._replace(sub=None))


def cls_counts(cls):
    """Sums of the walking kernels' per-lane K6 counters (n, 5), with the
    share of MAIN nulls classified and the sigma fetches avoided."""
    from uivr_tpu_torch.ops.volpath_step import CLS_COUNTERS
    c = dict(zip(CLS_COUNTERS, cls.to("cpu").long().sum(0).tolist()))
    c["main_nulls_classified_share"] = c["cls_main_nulls"] / max(c["main_nulls"], 1)
    c["fetches_avoided"] = c["cls_main_nulls"] + c["cls_shadow"]
    c["fetches_avoided_share"] = c["fetches_avoided"] / max(c["candidates"], 1)
    return c


def on_off_ms(on, off, reps=2):
    """CUDA-event times (ms) of two versions of a launch, in turns (on,
    off, off, on), each the mean of its two turns."""
    a = cuda_ms(on, reps)
    b = cuda_ms(off, reps) + cuda_ms(off, reps)
    return (a + cuda_ms(on, reps)) / 2, b / 2


def event_fetch_bytes(events, cls):
    """The fetch model's bytes of ``events`` tracking events: 132 B of grid
    corners and majorant each, but 8 B (majorant + subcell bound) for the
    events K6 classified."""
    classified = cls["fetches_avoided"] if cls else 0
    return 132 * (events - classified) + 8 * classified


# ------------------------------------------------------------------ training
DRT_KERNELS = ("volpath_drt_walk", "volpath_drt_nee", "volpath_drt_phase",
               "volpath_drt_scatter")
# rounds of turns (persistent, direct, direct, persistent) in which
# drt_turns times the DRT walk and NEE
DRT_TURN_ROUNDS = 4
# the walk's per-vertex outputs
DRT_WALK_OUT = ("t_sel", "wsum", "found", "trips_a", "p", "sel_sig", "sel_alb")
ADJ_KERNELS = ("volpath_adjoint", "volpath_primal_state") + DRT_KERNELS
TRAIN_KERNELS = ("volpath_primal",) + ADJ_KERNELS
SLICE = 8192    # lanes of a training step's adjoint call held against the twin


def twins_without_autograd(volpath_flat):
    """Run the twins' entry points (``sample_primal``, ``adjoint_walk``,
    ``_drt_backward_flat``) under ``torch.inference_mode``: the same ops on
    the same tensors, so the same bits, with less host time per op (the
    twins are bound by it: thousands of small ops per tracking event); no
    one takes their gradients, and the main path never calls them."""
    import functools

    import torch
    for name in ("sample_primal", "adjoint_walk", "_drt_backward_flat"):
        fn = getattr(volpath_flat, name)

        @functools.wraps(fn)
        def run(*a, _fn=fn, **k):
            with torch.inference_mode():
                return _fn(*a, **k)
        setattr(volpath_flat, name, run)


def rel_l1(a, ref):
    return float((a - ref).abs().sum() / ref.abs().sum().clamp_min(1e-30))


def equal_frac(a, b):
    return float((a == b).float().mean())


class StepRecorder:
    """Records what the steps of ``opt.run_optimization`` do, around the
    package's own functions, each of which still runs as it is: CUDA events
    of the pixel draw, of the whole step and of every kernel launch
    (``volpath_step.TIMINGS``); the launch counters' growth over the step
    (``counts``); the adjoint walk's inputs and outputs; the delayed DRT
    term's inputs; the gradients the backward returns; the first K7 forward
    chunk's inputs and outputs (``forward``); CUDA events around the
    step's Adam update and projection (``ops``)."""

    def __init__(self, vs, loop):
        self.vs, self.loop = vs, loop
        self.steps, self.pre, self.saved = [], [], {}

    def __enter__(self):
        import torch
        vs = self.vs

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def timed(fn):
            def run(*a, **k):
                s = event()
                out = fn(*a, **k)
                self.pre.append((fn.__name__, s, event()))
                return out
            return run

        def make_step(make):
            def build(*a, **k):
                step = make(*a, **k)

                def run(*args):
                    rec = {"pre": self.pre, "launches": []}
                    self.pre = []
                    self.steps.append(rec)
                    torch.cuda.synchronize()
                    vs.TIMINGS = rec["launches"]
                    before = dict(vs.LAUNCHES)
                    t0 = time.perf_counter()
                    with torch.profiler.record_function("train_step"):
                        rec["start"] = event()
                        out = step(*args)
                        rec["end"] = event()
                        torch.cuda.synchronize()
                    rec["seconds"] = time.perf_counter() - t0
                    vs.TIMINGS = None
                    rec["counts"] = {k: vs.LAUNCHES[k] - before[k] for k in before}
                    rec["loss"] = float(out[2])
                    return out
                return run
            return build

        def in_step(fn):
            def run(*a, **k):
                s = event()
                out = fn(*a, **k)
                if self.steps:
                    self.steps[-1].setdefault("ops", []).append((fn.__name__, s, event()))
                return out
            return run

        def adjoint_walk(fn):
            def run(cfg, scene, o, d, seed, dL, state_in):
                out = fn(cfg, scene, o, d, seed, dL, state_in)
                self.steps[-1]["adjoint"] = dict(cfg=cfg, scene=scene, o=o, d=d, seed=seed,
                                                 dL=dL, L=state_in, res=out[1], stats=out[2])
                return out
            return run

        def drt(fn):
            def run(cfg, scene, seed, res, adjoint, acc):
                self.steps[-1]["drt"] = dict(seed=seed, res=res, adjoint=adjoint)
                return fn(cfg, scene, seed, res, adjoint, acc)
            return run

        def grads(fn):
            def run(*a):
                g = fn(*a)
                self.steps[-1]["grads"] = g
                return g
            return run

        def forward(fn):
            def run(*a, k_cand=1, **k):
                out = fn(*a, k_cand=k_cand, **k)
                if k_cand > 1 and self.steps and "forward" not in self.steps[-1]:
                    self.steps[-1]["forward"] = dict(zip(("cfg", "scene", "o", "d", "seed"), a),
                                                     k_cand=k_cand, L=out[0], escaped=out[1])
                return out
            return run

        for mod, name, wrap in ((self.loop, "_make_step", make_step),
                                (self.loop, "sample_batch_pixels", timed),
                                (self.loop, "gather_ref_values", timed),
                                (self.loop, "adam_step", in_step),
                                (self.loop, "enforce_valid_params", in_step),
                                (vs, "adjoint_walk_kernel", adjoint_walk),
                                (vs, "drt_backward_kernel", drt),
                                (vs, "sample_adjoint_kernel", grads),
                                (vs, "sample_primal_kernel", forward)):
            self.saved[(mod, name)] = getattr(mod, name)
            setattr(mod, name, wrap(getattr(mod, name)))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)
        self.vs.TIMINGS = None


def step_parts(rec):
    """A recorded step's parts (ms): consecutive spans of the device's
    timeline between its CUDA events, which add up to the step, and each
    backward kernel's own launch."""
    def ms(a, b):
        return a.elapsed_time(b)
    L = rec["launches"]
    i_adj = next(i for i, x in enumerate(L) if x[0] == "volpath_adjoint")
    prim = [x for x in L[:i_adj] if x[0] == "volpath_primal"]
    fwd, replay = prim[:-1], prim[-1]
    one = {x[0]: x for x in L[i_adj:] if x[0] in ADJ_KERNELS}
    last = max(one.values(), key=L.index)
    k_fwd = sum(ms(s, e) for _, s, e in fwd)
    kern = {k: ms(s, e) for k, (_, s, e) in one.items()}
    return {"pixels": sum(ms(s, e) for _, s, e in rec["pre"]),
            "forward_kernels": k_fwd, "forward_launches": len(fwd),
            "forward_rays_mean": ms(rec["start"], fwd[-1][2]) - k_fwd,
            "loss_adjoint_rays": ms(fwd[-1][2], replay[1]),
            "replay": ms(replay[1], replay[2]), **kern,
            "backward_other": ms(replay[2], last[2]) - sum(kern.values()),
            "grads_adam_projection": ms(last[2], rec["end"]),
            "step": ms(rec["start"], rec["end"])}


class Laps:
    """Host-clock stamps (with a device sync on either side) of calls of
    ``module.<name>``, for the plain twin's parts."""

    def __init__(self, module, names):
        self.module, self.names, self.stamps, self.saved = module, names, {}, {}

    def __enter__(self):
        import torch

        def wrap(name, fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                self.stamps[name] = (t0, time.perf_counter())
                return out
            return run
        for name in self.names:
            self.saved[name] = getattr(self.module, name)
            setattr(self.module, name, wrap(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def phase_adjoint(card, dev, vs, janga, dust, cube, rays_of):
    """The adjoint walk (after one replay primal each): the kernel with K6
    on against K6 off on the same inputs (draws and reservoir depth equal on
    every lane, gradients within a relative L1 of 1e-4, the atomics' order
    aside), and against the twin where ``need`` is given.  The twins run
    after every kernel time is taken, two at a time (run_twins)."""
    import torch
    from uivr_tpu_torch.config import get_int_config
    rs = np.random.RandomState(20261017)
    runs = [("janga-smoke", janga, "volpathsimple-drt", {}, 8192, 0.90),
            ("janga-smoke", janga, "volpathsimple-basic", {"shadow_rr": 0.05}, 8192, 0.90),
            ("dust-devil", dust, "volpathsimple-drt", {}, 8192, None),
            ("tiny-cube", cube, "volpathsimple-drt", {}, 16384, 0.95),
            ("tiny-cube", cube, "volpathsimple-drt", {"use_nee": False}, 16384, 0.95)]
    checked = []
    for name, (preset, b, sc), integ, kw, n, need in runs:
        cfg = dataclasses.replace(get_int_config(integ).create(max_depth=preset.max_depth), **kw)
        off = no_cls(sc)
        o, d = rays_of(b, n)
        dL = torch.from_numpy(rs.rand(n, 3).astype(np.float32) / n).to(dev)
        seed = 4242
        Lk, _ = vs.sample_primal_kernel(cfg, sc, o, d, seed)
        acc_k, res_k, st_k = vs.adjoint_walk_kernel(cfg, sc, o, d, seed, dL, Lk)
        acc_o, res_o, st_o = vs.adjoint_walk_kernel(cfg, off, o, d, seed, dL, Lk)
        torch.cuda.synchronize()
        k_ms, off_ms = on_off_ms(lambda: vs.adjoint_walk_kernel(cfg, sc, o, d, seed, dL, Lk),
                                 lambda: vs.adjoint_walk_kernel(cfg, off, o, d, seed, dL, Lk), 1)
        on_off = {k: equal_frac(st_k[k], st_o[k]) for k in ("dim", "alt_dim", "steps")}
        on_off["reservoir_depth"] = equal_frac(res_k.depth, res_o.depth)
        on_off_rel = {"sigma": rel_l1(acc_k.sigma, acc_o.sigma),
                      "albedo": rel_l1(acc_k.albedo, acc_o.albedo)}
        rec = {"phase": "adjoint", "scene": name, "integrator": integ, **kw, "rays": n,
               "cls_on_off_agreement": on_off, "cls_on_off_rel_l1": on_off_rel,
               "cls": cls_counts(st_k["cls"]), "kernel_ms": k_ms, "kernel_ms_cls_off": off_ms,
               "events": int(st_k["steps"].sum()), "card": card}
        bad = min(on_off.values()) < 1.0 or max(on_off_rel.values()) > 1e-4
        checked.append((name, integ, kw, need, rec, bad, acc_k, res_k, st_k,
                        (cfg, sc, o, d, seed, dL)))
    twins = iter(run_twins([("adjoint_twin", (0, 1, 2), args, {})
                            for *_, need, _, _, _, _, _, args in checked if need is not None]))
    for name, integ, kw, need, rec, bad, acc_k, res_k, st_k, _ in checked:
        if need is not None:
            (acc_t, res_t, st_t), plain_ms = next(twins)
            agree = {"dim": equal_frac(st_k["dim"], st_t["dim"]),
                     "alt_dim": equal_frac(st_k["alt_dim"], st_t["alt_dim"]),
                     "reservoir_depth": equal_frac(res_k.depth, res_t.depth)}
            rel = {"sigma": rel_l1(acc_k.sigma, acc_t.sigma),
                   "albedo": rel_l1(acc_k.albedo, acc_t.albedo)}
            rec.update({"agreement": agree, "need": need, "rel_l1": rel,
                        "max_abs_err": max(float((acc_k.sigma - acc_t.sigma).abs().max()),
                                           float((acc_k.albedo - acc_t.albedo).abs().max())),
                        "grad_abs_sum": float(acc_t.sigma.abs().sum()),
                        "plain_ms": plain_ms})
            bad = bad or min(agree.values()) < need or max(rel.values()) > 1e-2 \
                or not rec["grad_abs_sum"] > 0
        emit(rec)
        if bad:
            raise RuntimeError(f"adjoint {name} {integ} {kw}: the kernel disagrees with "
                               "itself without K6 or with the twin")


# The plain twins run in worker processes (spawn, each its own CUDA
# context) while this process runs other untimed work: the twins are bound
# by host time per op, so processes on cores of their own take about the
# time of the longest.  run_twins keeps to one worker and this process;
# phase 9c runs every check_step's twins and its own seeds on all
# TWIN_WORKERS.  Arguments and results
# cross as torch.save bytes (CUDA tensors arrive on the card), not through
# shared memory.
TWIN_WORKERS = 5
_TWIN_POOL = []


def twin_pool():
    """The workers (each started on first need)."""
    if not _TWIN_POOL:
        import concurrent.futures
        import multiprocessing
        _TWIN_POOL.append(concurrent.futures.ProcessPoolExecutor(
            max_workers=TWIN_WORKERS, mp_context=multiprocessing.get_context("spawn")))
    return _TWIN_POOL[0]


def close_twin_pool():
    """Stop the workers, if any was started."""
    while _TWIN_POOL:
        _TWIN_POOL.pop().shutdown(wait=True, cancel_futures=True)


def _dumps(obj):
    import io

    import torch
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _loads(data):
    import io

    import torch
    return torch.load(io.BytesIO(data), weights_only=False)


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def adjoint_twin(cfg, sc, o, d, seed, dL, deferred=True):
    """Phase 6's twin: the twin's replay primal, then its adjoint walk from
    that radiance: (accumulator, reservoir, stats)."""
    from uivr_tpu_torch.integrators import volpath_flat
    Lt, _ = volpath_flat.sample_primal(cfg, sc, o, d, seed, deferred=deferred,
                                       max_iters=cfg.max_steps)
    return volpath_flat.adjoint_walk(cfg, sc, o, d, seed, dL, Lt, deferred=deferred)


def _twin_fn(name):
    """Twin ``name``: a ``volpath_flat`` entry point, adjoint_twin or
    (``drt_twin``) _check_drt_twin."""
    from uivr_tpu_torch.integrators import volpath_flat
    own = {"adjoint_twin": adjoint_twin, "drt_twin": _check_drt_twin}
    return own[name] if name in own else getattr(volpath_flat, name)


def _twin_job(name, payload, keep):
    """In a worker: twin ``name`` on ``payload``'s (args, kw) under
    inference mode; returns the bytes of the items ``keep`` of its result
    and its milliseconds."""
    import torch
    args, kw = _loads(payload)
    _sync()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = _twin_fn(name)(*args, **kw)
    _sync()
    ms = (time.perf_counter() - t0) * 1e3
    return _dumps(tuple(out[i] for i in keep)), ms


def _twin_jobs(jobs):
    """In a worker: :func:`_twin_job` on each of ``jobs`` in turn."""
    return [_twin_job(*job) for job in jobs]


def _twin_warm():
    import torch

    from uivr_tpu_torch.integrators import volpath_flat  # noqa: F401
    if torch.cuda.is_available():
        torch.cuda.init()


def submit_twin(name, keep, *args, **kw):
    """Run twin ``name`` in a worker: a future of (its result's items
    ``keep``, ms)."""
    return twin_pool().submit(_twin_job, name, _dumps((args, kw)), keep)


def twin_result(fut):
    data, ms = fut.result()
    return _loads(data), ms


def run_twins(jobs):
    """Twin jobs ``(name, keep, args, kw)``, two at a time: every other one
    in one worker, in turn, the rest here meanwhile.  Returns ``(the items
    keep of its result, ms)`` for each, in order.  Nothing may be timed on
    the card while this runs: the worker's launches share it."""
    import torch
    odd = [i for i in range(len(jobs)) if i % 2 == 1]
    fut = twin_pool().submit(_twin_jobs, [(jobs[i][0], _dumps((jobs[i][2], jobs[i][3])),
                                           jobs[i][1]) for i in odd])
    out = {}
    for i, (name, keep, args, kw) in enumerate(jobs):
        if i in odd:
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            res = _twin_fn(name)(*args, **kw)
        torch.cuda.synchronize()
        out[i] = (tuple(res[k] for k in keep), (time.perf_counter() - t0) * 1e3)
    out.update({i: (_loads(data), ms) for i, (data, ms) in zip(odd, fut.result())})
    return [out[i] for i in range(len(jobs))]


def _check_drt_twin(cfg, sc, dr):
    """``_drt_backward_flat`` on a step's reservoirs, its parts timed:
    (accumulator, stats, ms by kernel, total ms)."""
    import torch
    from uivr_tpu_torch.integrators import volpath_flat
    from uivr_tpu_torch.scene.gradients import init_accum
    acc_t = init_accum(sc.medium, need_emission=False)
    with Laps(volpath_flat, ("drt_distance", "_nee_primal", "sample_primal")) as laps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, p = volpath_flat._drt_backward_flat(cfg, sc, dr["seed"], dr["res"], dr["adjoint"],
                                               acc_t, return_stats=True, deferred=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    st = laps.stamps
    walk_end = st["drt_distance"][1]
    nee_end = st["_nee_primal"][1] if cfg.use_nee else walk_end
    ms = {"volpath_drt_walk": (walk_end - t0) * 1e3,
          "volpath_drt_nee": (nee_end - walk_end) * 1e3,
          "volpath_drt_phase": (st["sample_primal"][0] - nee_end) * 1e3,
          "volpath_primal_state": (st["sample_primal"][1] - st["sample_primal"][0]) * 1e3,
          "volpath_drt_scatter": (t1 - st["sample_primal"][1]) * 1e3}
    return acc_t, p, ms, (t1 - t0) * 1e3


def trips_summary(trips):
    """Max, p50, p90, p99, mean and sum of per-vertex trip counts."""
    import torch
    x = trips.to(torch.float64)
    if x.numel() == 0:
        return {"n": 0}
    q = torch.quantile(x, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                                       device=x.device)).tolist()
    return {"n": int(x.numel()), "max": int(x.max()), "p50": q[0], "p90": q[1], "p99": q[2],
            "mean": float(x.mean()), "sum": int(x.sum())}


def launch_turns(vs, run, turns):
    """CUDA-event times (ms) of the launches of ``run(x)`` for each x of
    ``turns`` (``volpath_step.TIMINGS``): per turn, {kernel: ms}."""
    import torch
    saved, vs.TIMINGS = vs.TIMINGS, []
    try:
        out = []
        for x in turns:
            start = len(vs.TIMINGS)
            run(x)
            out.append(vs.TIMINGS[start:])
        torch.cuda.synchronize()
        times = []
        for t in out:
            ms = {}
            for key, a, b in t:
                ms[key] = ms.get(key, 0.0) + a.elapsed_time(b)
            times.append(ms)
        return times
    finally:
        vs.TIMINGS = saved


def warp_iterations(steps, width=32):
    """Warp iterations of a one-ray-per-thread launch: the sum over groups
    of ``width`` consecutive rays of the group's longest walk."""
    import torch
    s = steps.to(torch.int64)
    g = torch.cat([s, s.new_zeros((-s.numel()) % width)]).reshape(-1, width)
    return int(g.max(dim=1).values.sum())


def drt_turns(vs, cfg, sc, seed, res, adjoint, measure=True):
    """The delayed DRT term on one step's reservoirs with the persistent
    walk and NEE kernels and with the one-thread-per-vertex ones they
    replaced (``direct``): the walk's outputs (DRT_WALK_OUT) and K_A, the
    NEE's nee, trips_b and K_B bit for bit; the walk's trips over the
    vertices that walk, the lane utilization of both walks (the direct one
    from its per-vertex trips, by warps and by blocks of 128), the
    persistent grid's lanes and the warp iterations of both walks (the
    persistent one's from its per-warp counters, the direct one's from
    its trips); with ``measure`` the walk's and the NEE's launches in
    DRT_TURN_ROUNDS rounds of turns (persistent, direct, direct,
    persistent), once while the two checked runs' outputs are held and
    once after they are released (``stats_released``: the later launches'
    buffers then lie elsewhere), and each walk's time per warp iteration
    of a resident warp (both walks hold 7 blocks of 128 threads a SM, the
    persistent grid's warps)."""
    import torch
    from uivr_tpu_torch.scene.gradients import init_accum

    def term(direct, stats=True):
        return vs.drt_backward_kernel(cfg, sc, seed, res, adjoint,
                                      init_accum(sc.medium, need_emission=False),
                                      return_stats=stats, direct=direct)
    (_, p), (_, d) = term(False), term(True)
    walk_eq = {f: torch.equal(p[f], d[f]) for f in DRT_WALK_OUT}
    walk_eq["K_A"] = p["k_a"] == d["k_a"]
    walk_eq["path_state_active"] = torch.equal(p["path_state"].active, d["path_state"].active)
    ta, util = p["trips_a"], p["walk_util"]
    walkers = int(res.active.sum())
    warps = int((util[:, 1] > 0).sum())
    lanes = 32 * warps
    iters = util[:warps, 1].to(torch.float64)
    walk = {"equal_to_direct": walk_eq, "K_A": p["k_a"], "walkers": walkers,
            "vertices": int((res.active & p["found"]).sum()),
            "trips": trips_summary(ta[res.active]),
            "utilization_direct": warp_utilization(ta),
            "utilization_direct_blocks": warp_utilization(ta, 128),
            "utilization_persistent": util_share(util), "grid_lanes": lanes,
            "reservoirs_per_lane": ta.numel() / max(lanes, 1),
            "walkers_per_lane": walkers / max(lanes, 1),
            "warp_iterations": {"direct": warp_iterations(ta), "persistent": int(iters.sum()),
                                "persistent_mean": float(iters.mean()),
                                "persistent_max": int(iters.max())}}
    nee = None
    if cfg.use_nee:
        nee_eq = {"nee": torch.equal(p["nee"], d["nee"]),
                  "trips_b": torch.equal(p["trips_b"], d["trips_b"]), "K_B": p["k_b"] == d["k_b"]}
        nee = {"equal_to_direct": nee_eq, "K_B": p["k_b"], "walks": int((p["trips_b"] > 0).sum()),
               "trips": int(p["trips_b"].sum())}
    if measure:
        order = (False, True, True, False) * DRT_TURN_ROUNDS

        def turns():
            times = launch_turns(vs, lambda x: term(x, stats=False), order)
            out = {}
            for key in ("volpath_drt_walk", "volpath_drt_nee"):
                t = [ms.get(key, ms.get(key + "_direct")) for ms in times]
                if None in t:
                    continue
                per = [x for x, direct in zip(t, order) if not direct]
                dir_ = [x for x, direct in zip(t, order) if direct]
                out[key] = {"ms_persistent": float(np.mean(per)), "ms_direct": float(np.mean(dir_)),
                            "ms_persistent_median": float(np.median(per)),
                            "ms_direct_median": float(np.median(dir_)),
                            "rounds_persistent_slower": sum(
                                per[2 * r] + per[2 * r + 1] > dir_[2 * r] + dir_[2 * r + 1]
                                for r in range(DRT_TURN_ROUNDS)),
                            "rounds": DRT_TURN_ROUNDS, "turns_ms": t}
            return out
        alive = turns()
        del p, d, ta, util
        released = turns()
        for rec, key in ((walk, "volpath_drt_walk"), (nee, "volpath_drt_nee")):
            if rec is not None:
                rec.update(alive[key], stats_released=released[key])
        it = walk["warp_iterations"]
        walk["ns_per_warp_iteration"] = {
            "direct": walk["ms_direct"] * 1e6 * warps / max(it["direct"], 1),
            "persistent": walk["ms_persistent"] * 1e6 * warps / max(it["persistent"], 1)}
    if not all(walk_eq.values()) or (nee and not all(nee["equal_to_direct"].values())):
        raise RuntimeError(f"drt: the persistent walk or NEE differs from the direct one: "
                           f"{walk_eq}, {nee and nee['equal_to_direct']}")
    return walk, nee


# byte offsets of the persistent walk's work counter in a scratch buffer,
# at which drt_walk_causes times the walk
COUNTER_OFFSETS = tuple(range(0, 16384, 256))


def drt_walk_causes(vs, cfg, sc, seed, res, adjoint, lanes):
    """What the persistent DRT walk pays per warp iteration against the
    direct one, on one step's reservoirs: both walks on the vertices in
    order, in a random order (locality: the draws are keyed by the
    vertex, so these are other walks of the same distribution) and on the
    first ``lanes`` vertices only (the persistent grid's lanes: each lane
    walks one vertex in both kernels, in the same warps, so nothing is
    refilled and only the scheduler differs).  Per input and kernel: the
    warp iterations, the walk's ms (in two rounds of turns, forward and
    back) and its ns per warp iteration of a resident warp.  Then the
    persistent walk alone on the vertices in order, launched with its work
    counter at each of COUNTER_OFFSETS in a scratch buffer (two passes,
    forward and back; the addresses of the buffer and of K_A's counts
    beside them)."""
    import ctypes
    import torch
    from uivr_tpu_torch.scene.gradients import init_accum
    perm = torch.randperm(res.o_l.shape[0], generator=torch.Generator().manual_seed(seed))
    perm = perm.to(res.o_l.device)
    inputs = {"ordered": (res, adjoint),
              "shuffled": (type(res)(*[f[perm] for f in res]), adjoint[perm].contiguous()),
              "one_per_lane": (type(res)(*[f[:lanes] for f in res]), adjoint[:lanes])}

    def term(x, stats=False):
        r, adj = inputs[x[0]]
        return vs.drt_backward_kernel(cfg, sc, seed, r, adj,
                                      init_accum(sc.medium, need_emission=False),
                                      return_stats=stats, direct=x[1] == "direct")
    configs = [(k, kind) for k in inputs for kind in ("direct", "persistent")]
    iters = {}
    for c in configs:
        st = term(c, stats=True)[1]
        iters[c] = warp_iterations(st["trips_a"]) if c[1] == "direct" else \
            int(st["walk_util"][:, 1].sum())
    order = (configs + configs[::-1]) * 2
    times = launch_turns(vs, term, order)
    out = {}
    for c in configs:
        t = [ms.get("volpath_drt_walk", ms.get("volpath_drt_walk_direct"))
             for ms, x in zip(times, order) if x == c]
        ms = float(np.mean(t))
        out.setdefault(c[0], {})[c[1]] = {
            "ms": ms, "turns_ms": t, "warp_iterations": iters[c],
            "ns_per_warp_iteration": ms * 1e6 * (lanes // 32) / max(iters[c], 1)}
    lib, dev = vs._load("drt"), res.o_l.device
    D = vs.drt_params(cfg, sc, seed, res, adjoint, init_accum(sc.medium, need_emission=False))[0]
    buf = torch.zeros(COUNTER_OFFSETS[-1] // 8 + 1, dtype=torch.int64, device=dev)
    stream = vs._stream(dev)

    def walk(off):
        rc = lib.volpath_drt_launch(ctypes.byref(D), 0, int(cfg.use_drt_mis),
                                    buf.data_ptr() + off, None, stream)
        if rc != 0:
            raise RuntimeError(f"drt_walk_causes: the walk's launch failed ({rc})")
    walk(0)
    marks = []
    for off in COUNTER_OFFSETS + COUNTER_OFFSETS[::-1]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        walk(off)
        ev[1].record()
        marks.append((off, ev))
    torch.cuda.synchronize()
    by_off = {}
    for off, (a, b) in marks:
        by_off.setdefault(off, []).append(a.elapsed_time(b))
    ms = [float(np.mean(by_off[off])) for off in COUNTER_OFFSETS]
    out["counter_placement"] = {"offsets": list(COUNTER_OFFSETS), "ms": ms, "min": min(ms),
                                "median": float(np.median(ms)), "max": max(ms),
                                "buffer_address": buf.data_ptr(), "counts_address": D.counts}
    return out


def check_step(card, vs, tag, step):
    """A recorded training step's kernels against the twins, at the shapes
    the step gave them: the adjoint call's per-lane primary draws, alt
    draws and reservoir depth on its last SLICE rays (the twin keyed by
    their ray ids), and ``drt_backward_kernel`` against
    ``_drt_backward_flat`` on all of the step's reservoirs (the twin's
    global-counter sampler admits no subset).  The DRT walks' times are
    taken here; the rest waits: the pending check is returned for phase
    9c, which runs its three twins (the adjoint slice's replay primal and
    adjoint walk, and the DRT term) in the twins' workers
    (``submit_check``) and the DRT kernel in this process
    (``finish_check``), beside its other untimed work."""
    a, dr = step["adjoint"], step["drt"]
    walk, nee = drt_turns(vs, a["cfg"], a["scene"], dr["seed"], dr["res"], dr["adjoint"])
    walk["causes"] = drt_walk_causes(vs, a["cfg"], a["scene"], dr["seed"], dr["res"],
                                     dr["adjoint"], walk["grid_lanes"])
    return {"card": card, "tag": tag, "step": step, "walk": walk, "nee": nee}


def submit_check(pending):
    """The twins of a pending check, submitted to the twins' workers,
    longest first: futures of the adjoint slice's walk, the DRT term and
    the slice's replay primal."""
    a, dr = pending["step"]["adjoint"], pending["step"]["drt"]
    cfg, sc = a["cfg"], a["scene"]
    n = a["o"].shape[0]
    sl = slice(n - SLICE, n)
    o, d = a["o"][sl].clone(), a["d"][sl].clone()   # a view would carry all of its storage
    return (submit_twin("adjoint_walk", (1, 2), cfg, sc, o, d, a["seed"], a["dL"][sl].clone(),
                        a["L"][sl].clone(), lane0=n - SLICE, deferred=True),
            submit_twin("drt_twin", (0, 1, 2, 3), cfg, sc, dr),
            submit_twin("sample_primal", (0,), cfg, sc, o, d, a["seed"], lane0=n - SLICE,
                        deferred=True, max_iters=cfg.max_steps))


def finish_check(vs, pending, futures):
    """``drt_backward_kernel`` on a pending check's reservoirs, then its
    twins' results (``submit_check``'s futures): the ``adjoint_step`` and
    ``drt`` records and their checks."""
    import torch
    from uivr_tpu_torch.scene.gradients import init_accum
    card, tag, step = pending["card"], pending["tag"], pending["step"]
    a, dr = step["adjoint"], step["drt"]
    cfg, sc = a["cfg"], a["scene"]
    n = a["o"].shape[0]
    sl = slice(n - SLICE, n)
    m = sc.medium
    acc_k, k = vs.drt_backward_kernel(cfg, sc, dr["seed"], dr["res"], dr["adjoint"],
                                      init_accum(m, need_emission=False), return_stats=True)
    adj_twin, drt_twin, primal_twin = futures
    (Lt,), primal_plain_ms = twin_result(primal_twin)
    drt_twin = twin_result(drt_twin)[0]
    (res_t, st_t), adj_plain_ms = twin_result(adj_twin)
    adj_agree = {"replay_L": lane_agreement(a["L"][sl], Lt),
                 "dim": equal_frac(a["stats"]["dim"][sl], st_t["dim"]),
                 "alt_dim": equal_frac(a["stats"]["alt_dim"][sl], st_t["alt_dim"]),
                 "reservoir_depth": equal_frac(a["res"].depth[sl], res_t.depth)}
    adj_err = max(float((a["res"].wsum[sl] - res_t.wsum).abs().max()),
                  float((a["res"].cur_w[sl] - res_t.cur_w).abs().max()))
    g = step["grads"]
    adj_rec = {"phase": "adjoint_step", "step": tag, "adjoint_rays": n,
               "adjoint_slice": [n - SLICE, n], "adjoint_agreement": adj_agree,
               "need": 0.90, "adjoint_max_abs_err": adj_err, "adjoint_plain_ms": adj_plain_ms,
               "adjoint_primal_plain_ms": primal_plain_ms,
               "adjoint_cls": cls_counts(a["stats"]["cls"]),
               "grads_finite": bool(torch.isfinite(g.sigma_t).all()
                                    and torch.isfinite(g.albedo).all()),
               "grads_abs_sum": [float(g.sigma_t.abs().sum()), float(g.albedo.abs().sum())],
               "card": card}
    emit(adj_rec)
    if min(adj_agree.values()) < 0.90:
        raise RuntimeError(f"adjoint_step {tag}: volpath_adjoint disagrees with the twin")
    if not (adj_rec["grads_finite"] and min(adj_rec["grads_abs_sum"]) > 0):
        raise RuntimeError(f"adjoint_step {tag}: the step's gradients are not finite and nonzero")

    rec = {"phase": "drt", "step": tag, "reservoirs": n,
           "vertices": int((dr["res"].active & k["found"]).sum()),
           "K_A": k["k_a"], "K_B": k["k_b"], "recursive_cls": cls_counts(k["rec_stats"]["cls"]),
           "walk_persistent_vs_direct": pending["walk"],
           "nee_persistent_vs_direct": pending["nee"], "card": card}
    acc_t, p, drt_plain_ms, drt_plain_total_ms = drt_twin
    both = k["path_state"].active & p["path_state"].active
    agree = {f: equal_frac(k[f], p[f]) for f in ("t_sel", "wsum", "found")}
    agree["path_state_active"] = equal_frac(k["path_state"].active, p["path_state"].active)
    agree["recursive_L"] = lane_agreement(k["rec_L"][both], p["rec_L"][both])
    rel = {"sigma": rel_l1(acc_k.sigma, acc_t.sigma), "albedo": rel_l1(acc_k.albedo, acc_t.albedo)}
    rec.update({
        "K_A_plain": int(p["k_a"]), "K_B_plain": int(p["k_b"]),
        "drt_agreement": agree, "need": 0.90, "drt_rel_l1": rel,
        "drt_max_abs_err": {
            "volpath_drt_walk": float((k["wsum"] - p["wsum"]).abs().max()),
            "volpath_drt_nee": float((k["nee"][both] - p["nee"][both]).abs().max()),
            "volpath_drt_phase": float((k["path_state"].d_w[both]
                                        - p["path_state"].d_w[both]).abs().max()),
            "volpath_primal_state": float((k["rec_L"][both] - p["rec_L"][both]).abs().max()),
            "volpath_drt_scatter": max(float((acc_k.sigma - acc_t.sigma).abs().max()),
                                       float((acc_k.albedo - acc_t.albedo).abs().max()))},
        "drt_plain_ms": drt_plain_ms, "drt_plain_total_ms": drt_plain_total_ms})
    emit(rec)
    if min(agree.values()) < 0.90 or [k["k_a"], k["k_b"]] != [int(p["k_a"]), int(p["k_b"])] \
            or max(rel.values()) > 1e-2 or not float(acc_t.sigma.abs().sum()) > 0:
        raise RuntimeError(f"drt {tag}: the DRT kernels disagree with the twin")
    return dict(adj_rec, **rec, drt_stats=k)


def phase_train(card, vs, scene, out_dir, n_iter, ref_spp, opt_kw=None, checkpoints=True,
                ref_bundle=None, need=(), k_cand=None, ab=(), trace=False):
    """run_optimization of volpathsimple-drt at the preset's full width
    (batch 32,768 pixels, 16 adjoint spp, primal factor 64), ``n_iter``
    iterations from the constant start with the grids at full resolution
    (no upsampling), then one step of it from the ground-truth grids; both
    recorded by StepRecorder.  The counters are set to 0 just before the
    main run: every training kernel, K6 and the counters ``need`` name must
    launch, no twin may run, the parameters must change (and with
    ``checkpoints`` the .vol files read back).  The references are
    rendered from ``ref_bundle`` (the preset's reference scene) where it
    is given, else from the training bundle's grids, for the bundle's
    training sensors.  ``k_cand``: ``UIVR_KCAND`` for the whole phase (the
    renders read it, make_render once per run).  ``ab``: the steps ("truth",
    "start": the second iteration from the constant start) timed with the
    one-ray-per-thread kernels and the persistent ones in turns
    (step_turns); ``trace``: one more truth step under the profiler
    (trace_step)."""
    import os
    args = (card, vs, scene, out_dir, n_iter, ref_spp, opt_kw, checkpoints, ref_bundle, need,
            ab, trace)
    if k_cand is None:
        return _phase_train(*args)
    os.environ["UIVR_KCAND"] = str(k_cand)
    try:
        return _phase_train(*args)
    finally:
        del os.environ["UIVR_KCAND"]


def step_turns(vs, loop, run, idx, k7_only=False):
    """CUDA-event time (ms) of step ``idx`` of ``run()`` (a run_optimization)
    with the one-ray-per-thread kernels and with the persistent ones in
    turns (direct, persistent, persistent, direct); each run must have
    launched only the walking kernels of its kind.  ``k7_only``: only the
    K7 launches change kind (a step under UIVR_KCAND > 1)."""
    import contextlib
    direct_kinds = ("volpath_primal_direct", "volpath_adjoint_direct", "volpath_drt_walk_direct",
                    "volpath_primal_state_direct")
    persistent_kinds = ("volpath_primal", "volpath_adjoint", "volpath_drt_walk",
                        "volpath_primal_state")
    walking = ("volpath_primal_k_direct", "k_candidate") if k7_only else (
        direct_kinds + persistent_kinds)
    t, counts = [], []
    for direct in (True, False, False, True):
        with (Direct(vs, k7_only) if direct else contextlib.nullcontext()), \
                StepRecorder(vs, loop) as r:
            run()
        st = r.steps[idx]
        t.append(st["start"].elapsed_time(st["end"]))
        c = st["counts"]
        counts.append(c)
        if k7_only:    # a direct K7 launch counts as a K7 launch too
            kinds = [c["volpath_primal_k_direct"]] if direct else [c["k_candidate"]]
            others = [c["k_candidate"] - c["volpath_primal_k_direct"]] if direct else \
                [c["volpath_primal_k_direct"]]
        else:
            kinds = [c[k] for k in (direct_kinds if direct else persistent_kinds)]
            others = [c[k] for k in (persistent_kinds if direct else direct_kinds)]
        if min(kinds) == 0 or max(others) > 0:
            raise RuntimeError(f"step A/B: a {'direct' if direct else 'persistent'} step "
                               f"launched other kernels: {c}")
    return {"direct_ms": (t[0] + t[3]) / 2, "persistent_ms": (t[1] + t[2]) / 2, "turns_ms": t,
            "speedup": (t[0] + t[3]) / (t[1] + t[2]),
            "launches_direct": {k: counts[0][k] for k in walking},
            "launches_persistent": {k: counts[1][k] for k in walking}}


def trace_step(vs, loop, run):
    """One training step under the profiler (``utils/profiling.trace``),
    each kernel launch in a ``record_function`` range of its name: the
    device's busy and idle share over the step, its longest idle gaps, the
    kernels by device time, and the host calls that waited for the device
    between the forward's first and last launch."""
    import torch
    from uivr_tpu_torch.utils import profiling
    launch = vs._launch

    def ranged(key, *a, **k):
        with torch.profiler.record_function(key):
            return launch(key, *a, **k)
    vs._launch = ranged
    try:
        with StepRecorder(vs, loop) as r, profiling.trace() as prof:
            run()
    finally:
        vs._launch = launch
    step = profiling.host_ranges(prof, "train_step")
    fwd = profiling.host_ranges(prof, "volpath_primal")
    n_fwd = r.steps[0]["counts"]["volpath_primal"] - 1      # the last one is the replay
    rec = {"step_host_ms": (step[0][1] - step[0][0]) / 1e3 if step else None,
           "step_event_ms": r.steps[0]["start"].elapsed_time(r.steps[0]["end"]),
           **profiling.device_summary(prof, window=step[0] if step else None)}
    if len(fwd) > n_fwd > 1:
        lo, hi = fwd[0][0], fwd[n_fwd - 1][0]
        rec["forward_launches"] = n_fwd
        rec["syncs_between_forward_launches"] = profiling.syncs_between(prof, lo, hi)
        rec["forward_device"] = profiling.device_summary(prof, window=(lo, hi), top=3, n_gaps=3)
    if not rec["device_events"]:
        rec["note"] = "the trace holds no device time: key_averages() show none on this machine"
    return rec


def _phase_train(card, vs, scene, out_dir, n_iter, ref_spp, opt_kw, checkpoints, ref_bundle,
                 need, ab, trace):
    import os

    import torch
    from uivr_tpu_torch.config import get_int_config
    from uivr_tpu_torch.core import vol_io
    from uivr_tpu_torch.integrators import volpath_flat
    from uivr_tpu_torch.opt import OptimizationConfig, loop, render_references
    from uivr_tpu_torch.render import RenderSettings
    preset, b, _ = scene
    name = preset.name
    cfg = get_int_config("volpathsimple-drt").create(max_depth=preset.max_depth)
    out_dir = out_dir / name
    t0 = time.perf_counter()
    rb = ref_bundle or b
    refs = render_references(rb, RenderSettings(integrator=cfg, medium=rb.medium_cfg,
                                                film_size=rb.film_size, spp=ref_spp,
                                                spp_grad=ref_spp),
                             str(out_dir / "references"), spp=ref_spp, overwrite=True,
                             sensors=list(b.sensors) if b.sensors else None)
    ref_s = time.perf_counter() - t0
    width = dict(spp=16, lr=5e-3, primal_spp_factor=64, batch_size=32768, upsample=None,
                 preview_spp=16)
    width.update(opt_kw or {})
    opt = OptimizationConfig(name=f"{name}/volpathsimple-drt", n_iter=n_iter,
                             preview_stride=0, checkpoint_stride=2 if checkpoints else 0,
                             checkpoint_initial=checkpoints, checkpoint_final=checkpoints,
                             render_initial=False, **width)
    for k in vs.LAUNCHES:
        vs.LAUNCHES[k] = 0
    for k in volpath_flat.CALLS:
        volpath_flat.CALLS[k] = 0
    with StepRecorder(vs, loop) as main:
        t0 = time.perf_counter()
        final = loop.run_optimization(str(out_dir / "train"), opt, b, cfg, ref_images=refs,
                                      resume=False, verbose=False)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = dict(vs.LAUNCHES)
    plain_calls = dict(volpath_flat.CALLS)
    # one step from the ground-truth grids: walks as long as late in a run
    one = OptimizationConfig(name=f"{name}/truth", n_iter=1, preview_stride=0,
                             checkpoint_stride=0, checkpoint_initial=False,
                             checkpoint_final=False, render_initial=False,
                             render_final=False, **width)
    with StepRecorder(vs, loop) as truth:
        loop.run_optimization(str(out_dir / "truth"), one, b, cfg, ref_images=refs,
                              start_params=b.params, resume=False, verbose=False)

    def run_truth():
        loop.run_optimization(str(out_dir / "ab"), one, b, cfg, ref_images=refs,
                              start_params=b.params, resume=False, verbose=False)
    turns = {}
    if "truth" in ab:
        turns["truth"] = step_turns(vs, loop, run_truth, 0)
    if "truth_k7" in ab:
        turns["truth_k7"] = step_turns(vs, loop, run_truth, 0, k7_only=True)
    if "start" in ab:
        two = dataclasses.replace(one, name=f"{name}/ab-start", n_iter=2)
        turns["start"] = step_turns(vs, loop, lambda: loop.run_optimization(
            str(out_dir / "ab-start"), two, b, cfg, ref_images=refs, resume=False,
            verbose=False), 1)
    traced = trace_step(vs, loop, run_truth) if trace else None
    vols = {}
    if checkpoints:
        for tag, grids in (("initial", b.start_from), ("final", final)):
            for key in ("sigma_t", "albedo"):
                data, _ = vol_io.read_vol(str(out_dir / "train" / "params"
                                              / f"{tag}-medium1_{key}.vol"))
                vols[f"{tag}_{key}"] = bool(np.array_equal(data, getattr(grids, key).cpu().numpy()))
    changed = {k: not torch.equal(getattr(final, k), getattr(b.start_from, k))
               for k in ("sigma_t", "albedo")}
    steps = [{"seconds": s["seconds"], "loss": s["loss"], "launches": s["counts"],
              "parts_ms": step_parts(s)} for s in main.steps + truth.steps]
    rec = {"phase": "train", "scene": name, "integrator": "volpathsimple-drt",
           "k_cand": int(os.environ.get("UIVR_KCAND", 1)),
           "batch": 32768, "spp_primal": 1024, "spp_grad": 16,
           "grid": list(b.params.sigma_t.shape), "sensors": b.cameras.n_sensors,
           "lr": opt.lr, "lr_factors": opt.lr_factors,
           "ref_spp": ref_spp, "references_s": ref_s, "run_s": run_s,
           "iterations": steps[:-1], "truth_step": steps[-1],
           "truth_adjoint_cls": cls_counts(truth.steps[0]["adjoint"]["stats"]["cls"]),
           "launches": launches, "plain_twin_calls": plain_calls,
           "checkpoints_read_back": vols, "params_changed": changed,
           "step_turns": turns, "card": card}
    emit(rec)
    if traced is not None:
        emit({"phase": "trace", "scene": name, "step": "truth", **traced, "card": card})
        rec["trace"] = traced
    missing = [k for k in TRAIN_KERNELS + ("subcell_classification",) + tuple(need)
               if not launches[k] > 0]
    if missing or any(plain_calls.values()):
        raise RuntimeError(f"{name}: training did not run through the kernels: missing "
                           f"{missing}, plain twin calls {plain_calls}")
    if not (all(changed.values()) and all(vols.values()) and len(main.steps) == n_iter
            and all(math.isfinite(s_["loss"]) for s_ in steps)):
        raise RuntimeError(f"{name}: training step checks failed")
    return rec, main.steps[0], truth.steps[0]


def phase_fd(card, vs, out_dir):
    """``python -m uivr_tpu_torch.cli.fd`` on tiny-cube (spp 1024, res 16,
    all three grids) under volpathsimple-drt and volpathsimple-basic, with
    K6 on and off (``--cls-cells 0``): each run launches the kernels and no
    twin; off writes the same FD values and adjoint gradients."""
    import torch
    from uivr_tpu_torch.cli import fd as cli_fd
    from uivr_tpu_torch.integrators import volpath_flat
    keys = ("sigma_t", "albedo", "emission")
    out = {}
    for integ in ("volpathsimple-drt", "volpathsimple-basic"):
        runs = {}
        for tag, extra in (("on", []), ("off", ["--cls-cells", "0"])):
            d = out_dir / "fd" / integ / tag
            for k in vs.LAUNCHES:
                vs.LAUNCHES[k] = 0
            for k in volpath_flat.CALLS:
                volpath_flat.CALLS[k] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = cli_fd.main(["--scene", "tiny-cube", "--integrator", integ,
                                   "--spp", "1024", "--res", "16", "--out", str(d)] + extra)
            torch.cuda.synchronize()
            runs[tag] = {"seconds": time.perf_counter() - t0, "summary": summary,
                         "launches": {k: v for k, v in vs.LAUNCHES.items() if v},
                         "plain_twin_calls": dict(volpath_flat.CALLS),
                         "fd": {k: np.load(d / f"fd_{k}.npy") for k in keys},
                         "adjoint": {k: np.load(d / f"adjoint_{k}.npy") for k in keys}}
        on, off = runs["on"], runs["off"]

        def rel(a, b):
            return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))
        rec = {"phase": "fd", "scene": "tiny-cube", "integrator": integ, "spp": 1024,
               "res": 16, "keys": list(keys),
               "summary": on["summary"], "summary_cls_off": off["summary"],
               "fd_equal_cls_off": all(np.array_equal(on["fd"][k], off["fd"][k]) for k in keys),
               "fd_rel_l1_cls_off": {k: rel(on["fd"][k], off["fd"][k]) for k in keys},
               "adjoint_rel_l1_cls_off": {k: rel(on["adjoint"][k], off["adjoint"][k])
                                          for k in keys},
               "seconds": {t: r["seconds"] for t, r in runs.items()},
               "launches": {t: r["launches"] for t, r in runs.items()},
               "plain_twin_calls": {t: r["plain_twin_calls"] for t, r in runs.items()},
               "card": card}
        emit(rec)
        need = ["volpath_primal", "volpath_adjoint"]
        if integ == "volpathsimple-drt":
            need += list(ADJ_KERNELS)
        ok = all(r["launches"].get(k, 0) > 0 for r in runs.values() for k in need)
        ok = ok and on["launches"].get("subcell_classification", 0) > 0 \
            and "subcell_classification" not in off["launches"]
        ok = ok and not any(v for r in runs.values() for v in r["plain_twin_calls"].values())
        ok = ok and max(rec["fd_rel_l1_cls_off"].values()) <= 1e-4 \
            and max(rec["adjoint_rel_l1_cls_off"].values()) <= 1e-4
        ok = ok and all(math.isfinite(v) for s_ in on["summary"].values() for v in s_.values())
        if not ok:
            raise RuntimeError(f"fd {integ}: the FD entry point failed its checks")
        out[integ] = rec
    # the NeRF stage's gradients against FD (no K6: the march reads no table)
    from uivr_tpu_torch.integrators import nerf
    d = out_dir / "fd" / "nerf"
    for k in vs.LAUNCHES:
        vs.LAUNCHES[k] = 0
    for k in nerf.CALLS:
        nerf.CALLS[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = cli_fd.main(["--scene", "tiny-cube", "--integrator", "nerf", "--spp", "1024",
                           "--res", "16", "--keys", "sigma_t", "emission", "--out", str(d)])
    torch.cuda.synchronize()
    rec = {"phase": "fd", "scene": "tiny-cube", "integrator": "nerf", "spp": 1024, "res": 16,
           "keys": ["sigma_t", "emission"], "summary": summary,
           "seconds": time.perf_counter() - t0,
           "launches": {k: v for k, v in vs.LAUNCHES.items() if v},
           "plain_calls": dict(nerf.CALLS), "card": card}
    emit(rec)
    if not (rec["launches"].get("nerf_primal", 0) > 0 and rec["launches"].get("nerf_adjoint", 0) > 0
            and not any(rec["plain_calls"].values())
            and all(summary[k]["corr"] >= 0.9 for k in ("sigma_t", "emission"))):
        raise RuntimeError(f"fd nerf: the FD entry point failed its checks: {rec}")
    out["nerf"] = rec
    return out


def phase_cli(card, out_dir):
    """The reproduce CLI on tiny-cube with its default stages, ``nerf`` then
    ``volpathsimple-drt`` (20 iterations at batch 557 each)."""
    import json as json_
    from uivr_tpu_torch.cli import reproduce
    outputs = out_dir / "cli"
    if outputs.exists():
        import shutil
        shutil.rmtree(outputs)
    t0 = time.perf_counter()
    reproduce.main(["--config", "tiny-cube", "--scale", "0.034", "--ref-spp", "16",
                    "--outputs", str(outputs)])
    dt = time.perf_counter() - t0
    stages = {}
    for stage in ("nerf", "volpathsimple-drt"):
        run = outputs / "tiny-cube" / stage
        with open(run / "metrics.jsonl") as f:
            recs = [json_.loads(ln) for ln in f]
        stages[stage] = {"losses": [r["loss"] for r in recs if "loss" in r],
                         "final_checkpoint": (run / "params" /
                                              "final-medium1_sigma_t.vol").exists()}
    rec = {"phase": "cli", "command": "reproduce --config tiny-cube --scale 0.034 "
           "--ref-spp 16", "seconds": dt, "stages": stages, "card": card}
    emit(rec)
    if not all(s_["losses"] and all(math.isfinite(x) for x in s_["losses"])
               and s_["final_checkpoint"] for s_ in stages.values()):
        raise RuntimeError("cli: a stage has no losses or no final checkpoint")


class NerfCalls:
    """Records the calls of the NeRF wrappers (``ops/nerf_step``) within:
    each call's kind, its grid shape and, with ``keep``, its inputs and
    outputs."""

    def __init__(self, nerf_step, keep=False):
        self.mod, self.keep, self.calls, self.saved = nerf_step, keep, [], {}

    def __enter__(self):
        for name in ("sample_primal_kernel", "sample_adjoint_kernel"):
            fn = getattr(self.mod, name)

            def run(cfg, scene, o, d, seed, *rest, _fn=fn, _name=name):
                out = _fn(cfg, scene, o, d, seed, *rest)
                rec = {"kind": _name, "grid": tuple(scene.medium.params.sigma_t.shape[:3])}
                if self.keep:
                    rec.update(cfg=cfg, scene=scene, o=o, d=d, seed=seed, rest=rest, out=out)
                self.calls.append(rec)
                return out
            self.saved[name] = fn
            setattr(self.mod, name, run)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)


def nerf_step_parts(rec):
    """A recorded NeRF step's parts (ms), consecutive spans of the device's
    timeline between its CUDA events."""
    def ms(a, b):
        return a.elapsed_time(b)
    L = rec["launches"]
    prim = [x for x in L if x[0] == "nerf_primal"]
    fwd, replay = prim[0], prim[-1]
    adj = next(x for x in L if x[0] == "nerf_adjoint")
    ops = {name: (s, e) for name, s, e in rec["ops"]}
    adam, proj = ops["adam_step"], ops["enforce_valid_params"]
    return {"pixels": sum(ms(s, e) for _, s, e in rec["pre"]),
            "forward_rays_grid": ms(rec["start"], fwd[1]), "forward": ms(fwd[1], fwd[2]),
            "loss_adjoint_rays": ms(fwd[2], replay[1]), "replay": ms(replay[1], replay[2]),
            "adjoint_grids": ms(replay[2], adj[1]), "adjoint": ms(adj[1], adj[2]),
            "gradients": ms(adj[2], adam[0]), "adam": ms(*adam),
            "adam_to_projection": ms(adam[1], proj[0]), "projection": ms(*proj),
            "rest": ms(proj[1], rec["end"]), "step": ms(rec["start"], rec["end"])}


def nerf_work(scene, o, d, steps, voxels=None):
    """(active rays, bytes the primal and the adjoint must move, their
    float and integer operations, bytes their steps fetch) for rays o, d;
    the grid's bytes are those of ``voxels`` voxels where given (the ones
    the march reads), else of the whole grid."""
    m, em = scene.medium, scene.emitter
    n = o.shape[0]
    active = int(nerf_active(scene, o, d).sum())
    grid = (m.params.sigma_t[..., 0].numel() if voxels is None else voxels) * 16
    env = em.data.numel() * 4 if hasattr(em, "data") else 0
    march = active * steps
    ints = wavefront_ops(n, n)
    return {"active": active,
            "nerf_primal": dict(bytes=24 * n + grid + env + 13 * n, ints=ints,
                                flops=NERF_FLOP_PER_STEP["nerf_primal"] * march
                                + NERF_FLOP_PER_RAY * n,
                                fetch=march * 128 + 37 * n),
            "nerf_adjoint": dict(bytes=48 * n + 2 * grid, ints=ints,
                                 flops=NERF_FLOP_PER_STEP["nerf_adjoint"] * march
                                 + NERF_FLOP_PER_RAY * n,
                                 fetch=march * 256 + 48 * n)}


class NerfShape:
    """The NeRF kernels at one shape through their launchers, on grids and
    parameter blocks made once: the forward rays' primal and the adjoint
    rays' adjoint (``L_in`` their replay, ``dL`` given), each through the
    main path's launcher or its one-ray-per-thread twin, the adjoint's
    global atomics (its counting builds) on request.  ``index64`` picks the
    march kernels' index type as the wrappers' keyword does; ``grid`` is
    the interleaved grid when the caller has made it."""

    def __init__(self, vs, nerf_step, cfg, scene, fwd, adj, dL, index64=None, grid=None):
        import ctypes

        import torch
        self.ctypes = ctypes
        self.lib = vs._load("nerf")
        (o, d, seed), (ao, ad, aseed) = fwd, adj
        dev = o.device
        self.grid = nerf_step.nerf_grid(scene.medium) if grid is None else grid
        self.stream = torch.cuda.current_stream().cuda_stream
        self.count = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.p, self.p_scratch = nerf_step.nerf_params(cfg, scene, o, d, seed, self.grid,
                                                       index64)
        self.L = torch.empty((o.shape[0], 3), dtype=torch.float32, device=dev)
        self.valid = torch.empty((o.shape[0],), dtype=torch.bool, device=dev)
        self.p.P.L, self.p.valid = self.L.data_ptr(), self.valid.data_ptr()
        self.a, self.a_scratch = nerf_step.nerf_params(cfg, scene, ao, ad, aseed, self.grid,
                                                       index64)
        self.L_in = torch.empty((ao.shape[0], 3), dtype=torch.float32, device=dev)
        valid_in = torch.empty((ao.shape[0],), dtype=torch.bool, device=dev)
        self.a.P.L, self.a.valid = self.L_in.data_ptr(), valid_in.data_ptr()
        self._check(self.lib.nerf_primal_launch(ctypes.byref(self.a), self.stream))
        self.a.P.L, self.a.valid = None, None
        self.dL = dL.contiguous()
        self.g = torch.zeros_like(self.grid)
        self.a.L_in, self.a.dL, self.a.g_grid = (self.L_in.data_ptr(), self.dL.data_ptr(),
                                                 self.g.data_ptr())
        self.n, self.n_adj = o.shape[0], ao.shape[0]

    @staticmethod
    def _check(rc):
        if rc != 0:
            raise RuntimeError(f"a NeRF kernel launch failed ({rc})")

    def primal(self, direct=False):
        name = "nerf_primal_direct_launch" if direct else "nerf_primal_launch"
        self._check(getattr(self.lib, name)(self.ctypes.byref(self.p), self.stream))

    def adjoint(self, direct=False, count=False, fresh=False):
        if fresh:
            self.g.zero_()
        if count:
            self.count.zero_()
            self.a.atomics = self.count.data_ptr()
        name = "nerf_adjoint_direct_launch" if direct else "nerf_adjoint_launch"
        rc = getattr(self.lib, name)(self.ctypes.byref(self.a), self.stream)
        self.a.atomics = None
        self._check(rc)


def nerf_active(scene, o, d):
    """(n,) bool: the rays that enter the medium's box."""
    from uivr_tpu_torch.scene.medium import intersect_bbox
    tn, tf, _, _, _ = intersect_bbox(scene.medium, o, d)
    return tf > tn


def l2_probe(lib, dev, voxels, rounds=16, reps=3):
    """Random float4 gathers and float4 atomicAdds over a buffer of each
    voxel count in ``voxels`` (``lib``: ``load_l2_probe``'s build of
    ``csrc/l2_probe.cu``): per count the operations a launch ran, ms and
    rates (operations/s)."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    blocks = SMS * 16
    ops = blocks * 128 * rounds * 8
    out = torch.empty((blocks * 128,), dtype=torch.float32, device=dev)
    rec = {}
    for nv in voxels:
        buf = torch.zeros((nv, 4), dtype=torch.float32, device=dev)

        def gather():
            if lib.l2_gather_launch(buf.data_ptr(), nv, rounds, blocks, out.data_ptr(), stream):
                raise RuntimeError("l2_gather launch failed")

        def atomic():
            if lib.l2_atomic_launch(buf.data_ptr(), nv, rounds, blocks, stream):
                raise RuntimeError("l2_atomic launch failed")
        gather()
        atomic()
        g_ms, a_ms = cuda_ms(gather, reps), cuda_ms(atomic, reps)
        rec[nv] = {"bytes": nv * 16, "ops": ops, "gather_ms": g_ms, "atomic_ms": a_ms,
                   "gathers_per_s": ops / g_ms * 1e3, "atomics_per_s": ops / a_ms * 1e3}
        del buf
    return rec


def listed_utilization(hits):
    """Busy share of the lanes of a launch over ``hits`` listed rays, one a
    thread, each the same number of queries: hits / (32 x its warps)."""
    return hits / max(32 * -(-hits // 32), 1)


def nerf_shape_record(vs, nerf_step, tag, cfg, scene, fwd, adj, dL, probe, reps=5):
    """One shape of phase_nerf step 5: the redesigned primal against the
    direct one on every lane (L and valid bit for bit), the redesigned
    adjoint's gradients against the direct one's (relative L1), against a
    second run of the direct kernel's, and both against the float64 sums
    of the direct kernel's terms (its ``g_grid64`` build), both
    kernels' lane utilization (the direct's from its warps of 32
    consecutive rays, the redesigned's from its list), the adjoints' global
    atomics a launch (counting builds), ms in turns, and the L2 model's ms
    (``probe``'s rates at the grid's voxel count)."""
    import torch
    sh = NerfShape(vs, nerf_step, cfg, scene, fwd, adj, dL)
    sh.primal(direct=True)
    Ld, vd = sh.L.clone(), sh.valid.clone()
    sh.primal()
    torch.cuda.synchronize()
    hits = int(sh.p_scratch[1].item())
    equal = bool(torch.equal(sh.L, Ld) and torch.equal(sh.valid, vd))
    sh.adjoint(direct=True, count=True, fresh=True)
    torch.cuda.synchronize()
    gd, adds_d = sh.g.clone(), int(sh.count.item())
    sh.adjoint(count=True, fresh=True)
    torch.cuda.synchronize()
    hits_a, adds_k = int(sh.a_scratch[1].item()), int(sh.count.item())
    gk = sh.g.clone()
    sh.adjoint(direct=True, fresh=True)             # the direct kernel again
    gd2 = sh.g.clone()
    g64 = torch.zeros(sh.g.shape, dtype=torch.float64, device=sh.g.device)
    sh.a.g_grid64 = g64.data_ptr()
    sh.adjoint(direct=True)                         # its terms summed in float64
    sh.a.g_grid64 = None
    torch.cuda.synchronize()

    def rel(a, ref):
        return {"sigma_t": rel_l1(a[..., :1].double(), ref[..., :1].double()),
                "emission": rel_l1(a[..., 1:].double(), ref[..., 1:].double())}
    act = nerf_active(scene, fwd[0], fwd[1])
    act_a = nerf_active(scene, adj[0], adj[1])
    steps = cfg.queries_per_ray
    util_d = {"nerf_primal": warp_utilization(act.to(torch.int64) * steps),
              "nerf_adjoint": warp_utilization(act_a.to(torch.int64) * steps)}
    ms = {}
    for key, run in (("nerf_primal", sh.primal), ("nerf_adjoint", sh.adjoint)):
        d_ms, k_ms, t = turns_ms(lambda: run(direct=True), run, reps)
        ms[key] = {"direct": d_ms, "redesigned": k_ms, "turns": t, "speedup": d_ms / k_ms}
    voxels = int(sh.grid[..., 0].numel())
    rate = probe[voxels]
    gathers = {"nerf_primal": int(act.sum()) * steps * 8,
               "nerf_adjoint": int(act_a.sum()) * steps * 8}
    l2 = {k: {"l2_gather_ms": gathers[k] / rate["gathers_per_s"] * 1e3} for k in gathers}
    l2["nerf_adjoint"].update(
        l2_atomic_ms_direct=adds_d / rate["atomics_per_s"] * 1e3,
        l2_atomic_ms=adds_k / rate["atomics_per_s"] * 1e3)
    return {"shape": tag, "grid": list(sh.grid.shape[:3]), "rays": sh.n, "adjoint_rays": sh.n_adj,
            "active": int(act.sum()), "active_adjoint": int(act_a.sum()),
            "listed": {"nerf_primal": hits, "nerf_adjoint": hits_a},
            "primal_equal_to_direct": equal, "adjoint_rel_l1_to_direct": rel(gk, gd),
            "direct_rel_l1_to_itself": rel(gd2, gd),
            "adjoint_rel_l1_to_f64": {"redesigned": rel(gk, g64), "direct": rel(gd, g64)},
            "utilization_direct": util_d,
            "utilization": {"nerf_primal": listed_utilization(hits),
                            "nerf_adjoint": listed_utilization(hits_a)},
            "atomics": {"direct": adds_d, "redesigned": adds_k},
            "ms": ms, "l2_model": l2}


def nerf_step_rays(b, batch, spp, seed, dev):
    """The rays of a NeRF training pass: ``batch`` pixels drawn from a seed
    over every sensor, ``spp`` rays each (``render/batched._expand_rays``)."""
    import torch
    from uivr_tpu_torch.render import batched
    rs = np.random.RandomState(seed)
    W, H = b.film_size
    sidx = torch.from_numpy(rs.randint(0, b.cameras.n_sensors, batch)).to(dev)
    pix = torch.from_numpy(np.stack([rs.randint(0, W, batch), rs.randint(0, H, batch)],
                                    axis=-1)).to(dev)
    o, d = batched._expand_rays(b.cameras, sidx, pix, b.film_size, spp, seed + 1)
    return o.contiguous(), d.contiguous()


def nerf_stage_iterations(res):
    """{grid resolution: iterations} of the reference's NeRF stage (6000
    iterations, upsampled at ``BASE_OPT["upsample"]``; the grid doubles at
    each from 128 / 2**len(upsample))."""
    from uivr_tpu_torch.cli import reproduce
    from uivr_tpu_torch.opt.schedule import upsample_iterations
    n = reproduce.BASE_OPT["n_iter"]
    at = sorted(upsample_iterations(reproduce.BASE_OPT["upsample"], n)) + [n]
    starts = [0] + at[:-1]
    return {r: e - s_ for r, s_, e in zip(res, starts, at)}


def nerf_shapes(card, vs, probe_lib, nerf_step, cfg, janga_in, dust_in):
    """phase_nerf step 5 at every grid resolution of the stage (janga's
    truth grids resized by ``resize_trilinear``, the given rays) and at
    dust-devil's 256^3 truth grids with a dust-devil NeRF step's rays, with
    the L2 probe's rates at each grid's voxel count; one ``nerf_shape``
    line each, and the stage's kernel time at each resolution weighted by
    its iterations.  Returns {shape: record}."""
    import torch
    from uivr_tpu_torch.core.grids import resize_trilinear
    from uivr_tpu_torch.scene.medium import MediumParams, finalize_medium
    from uivr_tpu_torch.scene.scene import Scene
    (b, scene, fwd, adj, dL), (db, dscene, dfwd, dadj, ddL) = janga_in, dust_in
    dev = fwd[0].device
    probe = l2_probe(probe_lib, dev, [r ** 3 for r in NERF_RES] + [int(dscene.medium.params.sigma_t[
        ..., 0].numel())])
    emit({"phase": "nerf_l2_probe", "rates": {str(k): v for k, v in probe.items()},
          "card": card})
    out = {}
    for res in NERF_RES:
        if res == scene.medium.params.sigma_t.shape[0]:
            sc = scene
        else:
            grids = MediumParams(*[resize_trilinear(g, (res,) * 3)
                                   for g in scene.medium.params])
            sc = Scene(finalize_medium(grids, b.medium_cfg, b.to_world), scene.emitter,
                       scene.cameras)
        out[f"janga-{res}"] = nerf_shape_record(vs, nerf_step, f"janga-smoke {res}^3", cfg, sc,
                                                fwd, adj, dL, probe)
        emit({"phase": "nerf_shape", **out[f"janga-{res}"], "card": card})
        del sc
        torch.cuda.empty_cache()
    out["dust-256"] = nerf_shape_record(vs, nerf_step, "dust-devil 256^3", cfg, dscene, dfwd,
                                        dadj, ddL, probe)
    emit({"phase": "nerf_shape", **out["dust-256"], "card": card})
    iters = nerf_stage_iterations(NERF_RES)
    stage = {w: sum(iters[r] * (2 * out[f"janga-{r}"]["ms"]["nerf_primal"][w]
                                + out[f"janga-{r}"]["ms"]["nerf_adjoint"][w])
                    for r in NERF_RES) / 1e3 for w in ("direct", "redesigned")}
    emit({"phase": "nerf_stage_kernels", "iterations": iters,
          "kernel_s_per_stage": stage, "card": card})
    # the adjoint's float32 sums against the float64 sums of the same terms
    # (the direct kernel's own float32 sums stray further on coarse grids)
    bad = {k: v for k, v in out.items()
           if not v["primal_equal_to_direct"]
           or any(e > 1e-5 for e in v["adjoint_rel_l1_to_f64"]["redesigned"].values())}
    if bad:
        raise RuntimeError(f"nerf shapes: the redesigned kernels disagree with the direct ones "
                           f"at {sorted(bad)}")
    return out, stage


def nerf_registers(vs):
    """ptxas' registers of the march kernels' instantiations, from the NeRF
    library's build log: {kernel: {"int32": n, "int64": n}} (the
    adjoint's main-path build, without the atomics count)."""
    import re
    out = {k: {} for k in NERF_KERNELS}
    for name, rep in ptxas_report(vs.BUILD["nerf"]["log"]).items():
        m = re.search(r"Used (\d+) registers", rep)
        for kernel, tmpl in (("nerf_primal", "nerf_primal_kernelI{}E"),
                             ("nerf_adjoint", "nerf_adjoint_kernelILb0E{}E")):
            for key, code in (("int32", "i"), ("int64", "l")):
                if m and tmpl.format(code) in name:
                    out[kernel][key] = int(m.group(1))
    return out


def nerf_march_reads(cfg, scene, o, d, seed):
    """(distinct voxels whose corners the march of rays o, d reads, share
    of its queries in the grid's upper half in z): the plain march's
    points (``integrators/nerf._setup``), eight corners each, marked in a
    bitmap of the grid's voxels."""
    import torch
    from uivr_tpu_torch.core.grids import _corner_indices_weights
    from uivr_tpu_torch.core.rng import make_sampler
    from uivr_tpu_torch.integrators import nerf
    n = o.shape[0]
    m, active, entry, dl, step, jit, _ = nerf._setup(
        cfg, scene, o, d, make_sampler(seed, n_lanes=n, device=o.device))
    shape = tuple(m.params.sigma_t.shape[:3])
    seen = torch.zeros(math.prod(shape), dtype=torch.bool, device=o.device)
    e, dl_, st, jt = entry[active], dl[active], step[active], jit[active]
    upper = 0
    for j in range(cfg.queries_per_ray):
        p = e + (st * ((j + 1) + (jt if cfg.jitter else 0.0)))[:, None] * dl_
        idx, _ = _corner_indices_weights(shape, p)
        seen[idx.reshape(-1)] = True
        upper += int((p[:, 2] >= 0.5).sum())
    return int(seen.sum()), upper / max(int(active.sum()) * cfg.queries_per_ray, 1)


def nerf_large_rays(b, n, dev, seed):
    """n world rays through a medium's box (``b.to_world``), from a seeded
    generator: each aims at a point of the box from 2 local units away;
    three in four aim at its upper half in z, on directions a quarter as
    steep in z as random ones."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    target = torch.rand((n, 3), generator=g, device=dev)
    up = (3 * n) // 4
    target[:up, 2] = 0.5 + 0.5 * target[:up, 2]
    dirs = torch.randn((n, 3), generator=g, device=dev)
    dirs[:up, 2] *= 0.25
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    T = torch.as_tensor(np.asarray(b.to_world, np.float32), device=dev)
    o = (target - 2.0 * dirs) @ T[:3, :3].T + T[:3, 3]
    d = dirs @ T[:3, :3].T
    return o.contiguous(), (d / d.norm(dim=1, keepdim=True)).contiguous()


def phase_nerf_large(card, vs, nerf_step, cfg, b, sc, fwd, adj, dL, plain):
    """Phase nerf_large (see the module's docstring): the int64_t march
    kernels at 128^3 against the int32_t ones on the truth step's inputs
    (``sc``, ``fwd``, ``adj``, ``dL``; ``plain``: the plain version's L and
    gradients on them), then on a NERF_LARGE_SHAPE grid through the
    wrappers.  Returns its two records (128^3, the large grid)."""
    import torch
    from uivr_tpu_torch.core.rng import make_sampler
    from uivr_tpu_torch.integrators import nerf
    from uivr_tpu_torch.scene.medium import MediumConfig, MediumParams, finalize_medium
    from uivr_tpu_torch.scene.scene import Scene
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = fwd[0].device
    Lp, gp = plain

    def slabs(a, ref, fn, z=16):
        """fn over slabs of ``z`` planes of a and ref in float64: the grids
        of the large half are too big for whole-grid temporaries."""
        return [fn(a[i:i + z].double(), ref[i:i + z].double()) for i in range(0, a.shape[0], z)]

    def rel_slabs(a, ref):
        parts = slabs(a, ref, lambda x, y: ((x - y).abs().sum().item(), y.abs().sum().item()))
        return sum(p[0] for p in parts) / max(sum(p[1] for p in parts), 1e-30)

    def rel(g4, ref):
        """Relative L1 of a (D, H, W, 4) gradient grid to ``ref``, either
        of the same layout or MediumParams."""
        sig, em = ((ref.sigma_t, ref.emission) if isinstance(ref, MediumParams)
                   else (ref[..., :1], ref[..., 1:]))
        return {"sigma_t": rel_slabs(g4[..., :1], sig), "emission": rel_slabs(g4[..., 1:], em)}

    def max_err(g4, ref):
        return max(max(slabs(g4[..., :1], ref.sigma_t, lambda x, y: (x - y).abs().max().item())),
                   max(slabs(g4[..., 1:], ref.emission,
                             lambda x, y: (x - y).abs().max().item())))

    # ---- 128^3: both instantiations on the same inputs
    sh = {w: NerfShape(vs, nerf_step, cfg, sc, fwd, adj, dL, index64=w) for w in (False, True)}
    sh[False].primal()
    sh[True].primal()
    sh[True].adjoint(fresh=True)
    sh[False].adjoint(fresh=True)
    g64 = torch.zeros(sh[True].g.shape, dtype=torch.float64, device=dev)
    sh[False].a.g_grid64 = g64.data_ptr()
    sh[False].adjoint(direct=True)                  # the direct kernel's terms in float64
    sh[False].a.g_grid64 = None
    torch.cuda.synchronize()
    at128 = {"rays": sh[True].n, "adjoint_rays": sh[True].n_adj,
             "primal_equal_to_int32": bool(torch.equal(sh[True].L, sh[False].L)
                                           and torch.equal(sh[True].valid, sh[False].valid)),
             "adjoint_rel_l1_to_f64": {"int64": rel(sh[True].g, g64),
                                       "int32": rel(sh[False].g, g64)},
             "adjoint_rel_l1_to_int32": rel(sh[True].g, sh[False].g),
             "max_abs_err_to_plain": {"nerf_primal": (sh[True].L - Lp).abs().max().item(),
                                      "nerf_adjoint": max_err(sh[True].g, gp)}}
    del g64
    ms = {}
    for key, run in (("nerf_primal", "primal"), ("nerf_adjoint", "adjoint")):
        i32, i64, t = turns_ms(getattr(sh[False], run), getattr(sh[True], run), 5)
        ms[key] = {"int32": i32, "int64": i64, "turns": t, "int64_over_int32": i64 / i32}
    at128["ms"] = ms
    regs = nerf_registers(vs)
    at128["registers"] = regs
    at128["int32_registers_as_measured"] = all(
        regs[k].get("int32") == v for k, v in NERF_I32_REGISTERS.items())
    del sh
    torch.cuda.empty_cache()
    ok128 = at128["primal_equal_to_int32"] and all(
        e <= 1e-5 for e in at128["adjoint_rel_l1_to_f64"]["int64"].values())

    # ---- a grid of 2^29 voxels, on the card from a seeded generator
    D, H, W = NERF_LARGE_SHAPE
    gen = torch.Generator(device=dev).manual_seed(20261019)
    params = MediumParams(
        sigma_t=torch.rand((D, H, W, 1), generator=gen, device=dev) * 0.1,
        albedo=torch.rand((D, H, W, 3), generator=gen, device=dev),
        emission=torch.rand((D, H, W, 3), generator=gen, device=dev) * 0.5)
    # no majorant supergrid or subcell table: the NeRF march reads neither
    mcfg = MediumConfig(majorant_factor=0, scale=b.medium_cfg.scale, cls_cells=0)
    m = finalize_medium(params, mcfg, b.to_world)
    # the path tracer's interleaved [sigma, albedo] grid, which the march
    # does not read either: 8 GiB back
    big = Scene(m._replace(grid=m.grid.new_empty(0)), sc.emitter, sc.cameras)
    del m, params
    n, S = fwd[0].shape[0], NERF_LARGE_SLICE
    o, d = nerf_large_rays(b, n, dev, 23)
    seed = 29
    dLs = torch.from_numpy(np.random.RandomState(31).randn(S, 3).astype(np.float32) * 0.01).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase

    # the wrappers, as the stage would call them on such a grid
    for k in vs.LAUNCHES:
        vs.LAUNCHES[k] = 0
    for k in nerf.CALLS:
        nerf.CALLS[k] = 0
    L, valid = nerf_step.sample_primal_kernel(cfg, big, o, d, seed)
    g = nerf_step.sample_adjoint_kernel(cfg, big, o[:S], d[:S], seed, dLs, L[:S].contiguous())
    torch.cuda.synchronize()
    launches = {k: v for k, v in vs.LAUNCHES.items() if v}
    plain_calls = dict(nerf.CALLS)
    albedo_zero = not g.albedo.any().item()
    gw = torch.cat([g.sigma_t, g.emission], dim=-1)
    del g
    # the plain version on the slice
    t0 = time.perf_counter()
    Lps, vps, _ = nerf.sample_primal(cfg, big, o[:S], d[:S], make_sampler(seed, n_lanes=S,
                                                                          device=dev))
    torch.cuda.synchronize()
    p_plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    gps, _ = nerf.sample_adjoint(cfg, big, o[:S], d[:S], make_sampler(seed, n_lanes=S, device=dev),
                                 dLs, L[:S].contiguous())
    torch.cuda.synchronize()
    a_plain_ms = (time.perf_counter() - t0) * 1e3
    large = {"grid": [D, H, W], "voxels": D * H * W, "rays": n, "slice": S,
             "launches": launches, "plain_calls": plain_calls,
             "primal_bit_equal_to_plain": bool(torch.equal(L[:S], Lps)
                                                and torch.equal(valid[:S], vps)),
             "active_slice": int(nerf_active(big, o[:S], d[:S]).sum()),
             "albedo_gradient_zero": albedo_zero,
             "adjoint_rel_l1_to_plain": rel(gw, gps),
             "max_abs_err_to_plain": {"nerf_primal": (L[:S] - Lps).abs().max().item(),
                                      "nerf_adjoint": max_err(gw, gps)},
             "plain_ms": {"nerf_primal": p_plain_ms, "nerf_adjoint": a_plain_ms}}
    del gps, Lps, vps
    # float64 sums of the direct kernel's terms, then the direct kernel
    grid = nerf_step.nerf_grid(big.medium)
    shs = NerfShape(vs, nerf_step, cfg, big, (o[:S], d[:S], seed), (o[:S], d[:S], seed), dLs,
                    grid=grid)
    if not torch.equal(shs.L_in, L[:S]):
        raise RuntimeError("nerf_large: the launcher's primal differs from the wrapper's")
    g64 = torch.zeros((D, H, W, 4), dtype=torch.float64, device=dev)
    shs.a.g_grid64 = g64.data_ptr()
    shs.adjoint(direct=True)
    shs.a.g_grid64 = None
    large["adjoint_rel_l1_to_f64"] = {"int64": rel(gw, g64)}
    del gw
    shs.adjoint(direct=True, fresh=True)
    torch.cuda.synchronize()
    large["adjoint_rel_l1_to_f64"]["direct"] = rel(shs.g, g64)
    del g64, shs
    torch.cuda.empty_cache()
    # both kernels on every ray, and the voxels the march reads
    shn = NerfShape(vs, nerf_step, cfg, big, (o, d, seed), (o, d, seed),
                    torch.from_numpy(np.random.RandomState(37).randn(n, 3).astype(np.float32)
                                     * 0.01).to(dev), grid=grid)
    shn.primal()
    shn.adjoint(fresh=True)
    large["ms"] = {"nerf_primal": cuda_ms(shn.primal, 3), "nerf_adjoint": cuda_ms(shn.adjoint, 3)}
    reads, upper = nerf_march_reads(cfg, big, o, d, seed)
    work = nerf_work(big, o, d, cfg.queries_per_ray, voxels=reads)
    large.update(voxels_read=reads, upper_half_query_share=upper,
                 bound={k: bound(work[k]["bytes"], work[k]["flops"], work[k]["ints"])
                        for k in NERF_KERNELS},
                 max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del shn, grid, big
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    large["setup_s"] = setup_s
    seconds = time.perf_counter() - t_phase
    emit({"phase": "nerf_large", "at_128": at128, "large": large, "seconds": seconds,
          "card": card})
    bad = [k for k, v in (
        ("128^3", ok128),
        ("launches", launches.get("nerf_primal_i64") == 1 and launches.get("nerf_adjoint_i64") == 1
         and set(launches) == {"nerf_primal_i64", "nerf_adjoint_i64"}),
        ("plain calls", not any(plain_calls.values())),
        ("primal", large["primal_bit_equal_to_plain"] and large["active_slice"] > S // 2),
        ("adjoint", albedo_zero and all(
            e <= 1e-5 for e in list(large["adjoint_rel_l1_to_plain"].values())
            + list(large["adjoint_rel_l1_to_f64"]["int64"].values()))),
        ("upper half", upper > 0.5)) if not v]
    if bad:
        raise RuntimeError(f"nerf_large: checks failed: {bad}")

    return at128, large


def phase_nerf(card, vs, probe_lib, janga, dust, out_dir):
    """The NeRF bootstrap stage of janga-smoke at the reference's width
    (``_opt_for("janga-smoke", "nerf", 1.0)``: batch 32,768, spp 4, primal
    factor 1, lr 1e-2: 131,072 forward, replay and adjoint rays a step, 128
    queries a ray), on the references the train phase rendered:

    1. a step from the ground-truth grids (128^3) and one from the constant
       start (its second), recorded (``StepRecorder``, ``NerfCalls``): the
       kernels' forward L and adjoint gradients against the plain version
       on the truth step's own inputs, the step's parts;
    2. the stage through ``cli.reproduce._run_stages`` with n_iter cut to
       25 (upsampling at 1, 4, 9, 16: 8^3 to 128^3), every counter set to 0
       just before: both kernels launched, their direct twins not, no plain
       call, no volpath kernel, finite losses, a final checkpoint at 128^3;
    3. one full-width ``volpathsimple-drt`` step of janga-smoke-from-nerf
       through ``_run_stages``, warm-started from that checkpoint;
    4. ``cli.render --integrator nerf --spp 64 --checkpoint`` of it;
    5. both kernels against their direct twins at every shape of
       ``nerf_shapes`` (every resolution of the stage, on the truth step's
       rays, and dust-devil's 256^3), the direct twins against the plain
       version on the truth step's inputs, plain times, bounds;
    6. ``phase_nerf_large``: the kernels' int64_t instantiation at 128^3
       and on a grid of 2^29 voxels.
    Returns the kernels line's rows."""
    import argparse
    import shutil

    import torch
    from uivr_tpu_torch.cli import render as cli_render
    from uivr_tpu_torch.cli import reproduce
    from uivr_tpu_torch.config import get_int_config, get_scene_config
    from uivr_tpu_torch.core.rng import make_sampler
    from uivr_tpu_torch.integrators import nerf
    from uivr_tpu_torch.ops import nerf_step
    from uivr_tpu_torch.opt import OptimizationConfig, load_checkpoint, load_references, loop
    preset, b, _ = janga
    dev = b.params.sigma_t.device
    cfg = get_int_config("nerf").create(max_depth=preset.max_depth)
    stage = reproduce._opt_for("janga-smoke", "nerf", 1.0)
    refs = load_references(str(out_dir / "janga-smoke" / "references"), b,
                           sensors=list(b.sensors) if b.sensors else None)
    root = out_dir / "nerf"
    if root.exists():
        shutil.rmtree(root)
    width = dict(spp=stage.spp, lr=stage.lr, primal_spp_factor=stage.primal_spp_factor,
                 batch_size=stage.batch_size, upsample=None, preview_stride=0,
                 checkpoint_stride=0, checkpoint_initial=False, checkpoint_final=False,
                 render_initial=False, render_final=False)

    def counters_zero():
        for k in vs.LAUNCHES:
            vs.LAUNCHES[k] = 0
        for k in nerf.CALLS:
            nerf.CALLS[k] = 0

    # ---- 1. truth and start steps
    steps = {}
    for tag, start, n_iter in (("truth", b.params, 1), ("start", None, 2)):
        opt = OptimizationConfig(name=f"janga-smoke/nerf-{tag}", n_iter=n_iter, **width)
        with StepRecorder(vs, loop) as r, NerfCalls(nerf_step, keep=tag == "truth") as calls:
            loop.run_optimization(str(root / tag), opt, b, cfg, ref_images=refs,
                                  start_params=start, resume=False, verbose=False)
        steps[tag] = (r.steps[-1], calls.calls)
    rec, calls = steps["truth"]
    fwd, replay, adj = calls
    if [c["kind"] for c in calls] != ["sample_primal_kernel"] * 2 + ["sample_adjoint_kernel"]:
        raise RuntimeError(f"nerf truth step: unexpected calls {[c['kind'] for c in calls]}")
    sc, o, d, seed = fwd["scene"], fwd["o"], fwd["d"], fwd["seed"]
    n = o.shape[0]
    L = fwd["out"][0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Lp, _, _ = nerf.sample_primal(cfg, sc, o, d, make_sampler(seed, n_lanes=n, device=dev))
    torch.cuda.synchronize()
    p_plain_ms = (time.perf_counter() - t0) * 1e3
    ao, ad, aseed = adj["o"], adj["d"], adj["seed"]
    dL, L_in = adj["rest"]
    g = adj["out"]
    t0 = time.perf_counter()
    gp, _ = nerf.sample_adjoint(cfg, adj["scene"], ao, ad,
                                make_sampler(aseed, n_lanes=ao.shape[0], device=dev), dL, L_in)
    torch.cuda.synchronize()
    a_plain_ms = (time.perf_counter() - t0) * 1e3
    p_err = (L - Lp).abs().max().item()
    p_rel = p_err / max(Lp.abs().max().item(), 1e-30)
    a_rel = {k: rel_l1(getattr(g, k), getattr(gp, k)) for k in ("sigma_t", "emission")}
    parts = {t: nerf_step_parts(s_) for t, (s_, _) in steps.items()}
    check = {"rays": n, "adjoint_rays": ao.shape[0],
             "primal_max_abs_err": p_err, "primal_rel_max_abs_err": p_rel,
             "primal_bit_equal_lanes": float((L == Lp).all(dim=1).float().mean()),
             "adjoint_rel_l1": a_rel, "albedo_gradient_zero": not g.albedo.any().item(),
             "plain_ms": {"nerf_primal": p_plain_ms, "nerf_adjoint": a_plain_ms},
             "launches_per_step": {k: rec["counts"][k] for k in NERF_KERNELS}}
    emit({"phase": "nerf_step", "scene": "janga-smoke", "batch": stage.batch_size,
          "spp": stage.spp, "primal_spp_factor": stage.primal_spp_factor, "lr": stage.lr,
          "grid": list(b.params.sigma_t.shape), "queries_per_ray": cfg.queries_per_ray,
          "loss": {t: s_["loss"] for t, (s_, _) in steps.items()},
          "seconds": {t: s_["seconds"] for t, (s_, _) in steps.items()},
          "parts_ms": parts, **check, "card": card})
    if p_rel > 1e-5 or max(a_rel.values()) > 1e-5 or not check["albedo_gradient_zero"] \
            or check["launches_per_step"] != {"nerf_primal": 2, "nerf_adjoint": 1}:
        raise RuntimeError(f"nerf truth step: the kernels disagree with the plain version: "
                           f"{check}")

    # ---- 2. the stage through _run_stages, 25 iterations
    cut = {"nerf": 25, "volpathsimple-drt": 1}
    opt_for, run_opt = reproduce._opt_for, reproduce.run_optimization
    warm = {}

    def args(config, integrator):
        return argparse.Namespace(config=config, integrator=[integrator],
                                  outputs=str(root / "stages"), scale=1.0, shadow_rr=0.0,
                                  scan_stride=10)

    def run_recorded(*a, **k):
        warm["start_params"] = k.get("start_params")
        return run_opt(*a, **k)
    reproduce._opt_for = lambda s_, i_, x_: dataclasses.replace(opt_for(s_, i_, x_),
                                                                 n_iter=cut[i_])
    reproduce.run_optimization = run_recorded
    try:
        counters_zero()
        t0 = time.perf_counter()
        with StepRecorder(vs, loop) as r, NerfCalls(nerf_step) as calls:
            a_ = args("janga-smoke", "nerf")
            reproduce._run_stages(a_, preset, b, refs, 64, dev, reproduce._stage_opts(a_))
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        launches = {k: v for k, v in vs.LAUNCHES.items() if v}
        plain_calls = dict(nerf.CALLS)
        run_dir = root / "stages" / "janga-smoke" / "nerf"
        with open(run_dir / "metrics.jsonl") as f:
            metrics = [json.loads(ln) for ln in f]
        losses_ = [m_["loss"] for m_ in metrics if "loss" in m_]
        # one adjoint call a step; the previews call the primal only
        it_grids = [c["grid"] for c in calls.calls if c["kind"] == "sample_adjoint_kernel"]
        first_at = {}
        for it, shp in enumerate(it_grids):
            first_at.setdefault(shp, it)
        final_ck = run_dir / "params" / "final-medium1_sigma_t.vol"
        final = load_checkpoint(str(run_dir / "params"), "final", device=dev)
        stage_rec = {"iterations": len(r.steps), "seconds": stage_s, "losses": losses_,
                     "grid_first_iteration": {"x".join(map(str, k)): v
                                              for k, v in first_at.items()},
                     "step_ms": [s_["start"].elapsed_time(s_["end"]) for s_ in r.steps],
                     "launches": launches, "plain_calls": plain_calls,
                     "final_grid": list(final.sigma_t.shape)}
        emit({"phase": "nerf_stage", "scene": "janga-smoke", **stage_rec, "card": card})
        if not (launches.get("nerf_primal", 0) > 0 and launches.get("nerf_adjoint", 0) > 0
                and not any(plain_calls.values()) and "volpath_primal" not in launches
                and not any(launches.get(f"{k}_direct", 0) for k in NERF_KERNELS)
                and not any(launches.get(f"{k}_i64", 0) for k in NERF_KERNELS)
                and len(r.steps) == 25 and losses_ and all(map(math.isfinite, losses_))
                and final_ck.exists() and tuple(final.sigma_t.shape[:3]) == (128, 128, 128)
                and sorted(first_at.values()) == [0, 1, 4, 9, 16]):
            raise RuntimeError(f"nerf stage: checks failed: {stage_rec}")
        nerf_launches = launches

        # ---- 3. janga-smoke-from-nerf, one volpathsimple-drt step
        counters_zero()
        t0 = time.perf_counter()
        with StepRecorder(vs, loop) as r:
            a_ = args("janga-smoke-from-nerf", "volpathsimple-drt")
            reproduce._run_stages(a_, get_scene_config("janga-smoke-from-nerf"), b, refs, 64,
                                  dev, reproduce._stage_opts(a_))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        launches = {k: v for k, v in vs.LAUNCHES.items() if v}
        sp = warm.get("start_params")
        warm_rec = {"seconds": warm_s, "loss": r.steps[0]["loss"] if r.steps else None,
                    "step_ms": [s_["start"].elapsed_time(s_["end"]) for s_ in r.steps],
                    "warm_started": sp is not None and all(
                        torch.equal(getattr(sp, k), getattr(final, k))
                        for k in ("sigma_t", "albedo", "emission")),
                    "launches": launches}
        emit({"phase": "nerf_warm_start", "scene": "janga-smoke-from-nerf", **warm_rec,
              "card": card})
        done = root / "stages" / "janga-smoke-from-nerf" / "volpathsimple-drt" / "params" \
            / "final-medium1_sigma_t.vol"
        if not (warm_rec["warm_started"] and len(r.steps) == 1 and done.exists()
                and math.isfinite(warm_rec["loss"])
                and all(launches.get(k, 0) > 0 for k in TRAIN_KERNELS)
                and not any(launches.get(k, 0) for k in NERF_KERNELS)):
            raise RuntimeError(f"janga-smoke-from-nerf: checks failed: {warm_rec}")
    finally:
        reproduce._opt_for, reproduce.run_optimization = opt_for, run_opt

    # ---- 4. the render CLI on the stage's checkpoint
    counters_zero()
    exr = root / "nerf-s0.exr"
    img, dt = cli_render.main(["--scene", "janga-smoke", "--integrator", "nerf", "--spp", "64",
                               "--checkpoint", str(run_dir / "params"), "--out", str(exr)])
    W, H = b.film_size
    render_rec = {"rays": W * H * 64, "seconds": dt, "mrays_per_s": W * H * 64 / dt / 1e6,
                  "image_mean": float(img.mean()),
                  "launches": {k: v for k, v in vs.LAUNCHES.items() if v},
                  "plain_calls": dict(nerf.CALLS)}
    emit({"phase": "nerf_render", "scene": "janga-smoke", "spp": 64, **render_rec, "card": card})
    if not (render_rec["launches"].get("nerf_primal", 0) > 0 and np.isfinite(img).all()
            and not any(render_rec["plain_calls"].values())
            and "volpath_primal" not in render_rec["launches"]):
        raise RuntimeError(f"nerf render: checks failed: {render_rec}")

    # ---- 5. the kernels at every resolution of the stage and out of L2, bounds
    dust_in = nerf_dust_inputs(dust)
    shapes, stage_s = nerf_shapes(card, vs, probe_lib, nerf_step, cfg,
                                  (b, adj["scene"], (o, d, seed), (ao, ad, aseed), dL),
                                  dust_in)
    s128 = shapes["janga-128"]
    # the direct kernels against the plain version on the truth step's inputs
    Ld, _ = nerf_step.sample_primal_kernel(cfg, sc, o, d, seed, direct=True)
    gd = nerf_step.sample_adjoint_kernel(cfg, adj["scene"], ao, ad, aseed, dL, L_in, direct=True)
    torch.cuda.synchronize()
    errs_direct = {"nerf_primal": (Ld - Lp).abs().max().item(), "nerf_adjoint": max(
        (getattr(gd, k) - getattr(gp, k)).abs().max().item() for k in ("sigma_t", "emission"))}
    work = {"nerf_primal": nerf_work(sc, o, d, cfg.queries_per_ray),
            "nerf_adjoint": nerf_work(adj["scene"], ao, ad, cfg.queries_per_ray)}
    step_ms = {"nerf_primal": parts["truth"]["forward"], "nerf_adjoint": parts["truth"]["adjoint"]}
    errs = {"nerf_primal": p_err, "nerf_adjoint": max(
        (getattr(g, k) - getattr(gp, k)).abs().max().item() for k in ("sigma_t", "emission"))}
    rows = []
    for name, line in (("nerf_primal", 61), ("nerf_adjoint", 95)):
        w = work[name][name]
        b_ms, b_by = bound(w["bytes"], w["flops"], w["ints"])
        base = {"route": "cuda", "source": "uivr_tpu_torch/ops/csrc/nerf.cu",
                "replaces": f"uivr_tpu/integrators/nerf.py:{line}", "tpu_kernel": False,
                "plain_ms": check["plain_ms"][name], "bound_ms": b_ms, "bound_by": b_by,
                "gather_bound_ms": bound(w["fetch"], 0)[0], "fetch_bytes": w["fetch"],
                "library_ms": None, "active_rays": work[name]["active"],
                "l2_gather_ms": s128["l2_model"][name]["l2_gather_ms"],
                "shape": f"{n} rays x {cfg.queries_per_ray} queries, janga-smoke NeRF truth "
                         f"step, 128^3 grid"}
        by_res = {k: v["ms"][name] for k, v in shapes.items()}
        rows.append({
            "name": name, **base, "redesigned": "one listed ray inside the box a thread",
            "launches": nerf_launches[name],
            "launches_per_nerf_step": check["launches_per_step"][name],
            "max_abs_err": errs[name], "ms": step_ms[name],
            "ms_alone": s128["ms"][name]["redesigned"],
            "ms_by_shape": {k: v["redesigned"] for k, v in by_res.items()},
            "utilization": s128["utilization"][name]})
        rows.append({
            "name": f"{name}_direct", **base, "comparison_only": True,
            "launches": nerf_launches.get(f"{name}_direct", 0),
            "max_abs_err": errs_direct[name], "ms": s128["ms"][name]["direct"],
            "ms_by_shape": {k: v["direct"] for k, v in by_res.items()},
            "utilization": s128["utilization_direct"][name]})
    rows[0]["rel_max_abs_err"] = p_rel
    rows[2]["rel_l1"] = a_rel
    for r in rows[2:]:
        r["atomics"] = s128["atomics"]["direct" if r["name"].endswith("_direct") else "redesigned"]
        r["l2_atomic_ms"] = s128["l2_model"]["nerf_adjoint"][
            "l2_atomic_ms_direct" if r["name"].endswith("_direct") else "l2_atomic_ms"]

    # ---- 6. the int64_t instantiation (nerf_large): at 128^3 in turns with
    # the int32_t kernels on the truth step's inputs, then at 2^29 voxels
    at128, large = phase_nerf_large(card, vs, nerf_step, cfg, b, adj["scene"], (o, d, seed),
                                    (ao, ad, aseed), dL, (Lp, gp))
    for r in (rows[0], rows[2]):
        r.update(index="int32_t", ms_turns_with_int64=at128["ms"][r["name"]]["int32"],
                 registers=at128["registers"][r["name"]].get("int32"))
    for r in (rows[0], rows[2]):
        name = r["name"]
        big_bound = large["bound"][name]
        rows.append({
            **{k: r[k] for k in ("route", "source", "replaces", "tpu_kernel", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms", "shape")},
            "name": f"{name}_i64", "index": "int64_t",
            "launches": large["launches"].get(f"{name}_i64", 0),
            "max_abs_err": at128["max_abs_err_to_plain"][name],
            "ms": at128["ms"][name]["int64"], "ms_turns_with_int32": at128["ms"][name]["int32"],
            "registers": at128["registers"][name].get("int64"),
            "large": {"grid": large["grid"], "rays": large["rays"], "ms": large["ms"][name],
                      "bound_ms": big_bound[0], "bound_by": big_bound[1],
                      "voxels_read": large["voxels_read"],
                      "max_abs_err_slice": large["max_abs_err_to_plain"][name],
                      "plain_ms_slice": large["plain_ms"][name]}})
    emit({"phase": "nerf_kernels", "rows": rows, "stage_kernel_s": stage_s, "card": card})
    return rows


def nerf_dust_inputs(dust):
    """dust-devil's NeRF step at its truth grids (256^3): its
    ``EXPERIMENT_OVERRIDES`` batch, spp and primal factor give the forward
    and adjoint rays (pixels and jitter from seeds), dL from a seed."""
    import torch
    from uivr_tpu_torch.cli import reproduce
    _, db, dsc = dust
    dstage = reproduce._opt_for("dust-devil", "nerf", 1.0)
    dev = db.params.sigma_t.device
    fwd = nerf_step_rays(db, dstage.batch_size, dstage.spp * dstage.primal_spp_factor, 31, dev)
    adj = nerf_step_rays(db, dstage.batch_size, dstage.spp, 37, dev)
    dL = torch.from_numpy(np.random.RandomState(41).randn(adj[0].shape[0], 3)
                          .astype(np.float32) * 0.01).to(dev)
    return db, dsc, (*fwd, 5), (*adj, 6), dL


def table_bytes(scene):
    """Bytes of the tables every walking kernel reads: the (D,H,W,4)
    sigma+albedo grid, the majorant supergrid and the envmap's tables."""
    m, em = scene.medium, scene.emitter
    env = sum(getattr(em, f).numel() for f in ("data", "alias_tab", "row_pmf", "cond_pmf")
              if hasattr(em, f))
    return (m.grid.numel() + m.majorant_grid.numel() + env) * 4


def adjoint_bound(n, stats, cfg, scene):
    """Least time of volpath_adjoint at this run's counts: the bytes it must
    move (tables read once; o, d, L, dL in; reservoir and counters out, 137 B
    a ray; the sigma and albedo gradient grids written once) against the
    flops of its events.  ``gather_ms`` counts instead the bytes its events
    fetch: 132 B per event (8 B for an event K6 classified), 128 B of atomics
    per real collision, 32 B per transmittance sample and per replay
    collision, 120 B per ray."""
    events = int(stats["steps"].sum())
    real = int(stats["events"][:, 0].sum())
    replay = int(stats["events"][:, 1].sum())
    per_seg = cfg.trans_grad_samples + int(cfg.use_drt and cfg.use_drt_subsampling)
    samples = int(stats["alt_dim"].sum()) // per_seg * cfg.trans_grad_samples
    # every event hashes two primary draws (REPLAY re-reads them at rp_dim
    # without advancing dim); alt draws and the primary stream's draws
    # beyond two an event are extra
    extra_draws = int(stats["alt_dim"].sum()) + max(0, int(stats["dim"].sum()) - 2 * events)
    grads = scene.medium.params.sigma_t[..., 0].numel() * 16
    req = bound(table_bytes(scene) + grads + 137 * n,
                *tracking_ops(events, 2 * events + extra_draws))
    gather_ms, _ = bound(event_fetch_bytes(events, cls_counts(stats["cls"])) + 128 * real
                         + 32 * (samples + replay) + 120 * n, 0)
    return req, gather_ms, {"events": events, "real_collisions": real,
                            "replay_collisions": replay, "trans_samples": samples}


def drt_bounds(n, k, res, scene):
    """Least times of the four DRT kernels at this run's counts, from the
    bytes they must move (tables read once, per-lane I/O, the gradient
    grids written once) against their operations (wavefront_ops per draw,
    FLOP_PER_STEP per tracking step); and the bytes their steps fetch (132
    B per step) as ``gather_ms``.  The scatter reads the sigma and albedo
    the walk kept (16 B) instead of 128 B of corners and adds 128 B of
    atomics per vertex."""
    trips_a = int(k["trips_a"].sum())
    trips_b = int(k["trips_b"].sum())
    active = int((res.active & k["found"]).sum())
    tables = table_bytes(scene)
    m = scene.medium
    grids = m.grid.numel() * 4
    grads = m.params.sigma_t[..., 0].numel() * 16
    walk_io = n * (29 + 26 + 16)
    req = {
        "volpath_drt_walk": bound(grids + m.majorant_grid.numel() * 4 + walk_io,
                                  FLOP_PER_STEP * trips_a,
                                  wavefront_ops(2 * trips_a, 2 * k["k_a"])),
        "volpath_drt_nee": bound(tables + n * (25 + 16), FLOP_PER_STEP * trips_b,
                                 wavefront_ops(trips_b + 2 * active, 2 + k["k_b"])),
        "volpath_drt_phase": bound(n * (12 + 8 + 1 + 48 + 9), n * 100, wavefront_ops(2 * n, 2)),
        "volpath_drt_scatter": bound(grads + n * 1 + active * (12 + 4 + 36 + 16), active * 150),
    }
    gather = {
        "volpath_drt_walk": 132 * trips_a + walk_io,
        "volpath_drt_nee": 132 * trips_b + 28 * active + n * (25 + 16),
        "volpath_drt_phase": n * (12 + 8 + 1 + 48 + 9),
        "volpath_drt_scatter": n * 1 + active * (12 + 4 + 36 + 16 + 128),
    }
    return req, {key: bound(v, 0)[0] for key, v in gather.items()}, {
        "walk_steps": trips_a, "nee_steps": trips_b, "vertices": active}


def training_kernels(train, truth, check):
    """Kernel-line entries of the training path's kernels: launches in the
    main run (and in its first step); times of their launches in the
    recorded step from the ground-truth grids (walks as long as late in a
    run), with bounds from that step's counts; plain times and errors from
    ``check_step`` on that step."""
    runs = {k: {"launches": train["launches"][k],
                "launches_per_train_step": train["iterations"][0]["launches"][k]}
            for k in TRAIN_KERNELS}
    parts = train["truth_step"]["parts_ms"]
    a = truth["adjoint"]
    cfg, scene, n = a["cfg"], a["scene"], a["o"].shape[0]
    (a_bound, a_by), a_gather, a_counts = adjoint_bound(n, a["stats"], cfg, scene)
    k = check["drt_stats"]
    rec_steps = int(k["rec_stats"]["steps"].sum())
    rec_extra = max(0, int(k["rec_stats"]["dim"].sum()) - 2 * rec_steps)
    s_bound, s_by = bound(table_bytes(scene) + n * (49 + 13),
                          *tracking_ops(rec_steps, 2 * rec_steps + rec_extra))
    s_gather, _ = bound(event_fetch_bytes(rec_steps, cls_counts(k["rec_stats"]["cls"]))
                        + 28 * rec_extra / 5 + 49 * n, 0)
    d_req, d_gather, d_counts = drt_bounds(n, k, truth["drt"]["res"], scene)
    src = "uivr_tpu_torch/ops/csrc/"
    shape = "janga-smoke step from the ground truth"
    out = [
        {"name": "volpath_adjoint", "route": "cuda", "source": src + "volpath_adjoint.cu",
         "replaces": "uivr_tpu/ops/volpath_step.py:673", **runs["volpath_adjoint"],
         "max_abs_err": check["adjoint_max_abs_err"],
         "ms": parts["volpath_adjoint"], "plain_ms": check["adjoint_plain_ms"],
         "plain_shape": f"{SLICE} of its rays", "bound_ms": a_bound, "bound_by": a_by,
         "gather_bound_ms": a_gather, "library_ms": None,
         "agreement": min(check["adjoint_agreement"].values()),
         "shape": f"{n} adjoint rays, {shape}", **a_counts},
        {"name": "volpath_primal_state", "route": "cuda", "source": src + "volpath_primal.cu",
         "replaces": "uivr_tpu/ops/volpath_step.py:303 (path_state entry)",
         **runs["volpath_primal_state"],
         "max_abs_err": check["drt_max_abs_err"]["volpath_primal_state"],
         "ms": parts["volpath_primal_state"],
         "plain_ms": check["drt_plain_ms"]["volpath_primal_state"],
         "plain_shape": f"{n} path states", "bound_ms": s_bound, "bound_by": s_by,
         "gather_bound_ms": s_gather, "library_ms": None,
         "agreement": check["drt_agreement"]["recursive_L"],
         "shape": f"{n} path states, {shape}", "tracking_steps": rec_steps},
    ]
    replaces = {"volpath_drt_walk": "uivr_tpu/tracking/trackers.py:201",
                "volpath_drt_nee": "uivr_tpu/integrators/volpathsimple.py:95",
                "volpath_drt_phase": "uivr_tpu/integrators/volpath_flat.py:697",
                "volpath_drt_scatter": "uivr_tpu/integrators/volpath_flat.py:720"}
    for name in DRT_KERNELS:
        b_ms, b_by = d_req[name]
        out.append({"name": name, "route": "cuda", "source": src + "volpath_drt.cu",
                    "replaces": replaces[name], **runs[name],
                    "max_abs_err": check["drt_max_abs_err"][name], "ms": parts[name],
                    "plain_ms": check["drt_plain_ms"][name], "plain_shape": f"{n} reservoirs",
                    "bound_ms": b_ms, "bound_by": b_by, "gather_bound_ms": d_gather[name],
                    "library_ms": None,
                    "agreement": min(check["drt_agreement"][f] for f in ("t_sel", "wsum", "found")),
                    "shape": f"{n} reservoirs, {shape}", **d_counts})
    return out


def walking_on_off(vs, step, check):
    """CUDA-event times (ms) of the adjoint and the recursive primal with K6
    on and off, on a recorded training step's own inputs."""
    from uivr_tpu_torch.core.rng import sample_tea_32
    a = step["adjoint"]
    cfg, sc = a["cfg"], a["scene"]
    off = no_cls(sc)
    args = (a["o"], a["d"], a["seed"], a["dL"], a["L"])
    adj = on_off_ms(lambda: vs.adjoint_walk_kernel(cfg, sc, *args),
                    lambda: vs.adjoint_walk_kernel(cfg, off, *args), 1)
    ps = check["drt_stats"]["path_state"]
    rec_seed, _ = sample_tea_32(int(step["drt"]["seed"]), 0x7177)
    rec = on_off_ms(lambda: vs.sample_primal_kernel(cfg, sc, None, None, rec_seed, path_state=ps),
                    lambda: vs.sample_primal_kernel(cfg, off, None, None, rec_seed, path_state=ps),
                    1)
    n = a["o"].shape[0]
    return {"volpath_adjoint": {"ms_on": adj[0], "ms_off": adj[1],
                                "shape": f"{n} adjoint rays, truth step"},
            "volpath_primal_state": {"ms_on": rec[0], "ms_off": rec[1],
                                     "shape": f"{n} path states, truth step"}}


# ------------------------------------------------------------------- K7
K7_KS = (1, 2, 4, 8)
K7_SLICE = 1 << 16   # rays of a K7 training forward chunk held against the twin


def k7_equal(L, escaped, stats, Lt, et, st):
    """Per-lane equality of a K7 launch and its twin: radiance bit for bit,
    escapes, draws and every K7 counter; with the largest radiance error."""
    import torch
    from uivr_tpu_torch.ops.volpath_step import K7_COUNTERS
    eq = {"L": torch.equal(L, Lt), "escaped": torch.equal(escaped, et),
          "dim": torch.equal(stats["dim"], st["dim"])}
    eq.update({k: torch.equal(stats[k], st[k]) for k in K7_COUNTERS})
    return eq, float((L - Lt).abs().max())


def k7_counts(stats):
    """Sums of a K7 launch's per-lane counters and draws, with the share of
    fetched candidates that lay past a terminal event."""
    from uivr_tpu_torch.ops.volpath_step import K7_COUNTERS
    c = {k: int(stats[k].sum()) for k in K7_COUNTERS}
    c["dim"] = int(stats["dim"].sum())
    c["discarded_share"] = c["discarded"] / max(c["fetched"], 1)
    return c


def k7_bound(o, sc, c):
    """bound_ms of volpath_primal_k_kernel, the K2 row's rule: rays, grid,
    majorant and envmap tables read once (K6's table is not read: K6 is
    off), radiance and escapes written once, against the operations of this
    launch's cell steps and draws; and the fetch model's bound: 4 B of
    majorant per cell step, 128 B of corners per fetched candidate (the
    discarded ones too), 28 B per NEE sample, 36 B per ray."""
    em = sc.emitter
    n = o.shape[0]
    extra = c["dim"] - 2 * c["cell_steps"]
    proxy = getattr(em, "nee", None)
    tables = table_bytes(sc) + (0 if proxy is None else 4 * sum(
        t.numel() for t in (proxy.alias_tab, proxy.row_pmf, proxy.cond_pmf)))
    req = bound(24 * n + tables + 13 * n, *tracking_ops(c["cell_steps"], c["dim"]))
    gather, _ = bound(4 * c["cell_steps"] + 128 * c["fetched"] + 28 * extra / 5 + 36 * n, 0)
    return req, gather


def k7_runs(vs, cfg, sc, o, d, seed, measure=True):
    """K7 on one set of rays at K = 2, 4, 8, the persistent kernel against
    the one-ray-per-thread one: every lane equal (radiance bit for bit,
    escapes, draws, steps, the K7 counters), the lane utilization of both
    (the direct kernel's from its per-lane steps) and, with ``measure``,
    both times in turns (direct, persistent, persistent, direct), and the
    K=1 kernel's time (median of 3).  {K: record}; "out" holds the
    persistent kernel's outputs and stats."""
    import statistics

    import torch
    runs = {}
    if measure:
        out = vs.sample_primal_kernel(cfg, sc, o, d, seed, return_stats=True)
        torch.cuda.synchronize()
        ms = [cuda_ms(lambda: vs.sample_primal_kernel(cfg, sc, o, d, seed), 1)
              for _ in range(3)]
        runs[1] = {"out": out, "ms": statistics.median(ms), "ms_runs": ms,
                   "utilization": util_share(out[2]["util"])}
    for k in K7_KS[1:]:
        per = vs.sample_primal_kernel(cfg, sc, o, d, seed, return_stats=True, k_cand=k)
        direct = vs.sample_primal_kernel(cfg, sc, o, d, seed, return_stats=True, k_cand=k,
                                         direct=True)
        torch.cuda.synchronize()
        eq, _ = k7_equal(*per, *direct)
        eq["steps"] = torch.equal(per[2]["steps"], direct[2]["steps"])
        rec = {"out": per, "equal_to_direct": eq,
               "utilization": util_share(per[2]["util"]),
               "utilization_direct": warp_utilization(direct[2]["steps"])}
        if measure:
            d_ms, p_ms, t = turns_ms(
                lambda: vs.sample_primal_kernel(cfg, sc, o, d, seed, k_cand=k, direct=True),
                lambda: vs.sample_primal_kernel(cfg, sc, o, d, seed, k_cand=k))
            rec.update({"ms": p_ms, "ms_direct": d_ms, "turns_ms": t, "speedup": d_ms / p_ms})
        runs[k] = rec
        if not all(eq.values()):
            raise RuntimeError(f"K7 at K={k}: the persistent kernel differs from the direct "
                               f"one: {eq}")
    return runs


def k7_summary(runs):
    """The JSON-able part of k7_runs' records, with each K's counters."""
    return {k: dict({f: v for f, v in r.items() if f != "out"},
                    **({"counts": k7_counts(r["out"][2])} if k > 1 else {}))
            for k, r in runs.items()}


def k7_ptxas(vs):
    """ptxas' registers and spills of every K7 instantiation (persistent
    and direct) and of the K=1 persistent kernel."""
    return {k: v for k, v in ptxas_report(vs.BUILD["primal"]["log"]).items()
            if "primal_k" in k or "volpath_primal_kernel" in k}


def phase_k7_chunk(card, vs, cfg, sc, o, d, seed, dust=None, measure=True):
    """K7 at the render's chunk (janga-smoke, 2**20 rays): the persistent
    kernel against the one-ray-per-thread one at K = 2, 4, 8 on every lane,
    their utilizations and times in turns, the K=1 kernel's time, each K's
    counters; the K=4 kernel against the K=4 twin on every lane and the
    twin's time; ptxas' report of every K7 instantiation; ``dust`` (scene,
    o, d): the same on dust-devil's chunk, without the twin.  Without
    ``measure`` (``--quick``): the lane checks only, no twin."""
    import torch
    from uivr_tpu_torch.integrators import volpath_flat
    runs = k7_runs(vs, cfg, sc, o, d, seed, measure)
    rec = {"phase": "k7_chunk", "scene": "janga-smoke", "rays": o.shape[0],
           "runs": k7_summary(runs), "ptxas": k7_ptxas(vs), "card": card}
    if dust is not None:
        dsc, dout, dd = dust
        rec["dust_devil"] = {"rays": dout.shape[0],
                             "runs": k7_summary(k7_runs(vs, cfg, dsc, dout, dd, seed, measure))}
    if not measure:
        emit(rec)
        return rec
    t0 = time.perf_counter()
    twin = volpath_flat.sample_primal(cfg, sc, o, d, seed, return_stats=True, deferred=True,
                                      k_cand=4, max_iters=cfg.max_steps)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    eq, err = k7_equal(*runs[4]["out"], *twin)
    counts = {k: k7_counts(r["out"][2]) for k, r in runs.items() if k > 1}
    (b_ms, b_by), g_ms = k7_bound(o, sc, counts[4])
    rec.update({"equal_to_twin": eq, "max_abs_err": err,
                "ms": {k: r["ms"] for k, r in runs.items()},
                "ms_direct": {k: r["ms_direct"] for k, r in runs.items() if k > 1},
                "plain_ms": p_ms, "k1_steps": int(runs[1]["out"][2]["steps"].sum()),
                "counts": counts, "bound_ms": b_ms, "bound_by": b_by, "gather_bound_ms": g_ms,
                "means": {k: r["out"][0].mean(0).tolist() for k, r in runs.items()}})
    emit(rec)
    if not all(eq.values()) or err != 0.0:
        raise RuntimeError(f"K7: volpath_primal_k_kernel differs from the K=4 twin: {eq}")
    return rec


def k7_renders(b, st, seed, spp=64):
    """Full-frame renders of sensor 0 through render_image under
    UIVR_KCAND=1 and 4 in turns (1, 4, 4, 1): the images, mean host-clock
    seconds and the K7 launches of each K."""
    import os

    import torch
    from uivr_tpu_torch.ops import volpath_step as vs
    from uivr_tpu_torch.render import batched
    imgs, secs, k7 = {}, {1: [], 4: []}, {1: 0, 4: 0}
    for k in (1, 4, 4, 1):
        os.environ["UIVR_KCAND"] = str(k)
        before = vs.LAUNCHES["k_candidate"]
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = batched.render_image(st, b.params, b.emitter, b.cameras, 0, seed=seed,
                                       spp=spp, medium_to_world=b.to_world)
            secs[k].append(time.perf_counter() - t0)
        finally:
            del os.environ["UIVR_KCAND"]
        k7[k] += vs.LAUNCHES["k_candidate"] - before
        if k in imgs and not np.array_equal(imgs[k], img):
            raise RuntimeError(f"K={k}: a repeated render differs from the first")
        imgs[k] = img
    return imgs, {k: sum(v) / len(v) for k, v in secs.items()}, k7


def z_scores(pair):
    return [abs(m_) / max(s_, 1e-30) for m_, s_ in zip(pair["mean_diff"], pair["se_diff"])]


def phase_k7_unbiased(card, scenes):
    """janga-smoke and dust-devil, sensor 0 at 64 spp: the K=4 image against
    the K=1 image, per channel the paired per-pixel difference's mean within
    4 standard errors."""
    from uivr_tpu_torch.config import get_int_config
    from uivr_tpu_torch.render import batched
    out = {}
    for name, (preset, b, _) in scenes:
        cfg = get_int_config("volpathsimple-drt").create(max_depth=preset.max_depth)
        st = batched.RenderSettings(integrator=cfg, medium=b.medium_cfg, film_size=b.film_size,
                                    spp=64, spp_grad=64)
        imgs, secs, k7 = k7_renders(b, st, seed=1234)
        pair = paired_means(imgs[4], imgs[1])
        pair["z"] = z_scores(pair)
        W, H = b.film_size
        rec = {"phase": "k7_unbiased", "scene": name, "sensor": 0, "spp": 64,
               "rays": W * H * 64, "pair_k4_k1": pair, "limit_z": 4.0, "render_s": secs,
               "k_candidate_launches": k7, "card": card}
        emit(rec)
        if max(pair["z"]) > 4.0 or not (k7[4] > 0 and k7[1] == 0) \
                or not all(np.isfinite(i).all() for i in imgs.values()):
            raise RuntimeError(f"K7 {name}: K=4 is off the K=1 image (z = {pair['z']}) or the "
                               f"renders did not take K7 only at K=4 ({k7})")
        out[name] = rec
    return out


def phase_k7_train(card, vs, janga, out_dir, k1_train):
    """janga-smoke's full-width volpathsimple-drt run under UIVR_KCAND=4: two
    iterations and a truth step.  Per step 32 K7 launches (the forward's
    chunks), the replay and the DRT term's resumed primal at K=1 by the
    counters; check_step on the truth step; K7_SLICE rays of its first
    forward chunk against the K=4 twin keyed by their ray ids."""
    import torch
    from uivr_tpu_torch.integrators import volpath_flat
    train, first, truth = phase_train(card, vs, janga, out_dir / "k7", 2, 16, checkpoints=False,
                                      need=("k_candidate",), k_cand=4, ab=("truth_k7",))
    per_step = {}
    for tag, step in (("first", first), ("truth", truth)):
        c = step["counts"]
        per_step[tag] = {k: c[k] for k in ("volpath_primal", "k_candidate", "volpath_primal_state",
                                           "volpath_adjoint", "subcell_classification")}
        if not (c["k_candidate"] == 32 and c["volpath_primal"] == 33
                and c["volpath_primal_state"] == 1 and c["volpath_adjoint"] == 1):
            raise RuntimeError(f"K7 training {tag} step: expected 32 K7 forward launches, a K=1 "
                               f"replay and DRT resume: {c}")
    check = check_step(card, vs, "k7 truth", truth)
    f = truth["forward"]
    cfg, sc, o, d, seed = f["cfg"], f["scene"], f["o"], f["d"], f["seed"]
    L, e, st = vs.sample_primal_kernel(cfg, sc, o, d, seed, return_stats=True, k_cand=4)
    n = o.shape[0]
    lo = n - K7_SLICE
    t0 = time.perf_counter()
    twin = volpath_flat.sample_primal(cfg, sc, o[lo:], d[lo:], seed, return_stats=True,
                                      lane0=lo, deferred=True, k_cand=4,
                                      max_iters=cfg.max_steps)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    eq, err = k7_equal(L[lo:], e[lo:], {k: v[lo:] for k, v in st.items()}, *twin)
    eq["step_output"] = bool(torch.equal(L, f["L"]) and torch.equal(e, f["escaped"]))
    k1_fwd = k1_train["truth_step"]["parts_ms"]["forward_kernels"]
    rec = {"phase": "k7_train", "scene": "janga-smoke", "k_cand": 4, "per_step": per_step,
           "forward_chunk_rays": n, "slice": [lo, n], "slice_equal_to_twin": eq,
           "slice_max_abs_err": err, "slice_plain_ms": p_ms,
           "chunk_counts": k7_counts(st),
           "truth_forward_kernels_ms": train["truth_step"]["parts_ms"]["forward_kernels"],
           "truth_forward_kernels_ms_k1": k1_fwd,
           "truth_step_ms": train["truth_step"]["parts_ms"]["step"],
           "truth_step_ms_k1": k1_train["truth_step"]["parts_ms"]["step"],
           "truth_step_turns_k7_direct": train["step_turns"]["truth_k7"],
           "truth_loss": train["truth_step"]["loss"], "card": card}
    emit(rec)
    if not all(eq.values()) or err != 0.0:
        raise RuntimeError(f"K7 training forward: the kernel differs from the twin: {eq}")
    return train, first, rec, check


def phase_k7_xml(card, vs, cli_render, cfg, b, sc, random_pixel_rays, chunk, k1_render, out_dir):
    """janga-smoke XML with K7 and K3b together: 65,536 random-pixel rays at
    K=4 against the deferred K=4 twin on every lane, the kernel at K=4 and
    K=1 on the render's first chunk (in turns), and the render CLI under
    UIVR_KCAND=4 at 720x620: every walking launch took K3b and K7, no twin
    ran, the image within 4 standard errors of the K=1 render's.  Returns
    the twin's job (for run_twins) and ``finish(twin result, ms)``, which
    emits the record and runs the checks."""
    import os

    from uivr_tpu_torch.integrators import volpath_flat
    seed = 4242
    o, d = random_pixel_rays(b, 1 << 16)
    Lk, ek, sk = vs.sample_primal_kernel(cfg, sc, o, d, seed, return_stats=True, k_cand=4)
    co, cd = chunk
    k4_ms, k1_ms = on_off_ms(lambda: vs.sample_primal_kernel(cfg, sc, co, cd, 1234, k_cand=4),
                             lambda: vs.sample_primal_kernel(cfg, sc, co, cd, 1234), 2)
    for k in vs.LAUNCHES:
        vs.LAUNCHES[k] = 0
    for k in volpath_flat.CALLS:
        volpath_flat.CALLS[k] = 0
    os.environ["UIVR_KCAND"] = "4"
    try:
        img, dt = cli_render.main(["--scene", "janga-smoke", "--sensor", "0", "--spp", "64",
                                   "--out", str(out_dir / "janga-smoke-xml-s0-k4.exr")])
    finally:
        del os.environ["UIVR_KCAND"]
    launches, plain = dict(vs.LAUNCHES), dict(volpath_flat.CALLS)
    pair = paired_means(img, k1_render["image"])
    pair["z"] = z_scores(pair)
    W, H = b.film_size
    job = ("sample_primal", (0, 1, 2), (cfg, sc, o, d, seed),
           dict(return_stats=True, deferred=True, k_cand=4, max_iters=cfg.max_steps))

    def finish(twin, p_ms):
        eq, err = k7_equal(Lk, ek, sk, *twin)
        rec = {"phase": "k7_xml", "scene": "janga-smoke (XML)", "rays": o.shape[0],
               "equal_to_twin": eq, "max_abs_err": err, "plain_ms": p_ms,
               "counts": k7_counts(sk), "chunk_ms": {"k4": k4_ms, "k1": k1_ms},
               "render": {"spp": 64, "film": [W, H], "rays": W * H * 64, "seconds_k4": dt,
                          "seconds_k1": k1_render["seconds"],
                          "mrays_per_s_k4": W * H * 64 / dt / 1e6,
                          "launches": launches, "plain_twin_calls": plain, "pair_k4_k1": pair},
               "limit_z": 4.0, "card": card}
        emit(rec)
        if not all(eq.values()) or err != 0.0:
            raise RuntimeError(f"K7 with K3b: the kernel differs from the deferred twin: {eq}")
        if not (launches["volpath_primal"] > 0
                and launches["volpath_primal"] == launches["deferred_nee"]
                == launches["k_candidate"] and not any(plain.values())):
            raise RuntimeError(f"K7 XML render: not every launch took K3b and K7: {launches}, "
                               f"plain twin calls {plain}")
        if max(pair["z"]) > 4.0 or not np.isfinite(img).all():
            raise RuntimeError(f"K7 XML render: K=4 is off the K=1 image: z = {pair['z']}")
        return rec
    return job, finish


# ------------------------------------------------- persistent scheduling
# The walking kernels are persistent: lanes take rays from a work counter
# and a new one as soon as theirs ends.  The one-ray-per-thread kernels they
# replaced stay as ``direct`` launches, for comparison only.  With
# ``--sweep``, variants of the two libraries are built beside the package's:
# the minimum-blocks bound B of __launch_bounds__ (the package's:
# min_blocks()).
PERSIST_VARIANTS = {f"B{b}": [f"-DUIVR_MIN_BLOCKS={b}"] for b in (3, 4, 5, 6)}
# the package's own B (volpath_primal.cu, volpath_adjoint.cu) is not built again
PACKAGE_MIN_BLOCKS = {"primal": 5, "adjoint": 4}


def start_variant_builds():
    """Start nvcc on the primal and adjoint sources for each of
    PERSIST_VARIANTS into build/, beside the package's own build: {(lib,
    variant): (process, path)}."""
    from uivr_tpu_torch.ops import volpath_step as vs
    jobs = {}
    for key in ("primal", "adjoint"):
        for var, defs in PERSIST_VARIANTS.items():
            if var == f"B{PACKAGE_MIN_BLOCKS[key]}":
                continue
            out = vs.build_dir() / "variants" / f"libuivr_{key}-{var}.so"
            out.parent.mkdir(parents=True, exist_ok=True)
            proc = subprocess.Popen([vs._nvcc(), *vs.NVCC_FLAGS, *defs, "-o", str(out),
                                     str(vs.CSRC / vs.LIBS[key])],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[(key, var)] = (proc, out)
    return jobs


def finish_variant_builds(jobs):
    """Wait for the variant builds and load them: {(lib, variant): (ctypes
    library, ptxas report)}."""
    import ctypes

    from uivr_tpu_torch.ops import volpath_step as vs
    out = {}
    for (key, var), (proc, path) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {key} {var} failed:\n{log}")
        out[(key, var)] = (vs.bind(ctypes.CDLL(str(path)), key), ptxas_report(log))
    return out


class Direct:
    """Within: the wrappers' walking launches take the one-ray-per-thread
    kernels (``direct=True``; the DRT term's walk and NEE too), for the A/B
    of a whole training step; with ``k7_only`` only the K7 launches
    (``k_cand > 1``) do."""

    def __init__(self, vs, k7_only=False):
        self.vs, self.k7_only, self.saved = vs, k7_only, {}

    def __enter__(self):
        names = ("sample_primal_kernel",) if self.k7_only else (
            "sample_primal_kernel", "adjoint_walk_kernel", "drt_backward_kernel")
        for name in names:
            fn = getattr(self.vs, name)
            self.saved[name] = fn
            def run(*a, _fn=fn, **k):
                return _fn(*a, direct=not self.k7_only or k.get("k_cand", 1) > 1, **k)
            setattr(self.vs, name, run)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.vs, name, fn)


def warp_utilization(steps, width=32):
    """Busy share of the lane-iterations of a one-ray-per-thread launch:
    sum(steps) / (width * sum over groups of ``width`` consecutive rays of
    the group's longest walk)."""
    import torch
    s = steps.to(torch.int64)
    pad = (-s.numel()) % width
    g = torch.cat([s, s.new_zeros(pad)]).reshape(-1, width)
    return float(s.sum()) / max(float(g.max(dim=1).values.sum()) * width, 1.0)


def util_share(util):
    """Busy share of a persistent launch's lane-iterations, from its
    per-warp counters (lane-steps, iterations)."""
    c = util.sum(dim=0).tolist()
    return c[0] / max(32 * c[1], 1)


def turns_ms(a, b, reps=1):
    """CUDA-event times (ms) of two versions of a launch in turns (a, b, b,
    a), ``reps`` launches a turn: (mean of a, mean of b, the four times)."""
    t = [cuda_ms(f, reps) for f in (a, b, b, a)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def primal_equal(x, y):
    """Per-lane equality of two primal launches with stats: radiance bit for
    bit, escapes, draws, steps and K6's counters."""
    import torch
    (L1, e1, s1), (L2, e2, s2) = x, y
    eq = {"L": torch.equal(L1, L2), "escaped": torch.equal(e1, e2)}
    eq.update({k: torch.equal(s1[k], s2[k]) for k in ("dim", "steps", "cls")})
    return eq


def persistent_chunk(vs, name, cfg, sc, o, d, seed, path_state=None, measure=True):
    """One primal launch shape, direct against persistent: the lanes equal
    on every ray (primal_equal), the direct kernel's lane utilization by
    warps and by blocks of 128, the persistent one's from its counters, and
    (``measure``) both times in turns."""
    import torch
    args = (cfg, sc, o, d, seed)
    ps = dict(path_state=path_state)
    direct = vs.sample_primal_kernel(*args, return_stats=True, direct=True, **ps)
    per = vs.sample_primal_kernel(*args, return_stats=True, **ps)
    torch.cuda.synchronize()
    eq = primal_equal(per, direct)
    steps = direct[2]["steps"]
    rec = {"phase": "persistent_chunk", "launch": name,
           "rays": int(steps.numel()), "equal_to_direct": eq,
           "utilization_direct": warp_utilization(steps),
           "utilization_direct_blocks": warp_utilization(steps, 128),
           "tracking_steps": int(steps.sum()), "max_steps_lane": int(steps.max()),
           "median_steps_lane": float(steps.float().median())}
    if measure:
        rec["utilization_persistent"] = util_share(per[2]["util"])
        d_ms, p_ms, t = turns_ms(lambda: vs.sample_primal_kernel(*args, direct=True, **ps),
                                 lambda: vs.sample_primal_kernel(*args, **ps))
        rec.update({"ms_direct": d_ms, "ms_persistent": p_ms, "turns_ms": t,
                    "speedup": d_ms / p_ms})
    if not all(eq.values()):
        raise RuntimeError(f"{name}: the persistent primal differs from the direct kernel: {eq}")
    return rec, per


def persistent_adjoint(vs, cfg, sc, o, d, seed, dL, L, measure=True):
    """The adjoint at one shape, direct against persistent: per-ray outputs
    bit for bit (draws, alt draws, steps, events, K6's counters, the
    reservoir), gradients within a relative L1 of 1e-4 (the atomics' order
    follows the schedule), utilization and (``measure``) times in turns."""
    import torch
    args = (cfg, sc, o, d, seed, dL, L)
    acc_d, res_d, st_d = vs.adjoint_walk_kernel(*args, direct=True)
    acc_p, res_p, st_p = vs.adjoint_walk_kernel(*args, return_util=measure)
    torch.cuda.synchronize()
    eq = {k: torch.equal(st_p[k], st_d[k]) for k in ("dim", "alt_dim", "steps", "events", "cls")}
    eq.update({f"res_{f}": torch.equal(getattr(res_p, f), getattr(res_d, f))
               for f in res_p._fields})
    rel = {"sigma": rel_l1(acc_p.sigma, acc_d.sigma), "albedo": rel_l1(acc_p.albedo, acc_d.albedo)}
    rec = {"phase": "persistent_adjoint", "rays": o.shape[0], "equal_to_direct": eq,
           "rel_l1_to_direct": rel, "utilization_direct": warp_utilization(st_d["steps"]),
           "tracking_steps": int(st_d["steps"].sum()), "max_steps_lane": int(st_d["steps"].max())}
    if measure:
        rec["utilization_persistent"] = util_share(st_p["util"])
        d_ms, p_ms, t = turns_ms(lambda: vs.adjoint_walk_kernel(*args, direct=True),
                                 lambda: vs.adjoint_walk_kernel(*args))
        rec.update({"ms_direct": d_ms, "ms_persistent": p_ms, "turns_ms": t,
                    "speedup": d_ms / p_ms})
    if not all(eq.values()) or max(rel.values()) > 1e-4:
        raise RuntimeError(f"adjoint: the persistent kernel differs from the direct one: {eq}, "
                           f"{rel}")
    return rec, (acc_p, res_p, st_p)


def variant_primal(vs, lib, cfg, sc, o, d, seed):
    """The primal through a variant library's persistent launcher: (L,
    escaped)."""
    import ctypes

    import torch
    n, dev = o.shape[0], o.device
    L = torch.empty((n, 3), dtype=torch.float32, device=dev)
    esc = torch.empty((n,), dtype=torch.bool, device=dev)
    p = vs.primal_params(cfg, sc, o, d, seed, L, esc)
    counter, _ = vs.persistent_args(dev, False)
    rc = lib.volpath_primal_launch(ctypes.byref(p), 0, counter.data_ptr(), None,
                                   torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"variant primal launch failed ({rc})")
    return L, esc


def variant_adjoint(vs, lib, cfg, sc, o, d, seed, dL, L):
    """The adjoint through a variant library's persistent launcher: (acc,
    res, stats)."""
    import ctypes

    import torch
    from uivr_tpu_torch.scene.gradients import init_accum
    acc = init_accum(sc.medium, need_emission=False)
    a, res, st = vs.adjoint_params(cfg, sc, o, d, seed, dL, L, acc)
    counter, _ = vs.persistent_args(o.device, False)   # as the main path launches
    rc = lib.volpath_adjoint_launch(ctypes.byref(a), counter.data_ptr(), None,
                                    torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"variant adjoint launch failed ({rc})")
    return acc, res, st


def training_chunks(b, seed=77):
    """The rays of a training step's first forward chunk (batch 32,768
    pixels x 32 of its 1024 spp, as _primal_image splits it) and of its
    adjoint pass (x 16 spp: 524,288 rays), from the training sensors, as
    opt.loop draws them."""
    import torch
    from uivr_tpu_torch.core.rng import sample_tea_32
    from uivr_tpu_torch.render import batched
    dev = b.params.sigma_t.device
    sidx, pix = batched.sample_batch_pixels(seed, b.cameras.n_sensors, b.film_size, 32768,
                                            sensors=b.sensors or None, device=dev)
    fwd = batched._expand_rays(b.cameras, sidx, pix, b.film_size, 32,
                               sample_tea_32(seed, 1000)[0])
    adj = batched._expand_rays(b.cameras, sidx, pix, b.film_size, 16,
                               sample_tea_32(seed, 39)[0])
    return tuple(t.contiguous() for t in fwd), tuple(t.contiguous() for t in adj)


def phase_persistent(card, vs, dev, janga, dust, render_chunk, variants, measure=True):
    """The persistent walking kernels against the direct ones at the main
    path's shapes (janga-smoke's render chunk and a truth training step's
    forward chunk, replay, adjoint, DRT walk, NEE and the path state's
    primal; dust-devil's render chunk): equal on every lane, utilization
    before and after, and with ``measure`` times in turns.  With
    ``variants`` (``--sweep``): the minimum-blocks sweep (ptxas' registers
    and spills, times).
    Returns {launch: record} for the kernels line."""
    import torch
    from uivr_tpu_torch.config import get_int_config
    from uivr_tpu_torch.integrators.volpathsimple import _reservoir_get
    from uivr_tpu_torch.scene.gradients import init_accum
    preset, b, sc = janga
    cfg = get_int_config("volpathsimple-drt").create(max_depth=preset.max_depth)
    out = {}
    co, cd = render_chunk(b)
    out["render_chunk"], _ = persistent_chunk(vs, "janga-smoke render chunk", cfg, sc, co, cd,
                                              1234, measure=measure)
    (fo, fd), (ao, ad) = training_chunks(b)
    seed = 4243
    out["forward_chunk"], fwd = persistent_chunk(vs, "janga-smoke truth forward chunk", cfg, sc,
                                                 fo, fd, seed, measure=measure)
    out["replay"], rep = persistent_chunk(vs, "janga-smoke truth replay", cfg, sc, ao, ad, seed + 1,
                                          measure=measure)
    n = ao.shape[0]
    dL = torch.from_numpy(np.random.RandomState(11).rand(n, 3).astype(np.float32) / n).to(dev)
    out["adjoint"], (acc, res, st_adj) = persistent_adjoint(vs, cfg, sc, ao, ad, seed + 1, dL,
                                                            rep[0], measure=measure)
    adjoint = _reservoir_get(res) * dL
    _, drt = vs.drt_backward_kernel(cfg, sc, seed + 1, res, adjoint,
                                    init_accum(sc.medium, need_emission=False), return_stats=True)
    walk, nee = drt_turns(vs, cfg, sc, seed + 1, res, adjoint, measure)
    common = dict(phase="persistent_drt", reservoirs=n)
    out["drt_walk"] = dict(walk, launch="janga-smoke truth DRT walk", **common)
    out["drt_nee"] = dict(nee, launch="janga-smoke truth DRT NEE", **common)
    from uivr_tpu_torch.core.rng import sample_tea_32
    rec_seed, _ = sample_tea_32(seed + 1, 0x7177)
    out["state"], _ = persistent_chunk(vs, "janga-smoke truth DRT resume", cfg, sc, None, None,
                                       rec_seed, path_state=drt["path_state"], measure=measure)
    dco, dcd = render_chunk(dust[1])
    dcfg = get_int_config("volpathsimple-drt").create(max_depth=dust[0].max_depth)
    out["dust_chunk"], _ = persistent_chunk(vs, "dust-devil render chunk", dcfg, dust[2], dco, dcd,
                                            1234, measure=measure)
    for v in out.values():
        emit(dict(v, card=card))
    if not (measure and variants):
        return out
    # the minimum-blocks sweep: each variant build of
    # the primal on the forward chunk and of the adjoint at the replay's
    # shape, against the package's build in turns (package, variant,
    # variant, package), equal to it lane for lane
    package_b = {k: vs._load(k).min_blocks() for k in ("primal", "adjoint")}
    if package_b != PACKAGE_MIN_BLOCKS:
        raise RuntimeError(f"the package's minimum blocks are {package_b}, "
                           f"PACKAGE_MIN_BLOCKS says {PACKAGE_MIN_BLOCKS}")
    L_pkg, e_pkg = fwd[0], fwd[1]
    adj_args = (cfg, sc, ao, ad, seed + 1, dL, rep[0])
    sweep = {"primal": {f"B{package_b['primal']}": "package"},
             "adjoint": {f"B{package_b['adjoint']}": "package"}}
    for (key, var), (lib, ptx) in variants.items():
        if key == "primal":
            Lv, ev = variant_primal(vs, lib, cfg, sc, fo, fd, seed)
            same = {"L": torch.equal(Lv, L_pkg), "escaped": torch.equal(ev, e_pkg)}
            pkg_ms, v_ms, t = turns_ms(
                lambda: vs.sample_primal_kernel(cfg, sc, fo, fd, seed),
                lambda: variant_primal(vs, lib, cfg, sc, fo, fd, seed))
            name = "volpath_primal_kernel"
        else:
            acc_v, res_v, st_v = variant_adjoint(vs, lib, *adj_args)
            same = {"dim": torch.equal(vs._u32(st_v["dim"]), st_adj["dim"]),
                    "reservoir_depth": torch.equal(res_v.depth, res.depth),
                    "sigma_rel_l1_le_1e-4": rel_l1(acc_v.sigma, acc.sigma) <= 1e-4}
            pkg_ms, v_ms, t = turns_ms(lambda: vs.adjoint_walk_kernel(*adj_args),
                                       lambda: variant_adjoint(vs, lib, *adj_args))
            name = "volpath_adjoint_kernel"
        sweep[key][var] = {"ms": v_ms, "ms_package": pkg_ms, "turns_ms": t,
                           "equal_to_package": same,
                           "ptxas": {k: v_ for k, v_ in ptx.items() if name in k}}
        if not all(same.values()):
            raise RuntimeError(f"persistent {key} variant {var} differs from the package's "
                               f"build: {same}")
    rec = {"phase": "persistent", "scene": "janga-smoke",
           "package_min_blocks": package_b, "sweep": sweep, "card": card}
    emit(rec)
    out["sweep"] = rec
    return out


# ------------------------------------------------------------- XML scenes
# The janga-smoke and dust-devil presets load Mitsuba XML scenes whose
# assets the repository does not hold.  write_standins writes assets of the
# shapes the XML files and the presets' scene vars name, from a seed, into a
# scene directory beside copies of the XML files; UIVR_SCENE_DIR points the
# registry there.  Only the assets' contents are stand-ins.
STANDINS = {
    "janga-smoke": {"sigma": ("volumes/janga-smoke-264-136-136.vol", (136, 264, 136)),
                    "albedo": ("volumes/albedo-noise-256-128-128.vol", (128, 256, 128)),
                    "envmap": ("textures/gamrig_2k.hdr", (1024, 2048))},
    "dust-devil": {"sigma": ("volumes/embergen_dust_devil_tornado_a_50-256-256-256.vol",
                             (256, 256, 256)),
                   "albedo": ("volumes/albedo-constant-sand-256-256-256.vol", (256, 256, 256)),
                   "envmap": ("textures/kloofendal_38d_partly_cloudy_4k.exr", (2048, 4096))},
}


def plume(shape, rs):
    """A smoke-like density on a (D, H, W) grid over the unit cube: 24
    Gaussian blobs with a falloff in height, peak 1 (float32)."""
    z, y, x = (np.linspace(0, 1, n, dtype=np.float32) for n in shape)
    out = np.zeros(shape, np.float32)
    for _ in range(24):
        c = (rs.rand(3) * 0.7 + 0.15).astype(np.float32)
        s = np.float32(rs.rand() * 0.12 + 0.04)
        a = np.float32(rs.rand() * 1.2)
        gx, gy, gz = (np.exp(-(v - cv) ** 2 / (2 * s * s)) for v, cv in zip((x, y, z), c))
        out += a * gz[:, None, None] * gy[None, :, None] * gx[None, None, :]
    out *= np.exp(-2.5 * np.abs(y - 0.4))[None, :, None]
    return out / out.max()


def write_standins(root, seed=20261017):
    """Stand-in assets for the janga-smoke and dust-devil XML scenes under
    ``root``, each beside a copy of its XML file; returns seconds per scene."""
    import shutil
    from uivr_tpu_torch.config.scenes import procedural_sky
    from uivr_tpu_torch.core import exr_io, hdr_io, vol_io
    rs = np.random.RandomState(seed)
    seconds = {}
    for name, files in STANDINS.items():
        t0 = time.perf_counter()
        d = root / name
        (d / "volumes").mkdir(parents=True, exist_ok=True)
        (d / "textures").mkdir(parents=True, exist_ok=True)
        shutil.copy(HERE / "scenes" / name / f"{name}.xml", d / f"{name}.xml")
        path, shape = files["sigma"]
        vol_io.write_vol(str(d / path), plume(shape, rs)[..., None])
        path, shape = files["albedo"]
        if name == "janga-smoke":   # noise in [0.5, 0.95]
            alb = rs.uniform(0.5, 0.95, shape + (3,)).astype(np.float32)
        else:                       # a constant sand colour
            alb = np.broadcast_to(np.array([0.76, 0.62, 0.45], np.float32), shape + (3,))
        vol_io.write_vol(str(d / path), alb)
        path, (h, w) = files["envmap"]
        sky = procedural_sky(h, w)
        if path.endswith(".hdr"):
            hdr_io.write_hdr(str(d / path), sky)
        else:
            exr_io.write_exr(str(d / path), sky, compression="none")
        seconds[name] = time.perf_counter() - t0
    return seconds


def xml_scene(name, dev, ref=False):
    """(preset, bundle, scene) of an XML preset from $UIVR_SCENE_DIR: the
    training scene, or the reference scene with ``ref``."""
    from uivr_tpu_torch.config import get_scene_config
    from uivr_tpu_torch.scene.medium import finalize_medium
    from uivr_tpu_torch.scene.scene import Scene
    preset = get_scene_config(name)
    b = preset.build_ref(device=dev) if ref else preset.build(device=dev)
    return preset, b, Scene(finalize_medium(b.params, b.medium_cfg, b.to_world),
                            b.emitter, b.cameras)


def full_res(sc):
    """The same scene with K3 instead of K3b: its envmap without the coarse
    proxy, which is what make_envmap(data, nee_max_texels=0) builds."""
    return sc._replace(emitter=sc.emitter._replace(nee=None))


def xml_scene_record(name, b, sc, seconds):
    m, em = sc.medium, sc.emitter
    return {"phase": "xml_scene", "scene": name, "load_s": seconds,
            "film": list(b.film_size), "sensors": b.cameras.n_sensors,
            "training_sensors": len(b.sensors) if b.sensors else None,
            "sigma_t": list(b.params.sigma_t.shape), "albedo": list(b.params.albedo.shape),
            "majorant_resolution_factor": b.medium_cfg.majorant_factor,
            "majorant_cells": list(m.majorant_grid.shape),
            "subcells": list(m.sub.shape) if m.sub is not None else None,
            "envmap": list(em.data.shape[:2]), "envmap_texels": em.data.shape[0] * em.data.shape[1],
            "proxy": list(em.nee.data.shape[:2]) if em.nee is not None else None,
            "medium_to_world": np.asarray(b.to_world).round(6).tolist()}


def render_each(b, settings, seed, spp, turns=False, sensor=0):
    """Full-frame renders of ``sensor`` through ``render_image``, one per
    entry of ``settings`` (name -> (RenderSettings, emitter)), or in turns
    (a, b, b, a) with ``turns``: the images and each one's mean host-clock
    seconds."""
    import torch
    from uivr_tpu_torch.render import batched
    names = list(settings)
    imgs, secs = {}, {k: [] for k in names}
    for k in (names + names[::-1] if turns else names):
        st, emitter = settings[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs[k] = batched.render_image(st, b.params, emitter, b.cameras, sensor,
                                       seed=seed, spp=spp, medium_to_world=b.to_world)
        secs[k].append(time.perf_counter() - t0)
    return imgs, {k: sum(v) / len(v) for k, v in secs.items()}


def paired_means(a, b):
    """Per channel: the image means of ``a`` and ``b``, the mean of their
    per-pixel difference and its standard error from the per-pixel spread."""
    diff = (a - b).reshape(-1, 3).astype(np.float64)
    n = diff.shape[0]
    return {"mean_a": a.reshape(-1, 3).mean(0).tolist(), "mean_b": b.reshape(-1, 3).mean(0).tolist(),
            "mean_diff": diff.mean(0).tolist(),
            "se_diff": (diff.std(0, ddof=1) / math.sqrt(n)).tolist()}


def k3b_chunk_bound(o, sc, stats):
    """bound_ms of volpath_primal with K3b on one chunk: rays, grid,
    majorant, subcell table, the full-resolution map (radiance) and the
    proxy's tables read once, radiance and escapes written once, against
    the operations of this chunk's tracking steps and draws; and the fetch
    model's bound (132 B per event, 8 B if K6 classified it, 28 B per NEE
    sample: 16 B of proxy table and 12 B of radiance, 36 B per ray)."""
    m, em = sc.medium, sc.emitter
    n = o.shape[0]
    steps = int(stats["steps"].sum())
    extra = int(stats["dim"].sum()) - 2 * steps
    tables = m.grid.numel() + m.majorant_grid.numel() + m.sub.numel() + em.data.numel() \
        + sum(t.numel() for t in (em.nee.alias_tab, em.nee.row_pmf, em.nee.cond_pmf))
    req = bound(24 * n + 4 * tables + 13 * n, *tracking_ops(steps, 2 * steps + extra))
    gather, _ = bound(event_fetch_bytes(steps, cls_counts(stats["cls"])) + 28 * extra / 5
                      + 36 * n, 0)
    return req, gather, {"tracking_steps": steps, "extra_draws": extra}


def phase_xml(card, vs, dev, out_dir, random_pixel_rays, render_chunk, ab=()):
    """The XML path: janga-smoke's XML preset at full width (render CLI,
    K3b against its plain version and against K3, run_optimization; ``ab``
    its steps timed direct against persistent, as phase_train's) and
    dust-devil's 4k map (render, K3b and K3 timed in turns).  Returns the
    kernels-line entry of K3b and the XML records."""
    import os
    import tempfile

    import torch
    from uivr_tpu_torch.cli import render as cli_render
    from uivr_tpu_torch.config import get_int_config
    from uivr_tpu_torch.core import exr_io
    from uivr_tpu_torch.integrators import volpath_flat
    from uivr_tpu_torch.render import batched
    tmp = tempfile.TemporaryDirectory(prefix="uivr_scenes_", dir=out_dir)
    root = Path(tmp.name)
    asset_s = write_standins(root)
    os.environ["UIVR_SCENE_DIR"] = str(root)
    try:
        return _xml_phases(card, vs, dev, out_dir, random_pixel_rays, render_chunk, ab,
                           asset_s, cli_render, get_int_config, exr_io, volpath_flat,
                           batched, torch)
    finally:
        del os.environ["UIVR_SCENE_DIR"]
        tmp.cleanup()


def _xml_phases(card, vs, dev, out_dir, random_pixel_rays, render_chunk, ab, asset_s,
                cli_render, get_int_config, exr_io, volpath_flat, batched, torch):
    out = {}
    # ----------------------------------------------------------- xml-render
    exr = out_dir / "janga-smoke-xml-s0.exr"
    for k in vs.LAUNCHES:
        vs.LAUNCHES[k] = 0
    for k in volpath_flat.CALLS:
        volpath_flat.CALLS[k] = 0
    t0 = time.perf_counter()
    img, dt = cli_render.main(["--scene", "janga-smoke", "--sensor", "0", "--spp", "64",
                               "--out", str(exr)])
    cli_s = time.perf_counter() - t0
    k1_render = {"image": img, "seconds": dt}
    launches, plain = dict(vs.LAUNCHES), dict(volpath_flat.CALLS)
    back = exr_io.read_exr(str(exr))
    t0 = time.perf_counter()
    preset, b, sc = xml_scene("janga-smoke", dev)
    load_s = time.perf_counter() - t0
    emit(dict(xml_scene_record("janga-smoke", b, sc, load_s), assets_s=asset_s, card=card))
    W, H = b.film_size
    rays = W * H * 64
    rec = {"phase": "xml_render", "scene": "janga-smoke", "sensor": 0, "spp": 64,
           "film": [W, H], "rays": rays, "seconds": dt, "cli_seconds": cli_s,
           "mrays_per_s": rays / dt / 1e6, "image_mean": img.reshape(-1, 3).mean(0).tolist(),
           "launches": launches, "plain_twin_calls": plain, "exr_shape": list(back.shape),
           "exr_matches": bool(np.array_equal(back, img)), "card": card}
    emit(rec)
    if not (launches["volpath_primal"] > 0
            and launches["deferred_nee"] == launches["volpath_primal"]
            and launches["subcell_classification"] > 0 and not any(plain.values())):
        raise RuntimeError(f"janga-smoke XML: the render did not run K3b in the kernel: "
                           f"{launches}, plain twin calls {plain}")
    if back.shape != (H, W, 3) or not np.isfinite(back).all() or not np.array_equal(back, img):
        raise RuntimeError("janga-smoke XML: the rendered EXR is malformed")
    out["render"] = rec

    # ------------------------------------- K3b against its plain version
    # the kernels and their times first (random-pixel rays, the render's
    # chunk, K7), then the four twins two at a time (run_twins), then the
    # records and their checks
    cfg = get_int_config("volpathsimple-drt").create(max_depth=preset.max_depth)
    seed = 4242
    o, d = random_pixel_rays(b, 1 << 16)
    Lk, ek, sk = vs.sample_primal_kernel(cfg, sc, o, d, seed, return_stats=True)
    Lf, _ = vs.sample_primal_kernel(cfg, full_res(sc), o, d, seed)
    n = 8192
    ao, ad = random_pixel_rays(b, n)
    dL = torch.from_numpy(np.random.RandomState(7).rand(n, 3).astype(np.float32) / n).to(dev)
    La, _ = vs.sample_primal_kernel(cfg, sc, ao, ad, seed)
    for k in vs.LAUNCHES:
        vs.LAUNCHES[k] = 0
    acc_k, res_k, st_k = vs.adjoint_walk_kernel(cfg, sc, ao, ad, seed, dL, La)
    adj_deferred = vs.LAUNCHES["deferred_nee"]
    # K3b at the render's chunk: its time against K3's, its bound
    co, cd = render_chunk(b)
    seed0 = 1234
    Lc, ec, ck = vs.sample_primal_kernel(cfg, sc, co, cd, seed0, return_stats=True)
    torch.cuda.synchronize()
    k3b_ms, k3_ms = on_off_ms(lambda: vs.sample_primal_kernel(cfg, sc, co, cd, seed0),
                              lambda: vs.sample_primal_kernel(cfg, full_res(sc), co, cd, seed0), 2)
    (b_ms, b_by), g_ms, counts = k3b_chunk_bound(co, sc, ck)
    # the persistent kernel against the one-ray-per-thread one on this chunk
    rec, _ = persistent_chunk(vs, "janga-smoke XML render chunk (K3b)", cfg, sc, co, cd, seed0)
    emit(dict(rec, card=card))
    out["persistent"] = rec
    # K7 with K3b on this scene
    k7_job, k7_finish = phase_k7_xml(card, vs, cli_render, cfg, b, sc, random_pixel_rays,
                                     (co, cd), k1_render, out_dir)
    primal_twin, adj_twin, chunk_twin, k7_twin = run_twins([
        ("sample_primal", (0, 1, 2), (cfg, sc, o, d, seed),
         dict(return_stats=True, deferred=True, max_iters=cfg.max_steps)),
        ("adjoint_walk", (0, 1, 2), (cfg, sc, ao, ad, seed, dL, La), dict(deferred=True)),
        ("sample_primal", (0, 1, 2), (cfg, sc, co, cd, seed0),
         dict(return_stats=True, deferred=True, max_iters=cfg.max_steps)),
        k7_job])

    (Lp, ep, sp), p_ms = primal_twin
    agree = lane_agreement(Lk, Lp)
    mk, mp = Lk.mean(0).tolist(), Lp.mean(0).tolist()
    means_ok = all(abs(a - b_) <= 0.02 * abs(b_) for a, b_ in zip(mk, mp))
    rec = {"phase": "k3b_primal", "scene": "janga-smoke (XML)", "rays": o.shape[0],
           "agreement": agree, "need": 0.90, "same_draws": equal_frac(sk["dim"], sp["dim"]),
           "escaped_equal": equal_frac(ek, ep), "mean_kernel": mk, "mean_plain": mp,
           "max_abs_err": float((Lk - Lp).abs().max()), "plain_ms": p_ms,
           "lanes_differing_from_k3": float((Lk != Lf).any(dim=-1).float().mean()),
           "card": card}
    emit(rec)
    if agree < 0.90 or not means_ok:
        raise RuntimeError("K3b: volpath_primal disagrees with the deferred twin")
    out["primal"] = rec
    (acc_t, res_t, st_t), adj_plain_ms = adj_twin
    agree = {"dim": equal_frac(st_k["dim"], st_t["dim"]),
             "alt_dim": equal_frac(st_k["alt_dim"], st_t["alt_dim"]),
             "reservoir_depth": equal_frac(res_k.depth, res_t.depth)}
    rel = {"sigma": rel_l1(acc_k.sigma, acc_t.sigma), "albedo": rel_l1(acc_k.albedo, acc_t.albedo)}
    rec = {"phase": "k3b_adjoint", "scene": "janga-smoke (XML)", "rays": n,
           "agreement": agree, "need": 0.90, "rel_l1": rel, "plain_ms": adj_plain_ms,
           "deferred_launches": adj_deferred, "grad_abs_sum": float(acc_t.sigma.abs().sum()),
           "card": card}
    emit(rec)
    if min(agree.values()) < 0.90 or max(rel.values()) > 1e-2 or adj_deferred != 1 \
            or not rec["grad_abs_sum"] > 0:
        raise RuntimeError("K3b: volpath_adjoint disagrees with the deferred twin")
    (Lp, ep, sp), p_ms = chunk_twin
    agree = lane_agreement(Lc, Lp)
    mk, mp = Lc.mean(0).tolist(), Lp.mean(0).tolist()
    means_ok = all(abs(a - b_) <= 0.02 * abs(b_) for a, b_ in zip(mk, mp))
    rec = {"phase": "k3b_chunk", "scene": "janga-smoke (XML)", "rays": co.shape[0],
           "agreement": agree, "need": 0.90, "same_draws": equal_frac(ck["dim"], sp["dim"]),
           "escaped_equal": equal_frac(ec, ep), "mean_kernel": mk, "mean_plain": mp,
           "max_abs_err": float((Lc - Lp).abs().max()), "plain_ms": p_ms,
           "ms": {"k3b": k3b_ms, "k3": k3_ms}, "card": card}
    emit(rec)
    if agree < 0.90 or not means_ok:
        raise RuntimeError("K3b: volpath_primal disagrees with the deferred twin on the "
                           "render's chunk")
    out["chunk"] = rec
    out["k7"] = k7_finish(*k7_twin)

    # ---------------------------------------------------------- unbiasedness
    # K3b and K3 against each other and against the estimator without NEE
    # (escapes only, no alias table), whose mean is that of the same
    # integral; pixels are independent, so the per-pixel spread of each
    # paired difference gives its standard error
    st = batched.RenderSettings(integrator=cfg, medium=b.medium_cfg, film_size=b.film_size,
                                spp=256, spp_grad=256)
    no_nee = dataclasses.replace(st, integrator=dataclasses.replace(cfg, use_nee=False))
    imgs, secs = render_each(b, {"k3b": (st, sc.emitter), "k3": (st, full_res(sc).emitter),
                                 "no_nee": (no_nee, sc.emitter)}, seed=99, spp=256)
    pairs = {f"{a}-{c_}": paired_means(imgs[a], imgs[c_])
             for a, c_ in (("k3b", "no_nee"), ("k3", "no_nee"), ("k3b", "k3"))}
    for v in pairs.values():
        v["z"] = [abs(m_) / max(s_, 1e-30) for m_, s_ in zip(v["mean_diff"], v["se_diff"])]
    rec = {"phase": "unbiased", "scene": "janga-smoke (XML)", "sensor": 0, "spp": 256,
           "rays": W * H * 256, "pairs": pairs, "limit_z": 4.0, "render_s": secs,
           "chunk_ms": {"k3b": k3b_ms, "k3": k3_ms}, "card": card}
    emit(rec)
    if max(pairs["k3b-no_nee"]["z"]) > 4.0 or not all(np.isfinite(i).all() for i in imgs.values()):
        raise RuntimeError(f"K3b is off the no-NEE estimate: z = {pairs['k3b-no_nee']['z']}")
    out["unbiased"] = rec

    # ---------------------------------------------------------- xml-train
    ref = xml_scene("janga-smoke", dev, ref=True)
    train, first, truth = phase_train(card, vs, (preset, b, sc), out_dir / "xml", 2, 4,
                                      checkpoints=False, ref_bundle=ref[1],
                                      need=("deferred_nee",), ab=ab)
    grads = [s_["grads"] for s_ in (first, truth)]
    emit({"phase": "xml_train_grads", "scene": "janga-smoke (XML)",
          "grads_abs_sum": {tag: [float(g.sigma_t.abs().sum()), float(g.albedo.abs().sum())]
                            for tag, g in zip(("first", "truth"), grads)}, "card": card})
    if not all(torch.isfinite(g.sigma_t).all() and torch.isfinite(g.albedo).all()
               and g.sigma_t.abs().sum() > 0 and g.albedo.abs().sum() > 0 for g in grads):
        raise RuntimeError("janga-smoke XML training: the gradients are not finite and nonzero")
    launches = train["launches"]
    walking = launches["volpath_primal"] + launches["volpath_primal_state"] \
        + launches["volpath_adjoint"]
    if launches["deferred_nee"] != walking:
        raise RuntimeError(f"janga-smoke XML training: K3b ran in {launches['deferred_nee']} "
                           f"of {walking} walking launches")
    for tag, step in (("first", first), ("truth", truth)):
        c = step["counts"]
        step_walking = c["volpath_primal"] + c["volpath_primal_state"] + c["volpath_adjoint"]
        if not (c["volpath_adjoint"] == 1 and c["volpath_primal_state"] == 1
                and c["deferred_nee"] == step_walking):
            raise RuntimeError(f"janga-smoke XML {tag} step: K3b ran in {c['deferred_nee']} "
                               f"of {step_walking} walking launches: {c}")
    # the step's adjoint slice and DRT term (with K3b in its resumed primal)
    # against the deferred twins, on the step's own inputs
    out["check"] = check_step(card, vs, "janga-smoke XML truth", truth)
    out["train"] = train

    # ---------------------------------------------------- dust-devil (4k map)
    t0 = time.perf_counter()
    _, db, dsc = xml_scene("dust-devil", dev)
    emit(dict(xml_scene_record("dust-devil", db, dsc, time.perf_counter() - t0), card=card))
    dst = batched.RenderSettings(integrator=cfg, medium=db.medium_cfg, film_size=db.film_size,
                                 spp=64, spp_grad=64)
    for k in vs.LAUNCHES:
        vs.LAUNCHES[k] = 0
    dimgs, dsecs = render_each(db, {"k3b": (dst, dsc.emitter), "k3": (dst, full_res(dsc).emitter)},
                               seed=1234, spp=64, turns=True)
    dl = dict(vs.LAUNCHES)
    d_no_nee = dataclasses.replace(dst, integrator=dataclasses.replace(cfg, use_nee=False))
    nimg, nsecs = render_each(db, {"no_nee": (d_no_nee, dsc.emitter)}, seed=1234, spp=64)
    dimgs.update(nimg)
    dsecs.update(nsecs)
    dpairs = {f"{a}-{c_}": paired_means(dimgs[a], dimgs[c_])
              for a, c_ in (("k3b", "no_nee"), ("k3", "no_nee"), ("k3b", "k3"))}
    for v in dpairs.values():
        v["z"] = [abs(m_) / max(s_, 1e-30) for m_, s_ in zip(v["mean_diff"], v["se_diff"])]
    dco, dcd = render_chunk(db)
    d3b_ms, d3_ms = on_off_ms(lambda: vs.sample_primal_kernel(cfg, dsc, dco, dcd, seed0),
                              lambda: vs.sample_primal_kernel(cfg, full_res(dsc), dco, dcd, seed0),
                              2)
    dW, dH = db.film_size
    rec = {"phase": "xml_render", "scene": "dust-devil", "sensor": 0, "spp": 64,
           "film": [dW, dH], "rays": dW * dH * 64, "render_s": dsecs,
           "mrays_per_s": {k: dW * dH * 64 / v / 1e6 for k, v in dsecs.items()},
           "chunk_ms": {"k3b": d3b_ms, "k3": d3_ms}, "launches": dl,
           "pairs": dpairs, "limit_z": 4.0, "card": card}
    emit(rec)
    if not (dl["deferred_nee"] > 0 and dl["deferred_nee"] < dl["volpath_primal"]) \
            or not all(np.isfinite(i).all() for i in dimgs.values()):
        raise RuntimeError("dust-devil XML: the renders failed their checks")
    if max(dpairs["k3b-no_nee"]["z"]) > 4.0:
        raise RuntimeError(f"dust-devil XML: K3b is off the no-NEE estimate: "
                           f"z = {dpairs['k3b-no_nee']['z']}")
    out["dust"] = rec

    kernel = {
        "name": "deferred_nee", "route": "cuda", "source": "uivr_tpu_torch/ops/csrc/volpath_lane.cuh",
        "replaces": "uivr_tpu/ops/volpath_step.py:606", "launches": launches["deferred_nee"],
        "launches_per_train_step": first["counts"]["deferred_nee"],
        "max_abs_err": out["chunk"]["max_abs_err"], "agreement": out["chunk"]["agreement"],
        "ms": k3b_ms, "ms_k3": k3_ms, "plain_ms": out["chunk"]["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "gather_bound_ms": g_ms, "library_ms": None,
        "shape": f"volpath_primal with K3b, {co.shape[0]} rays, janga-smoke XML sensor 0 "
                 "(2,097,152-texel map, 2,048-texel proxy)",
        "dust_devil_4k": {"ms": d3b_ms, "ms_k3": d3_ms, "shape": f"{dco.shape[0]} rays"},
        **counts}
    return kernel, out


def phase_xml_chunk_quick(card, vs, dev, render_chunk):
    """janga-smoke XML's render chunk (K3b), direct against persistent, on
    stand-in assets (as phase_xml writes them)."""
    import os
    import tempfile

    from uivr_tpu_torch.config import get_int_config
    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(prefix="uivr_scenes_", dir=out_dir)
    write_standins(Path(tmp.name))
    os.environ["UIVR_SCENE_DIR"] = tmp.name
    try:
        preset, b, sc = xml_scene("janga-smoke", dev)
        cfg = get_int_config("volpathsimple-drt").create(max_depth=preset.max_depth)
        co, cd = render_chunk(b)
        rec, _ = persistent_chunk(vs, "janga-smoke XML render chunk (K3b)", cfg, sc, co, cd, 1234,
                                  measure=False)
        emit(dict(rec, card=card))
    finally:
        del os.environ["UIVR_SCENE_DIR"]
        tmp.cleanup()


NESTED_BUDGET_S = 120.0   # the quadratic adjoint at the largest depth that fits
NESTED_DEPTHS = (16, 64)    # tried in turn while the predicted time fits; 8 if 16 does not


def nested_seconds(fn):
    """``fn()``'s result, its seconds on the host clock and from CUDA
    events, and the wavefront iterations (host syncs) it ran."""
    import torch
    from uivr_tpu_torch.tracking.trackers import WAVEFRONT
    torch.cuda.synchronize()
    it0 = WAVEFRONT["iterations"]
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    iters = WAVEFRONT["iterations"] - it0
    return out, {"host_s": host, "event_s": e0.elapsed_time(e1) / 1e3,
                 "wavefront_iterations": iters,
                 "ms_per_iteration": host * 1e3 / iters if iters else None}


def fixed_cube_rays(b, dev, rep):
    """tests/test_integrators.py's fixed rays: 16 pixels of sensor 0 in
    the film's middle half, each ``rep`` times."""
    import torch
    from uivr_tpu_torch.scene.camera import sample_rays
    xs, ys = np.meshgrid(np.arange(4), np.arange(4))
    uv = (np.stack([xs.ravel(), ys.ravel()], -1) + 0.5) / 4.0 * 0.5 + 0.25
    uv = torch.from_numpy(np.tile(uv, (rep, 1)).astype(np.float32)).to(dev)
    return sample_rays(b.cameras, torch.zeros(uv.shape[0], dtype=torch.int64, device=dev), uv)


NESTED_SEEDS_HERE = 2   # (a)'s seeds run in this process; the others in the workers
NESTED_CONFIGS = {   # (a)'s estimators, all with NEE at max_depth 16
    "basic": dict(use_drt=False, engine="nested"),
    "drt": dict(engine="nested"),
    "drt-quadratic": dict(use_drt_subsampling=False, engine="nested"),
    "drt-kernel": dict(),
}


def nested_seed_runs(vs, sc, o, d, seeds):
    """For each seed of (a): every NESTED_CONFIGS estimator's primal and
    gradients from the same rays and seed (dL = 1 / (3 n)).  Returns
    {name: [flat sigma_t and albedo gradients]}, the nested and kernel
    images and each estimator's seconds, all on the host."""
    import torch
    from uivr_tpu_torch.core.rng import make_sampler
    from uivr_tpu_torch.integrators import VolpathConfig, volpathsimple
    n, dev = o.shape[0], o.device
    dL = torch.full((n, 3), 1.0 / (n * 3), device=dev)
    grads = {k: [] for k in NESTED_CONFIGS}
    images = {"nested": [], "kernel": []}
    secs = {k: 0.0 for k in NESTED_CONFIGS}
    for seed in seeds:
        for name, kw in NESTED_CONFIGS.items():
            cfg = VolpathConfig(max_depth=16, **kw)
            t0 = time.perf_counter()
            if cfg.engine == "nested":
                L, _, _ = volpathsimple.sample_primal(cfg, sc, o, d,
                                                      make_sampler(seed, n_lanes=n, device=dev))
                g, _ = volpathsimple.sample_adjoint(cfg, sc, o, d,
                                                    make_sampler(seed, n_lanes=n, device=dev), dL, L)
            else:
                L, _ = vs.sample_primal_kernel(cfg, sc, o, d, seed)
                g = vs.sample_adjoint_kernel(cfg, sc, o, d, seed, dL, L)
            _sync()
            secs[name] += time.perf_counter() - t0
            grads[name].append(torch.cat([g.sigma_t.reshape(-1), g.albedo.reshape(-1)]).cpu()
                               .double())
            if name in ("basic", "drt-kernel"):
                images["nested" if name == "basic" else "kernel"].append(L.cpu().double())
    return grads, images, secs


def _nested_seed_job(payload):
    """In the worker: :func:`nested_seed_runs` on ``payload``."""
    from uivr_tpu_torch.ops import volpath_step as vs
    return _dumps(nested_seed_runs(vs, *_loads(payload)))


def nested_unbiased(vs, cube, dev, seeds=6, rep=2048):
    """(a): the gradients of the nested engine's three forms and of the
    kernels' ``volpathsimple-drt`` on tiny-cube (max_depth 16, NEE on), their
    means over ``seeds`` seeds agreeing pairwise, and the nested primal's
    image against the kernel's per channel.  The first NESTED_SEEDS_HERE
    seeds run here, each other one in a worker of its own: nothing here is
    timed but the seconds of each estimator, which include the sharing."""
    import torch
    _, b, sc = cube
    o, d = fixed_cube_rays(b, dev, rep)
    n = o.shape[0]
    all_seeds = [400 + 17 * s for s in range(seeds)]
    futs = [twin_pool().submit(_nested_seed_job, _dumps((sc, o, d, [s])))
            for s in all_seeds[NESTED_SEEDS_HERE:]]
    grads, images, secs = nested_seed_runs(vs, sc, o, d, all_seeds[:NESTED_SEEDS_HERE])
    for fut in futs:
        g2, i2, s2 = _loads(fut.result())
        for k in grads:
            grads[k] += g2[k]
            secs[k] += s2[k]
        for k in images:
            images[k] += i2[k]
    means = {k: torch.stack(v).mean(0) for k, v in grads.items()}
    scale = means["basic"].abs().max().item()
    pairs = {}
    names = list(NESTED_CONFIGS)
    for i, a in enumerate(names):
        for bb in names[i + 1:]:
            diff = (means[a] - means[bb]).abs() / scale
            pairs[f"{a}/{bb}"] = {"median": diff.median().item(), "max": diff.max().item(),
                                  "corr": float(np.corrcoef(means[a].numpy(),
                                                            means[bb].numpy())[0, 1])}
    La, Lb = torch.cat(images["nested"]), torch.cat(images["kernel"])
    se = (La.var(0) / La.shape[0] + Lb.var(0) / Lb.shape[0]).sqrt()
    z = ((La.mean(0) - Lb.mean(0)).abs() / se.clamp_min(1e-30)).tolist()
    ok = all(p["median"] < 0.03 for p in pairs.values()) and max(z) <= 4.0
    return {"rays": n, "fixed_pixels": 16, "repeats": rep, "seeds": seeds, "max_depth": 16,
            "grad_pairs": pairs, "grad_scale": scale, "image_mean_nested": La.mean(0).tolist(),
            "image_mean_kernel": Lb.mean(0).tolist(), "image_z": z,
            "seconds_shared": secs, "ok": ok}


def nested_card_vs_cpu(janga, rays, dev):
    """(b): the nested primal of janga-smoke's truth grids on the card and
    on the CPU, the same code on the same 2^14 rays at max_depth 8; the
    card's run once more under the profiler (``utils/profiling``): its
    device events (kernels and copies) per wavefront iteration, the
    device's idle share and the host calls that waited for it."""
    from uivr_tpu_torch.config import get_scene_config
    from uivr_tpu_torch.core.rng import make_sampler
    from uivr_tpu_torch.integrators import VolpathConfig, volpathsimple
    from uivr_tpu_torch.scene.medium import finalize_medium
    from uivr_tpu_torch.scene.scene import Scene
    from uivr_tpu_torch.utils import profiling
    preset, b, sc = janga
    o, d = rays
    n = o.shape[0]
    cfg = VolpathConfig(max_depth=8, engine="nested")
    (Lc, _, sc_), times = nested_seconds(lambda: volpathsimple.sample_primal(
        cfg, sc, o, d, make_sampler(42, n_lanes=n, device=dev)))
    with profiling.trace() as prof:
        _, traced = nested_seconds(lambda: volpathsimple.sample_primal(
            cfg, sc, o, d, make_sampler(42, n_lanes=n, device=dev)))
    summary = profiling.device_summary(prof, top=5, n_gaps=3)
    iters = traced["wavefront_iterations"]
    traced.update(device_events=summary["device_events"],
                  device_events_per_iteration=summary["device_events"] / max(iters, 1),
                  top_kernels=[dict(k_, name=k_["name"][:80]) for k_ in summary["top_kernels"]],
                  **{k: summary[k] for k in ("window_ms", "busy_ms", "idle_share", "syncs")})
    bc = preset.build(device="cpu")
    scpu = Scene(finalize_medium(bc.params, bc.medium_cfg, bc.to_world), bc.emitter, bc.cameras)
    t0 = time.perf_counter()
    Lp, _, sp = volpathsimple.sample_primal(cfg, scpu, o.cpu(), d.cpu(),
                                            make_sampler(42, n_lanes=n))
    cpu_s = time.perf_counter() - t0
    Lc = Lc.cpu()
    agree = lane_agreement(Lc, Lp)
    mc, mp = Lc.mean(0).tolist(), Lp.mean(0).tolist()
    means_ok = all(abs(a - b_) <= 0.02 * abs(b_) for a, b_ in zip(mc, mp))
    ok = means_ok and (sc_.dim != sp.dim or agree >= 0.90)
    return {"rays": n, "max_depth": 8, "seed": 42, "dim_cuda": sc_.dim, "dim_cpu": sp.dim,
            "agreement": agree, "mean_cuda": mc, "mean_cpu": mp, "card": times,
            "card_traced": traced, "cpu_s": cpu_s, "ok": ok}


def nested_times(vs, janga, dev, render_chunk, random_pixel_rays, out_dir):
    """(c): the nested primal at one pass of the main path's width, the
    quadratic adjoint at the step's adjoint width at the largest depth of
    NESTED_DEPTHS whose predicted time fits NESTED_BUDGET_S, and one
    ``run_optimization`` step of the quadratic preset beside the same step
    of ``volpathsimple-drt`` on the kernels."""
    import torch
    from uivr_tpu_torch.config import get_int_config
    from uivr_tpu_torch.core.rng import make_sampler
    from uivr_tpu_torch.integrators import VolpathConfig, volpathsimple
    from uivr_tpu_torch.opt import OptimizationConfig, load_references, loop
    preset, b, sc = janga
    rec = {}
    o, d = render_chunk(b)
    n = o.shape[0]
    cfg = VolpathConfig(max_depth=64, engine="nested")
    (L, _, s), t = nested_seconds(lambda: volpathsimple.sample_primal(
        cfg, sc, o, d, make_sampler(1234, n_lanes=n, device=dev)))
    rec["primal"] = {"rays": n, "max_depth": 64, "dim": s.dim, **t,
                     "finite": bool(torch.isfinite(L).all()), "mean": L.mean(0).tolist()}
    # the quadratic adjoint, replaying its own primal
    o, d = random_pixel_rays(b, 524288)
    n = o.shape[0]
    dL = torch.rand((n, 3), generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev) / n
    runs = []

    def quadratic(depth):
        q = VolpathConfig(max_depth=depth, use_drt_subsampling=False, engine="nested")
        (L, _, _), tp = nested_seconds(lambda: volpathsimple.sample_primal(
            q, sc, o, d, make_sampler(77, n_lanes=n, device=dev)))
        (g, _), ta = nested_seconds(lambda: volpathsimple.sample_adjoint(
            q, sc, o, d, make_sampler(77, n_lanes=n, device=dev), dL, L))
        runs.append({"max_depth": depth, "replay": tp, "adjoint": ta,
                     "grads_finite": bool(torch.isfinite(g.sigma_t).all()
                                          and torch.isfinite(g.albedo).all()),
                     "grads_nonzero": bool(g.sigma_t.abs().sum() > 0)})
        return tp["host_s"] + ta["host_s"]
    for i, depth in enumerate(NESTED_DEPTHS):
        s_ = quadratic(depth)
        if s_ > NESTED_BUDGET_S:
            if i == 0:
                quadratic(8)
            break
        if i + 1 < len(NESTED_DEPTHS):
            # iterations grow with the depth squared: a recursive path at every bounce
            runs[-1]["predicted_next_s"] = s_ * (NESTED_DEPTHS[i + 1] / depth) ** 2
            if runs[-1]["predicted_next_s"] > NESTED_BUDGET_S:
                break
    done = [r_ for r_ in runs
            if r_["replay"]["host_s"] + r_["adjoint"]["host_s"] <= NESTED_BUDGET_S]
    rec["quadratic_adjoint"] = {"rays": n, "runs": runs, "budget_s": NESTED_BUDGET_S,
                                "largest_depth_within_budget":
                                    max(r_["max_depth"] for r_ in done) if done else None}
    # one step of each preset at 4,096 pixels x 4 spp, max_depth 16
    refs = load_references(str(out_dir / preset.name / "references"), b)
    steps = {}
    for name in ("volpathsimple-drt-quadratic", "volpathsimple-drt"):
        icfg = get_int_config(name).create(max_depth=16)
        opt = OptimizationConfig(name=f"{preset.name}/{name}", n_iter=1, spp=4,
                                 primal_spp_factor=1, batch_size=4096, upsample=None,
                                 preview_stride=0, checkpoint_stride=0,
                                 checkpoint_initial=False, checkpoint_final=False,
                                 render_initial=False, render_final=False)
        calls = dict(volpathsimple.CALLS)
        _, t = nested_seconds(lambda: loop.run_optimization(
            str(out_dir / "nested" / name), opt, b, icfg, ref_images=refs,
            start_params=b.params, resume=False, verbose=False))
        steps[name] = {**t, "nested_calls": {k: volpathsimple.CALLS[k] - calls[k]
                                             for k in calls}}
    rec["step"] = {"pixels": 4096, "spp": 4, "primal_spp_factor": 1, "max_depth": 16,
                   "from": "ground truth", **steps}
    return rec


def nested_cli(out_dir):
    """(d): ``reproduce --integrator volpathsimple-drt-quadratic --retries 1``
    on tiny-cube: one child, exit 0, checkpoints and finite losses."""
    import json as json_
    from uivr_tpu_torch.cli import reproduce
    outputs = out_dir / "cli"
    stage = outputs / "tiny-cube" / "volpathsimple-drt-quadratic"
    if stage.exists():
        import shutil
        shutil.rmtree(stage)
    children = []
    call = reproduce.subprocess.call

    def counted(child):
        children.append(list(child))
        return call(child)
    reproduce.subprocess.call = counted
    t0 = time.perf_counter()
    try:
        reproduce.main(["--config", "tiny-cube", "--integrator", "volpathsimple-drt-quadratic",
                        "--scale", "0.01", "--ref-spp", "16", "--outputs", str(outputs),
                        "--retries", "1"])
        code = None
    except SystemExit as e:
        code = e.code
    finally:
        reproduce.subprocess.call = call
    dt = time.perf_counter() - t0
    losses = []
    if (stage / "metrics.jsonl").exists():
        with open(stage / "metrics.jsonl") as f:
            losses = [r["loss"] for r in map(json_.loads, f) if "loss" in r]
    ckpts = sorted(p.name for p in (stage / "params").glob("*.vol")) \
        if (stage / "params").exists() else []
    ok = (code == 0 and len(children) == 1 and "--retries" not in children[0]
          and children[0][1:3] == ["-m", "uivr_tpu_torch.cli.reproduce"] and losses
          and all(math.isfinite(x) for x in losses)
          and "final-medium1_sigma_t.vol" in ckpts and "initial-medium1_sigma_t.vol" in ckpts)
    return {"command": "reproduce --config tiny-cube --integrator volpathsimple-drt-quadratic "
                       "--scale 0.01 --ref-spp 16 --retries 1",
            "exit_code": code, "attempts": len(children), "child": children[:1], "seconds": dt,
            "losses": losses, "checkpoints": ckpts, "ok": bool(ok)}


def phase_nested(card, vs, dev, janga, cube, out_dir, render_chunk, random_pixel_rays,
                 pending=()):
    """9c: the nested engine on the card (see the module docstring), and
    the rest of the ``pending`` checks (``check_step``); returns its
    record and the finished checks, in order."""
    import torch
    from uivr_tpu_torch.integrators import volpathsimple
    import threading
    t0 = time.perf_counter()
    calls = dict(volpathsimple.CALLS)
    # (d) runs its child process while (a) runs here and in the workers,
    # beside the pending checks' twins; (b) and (c) then run alone
    cli = {}

    def run_cli():
        try:
            cli.update(nested_cli(out_dir))
        except Exception:
            cli.update(ok=False, error=traceback.format_exc().splitlines()[-1])
    cli_thread = threading.Thread(target=run_cli)
    cli_thread.start()
    try:
        futures = [submit_check(p) for p in pending]
        unbiased = nested_unbiased(vs, cube, dev)
        checks = [finish_check(vs, p, f) for p, f in zip(pending, futures)]
    finally:
        cli_thread.join()
    shared_s = time.perf_counter() - t0
    twins = nested_card_vs_cpu(janga, random_pixel_rays(janga[1], 1 << 14), dev)
    times = nested_times(vs, janga, dev, render_chunk, random_pixel_rays, out_dir)
    depth = times["quadratic_adjoint"]["largest_depth_within_budget"]
    reduced = {"batch": "4,096 pixels (32,768)", "spp": "4 primal x 4 adjoint (1,024 x 16)",
               "max_depth": f"16 in the step; the quadratic adjoint at {depth} (64)",
               "iterations": "1 (6000)"}
    rec = {"phase": "nested", "unbiased": unbiased, "card_vs_cpu": twins, "times": times,
           "cli": cli, "reduced": reduced, "checks": [p["tag"] for p in pending],
           "shared_seconds": shared_s,
           "nested_calls": {k: volpathsimple.CALLS[k] - calls[k] for k in calls},
           "seconds": time.perf_counter() - t0, "card": card}
    emit(rec)
    fails = [k for k, v in (("unbiased", unbiased), ("card_vs_cpu", twins), ("cli", cli))
             if not v.get("ok")]
    if depth is None:
        fails.append("the quadratic adjoint took longer than NESTED_BUDGET_S at every depth")
    if not times["primal"]["finite"] or not all(r["grads_finite"] and r["grads_nonzero"]
                                                 for r in times["quadratic_adjoint"]["runs"]):
        fails.append("times")
    step = times["step"]
    if (step["volpathsimple-drt-quadratic"]["nested_calls"]["sample_adjoint"] < 1
            or any(step["volpathsimple-drt"]["nested_calls"].values())):
        fails.append("step: the quadratic preset did not run the nested engine, or the "
                     "kernels' preset did")
    if fails:
        raise RuntimeError(f"nested: checks failed: {fails}")
    return rec, checks


PARALLEL_BATCH = 32768         # janga-smoke's training batch, pixels
PARALLEL_PIXEL_SEED = 3        # the batch's pixels, as tests/test_parallel.py draws them
PARALLEL_SEEDS = (11, 31, 51, 71)   # render seeds of the four steps, seed_grad = seed + 1
PARALLEL_KERNELS = ("tea", "volpath_primal", "volpath_primal_state", "volpath_adjoint",
                    "volpath_drt_walk", "volpath_drt_nee", "volpath_drt_phase",
                    "volpath_drt_scatter")


def parallel_setup(b, dev, first_half=False):
    """(render, (sensor_idx, pixels, ref)) of the ``parallel`` phase:
    ``volpathsimple-drt`` at janga-smoke's full training width (1,024
    primal and 16 adjoint spp, max_depth 64), PARALLEL_BATCH pixels of the
    training sensors drawn from PARALLEL_PIXEL_SEED (its first half with
    ``first_half``), a constant reference of 0.25 (tests/test_parallel.py's)."""
    import torch
    from uivr_tpu_torch.config import get_int_config, get_scene_config
    from uivr_tpu_torch.render.batched import (RenderSettings, make_render,
                                               sample_batch_pixels)
    cfg = get_int_config("volpathsimple-drt").create(
        max_depth=get_scene_config("janga-smoke").max_depth)
    st = RenderSettings(integrator=cfg, medium=b.medium_cfg, film_size=b.film_size,
                        spp=16 * 64, spp_grad=16)
    sidx, pix = sample_batch_pixels(PARALLEL_PIXEL_SEED, b.cameras.n_sensors, b.film_size,
                                    PARALLEL_BATCH, sensors=b.sensors, device=dev)
    batch = (sidx, pix, torch.full((PARALLEL_BATCH, 3), 0.25, device=dev))
    if first_half:
        batch = tuple(x[:PARALLEL_BATCH // 2] for x in batch)
    return make_render(st, b.to_world), batch


def grad_slabs(grads):
    """The gradients' z-slab sums, concatenated (tests/test_parallel.py's
    aggregate: per-voxel DRT gradients are noise-dominated at this budget)."""
    import torch
    return torch.cat([g.reshape(g.shape[0], -1).sum(1) for g in grads]).cpu().numpy()


def parallel_rank(mesh, first_half, out_path):
    """One rank of the ``parallel`` phase: janga-smoke's truth grids built
    on the rank's device, its shard of the batch, one
    ``sharded_loss_and_grad`` step a seed of PARALLEL_SEEDS with every
    counter set to 0 just before; saves each step's loss, gradient slabs,
    host-clock ms (ending in a sync) and launch counts, the first step's
    gradients and the group's backend to ``out_path % rank``."""
    import torch
    import torch.distributed as dist
    from uivr_tpu_torch.config import get_scene_config
    from uivr_tpu_torch.integrators import volpath_flat
    from uivr_tpu_torch.ops import volpath_step as vs
    from uivr_tpu_torch.opt import losses
    from uivr_tpu_torch.parallel import shard_batch, sharded_loss_and_grad
    b = get_scene_config("janga-smoke").build(device=mesh.device)
    render, batch = parallel_setup(b, mesh.device, first_half)
    vag = sharded_loss_and_grad(mesh, render, losses.l1)
    sidx, pix, ref = shard_batch(mesh, batch)
    steps, first = [], None
    for s in PARALLEL_SEEDS:
        for k in vs.LAUNCHES:
            vs.LAUNCHES[k] = 0
        for k in volpath_flat.CALLS:
            volpath_flat.CALLS[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = vag(b.params, b.emitter, b.cameras, sidx, pix, ref, s, s + 1)
        torch.cuda.synchronize()
        steps.append({"seed": s, "ms": (time.perf_counter() - t0) * 1e3, "loss": float(loss),
                      "slabs": grad_slabs(grads), "launches": dict(vs.LAUNCHES),
                      "plain_calls": dict(volpath_flat.CALLS),
                      "finite": all(bool(torch.isfinite(g).all()) for g in grads)})
        if first is None:
            first = [loss.cpu()] + [g.cpu() for g in grads]
    torch.save({"steps": steps, "first": first, "backend": dist.get_backend(),
                "world": mesh.size, "device": str(mesh.device)}, out_path % mesh.rank)


def value_and_grad(render, b, batch, seed, seed_grad):
    """loss and gradients of one unsharded step (the plain autograd of the
    batch render, as opt.loop's step takes them)."""
    import torch
    from uivr_tpu_torch.opt import losses
    leaves = type(b.params)(*[p.detach().requires_grad_(True) for p in b.params])
    sidx, pix, ref = batch
    value = losses.l1(render(leaves, b.emitter, b.cameras, sidx, pix, seed, seed_grad), ref)
    return [value.detach()] + list(torch.autograd.grad(value, leaves))


def rel_err(got, want):
    """Relative error of the loss and each gradient field: |a-b| / |b| for
    the loss, relative L1 for the grids (0 where both are 0)."""
    out = {"loss": abs(float(got[0]) - float(want[0])) / max(abs(float(want[0])), 1e-30)}
    for k, a, b_ in zip(("sigma_t", "albedo", "emission"), got[1:], want[1:]):
        a, b_ = a.to(b_.device), b_
        num, den = float((a - b_).abs().sum()), float(b_.abs().sum())
        out[k] = num / den if den > 0 else (0.0 if num == 0 else math.inf)
    return out


def within(err, loss_tol=1e-6, grad_tol=1e-5):
    return err["loss"] <= loss_tol and all(err[k] <= grad_tol
                                           for k in ("sigma_t", "albedo", "emission"))


def native_loads(card, dev, out_dir):
    """janga-smoke's and dust-devil's XML presets loaded from stand-in
    assets (``write_standins``) with the native helpers and with the Python
    path asked for explicitly (``native._load`` made to find no compiler),
    each load's seconds and the helpers' ``CALLS``; the maps and every
    emitter table must be bit-equal."""
    import os
    import tempfile
    from unittest import mock

    import torch
    from uivr_tpu_torch import native
    tmp = tempfile.TemporaryDirectory(prefix="uivr_scenes_", dir=out_dir)
    root = Path(tmp.name)
    write_standins(root)
    os.environ["UIVR_SCENE_DIR"] = str(root)
    recs = {}
    try:
        for name in ("janga-smoke", "dust-devil"):
            loads = {}
            for path in ("native", "python"):
                calls = dict(native.CALLS)
                with mock.patch.object(native, "_load", return_value=None) \
                        if path == "python" else contextlib.nullcontext():
                    t0 = time.perf_counter()
                    _, b, _ = xml_scene(name, dev)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                loads[path] = (dt, {k: native.CALLS[k] - calls[k] for k in calls}, b.emitter)
            e_n, e_p = loads["native"][2], loads["python"][2]
            tables = ("data", "row_pmf", "cond_pmf", "alias_tab")
            equal = all(torch.equal(getattr(e_n, k), getattr(e_p, k)) for k in tables) and (
                (e_n.nee is None and e_p.nee is None)
                or all(torch.equal(getattr(e_n.nee, k), getattr(e_p.nee, k)) for k in tables))
            recs[name] = {"load_s_native": loads["native"][0], "load_s_python": loads["python"][0],
                          "calls_native": loads["native"][1], "calls_python": loads["python"][1],
                          "envmap": list(e_n.data.shape[:2]), "tables_equal": bool(equal)}
    finally:
        del os.environ["UIVR_SCENE_DIR"]
        tmp.cleanup()
    ok = all(r["tables_equal"] and r["calls_native"]["native"] > 0
             and r["calls_native"]["python"] == 0 and r["calls_python"]["python"] > 0
             and r["calls_python"]["native"] == 0 for r in recs.values())
    return {"scenes": recs, "ok": bool(ok)}


def mesh_cli(out_dir):
    """(c): ``reproduce --config tiny-cube --integrator volpathsimple-drt
    --mesh 2 --scale 0.01`` (20 iterations at batch 256) as a child process,
    started here and returned as (Popen, its outputs directory, its
    command)."""
    import shutil
    outputs = out_dir / "mesh"
    if outputs.exists():
        shutil.rmtree(outputs)
    cmd = [sys.executable, "-m", "uivr_tpu_torch.cli.reproduce", "--config", "tiny-cube",
           "--integrator", "volpathsimple-drt", "--mesh", "2", "--scale", "0.01",
           "--ref-spp", "16", "--outputs", str(outputs)]
    proc = subprocess.Popen(cmd, cwd=str(HERE), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, outputs, cmd


def mesh_cli_result(proc, outputs, cmd, t0):
    import re
    out, _ = proc.communicate(timeout=300)
    dt = time.perf_counter() - t0
    stage = outputs / "tiny-cube" / "volpathsimple-drt"
    metrics = sorted(str(p.relative_to(outputs)) for p in outputs.rglob("metrics.jsonl"))
    losses = []
    if (stage / "metrics.jsonl").exists():
        with open(stage / "metrics.jsonl") as f:
            losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
    ckpts = sorted(p.name for p in (stage / "params").glob("*")) \
        if (stage / "params").exists() else []
    digests = dict(re.findall(r"\[rank (\d+)/2\] tiny-cube/volpathsimple-drt final grids "
                              r"sha256 ([0-9a-f]{16})", out))
    backends = re.findall(r"\[dist\] rank \d+/2: (\w+)", out)
    want = sorted(f"{p}-medium1_{k}.vol" for p in ("initial", "final")
                  for k in ("sigma_t", "albedo", "emission"))
    ok = (proc.returncode == 0 and metrics == ["tiny-cube/volpathsimple-drt/metrics.jsonl"]
          and ckpts == want and losses and all(math.isfinite(x) for x in losses)
          and sorted(digests) == ["0", "1"] and len(set(digests.values())) == 1
          and backends == ["gloo", "gloo"])
    return {"command": " ".join(cmd[1:]).replace(str(outputs), "<outputs>"),
            "exit_code": proc.returncode, "seconds": dt, "metrics_files": metrics,
            "checkpoints": ckpts, "losses": losses, "final_grids_sha256": digests,
            "backends": backends, "ok": bool(ok),
            "tail": out.splitlines()[-12:] if proc.returncode else []}


def phase_parallel(card, vs, dev, janga, out_dir):
    """9d: data parallel (``uivr_tpu_torch.parallel``) and the native host
    helpers (see the module docstring)."""
    import torch
    from uivr_tpu_torch.parallel import Mesh, local_seeds, shard_batch, spawn
    t_phase = time.perf_counter()
    _, b, _ = janga
    render, batch = parallel_setup(b, dev)
    # the parent's steps first, alone on the card: each shard of the first
    # seed with its rank's seeds, then the unsharded step of every seed
    s0 = PARALLEL_SEEDS[0]
    shards = []
    for m in (Mesh(size=2, rank=r, device=dev) for r in range(2)):
        shards.append(value_and_grad(render, b, shard_batch(m, batch), *local_seeds(m, s0, s0 + 1)))
    mean = [(x + y) / 2 for x, y in zip(*shards)]
    single = []
    for s in PARALLEL_SEEDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = value_and_grad(render, b, batch, s, s + 1)
        torch.cuda.synchronize()
        single.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": float(g[0]),
                       "slabs": grad_slabs(g[1:])})
    # (a) two ranks on this card (gloo)
    path = str(out_dir / "parallel-rank%d.pt")
    t0 = time.perf_counter()
    spawn(parallel_rank, 2, (False, path), device="cuda", timeout_s=300)
    a_s = time.perf_counter() - t0
    ranks = [torch.load(path % r, weights_only=False) for r in range(2)]
    errs = [rel_err(r_["first"], mean) for r_ in ranks]
    ranks_equal = all(torch.equal(x, y) for x, y in zip(ranks[0]["first"], ranks[1]["first"]))
    ls = [st["loss"] for st in ranks[0]["steps"]]
    l1s = [st["loss"] for st in single]
    m_sh = np.mean([st["slabs"] for st in ranks[0]["steps"]], 0)
    m_1 = np.mean([st["slabs"] for st in single], 0)
    corr = float(np.corrcoef(m_1, m_sh)[0, 1])
    loss_gap = abs(np.mean(ls) - np.mean(l1s)) / max(abs(np.mean(l1s)), 1e-9)
    launched = [{k: st["launches"][k] for k in PARALLEL_KERNELS} for r_ in ranks
                for st in r_["steps"]]
    direct = sum(v for r_ in ranks for st in r_["steps"] for k, v in st["launches"].items()
                 if k.endswith("_direct"))
    plain = sum(v for r_ in ranks for st in r_["steps"] for v in st["plain_calls"].values())
    sharded_ms = [max(r_["steps"][i]["ms"] for r_ in ranks) for i in range(len(PARALLEL_SEEDS))]
    a = {"backends": [r_["backend"] for r_ in ranks], "devices": [r_["device"] for r_ in ranks],
         "seconds": a_s, "rel_err_vs_shard_mean": errs, "ranks_bit_equal": ranks_equal,
         "losses_sharded": ls, "losses_single": l1s, "loss_gap": float(loss_gap),
         "slab_correlation": corr, "launches_per_rank_step": launched[:2],
         "direct_launches": direct, "plain_calls": plain,
         "finite": all(st["finite"] for r_ in ranks for st in r_["steps"]),
         "step_ms_two_ranks_time_sliced_on_one_card": sharded_ms,
         "step_ms_single_process": [st["ms"] for st in single]}
    a["ok"] = bool(a["backends"] == ["gloo", "gloo"] and all(within(e) for e in errs)
                   and ranks_equal and loss_gap < 0.05 and corr > 0.85 and a["finite"]
                   and all(all(v > 0 for v in la.values()) for la in launched)
                   and direct == 0 and plain == 0)
    # (c) reproduce --mesh 2 in a child process, beside (b)
    t_c = time.perf_counter()
    cli = mesh_cli(out_dir)
    # (b) a one-rank NCCL group on cuda:0, on the first half of the batch:
    # its shard 0 is the parent's
    path_b = str(out_dir / "parallel-nccl-rank%d.pt")
    spawn(parallel_rank, 1, (True, path_b), device="cuda", timeout_s=300)
    nccl = torch.load(path_b % 0, weights_only=False)
    err_b = rel_err(nccl["first"], shards[0])
    b_rec = {"backend": nccl["backend"], "world": nccl["world"], "device": nccl["device"],
             "rel_err_vs_shard0": err_b, "launches": nccl["steps"][0]["launches"],
             "ok": bool(nccl["backend"] == "nccl" and within(err_b)
                        and all(nccl["steps"][0]["launches"][k] > 0 for k in PARALLEL_KERNELS))}
    c = mesh_cli_result(*cli, t_c)
    loads = native_loads(card, dev, out_dir)
    rec = {"phase": "parallel", "scene": "janga-smoke", "batch": PARALLEL_BATCH,
           "spp": "1024 primal x 16 adjoint", "max_depth": 64, "seeds": list(PARALLEL_SEEDS),
           "two_ranks_gloo": a, "one_rank_nccl": b_rec, "reproduce_mesh": c,
           "native_loads": loads, "seconds": time.perf_counter() - t_phase, "card": card,
           "note": "two ranks share one card, time-sliced: not a scaling figure; NCCL "
                   "across several GPUs is not exercised on a one-card machine"}
    emit(rec)
    fails = [k for k, v in (("two_ranks_gloo", a), ("one_rank_nccl", b_rec),
                            ("reproduce_mesh", c), ("native_loads", loads)) if not v["ok"]]
    if fails:
        raise RuntimeError(f"parallel: checks failed: {fails}")
    return rec


def main(argv=None):
    """``--quick``: the builds, then the persistent kernels against the
    one-ray-per-thread ones at the main path's shapes (lanes equal, the
    latter's lane utilization), and stop.  ``--sweep``: every phase, with
    the minimum-blocks variants built and timed in phase 5a and the
    one-ray-per-thread A/B of janga's start step and of dust-devil's and
    janga XML's truth steps besides janga's truth step."""
    import torch
    args = sys.argv[1:] if argv is None else argv
    quick, sweep = "--quick" in args, "--sweep" in args
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    if not (HERE / "uivr_tpu_torch").is_dir():
        print(f"chip_smoke: the uivr_tpu_torch package is not next to {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import ctypes

    import numpy as np

    from uivr_tpu_torch import native
    from uivr_tpu_torch.cli import render as cli_render
    from uivr_tpu_torch.config import get_int_config, get_scene_config
    from uivr_tpu_torch.core import exr_io, rng
    from uivr_tpu_torch.integrators import volpath_flat
    from uivr_tpu_torch.ops import volpath_step as vs
    from uivr_tpu_torch.render import batched
    from uivr_tpu_torch.scene.camera import sample_rays
    from uivr_tpu_torch.scene.medium import finalize_medium
    from uivr_tpu_torch.scene.scene import Scene

    dev = torch.device("cuda")
    twins_without_autograd(volpath_flat)
    if not quick:
        twin_pool().submit(_twin_warm)   # the worker starts while the kernels build
    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    max_clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader"], capture_output=True,
                               text=True).stdout.strip()
    t0 = time.time()
    fmad_proc, fmad_lib = build_fmad_variant()
    probe_job = build_l2_probe()
    variant_jobs = start_variant_builds() if sweep else {}
    vs.build()      # one nvcc per source, all started together
    for name in vs.LIBS:
        vs._load(name)
    t_native = time.time()
    native_lib = native.lib_path("g++") if native._load() is not None else None
    native_build_s = time.time() - t_native
    fmad_log, _ = fmad_proc.communicate()
    if fmad_proc.returncode != 0:
        raise RuntimeError(f"nvcc --fmad=true failed:\n{fmad_log}")
    variants = finish_variant_builds(variant_jobs)
    probe_lib, probe_log = load_l2_probe(*probe_job)
    build_s = time.time() - t0
    emit({"phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "libraries": {k: str(b["path"].relative_to(HERE)) for k, b in vs.BUILD.items()},
          "build_s": round(build_s, 3),
          "native_library": str(native_lib.relative_to(HERE)) if native_lib else None,
          "native_build_s": round(native_build_s, 3),
          "nvcc_s": {k: b["seconds"] for k, b in vs.BUILD.items()},
          "ptxas": {k: ptxas_report(b["log"]) for k, b in vs.BUILD.items()},
          "ptxas_l2_probe": ptxas_report(probe_log),
          "ptxas_variants": {f"{k}-{v}": r for (k, v), (_, r) in variants.items()},
          "bound_rates": {"hbm_bytes_per_s": HBM_BYTES_PER_S, "fp32_ops_per_s": FP32_OPS_PER_S,
                          "int32_ops_per_s": INT32_OPS_PER_S, "sm_clock_hz": SM_CLOCK_HZ,
                          "sms": SMS, "sm_clock_max": max_clock,
                          "lane_draw_rounds": rng._DRAW_ROUNDS}})
    if rng._DRAW_ROUNDS != LANE_DRAW_ROUNDS:
        raise RuntimeError(f"the kernels draw with {rng._DRAW_ROUNDS} rounds, the bounds "
                           f"count {LANE_DRAW_ROUNDS}")

    rs = np.random.RandomState(20260417)
    # ---------------------------------------------------------- 2. tea
    n_tea = 1 << 20
    v0 = torch.from_numpy(rs.randint(0, 2 ** 32, n_tea, dtype=np.int64)).to(dev)
    v1 = torch.from_numpy(rs.randint(0, 2 ** 32, n_tea, dtype=np.int64)).to(dev)
    tea_exact = {}
    for rounds in (5, 6, 8):
        k0, k1 = vs.tea_i32(v0, v1, rounds)
        p0, p1 = rng.tea_plain(v0, v1, rounds)
        tea_exact[rounds] = bool(torch.equal(k0, p0) and torch.equal(k1, p1))
    emit({"phase": "tea", "pairs": n_tea, "bit_exact": tea_exact, "card": card})
    if not all(tea_exact.values()):
        raise RuntimeError(f"tea kernel differs from tea_plain: {tea_exact}")

    # ---------------------------------------------------------- 3. primal
    def scene_of(name):
        preset = get_scene_config(name)
        b = preset.build(device=dev)
        sc = Scene(finalize_medium(b.params, b.medium_cfg, b.to_world),
                   b.emitter, b.cameras)
        return preset, b, sc

    def sparse_variant(scene):
        """janga-smoke's density kept only in the central block [40:88]^3
        (x4), under one global majorant: empty subcells inside the
        majorant's cell, where SHADOW candidates classify (the sparse
        fixture of tests/pallas_common.py, at 128^3)."""
        preset, b, _ = scene
        mask = torch.zeros_like(b.params.sigma_t)
        mask[40:88, 40:88, 40:88] = 1.0
        params = b.params._replace(sigma_t=(b.params.sigma_t * mask * 4.0).contiguous())
        mcfg = dataclasses.replace(b.medium_cfg, majorant_factor=1)
        sc = Scene(finalize_medium(params, mcfg, b.to_world), b.emitter, b.cameras)
        return preset, dataclasses.replace(b, params=params, medium_cfg=mcfg), sc

    def random_pixel_rays(b, n):
        W, H = b.film_size
        pix = rs.randint(0, [W, H], size=(n, 2)).astype(np.float32)
        uv = torch.from_numpy((pix + rs.rand(n, 2).astype(np.float32))
                              / np.array([W, H], np.float32)).to(dev)
        o, d = sample_rays(b.cameras, torch.zeros(n, dtype=torch.int64, device=dev), uv)
        return o.contiguous(), d.contiguous()

    fmad = vs.bind(ctypes.CDLL(str(fmad_lib)), "primal")

    def run_fmad(cfg, sc, o, d, seed):
        L, _ = variant_primal(vs, fmad, cfg, sc, o, d, seed)
        torch.cuda.synchronize()
        return L

    def render_chunk(b, spp=64, seed0=1234):
        """The rays of a full-frame render's first chunk (2**20 rays)."""
        W_ = b.film_size[0]
        chunk_pix = (1 << 20) // spp
        pix = torch.stack([torch.arange(chunk_pix, device=dev) % W_,
                           torch.arange(chunk_pix, device=dev) // W_], dim=-1)
        sidx = torch.zeros(chunk_pix, dtype=torch.int64, device=dev)
        sub_seed, _ = rng.sample_tea_32(seed0, 22)
        return batched._expand_rays(b.cameras, sidx, pix, b.film_size, spp, sub_seed)

    n_cmp = 1 << 16
    seed = 42
    t_scenes = time.perf_counter()
    janga = scene_of("janga-smoke")
    dust = scene_of("dust-devil")
    cube = scene_of("tiny-cube")
    sparse = sparse_variant(janga)
    emit({"phase": "scenes", "seconds": time.perf_counter() - t_scenes,
          "subcells": {name: {"dims": list(sc_.medium.sub.shape),
                              "empty": int((sc_.medium.sub == 0).sum()),
                              "majorant_cells": list(sc_.medium.majorant_grid.shape)}
                       for name, (_, _, sc_) in (("janga-smoke", janga), ("dust-devil", dust),
                                                 ("tiny-cube", cube),
                                                 ("janga-smoke-sparse", sparse))}})
    if quick:
        # lane utilization of the one-ray-per-thread kernels at the main
        # path's shapes, and the persistent kernels equal to them on every
        # lane; no times
        phase_persistent(card, vs, dev, janga, dust, render_chunk, variants, measure=False)
        kcfg = get_int_config("volpathsimple-drt").create(max_depth=janga[0].max_depth)
        phase_k7_chunk(card, vs, kcfg, janga[2], *render_chunk(janga[1]), 1234,
                       dust=(dust[2], *render_chunk(dust[1])), measure=False)
        phase_xml_chunk_quick(card, vs, dev, render_chunk)
        print(card, flush=True)
        emit({"quick": True, "device": {"platform": "gpu",
                                        "kind": torch.cuda.get_device_name(0),
                                        "count": torch.cuda.device_count()}})
        return 0
    runs = [("janga-smoke", janga, True, 0.90), ("dust-devil", dust, True, 0.90),
            ("tiny-cube", cube, True, 0.95), ("tiny-cube", cube, False, 0.95),
            ("janga-smoke-sparse", sparse, True, None)]
    # the kernels and their times first, then the twins two at a time (the
    # worker shares the card: nothing is timed while it runs)
    checked = []
    for name, (preset, b, sc), nee, need in runs:
        cfg = dataclasses.replace(get_int_config("volpathsimple-basic").create(
            max_depth=preset.max_depth), use_nee=nee)
        off = no_cls(sc)
        o, d = random_pixel_rays(b, n_cmp)
        Lk, ek, sk = vs.sample_primal_kernel(cfg, sc, o, d, seed, return_stats=True)
        Lo, eo, so = vs.sample_primal_kernel(cfg, off, o, d, seed, return_stats=True)
        direct = vs.sample_primal_kernel(cfg, sc, o, d, seed, return_stats=True, direct=True)
        torch.cuda.synchronize()
        same = {"radiance_bits": torch.equal(Lk, Lo), "escaped": torch.equal(ek, eo),
                "dim": torch.equal(sk["dim"], so["dim"]),
                "steps": torch.equal(sk["steps"], so["steps"])}
        same_direct = primal_equal((Lk, ek, sk), direct)
        k_ms, off_ms = on_off_ms(lambda: vs.sample_primal_kernel(cfg, sc, o, d, seed),
                                 lambda: vs.sample_primal_kernel(cfg, off, o, d, seed), 3)
        cls = cls_counts(sk["cls"])
        rec = {"phase": "primal", "scene": name, "nee": nee, "rays": n_cmp,
               "cls_on_equals_off": same, "persistent_equals_direct": same_direct,
               "cls": cls, "kernel_ms": k_ms,
               "kernel_ms_cls_off": off_ms, "steps": int(sk["steps"].sum()),
               "max_steps_lane": int(sk["steps"].max()), "card": card}
        bad = not all(same.values()) or not all(same_direct.values())
        fmad_L = run_fmad(cfg, sc, o, d, seed) if name == "janga-smoke" else None
        checked.append((name, nee, need, cfg, sc, o, d, Lk, ek, sk, cls, rec, bad, fmad_L))
    twins = iter(run_twins([("sample_primal", (0, 1, 2), (cfg, sc, o, d, seed),
                             dict(return_stats=True, deferred=True, max_iters=cfg.max_steps))
                            for _, _, need, cfg, sc, o, d, *_ in checked if need is not None]))
    for name, nee, need, cfg, sc, o, d, Lk, ek, sk, cls, rec, bad, fmad_L in checked:
        if need is not None:
            (Lp, ep, sp), p_ms = next(twins)
            agree = lane_agreement(Lk, Lp)
            mk, mp = Lk.mean(0).tolist(), Lp.mean(0).tolist()
            means_ok = all(abs(a - b_) <= 0.02 * abs(b_) for a, b_ in zip(mk, mp))
            rec.update({"agreement": agree, "need": need,
                        "same_draws": (sk["dim"] == sp["dim"]).float().mean().item(),
                        "escaped_equal": (ek == ep).float().mean().item(),
                        "mean_kernel": mk, "mean_plain": mp,
                        "max_abs_err": (Lk - Lp).abs().max().item(), "plain_ms": p_ms})
            if fmad_L is not None:
                rec["agreement_fmad_true"] = lane_agreement(fmad_L, Lp)
            bad = bad or agree < need or not means_ok
        emit(rec)
        if bad:
            raise RuntimeError(f"{name} (nee={nee}): the kernel disagrees with itself "
                               "without K6 or with the plain twin")
        if name == "dust-devil" and not cls["cls_main_nulls"] > 0:
            raise RuntimeError("dust-devil: K6 classified no MAIN null")
        if name == "janga-smoke-sparse" and not (cls["cls_main_nulls"] > 0
                                                 and cls["cls_shadow"] > 0):
            raise RuntimeError(f"{name}: a K6 branch never fired: {cls}")

    # ---------------------------------------------------------- 4. render
    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    images, render_launches = {}, {}
    for name, (preset, b, sc) in (("janga-smoke", janga), ("dust-devil", dust)):
        exr = out_dir / f"{name}-s0.exr"
        for k in vs.LAUNCHES:
            vs.LAUNCHES[k] = 0
        volpath_flat.CALLS["volpath_primal"] = 0
        img, dt = cli_render.main(["--scene", name, "--sensor", "0",
                                   "--spp", "64", "--out", str(exr)])
        launches = dict(vs.LAUNCHES)
        plain_calls = volpath_flat.CALLS["volpath_primal"]
        back = exr_io.read_exr(str(exr))
        W, H = b.film_size
        rays = W * H * 64
        emit({"phase": "render", "scene": name, "sensor": 0, "spp": 64,
              "rays": rays, "seconds": dt, "mrays_per_s": rays / dt / 1e6,
              "image_mean": float(img.mean()), "launches": launches,
              "plain_twin_calls": plain_calls, "exr_shape": list(back.shape),
              "exr_finite": bool(np.isfinite(back).all()),
              "exr_matches": bool(np.array_equal(back, img)), "card": card})
        if not (launches["volpath_primal"] > 0 and launches["tea"] > 0
                and launches["subcell_classification"] > 0 and plain_calls == 0):
            raise RuntimeError(f"{name}: the render did not run through the kernels: "
                               f"{launches}, plain twin calls {plain_calls}")
        if back.shape != (H, W, 3) or not np.isfinite(back).all() \
                or not np.array_equal(back, img):
            raise RuntimeError(f"{name}: the rendered EXR is malformed")
        images[name], render_launches[name] = img, launches
    launches = render_launches["janga-smoke"]

    # ------------------------------------------------- 4b. where the time goes
    cfg = get_int_config("volpathsimple-drt").create(max_depth=janga[0].max_depth)
    for name, (preset, b, sc) in (("janga-smoke", janga), ("dust-devil", dust)):
        st = batched.RenderSettings(integrator=cfg, medium=b.medium_cfg,
                                    film_size=b.film_size, spp=64, spp_grad=64)
        st_off = dataclasses.replace(st, medium=dataclasses.replace(b.medium_cfg, cls_cells=0))
        repeats = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = batched.render_image(st, b.params, b.emitter, b.cameras, 0, seed=1234,
                                         medium_to_world=b.to_world)
            repeats.append(time.perf_counter() - t0)
        # K6 on and off in turns (on, off, off, on)
        turns = [time_render_parts(s_, b, seed=1234, spp=64) for s_ in (st, st_off, st_off, st)]
        emit({"phase": "breakdown", "scene": name, "render_s": repeats,
              "same_image": bool(np.array_equal(again, images[name])),
              "parts_ms": turns[0], "parts_ms_cls_off": turns[1],
              "kernel_ms_cls_on_off_turns": [t["kernel"] for t in turns], "card": card})
        if not np.array_equal(again, images[name]):
            raise RuntimeError(f"{name}: a repeated render differs from the first")

    # ---------------------------------------------------------- 5. kernels
    preset, b, sc = janga
    seed0 = 1234
    o, d = render_chunk(b)
    n = o.shape[0]
    Lk, ek, sk = vs.sample_primal_kernel(cfg, sc, o, d, seed0, return_stats=True)
    torch.cuda.synchronize()
    k_ms, k_off_ms = on_off_ms(lambda: vs.sample_primal_kernel(cfg, sc, o, d, seed0),
                               lambda: vs.sample_primal_kernel(cfg, no_cls(sc), o, d, seed0), 3)
    t0 = time.perf_counter()
    Lp, ep, sp = volpath_flat.sample_primal(cfg, sc, o, d, seed0, return_stats=True,
                                            deferred=True, max_iters=cfg.max_steps)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    steps = int(sk["steps"].sum())
    extra_draws = int(sk["dim"].sum()) - 2 * steps
    m = sc.medium
    em = sc.emitter
    in_bytes = (o.numel() + d.numel()) * 4 + m.grid.numel() * 4 + m.majorant_grid.numel() * 4 \
        + m.sub.numel() * 4 \
        + sum(t.numel() * 4 for t in (em.data, em.alias_tab, em.row_pmf, em.cond_pmf))
    out_bytes = n * (12 + 1)
    k_bound, k_by = bound(in_bytes + out_bytes, *tracking_ops(steps, 2 * steps + extra_draws))
    scatters = extra_draws / 5
    chunk_cls = cls_counts(sk["cls"])
    gather_ms, _ = bound(event_fetch_bytes(steps, chunk_cls) + 28 * scatters + 36 * n, 0)
    gather_off_ms, _ = bound(event_fetch_bytes(steps, None) + 28 * scatters + 36 * n, 0)
    # dust-devil's first render chunk, K6 on and off
    dust_o, dust_d = render_chunk(dust[1])
    _, _, dust_sk = vs.sample_primal_kernel(cfg, dust[2], dust_o, dust_d, seed0,
                                            return_stats=True)
    dust_ms, dust_off_ms = on_off_ms(
        lambda: vs.sample_primal_kernel(cfg, dust[2], dust_o, dust_d, seed0),
        lambda: vs.sample_primal_kernel(cfg, no_cls(dust[2]), dust_o, dust_d, seed0), 2)

    tea_rounds = 8   # the wavefront sampler's vector hash of the ray generation
    t0_, t1_ = v0[:n], v1[:n]
    a32, b32 = t0_.to(torch.int32), t1_.to(torch.int32)   # the kernel's operands
    o0, o1 = torch.empty_like(a32), torch.empty_like(b32)
    lib = vs._load()
    stream = torch.cuda.current_stream().cuda_stream

    def tea_launch():
        if lib.tea_launch(a32.data_ptr(), b32.data_ptr(), o0.data_ptr(), o1.data_ptr(),
                          n, tea_rounds, stream):
            raise RuntimeError("tea_kernel launch failed")
    tea_launch()
    t_ms = cuda_ms(tea_launch, 20)
    tp_ms = cuda_ms(lambda: rng.tea_plain(t0_, t1_, tea_rounds), 5)
    t_bound, t_by = bound(16 * n, 0, TEA_OPS_PER_ROUND * tea_rounds * n)
    kernels = [
        {"name": "tea", "route": "cuda", "source": "uivr_tpu_torch/ops/csrc/rng.cuh",
         "replaces": "uivr_tpu/ops/volpath_step.py:71", "launches": launches["tea"],
         "max_abs_err": 0.0, "ms": t_ms, "plain_ms": tp_ms, "bound_ms": t_bound,
         "bound_by": t_by, "library_ms": None, "agreement": 1.0,
         "shape": f"{n} pairs x {tea_rounds} rounds"},
        {"name": "volpath_primal", "route": "cuda",
         "source": "uivr_tpu_torch/ops/csrc/volpath_primal.cu",
         "replaces": "uivr_tpu/ops/volpath_step.py:303", "launches": launches["volpath_primal"],
         "max_abs_err": (Lk - Lp).abs().max().item(), "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": k_bound, "bound_by": k_by, "library_ms": None,
         "agreement": lane_agreement(Lk, Lp), "gather_bound_ms": gather_ms,
         "shape": f"{n} rays, janga-smoke sensor 0", "tracking_steps": steps,
         "extra_draws": extra_draws},
    ]
    if kernels[1]["agreement"] < 0.90:
        raise RuntimeError("main-path chunk: kernel disagrees with the plain twin")
    # the persistent kernels against the one-ray-per-thread ones
    persist = phase_persistent(card, vs, dev, janga, dust, render_chunk, variants)
    more_ab = ("truth",) if sweep else ()
    # K7 at the same chunk, and its images against K=1
    k7_chunk = phase_k7_chunk(card, vs, cfg, sc, o, d, seed0,
                              dust=(dust[2], dust_o, dust_d))
    phase_k7_unbiased(card, (("janga-smoke", janga), ("dust-devil", dust)))

    # ---------------------------------------------------------- 6-9. training
    phase_adjoint(card, dev, vs, janga, dust, cube, random_pixel_rays)
    train, start, truth = phase_train(card, vs, janga, out_dir, 3, 64,
                                      ab=("truth", "start") if sweep else ("truth",), trace=True)
    start_check = check_step(card, vs, "start", start)
    check = check_step(card, vs, "truth", truth)
    k7_train, k7_first, k7_rec, k7_check = phase_k7_train(card, vs, janga, out_dir, train)
    dust_train, _, dust_truth = phase_train(
        card, vs, dust, out_dir, 2, 16, {"lr": 1e-4, "lr_factors": {"albedo": 100.0}},
        checkpoints=False, ab=more_ab)
    dust_check = check_step(card, vs, "dust-devil truth", dust_truth)
    phase_cli(card, out_dir)
    phase_fd(card, vs, out_dir)
    nerf_rows = phase_nerf(card, vs, probe_lib, janga, dust, out_dir)
    k3b, xml = phase_xml(card, vs, dev, out_dir, random_pixel_rays, render_chunk, more_ab)
    # every check_step's twins, the longest first
    _, (dust_check, _, _, check, _) = phase_nested(
        card, vs, dev, janga, cube, out_dir, render_chunk, random_pixel_rays,
        pending=(dust_check, xml["check"], k7_check, check, start_check))
    phase_parallel(card, vs, dev, janga, out_dir)
    for k in kernels:
        k["launches_per_train_step"] = train["iterations"][0]["launches"].get(k["name"], 0)
    kernels += training_kernels(train, truth, check)
    kernels += nerf_rows

    # ---------------------------------------------------------- 10. kernels
    walking = {"janga-smoke": {"volpath_primal": {"ms_on": k_ms, "ms_off": k_off_ms,
                                                  "shape": f"{n} rays, render chunk"},
                               **walking_on_off(vs, truth, check)},
               "dust-devil": {"volpath_primal": {"ms_on": dust_ms, "ms_off": dust_off_ms,
                                                 "shape": f"{dust_o.shape[0]} rays, render chunk"},
                              **walking_on_off(vs, dust_truth, dust_check)}}
    counts = {"janga-smoke": {"volpath_primal": chunk_cls,
                              "volpath_adjoint": cls_counts(truth["adjoint"]["stats"]["cls"]),
                              "volpath_primal_state": check["recursive_cls"]},
              "dust-devil": {"volpath_primal": cls_counts(dust_sk["cls"]),
                             "volpath_adjoint": cls_counts(dust_truth["adjoint"]["stats"]["cls"]),
                             "volpath_primal_state": dust_check["recursive_cls"]}}
    kernels.append(
        {"name": "subcell_classification", "route": "cuda",
         "source": "uivr_tpu_torch/ops/csrc/volpath_lane.cuh",
         "replaces": "uivr_tpu/ops/volpath_step.py:892",
         "launches": train["launches"]["subcell_classification"],
         "launches_per_train_step":
             train["iterations"][0]["launches"]["subcell_classification"],
         "max_abs_err": kernels[1]["max_abs_err"], "ms": k_ms, "ms_cls_off": k_off_ms,
         "plain_ms": p_ms, "bound_ms": k_bound, "bound_by": k_by, "library_ms": None,
         "gather_bound_ms": gather_ms, "gather_bound_ms_cls_off": gather_off_ms,
         "shape": f"volpath_primal with K6, {n} rays, janga-smoke sensor 0",
         "walking_kernels_ms": walking, "counts": counts, "on_equals_off": True})
    kernels.append(k3b)
    k7x = xml["k7"]
    k7_4 = k7_chunk["runs"][4]
    kernels.append(
        {"name": "k_candidate_batching", "route": "cuda",
         "source": "uivr_tpu_torch/ops/csrc/volpath_primal.cu",
         "replaces": "uivr_tpu/ops/volpath_step.py:366", "redesigned": "persistent",
         "launches": k7_train["launches"]["k_candidate"],
         "launches_per_train_step": k7_first["counts"]["k_candidate"],
         "max_abs_err": k7_chunk["max_abs_err"], "ms": k7_chunk["ms"][4],
         "ms_k1": k7_chunk["ms"][1], "ms_by_k": k7_chunk["ms"],
         "ms_direct_by_k": k7_chunk["ms_direct"], "utilization": k7_4["utilization"],
         "utilization_direct": k7_4["utilization_direct"], "plain_ms": k7_chunk["plain_ms"],
         "bound_ms": k7_chunk["bound_ms"], "bound_by": k7_chunk["bound_by"],
         "gather_bound_ms": k7_chunk["gather_bound_ms"],
         "discarded_share": k7_chunk["counts"][4]["discarded_share"], "library_ms": None,
         "shape": f"volpath_primal_k_kernel<4>, {n} rays, janga-smoke sensor 0 render chunk",
         "counts": k7_chunk["counts"][4],
         "xml_chunk_ms": k7x["chunk_ms"], "xml_max_abs_err": k7x["max_abs_err"],
         "train_slice_max_abs_err": k7_rec["slice_max_abs_err"],
         "truth_forward_kernels_ms": {"k4": k7_rec["truth_forward_kernels_ms"],
                                      "k1": k7_rec["truth_forward_kernels_ms_k1"]}})
    kernels.append(
        {"name": "volpath_primal_k_direct", "route": "cuda",
         "source": "uivr_tpu_torch/ops/csrc/volpath_primal.cu",
         "replaces": "uivr_tpu/ops/volpath_step.py:366", "comparison_only": True,
         "launches": k7_train["launches"]["volpath_primal_k_direct"],
         "max_abs_err": k7_chunk["max_abs_err"], "ms": k7_chunk["ms_direct"][4],
         "ms_direct_by_k": k7_chunk["ms_direct"], "plain_ms": k7_chunk["plain_ms"],
         "bound_ms": k7_chunk["bound_ms"], "bound_by": k7_chunk["bound_by"], "library_ms": None,
         "utilization": k7_4["utilization_direct"],
         "shape": f"volpath_primal_k_direct_kernel<4>, {n} rays, janga-smoke render chunk"})
    if k7_train["launches"]["volpath_primal_k_direct"] != 0:
        raise RuntimeError("the main path launched volpath_primal_k_direct")
    by_name = {k["name"]: k for k in kernels}
    # the DRT term's persistent walk and NEE against their direct kernels
    for name, key in (("volpath_drt_walk", "walk_persistent_vs_direct"),
                      ("volpath_drt_nee", "nee_persistent_vs_direct")):
        rec = check[key]
        base = by_name[name]
        base.update({"redesigned": "persistent",
                     "ms_persistent_same_shape": rec["ms_persistent"],
                     "ms_direct_same_shape": rec["ms_direct"],
                     "equal_to_direct": all(rec["equal_to_direct"].values())})
        if name == "volpath_drt_walk":
            base.update({k: rec[k] for k in ("utilization_direct", "utilization_persistent",
                                             "grid_lanes", "trips", "warp_iterations",
                                             "ns_per_warp_iteration")})
        kernels.append({
            "name": name + "_direct", "route": "cuda", "source": base["source"],
            "replaces": base["replaces"], "comparison_only": True,
            "launches": train["launches"][name + "_direct"],
            "max_abs_err": base["max_abs_err"], "ms": rec["ms_direct"],
            "plain_ms": base["plain_ms"], "bound_ms": base["bound_ms"],
            "bound_by": base["bound_by"], "library_ms": None,
            "utilization": rec.get("utilization_direct"), "shape": base["shape"]})
    for name in ("volpath_drt_walk_direct", "volpath_drt_nee_direct"):
        if train["launches"][name] != 0:
            raise RuntimeError(f"the main path launched {name}")
    k7_default = {"train": train["launches"]["k_candidate"],
                  "render": {k: v["k_candidate"] for k, v in render_launches.items()}}
    if k7_default["train"] or any(k7_default["render"].values()):
        raise RuntimeError(f"with UIVR_KCAND unset the main path launched K7: {k7_default}")
    # the persistent kernels' utilization and their direct times; the
    # one-ray-per-thread kernels, for comparison only (the main path never
    # launched them: their counts in the main run are 0)
    pairs = (("volpath_primal", "volpath_primal_direct", persist["render_chunk"]),
             ("volpath_primal_state", "volpath_primal_state_direct", persist["state"]),
             ("volpath_adjoint", "volpath_adjoint_direct", persist["adjoint"]))
    for name, dname, rec in pairs:
        base = by_name[name]
        base.update({"ms_direct_same_shape": rec["ms_direct"],
                     "ms_persistent_same_shape": rec["ms_persistent"],
                     "utilization_direct": rec["utilization_direct"],
                     "utilization_persistent": rec["utilization_persistent"],
                     "same_shape": f"{rec['rays']} rays, {rec.get('launch', 'adjoint')}"})
        kernels.append({
            "name": dname, "route": "cuda", "source": base["source"],
            "replaces": base["replaces"], "comparison_only": True,
            "launches": train["launches"][dname], "max_abs_err": base["max_abs_err"],
            "ms": rec["ms_direct"], "plain_ms": base["plain_ms"], "bound_ms": base["bound_ms"],
            "bound_by": base["bound_by"], "library_ms": None,
            "utilization": rec["utilization_direct"],
            "shape": f"{rec['rays']} rays, {rec.get('launch', 'janga-smoke truth adjoint')}"})
        if train["launches"][dname] != 0:
            raise RuntimeError(f"the main path launched {dname}")
    fc = persist["forward_chunk"]
    by_name["volpath_primal"]["truth_forward_chunk"] = {
        k: fc[k] for k in ("rays", "ms_direct", "ms_persistent", "utilization_direct",
                           "utilization_persistent")}
    emit({"kernels": kernels, "card": card})
    if not all(math.isfinite(k[f]) for k in kernels for f in ("ms", "plain_ms", "bound_ms")):
        raise RuntimeError("a kernel timing is not finite")

    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        emit({"phase": "failed", "error": traceback.format_exc().splitlines()[-1]})
        rc = 1
    finally:
        close_twin_pool()
    sys.exit(rc)
