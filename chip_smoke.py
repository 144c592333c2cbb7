#!/usr/bin/env python3
"""On-card smoke run of dhqr_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed N]
                          [--phases 0,1,2,...,21,22,23]
                          [--accuracy-seeds N]

Needs one CUDA card (an H100 for the bounds below); exits non-zero without
one, and without the port beside it. Phases, each of which fails the run
on any error (0-6 and 8-23 run by default, 7 on request):

0. setup: the card's name and power limit, the nvcc build of the port's
   kernels (timed as set-up), and the full-FP32 matmul check;
1. every kernel against its plain PyTorch version on the card, at the
   leading panel shapes of the main, TSQR and gradient paths, at the
   sharded ``lstsq``'s 125-wide panels (its first and last), and at the
   shapes that stress the kernel's grid (an
   offset inside a CTA's slice, a ragged last CTA, a panel on a few CTAs,
   the tall 64-wide leaf, the tall ``lstsq``'s 32-wide leaves, 12-decade
   data over every SM, slices past the registers, which the kernel keeps
   in shared memory, and panels too tall for shared memory, which it
   streams, and the lookahead schedule's launches capped at
   ``LOOKAHEAD_CTAS`` SMs), and the port-only float64 kernel at the
   source's 4400 x 4000 test problem's panels (4400 x 128 at offsets 0,
   1984 and 3968), the square and tall leaves, its grid edges, 12-decade
   data and its shared and streamed variants, with its grid, variant
   (registers with no
   spill, shared or streamed), shared memory, registers and spills, a
   bit-identical repeat launch, and at the main path's shapes, the
   ``lstsq`` leaves and the shared, streamed and capped ones its time,
   the plain version's time, ``torch.geqrf``'s time on the same panel (a
   yardstick the port never calls) and the card's bound for the work;
   then the panels past 32-bit indices (``TALL_CASES``: the 16-wide
   streamed leaf at 2^27 + 8191 rows, f32, c64 and f64, more than 2^31
   elements, and one f32 column of 2^31 + 4097 rows), made on the card
   from a seeded generator, each held against its plain version in
   pieces with a bit-identical repeat, with its grid, registers, spills,
   the same times (``torch.geqrf`` where its output and workspace fit the
   free memory, else the reason) and its peak device memory;
2. main path, float32, square: ``qr`` and ``solve`` (each timed on its
   first call, which holds first-use set-up, and on a steady-state second
   call) and ``lstsq`` at 16384 x 16384, backward error and kernel launch
   counts;
3. main path, float32, tall: ``lstsq`` at 65536 x 256, at 524288 x 128
   (streamed 16-wide leaves) and at (2^27 + 8191) x 16 (one streamed leaf
   of more than 2^31 elements: one launch) against ``torch.linalg.lstsq``
   (yardstick) on the normal-equations residual, evaluated in float64 a
   block of rows at a time, with each call's peak device memory;
4. main path, complex64: ``qr`` (first and second call) -> ``solve`` at
   8192 x 4096;
5. the reference's criterion: ``lstsq`` at 4400 x 4000, float32,
   complex64 and float64 (the source's own type, on the f64 kernel),
   within 8x of numpy's LAPACK QR on the normal-equations residual;
6. where the time goes: ``torch.profiler`` device time of one 16384^2
   float32 ``qr`` by kernel class (panel kernel, GEMM, triangular solve,
   other) and the device's busy share of the call's wall time;
7. (opt-in: ``--phases 0,7``) where a panel's time goes: the kernel's time
   per call at panels from 5 to 132 CTAs, and the SM cycles per column in
   each section of a column step (merge, column pass, trailing pass, grid
   barrier) from a second build with section timers
   (``-DDHQR_PANEL_PROFILE``);
8. precision: the ``"high"`` (3 bf16 passes) and ``"default"`` (1 pass)
   products of ``ops/gemm.py`` on the card against their plain versions at
   the trailing update's shapes, f32 and c64, with their times and the full
   FP32 product's; ``qr`` at 16384^2 f32 for each trailing precision
   (steady-state second call, backward error); ``lstsq`` at 4400 x 4000,
   f32 and c64, for every ``POLICY_LADDER`` cell and the three presets, as
   a ratio to numpy's LAPACK QR (``accurate`` must meet 8x, the other
   rungs must be finite and say whether they do), beside the same ratio of
   witnesses (``torch.linalg.lstsq``; the port's factors with Q^H b
   through an explicit Q); and the factor quality at 4400 x 4000, f32 and
   c64 (backward error and orthogonality in f64 on the card) of the
   kernel's factors, the plain panel loop's and the kernel's schedule in
   eager PyTorch (the grid model as the engine's leaf, on the card), the
   kernel within 2x of the plain loop, with their ``lstsq`` ratios
   (``--accuracy-seeds N`` repeats kernel and plain loop for N seeds);
9. engines at ``BASELINE.json``'s tall-skinny 65536 x 256 f32:
   ``tsqr_lstsq`` (8 leaves of 8192 x 256; and c64 at 32768 x 256),
   ``tsqr_r`` (Gram identity), ``cholesky_qr_lstsq`` (shift off and on) and
   ``lstsq(engine=...)`` for tsqr, cholqr2 and cholqr3, each against
   ``torch.linalg.lstsq`` (yardstick) under the 8x bar and timed; each
   TSQR call's kernel launches equal the port's panel plan;
10. gradients: (a) ``lstsq_diff`` at 4096 x 512 f32 (and 2048 x 256 c64),
   the gradient of a scalar loss against the float64 normal-equations
   gradient autograd computes on the card (a yardstick the port never
   calls), the adjoint identity between ``jvp`` and ``backward``, forward
   + backward time against the forward alone, and the forward's kernel
   launches; (b) the factorization's own derivative
   (``householder_factor``): ``qr`` (a loss on H and alpha) and
   ``qr_explicit`` (a loss on Q and R) at 4400 x 4000 f32,
   ``lstsq(engine="tsqr")`` and ``lstsq(blocked=False)`` at 65536 x 256
   f32, the minimum-norm ``lstsq`` at 256 x 65536 f32 and ``qr`` at 2048 x
   256 c64: the directional derivative of each route (kernel, f32 plain
   panels, f64 plain panels) against an f64 central difference, the
   kernel route's gradient within 2x of the f32 plain route's error
   against the f64 route's gradient, ``torch.linalg.qr``'s f64 autograd
   gradient (yardstick) for ``qr_explicit`` and the f64 normal-equations
   gradient for the ``lstsq`` routes, the ``jvp``/``backward`` adjoint
   identity, the forward with grad bit for bit the one without and its
   launches = plan, forward and forward + backward times beside
   ``torch.linalg.qr``'s, and the backward's peak memory over the
   forward's (at most 6x A's bytes); and ``torch.profiler``'s view of
   the c64 backward (the card's idle share, kernels launched);
11. schedules: ``qr`` at 16384^2 f32 and 8192 x 4096 c64 by default, with
   ``lookahead=True`` and with ``agg_panels`` 2 and 4 (steady seconds,
   GFLOP/s, backward error, distance from the default's factors, launches
   = plan), the lookahead CTA cap swept over 16/33/66/132 with the
   ``torch.profiler`` device time in which a panel kernel and a GEMM ran
   at once, and ``lstsq`` at 4400 x 4000 per schedule under the 8x bar;
12. reconstruct: ``qr`` + ``solve`` with ``panel_impl="reconstruct"`` and
   ``"reconstruct:4096"`` at 16384 x 2048, f32 and f64 (plain panel
   path: ``use_pallas="never"``, as the kernel would take the panels),
   beside the ``"loop"`` engine, and ``lstsq`` at 4400 x 4000 under 8x;
13. sketch: ``lstsq(engine="sketch")`` at 65536 x 256 and 131072 x 256 f32
   and 32768 x 256 c64 (SRHT by "auto"), and the count sketch at 65536 x
   256, against ``torch.linalg.lstsq`` (8x) beside it and ``cholqr2``,
   with the operator draws per call;
14. sharded: the distributed tier, its ranks spawned processes that share
   card 0 (``dhqr_tpu_torch/parallel/_ranks.py``; the compute mode must
   be Default and MPS off): (a) NCCL with one rank, ``qr`` + ``solve`` at
   16384^2 f32 on ``column_mesh``, default and ``lookahead``, beside the
   single-device ``lookahead`` factors, and one mesh ``solve`` traced with
   ``torch.profiler`` beside the single-device one (the card's busy time
   and the ops that take the most device and host time); (b) gloo with 4
   ranks, the same per
   layout (block, cyclic) and schedule (default, ``lookahead``,
   ``agg_panels=2``); (c) gloo with 2 ranks, c64 ``qr`` + ``solve`` at
   8192 x 4096; (d) gloo with 4 ranks, ``lstsq(mesh=)`` at the reference's
   4400 x 4000 f32 and c64 and at 4400 x 3998 f32 (padded) under 8x; (e)
   gloo with 4 ranks, TSQR and CholeskyQR2 on the row mesh at 65536 x 256
   f32 against ``torch.linalg.lstsq`` (8x). Each factorization's backward
   error, its distance from the single-device factors (H for the one-rank
   default, else R up to row signs, with the pivots that took the other
   sign and the first one's size), its solve's normal-equations residual
   against the single-device solve's (8x), and the launches summed over
   the ranks against the single-device plan (P times it for
   ``agg_panels``, every rank factoring each group; TSQR: P times a leaf
   and a combine). Gloo carries the
   collectives through the host and the ranks time-share one H100, so a
   time here is never a scaling number;
15. guarded: ``guarded_lstsq`` at 16384^2 f32 in the default "fallback"
   mode against the unguarded ``lstsq`` (x bit-identical, the same
   launches, the guard's cost in percent), the same under an injected
   ``numeric.breakdown`` (the policy rung answers within 8x of
   ``torch.linalg.lstsq``), ``engine="cholqr2"`` with ``guards="full"`` at
   65536 x 256 f32 of condition 1e5 (rung 0 breaks down, the answer meets
   the residual gate) and a schedule that lands on the tsqr rung (its
   launches the TSQR plan), ``guarded_qr`` at 8192 x 4096 c64 (launches,
   backward error; a zero column refused before any launch) and
   ``guards="full"`` at 4400 x 4000 f32; then ``UpdatableQR`` on a stream
   of 64 rank-1 steps at 65536 x 256 f32 (refactor reasons, 4 launches
   for the initial factorization and each refactor and none for any other
   step, the sweeps' R against the live A's Gram beside what a sweep that
   did nothing would read, solves within 8x of ``torch.linalg.lstsq``, an
   update/downdate round trip, ms per update and per solve, kernels per
   update from ``torch.profiler``, beside a fresh ``qr`` and ``lstsq``);
16. wire: the compressed wire, the two-tier pod mesh, the depth-k
   pipeline and pulse, ranks sharing card 0 as in 14: (a) NCCL with one
   rank, ``qr(mesh=)`` + ``solve`` at 16384^2 f32 at ``comms`` None,
   ``"bf16"`` and ``"int8"``; (b) gloo with 4 ranks at 16384^2 f32: None,
   flat bf16 and int8, a 2x2 ``pod_mesh`` hierarchical and flat at None
   and ``"dcn:bf16"``, ``overlap_depth`` 2 and 3 at None and bf16; each
   with its seconds, backward error (a compressed one above the
   uncompressed one's, and below 0.05 on the bf16 wire), launches summed over the ranks (the plan, 128,
   pipelines included) and the wire census by family and leg, every
   entry's bytes equal to ``wire_bytes_formula`` and their ratio to the
   uncompressed bytes printed; (c) ``lstsq(mesh=)`` at the reference's
   4400 x 4000 f32 at bf16 and int8 on the column mesh and dcn:bf16 and
   dcn:int8 on the 2x2 pod mesh, with the model tier's floor of sweeps (its
   ratio to numpy's LAPACK QR printed: the floor does not reach 8x at this
   condition, nor int8 at all) and bf16 / dcn:bf16 with ``refine=6``
   sweeps, under 8x; (d) TSQR
   and CholeskyQR2 on a 4-rank row mesh at 65536 x 256 f32 uncompressed
   and at bf16 and int8, under 8x of numpy's LAPACK QR (with
   ``torch.linalg.lstsq``'s ratio beside it); (e) gloo with 2 ranks, 8192 x
   4096 c64 at bf16: no complex payload compressed, H, alpha and x
   bit-identical to None's; (f) pulse armed around one ``qr`` + ``solve``
   of (a) and of (b): the measured collective families, the census, and
   DHQR306, which must read skip with its reason;
17. serve: the batched serving tier on the JAX package's serving workload
   (``benchmarks/serving_throughput.py``: 256 f32 requests from its
   8-shape ladder, Zipf weights, micro-batches of 32), each bucket a CUDA
   graph captured once per cache key: (a) ``batched_lstsq``, a cold pass
   (the captures, their seconds) and 5 warm passes (zero misses,
   requests/s, p50/p99 per micro-batch), every residual under 8x numpy
   LAPACK's, beside one pass over half the mix with every key's program
   run eager and a loop of single ``lstsq`` calls (printed), and kernels
   per dispatch replayed and eager (``torch.profiler``); (b) ``batched_qr`` on the mix
   (backward errors under 1e-5, solves within 1e-5 of (a), the stack
   factored in place, results unchanged by a later replay); (c) 64 c64
   requests under 8x; (d) ``batched_sketched_lstsq`` at 16500 x 64 and
   16500 x 256 f32 under 8x of ``torch.linalg.lstsq``'s residual; (e) replay bit-identical to the eager
   program, a NaN request under ``guards=`` raising ``Breakdown``, the
   ``serve.dispatch`` and ``serve.compile`` fault sites; (f) xray armed:
   one report per captured key with its device seconds and achieved
   GFLOP/s, and the registry's ``serve.cache.*`` names;
18. serve_async: the async scheduler, the fleet router and the key store
   on the JAX package's async and fleet serving workloads
   (``benchmarks/serving_async.py``: 512 f32 requests over the same
   ladder, micro-batches of 32, SLO 1000 ms, flush interval 300 ms;
   ``benchmarks/serving_fleet.py``: 3 replicas and the kill ladder), over
   phase 17's captured programs and every power-of-two batch ``prewarm``
   adds: (a) capacity, the queued mix drained by a manual-mode scheduler
   beside the synchronous ``batched_lstsq`` ceiling, interleaved (zero
   misses, the drain's x bit-identical to the sync tier's, every residual
   under 8x); (b) open loop, Poisson arrivals at 0.92 of (a) (requests/s
   over the arrival window, p50 / p99 submit to done, zero rejects); (c)
   the ``serve.worker`` and ``serve.dispatch`` fault sites, a NaN request
   isolated by bisection, ``BackpressureError``; (d) phase 15 (f)'s
   update stream submitted as the ``"update"`` kind (R and the solves bit
   for bit the direct session's, 4 launches per factorization); (e) two
   keys of one lane, then of two lanes, replayed 200 times each from two
   threads while a third captures (bit-identical to serial replays; the
   same without lanes, a lock per program, rebuilt beside it); (f) a
   3-replica router beside one scheduler on a 256-request burst, the
   tenant spread, the kill ladder, a sticky update session; (g) a child
   interpreter on a key store this process recorded: its recaptures,
   counted misses with their reason, zero warm misses, an adopted
   quarantine;
19. tune_armor: the tuner and the armor seam, into a temporary plan DB
   (``DHQR_TUNE_DB``): (a) ``tune("lstsq", 65536, 256)`` at the default
   budget, each candidate's plan, ms, ratio to numpy's LAPACK QR and
   kernel launches, the winner and its speedup, then ``lstsq(plan=
   "auto")`` hitting the DB with no second tune, bit-identical to the
   winner's knobs; (b) ``tune("qr", 16384, 16384)`` at budget 8 and 2
   repeats (the f64 Gram gate on the card), then ``qr(plan="auto")``
   launching the winner's panel plan; (c) ``prewarm(plan="auto")`` of
   ``serve_lstsq`` on phase 17's two heaviest shapes, each bucket's
   candidates captured and replayed, then 256 requests with zero misses,
   the plan segment in the keys; (d) three rung-0 gate failures of
   ``guarded_lstsq(plan="auto")`` under an injected ``numeric.breakdown``
   demote the tall key (``resolve_plan`` None, ``tune.plan_gate.*`` in
   the registry); (e) ``armor.checks.qr_gap`` at 16384^2, honest against
   a corrupted entry (2 decades apart, localized); ``qr(mesh=)`` on one
   NCCL rank at 16384^2 f32 armed and disarmed (bit-identical, one
   verification, equal launches, the armed overhead); 4 gloo ranks at
   4400 x 4000 f32: a one-shot ``parallel.collective.corrupt`` in the
   ``lstsq``'s solve stage and one in a ``qr`` panel re-dispatched away,
   the same hit on an ``lstsq`` panel printed (the normal-equations
   checksum misses it at this size), a persistent ``drop`` typed
   ``ShardFailure`` with a shard index,
   the integrity tags poisoning a corrupted bf16 sum, two one-shot
   corruptions and a NaN on two dispatches of the bf16 ``sharded_lstsq``
   (re-dispatch, then the f32 degrade), and the three trips stripping
   ``comms`` from a stored plan in ``resolve_plan``; 2 gloo ranks at 8192
   x 4096 c64 armed, bit-identical to disarmed; (f) a mesh-less
   ``obs.pulse.measure`` of a card ``lstsq`` records CUDA events;
20. harness: the port's CLI entry points on the card: (a) the reference's
   sweep, ``harness.main(["1", "--sizes", "110x100,1100x1000,4400x4000",
   "--dtypes", "float32,complex64", "--bench"])`` in this process, every
   row ``ok`` under 8x numpy LAPACK's residual, each slowdown ratio
   printed; (b) ``harness 4 --sizes 4400x4000 --dtypes float32`` on four
   gloo ranks sharing the card, their launches added to this process's;
   (c) ``graft_entry.dryrun_multichip(4)`` with ``DHQR_DRYRUN_FULL=1`` in
   a child process, ``dryrun: all paths ok`` and each stage's seconds;
   (d) ``graft_entry.entry()``'s step twice against
   ``torch.linalg.lstsq`` under 8x, exactly 4 ``panel_qr_f32`` launches
   per call (128 columns at nb 32);
21. analysis: the port's lint on the card: (a) the self-scan of
   ``dhqr_tpu_torch``, ``chip_smoke.py`` and ``tests/test_torch_*.py``
   (the AST rules and the API check) with 0 unsuppressed findings, the
   suppressions counted by rule; (b) the concurrency pass with its
   lock-witness burst on the card, where the lanes capture and replay
   CUDA graphs: 0 findings, the witnessed edges (those through a lane lock
   counted apart), 0 held-set violations and the captures; (c) the count
   sketch's repeat: ``sketched_lstsq`` twice at 768 x 12 and at 65536 x
   256 f32 bit for bit (``torch.equal``), and at 65536 x 256 the bucket
   sum's time beside the ``index_add_`` sum it replaced (a yardstick the
   port no longer calls), their relative distance, and the bound of the
   bucket sum's bytes;
22. graph: the graph passes of the port's lint on the card: (a) the jaxpr
   pass (``analysis/jaxpr_pass.py``) over every preset, each registered
   route run once under the op log (``analysis/oplog.py``) on the card,
   and the complex64 ``qr`` / ``lstsq``: 0 unsuppressed findings, no f64
   op in an f32 route, every ``panel_qr_f32`` / ``panel_qr_c64`` event
   from the ``kernel`` path and as many as the launch counter moved, the
   host syncs per route; (b) the comms pass (``analysis/comms_pass.py``)
   at P = 2 and 4, gloo ranks sharing the card as in phase 14: 0
   unsuppressed findings, each route's logged bytes beside its contract's
   budget, the double-run stability check at P = 2, and the donation
   probes on the card; (c) the xray and pulse smokes on the card with the
   report's MFU, roofline bound and measured census; (d) the atlas with
   the collided serve cells compared on their CUDA-graph captures; (e)
   ``python -m dhqr_tpu_torch.analysis check`` with every pass in a child
   process (uncounted): exit 0, ``0 finding(s)``, its wall time; and, as
   a guard on the disarmed seam, steady-state ``qr`` 16384^2 f32 within
   PERF.md's spread (0.245-0.250 s) plus 2%;
23. in place: the kernel on a view of the matrix H itself, its rows read
   and written through H's row stride (the blocked engine's leaf,
   ``hopper_panel._panel_qr_kernel_in_place``), against the wrapper's
   transposed copy at ``IN_PLACE_CASES`` (the tall ``lstsq``'s 32-wide
   leaf at columns 0 and 96 of 131072 x 512, 16384 x 128 in 16384^2,
   uncapped and capped at ``LOOKAHEAD_CTAS``, the float64 4400 x 128 at
   offsets 0, 1984 and 3968 of 4400 x 4000 and its last panel, 32 wide,
   8192 x 128 c64, 100000 x 64 in shared memory, and a streamed 524288 x
   16 leaf, which must take the transposed copy): the factors and alpha
   bit for bit, H outside the view's active rows untouched, the layout
   taken, and the device time of the in-place entry beside the wrapper's
   and of the kernel alone in each layout.

Launch counts are zeroed right before each counted path and read right
after it: the main path (phases 2-5), the precision path (8), the TSQR
path (9), the gradient path (10), the schedules path (11), the
reconstruct (12) and sketch (13) paths, which must launch no panel kernel,
the sharded path (14), whose ranks' counts of their mesh calls alone
(zeroed after the single-device references each rank computes) are added
to the parent's, the guarded path (15 (a)-(e), its guarded calls), the
update path (15 (f), the stream's calls), each of which must equal what
the phase's own calls counted; the yardsticks inside them (the unguarded
``lstsq`` of (a), the fresh ``qr`` / ``lstsq`` of (f)) are taken back out
of the counts, the wire path (16), whose ranks' counts are added to
the parent's, and the serve path (17), which must launch no panel kernel
(its loop of single ``lstsq`` calls is a yardstick, taken back out), and
the async serve path (18), whose batched dispatches launch no panel
kernel and whose ``"update"`` kind launches 4 per factorization (its
direct yardstick stream, when phase 15 did not run, and the sticky
session's construction are taken back out), the tune_armor path (19),
whose ranks' counts are added to the parent's and on which both kernels
must launch, and the harness path (20 (a), (b), (d); the dry run of (c)
runs in a child process of its own, uncounted), on which both kernels
must launch, and the analysis path (21), whose witness burst goes through
the serve tier's column loop and may launch none, and the graph path
(22; its comms ranks and its CLI child uncounted), on which both kernels
must launch. The ``kernels`` line sums the paths. Phases 2 and 3 also
print each call's launches by layout (``LAYOUT_LAUNCHES``) beside those
by variant, held to ``blocked.plan_layouts``. Phases 6, 7 and 23 are
measurements and checks and are not counted. Each phase prints JSON
lines; then the ``kernels`` line, the card's ``nvidia-smi`` name and
power limit, and last the result line. Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and FLOP/s: FP32 on the
# CUDA cores, which is also the FP64 tensor-core rate, the most any float64
# kernel can reach on the card.
HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = 67e12

# Stated tolerances.
TOL_F32 = 2e-5       # kernel vs plain, f32: relative to max|.| of the plain result
TOL_C64 = 5e-5       # kernel vs plain, c64
TOL_F64 = 1e-12      # kernel vs plain, f64: the two sum in different orders,
                     # ~1e-14 of roundings at these heights, so 100x room
TOL_DECADES = 5e-7   # |alpha_0| vs the f64 column norm on 12-decade data
TOL_DECADES_F64 = 1e-12  # the same for the f64 kernel (numpy's own f64 norm
                         # carries ~1e-14 of rounding)
TOL_BACKWARD_F32 = 1e-5   # ||QR - A|| / ||A||, float32 (BASELINE.json)
TOL_BACKWARD_C64 = 5e-5   # the same, complex64
TOL_SOLVE_AGREE = 1e-5    # ||x - x2|| / ||x2||, qr().solve vs lstsq
CRITERION = 8.0           # normal-equations residual factor (reference)
TOL_BF16 = 1e-5      # bf16 pass vs plain: max|diff| / max(|C| + |A||B|)
TOL_GRAM = 2e-5      # ||R^H R - A^H A|| / ||A^H A||, f32 R (TSQR, sweeps)
TOL_GRAD = 1e-4      # f32 gradient vs the f64 normal-equations gradient
TOL_ADJOINT = 1e-4   # |<w, J u> - <J^T w, u>| / |<w, J u>|, f32
TOL_CD64 = 1e-8      # f64 route's directional derivative vs the f64 central
                     # difference of the same loss
TOL_YARDSTICK64 = 1e-8   # f64 gradient vs torch.linalg.qr's f64 autograd
KERNEL_GRAD_FACTOR = 2.0  # kernel gradient error <= 2x the f32 plain route's
BACKWARD_MEM_FACTOR = 6.0  # backward peak - forward peak <= 6x A's bytes

KERNEL_SOURCE = "dhqr_tpu_torch/csrc/panel_qr.cu"
# What one phase hands a later one in the same run: phase 17's serve cache
# (phase 18 reuses its captures) and phase 15 (f)'s update stream (phase 18
# (d) replays it through the scheduler and holds it bit for bit).
_SHARED: dict = {}
REPLACES = {"panel_qr_f32": "dhqr_tpu/ops/pallas_panel.py:192",
            "panel_qr_c64": "dhqr_tpu/ops/pallas_panel.py:247",
            # port-only: the JAX package's float64 panels are plain XLA ops
            "panel_qr_f64": None}
KERNEL_TOLS = {"panel_qr_f32": TOL_F32, "panel_qr_c64": TOL_C64,
               "panel_qr_f64": TOL_F64}
# Phase 1's panels past 32-bit indices, (kernel, m, nb, offset): the
# blocked engine's 16-wide streamed leaf at 2^27 + 8191 rows (2^31 + 131056
# elements; 8.6 GB f32, 17.2 GB c64) and one column of 2^31 + 4097 rows
# (8.6 GB), whose row index itself passes 32 bits.
TALL_CASES = (("panel_qr_f32", 2**27 + 8191, 16, 3),
              ("panel_qr_c64", 2**27 + 8191, 16, 3),
              ("panel_qr_f64", 2**27 + 8191, 16, 3),
              ("panel_qr_f32", 2**31 + 4097, 1, 5))
PIECE = 2**26   # elements per piece of a comparison over such a panel
# Phase 23's panels, (kernel, H's shape, first column c, width, row offset,
# CTA cap, layout): the view H[:, c:c + width] factored from the offset
# down, as the blocked engine's leaves lie in H (offset c: a leaf of the
# first panel; 4400 x 4000's last panel is 32 wide, so its 128-wide case at
# offset 3968 takes the columns before it).
IN_PLACE_CASES = (
    ("panel_qr_f32", (131072, 512), 0, 32, 0, None, "in_place"),
    ("panel_qr_f32", (131072, 512), 96, 32, 96, None, "in_place"),
    ("panel_qr_f32", (16384, 16384), 0, 128, 0, None, "in_place"),
    ("panel_qr_f32", (16384, 16384), 0, 128, 0, 66, "in_place"),
    ("panel_qr_f64", (4400, 4000), 0, 128, 0, None, "in_place"),
    ("panel_qr_f64", (4400, 4000), 1984, 128, 1984, None, "in_place"),
    ("panel_qr_f64", (4400, 4000), 3840, 128, 3968, None, "in_place"),
    ("panel_qr_f64", (4400, 4000), 3968, 32, 3968, None, "in_place"),
    ("panel_qr_c64", (8192, 4096), 0, 128, 0, None, "in_place"),
    ("panel_qr_f32", (100000, 256), 0, 64, 0, None, "in_place"),  # shared
    ("panel_qr_f32", (524288, 128), 0, 16, 0, None, "transposed"),  # streamed
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def once_ms(fn):
    """(result, device ms) of one call of ``fn``, with no warm-up: for work
    of seconds, where one call is the measurement."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def wall(fn):
    """(result, seconds) of ``fn`` ending in a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def panel_bound(m: int, nb: int, dtype):
    """(ms, "bytes" | "operations"): the least time for one (m, nb) panel,
    the larger of reading + writing the panel (and alpha) over HBM and
    ~2 m nb^2 operations (x4 complex) over the card's FP32 / FP64 peak."""
    complex_ = dtype == torch.complex64
    t_bytes = (2 * m * nb + nb) * dtype.itemsize / HBM_BYTES_PER_S
    t_ops = 2 * m * nb * nb * (4 if complex_ else 1) / FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def random_panel(rng, m, nb, dtype, decades=False):
    x = rng.standard_normal((m, nb))
    if decades:
        x = x * np.logspace(-6, 6, m)[:, None]
    if dtype == torch.complex64:
        x = x + 1j * rng.standard_normal((m, nb))
        return torch.from_numpy(x.astype(np.complex64)).cuda()
    if dtype == torch.float64:
        return torch.from_numpy(x).cuda()
    return torch.from_numpy(x.astype(np.float32)).cuda()


def random_problem(m, n, dtype, seed):
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        A = (rng.random((m, n)) + 1j * rng.random((m, n))).astype(dtype)
        b = (rng.random(m) + 1j * rng.random(m)).astype(dtype)
    else:
        A = rng.random((m, n)).astype(dtype)
        b = rng.random(m).astype(dtype)
    return A, b


_LAPACK = {}


def lapack_problem(m, n, dtype, seed):
    """(A, b, numpy's LAPACK solution) of ``random_problem``, solved once
    per process: phases 5, 8, 11 and 12 share the reference's problems."""
    key = (m, n, np.dtype(dtype).name, seed)
    if key not in _LAPACK:
        from dhqr_tpu_torch.utils.testing import lapack_lstsq

        A, b = random_problem(m, n, dtype, seed)
        _LAPACK[key] = (A, b, lapack_lstsq(A, b))
    return _LAPACK[key]


def oracle_of(m, n, dtype, seed):
    """(A, b, the oracle's normal-equations residual)."""
    from dhqr_tpu_torch.utils.testing import normal_equations_residual

    A, b, x = lapack_problem(m, n, dtype, seed)
    return A, b, normal_equations_residual(A, x, b)


# -- phases ------------------------------------------------------------------

def phase_setup():
    from dhqr_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    from dhqr_tpu_torch.ops.hopper_panel import _library

    _library()
    assert torch.backends.cuda.matmul.allow_tf32 is False, \
        "TF32 matmuls are on: precision='highest' needs full FP32"
    assert torch.get_float32_matmul_precision() == "highest"
    emit({"phase": 0, "name": "setup", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "libraries": sorted(p.name for p in paths.values()),
          "ptxas": [ln.strip() for name in paths
                    for ln in _build.build_log(name).splitlines()
                    if "Used" in ln or "spill" in ln]})
    return smi


def phase_kernels(seed):
    from dhqr_tpu_torch.ops import hopper_panel as hp

    rng = np.random.default_rng(seed)
    cases = [  # (kernel, m, nb, offset, 12-decade data, main-path shape,
        #        where each CTA keeps its slice: hp.VARIANTS)
        ("panel_qr_f32", 16384, 128, 0, False, True, "registers"),
        ("panel_qr_f32", 16384, 128, 64, False, False, "registers"),  # mid-slice
        ("panel_qr_f32", 8193, 128, 0, False, False, "registers"),    # ragged last
        ("panel_qr_f32", 129, 128, 0, False, False, "registers"),     # a few CTAs
        ("panel_qr_f32", 65536, 64, 0, False, False, "registers"),    # the tall leaf
        ("panel_qr_f32", 4096, 32, 5, False, False, "registers"),
        ("panel_qr_f32", 767, 8, 0, True, False, "registers"),
        ("panel_qr_f32", 16384, 8, 0, True, False, "registers"),      # 132 CTAs
        # the tall lstsq's leaves (131072 x 512: 16 leaves 32 wide, 993
        # rows per CTA), the first and the fourth, and 12-decade data
        ("panel_qr_f32", 131072, 32, 0, False, False, "registers"),
        ("panel_qr_f32", 131072, 32, 96, False, False, "registers"),
        ("panel_qr_f32", 131072, 32, 0, True, False, "registers"),
        # slices past the registers' 64 floats per thread: shared memory
        ("panel_qr_f32", 100000, 64, 0, False, False, "shared"),
        ("panel_qr_f32", 65536, 128, 0, False, False, "streamed"),
        ("panel_qr_f32", 524288, 16, 0, False, False, "streamed"),  # leaf
        # the leading panels of the TSQR path (phase 9: leaves of 8192 rows,
        # a 2048-row combine on 64 and 60 CTAs) and of the gradient path
        # (phase 10: 4096 rows)
        ("panel_qr_f32", 8192, 128, 0, False, False, "registers"),
        ("panel_qr_f32", 8064, 128, 0, False, False, "registers"),
        ("panel_qr_f32", 2048, 128, 0, False, False, "registers"),
        ("panel_qr_f32", 1920, 128, 0, False, False, "registers"),
        ("panel_qr_f32", 4096, 128, 0, False, False, "registers"),
        # the sharded lstsq's panels (phase 14: 4400 x 4000 on 4 ranks,
        # nb = 125, one leaf each): the first and the last
        ("panel_qr_f32", 4400, 125, 0, False, False, "registers"),
        ("panel_qr_f32", 525, 125, 0, False, False, "registers"),
        ("panel_qr_c64", 8192, 128, 0, False, True, "registers"),
        ("panel_qr_c64", 4096, 32, 5, False, False, "registers"),
        ("panel_qr_c64", 131, 128, 3, False, False, "registers"),
        # the lsq leaf's CTA slice in c64: 497 rows x 32 x 2 floats
        ("panel_qr_c64", 65536, 32, 3, False, False, "registers"),
        ("panel_qr_c64", 100000, 32, 0, False, False, "shared"),
        ("panel_qr_c64", 32768, 128, 7, False, False, "streamed"),
        ("panel_qr_c64", 262144, 16, 3, False, False, "streamed"),  # leaf
        # TSQR (leaves of 4096 rows, a 2048-row combine) and gradient
        # (2048 rows) panels
        ("panel_qr_c64", 4096, 128, 0, False, False, "registers"),
        ("panel_qr_c64", 3968, 128, 0, False, False, "registers"),
        ("panel_qr_c64", 2048, 128, 0, False, False, "registers"),
        ("panel_qr_c64", 1920, 128, 0, False, False, "registers"),
        ("panel_qr_c64", 4400, 125, 0, False, False, "registers"),
        ("panel_qr_c64", 525, 125, 0, False, False, "registers"),
        # float64 (port-only kernel): the source's test problem's rows
        # (4400 x 4000: the first and last panels' offsets and one
        # midway; 34, 32 and 31 rows per CTA), the grid edges, the square
        # and tall leaves,
        # 12-decade data, and the shared and streamed variants (8-byte
        # elements: c64's capacity)
        ("panel_qr_f64", 4400, 128, 0, False, True, "registers"),
        ("panel_qr_f64", 4400, 128, 1984, False, False, "registers"),
        ("panel_qr_f64", 4400, 128, 3968, False, False, "registers"),
        ("panel_qr_f64", 8193, 128, 64, False, False, "registers"),
        ("panel_qr_f64", 129, 128, 0, False, False, "registers"),
        ("panel_qr_f64", 16384, 8, 0, True, False, "registers"),
        ("panel_qr_f64", 16384, 128, 0, False, False, "registers"),
        ("panel_qr_f64", 4096, 32, 5, False, False, "registers"),
        # the one-column kernel's 24 rows per warp, and just past them
        ("panel_qr_f64", 50000, 32, 0, False, False, "registers"),
        ("panel_qr_f64", 60000, 32, 0, False, False, "shared"),
        ("panel_qr_f64", 131072, 16, 0, False, False, "shared"),
        ("panel_qr_f64", 131072, 32, 0, False, False, "streamed"),
        ("panel_qr_f64", 262144, 16, 3, False, False, "streamed"),  # leaf
    ]
    # timed beside the main-path shapes, the streamed, shared and capped
    # launches: the lsq leaves
    timed = {("panel_qr_f32", 131072, 32), ("panel_qr_c64", 65536, 32)}
    # the last field: the CTA cap; the lookahead schedule's capped launches
    # at the main path's panels (phase 11)
    cap = hp.LOOKAHEAD_CTAS
    cases = [case + (None,) for case in cases] + [
        ("panel_qr_f32", 16384, 128, 0, False, False, "registers", cap),
        ("panel_qr_c64", 8192, 128, 0, False, False, "registers", cap)]
    stats = {}
    dtypes = {name: dtype for dtype, name in hp.KERNELS.items()}
    for name, m, nb, off, decades, main_shape, variant, sms in cases:
        dtype, tol = dtypes[name], KERNEL_TOLS[name]
        grid = hp.kernel_launch_info(m, nb, off, dtype, sms=sms)
        panel = random_panel(rng, m, nb, dtype, decades)
        pf, alpha = hp._panel_qr_kernel(panel, off, sms)
        pf2, alpha2 = hp._panel_qr_kernel(panel, off, sms)  # fixed order
        torch.cuda.synchronize()
        repeat_equal = bool(torch.equal(pf, pf2) and torch.equal(alpha, alpha2))
        at = panel.T.contiguous()
        alpha_p = hp._PLAIN[dtype](at, off)
        pf_p = at.T
        err_pf = rel_err(pf, pf_p)
        err_alpha = rel_err(alpha, alpha_p)
        abs_err = float(max((pf - pf_p).abs().max(),
                            (alpha - alpha_p).abs().max()))
        kept = bool(torch.equal(pf[:off], panel[:off]))  # rows above offset
        finite = bool(torch.isfinite(torch.view_as_real(pf) if pf.is_complex()
                                     else pf).all())
        row = {"phase": 1, "kernel": name, "m": m, "nb": nb, "offset": off,
               "cta_cap": sms,
               "grid": grid, "rel_err_pf": err_pf, "rel_err_alpha": err_alpha,
               "max_abs_err": abs_err, "tol": tol, "rows_above_kept": kept,
               "repeat_bit_identical": repeat_equal, "finite": finite}
        ok = (err_pf <= tol and err_alpha <= tol and kept and finite
              and repeat_equal and grid["variant"] == variant
              and (variant != "registers" or (grid["spill_bytes"] == 0)))
        if m <= 1024 and dtype != torch.float64:  # the schedule model
            at_m = panel.T.contiguous()
            alpha_m = hp._panel_qr_grid_model(at_m, off, grid["ctas"])
            row["rel_err_vs_grid_model"] = max(rel_err(pf, at_m.T),
                                               rel_err(alpha, alpha_m))
            ok = ok and row["rel_err_vs_grid_model"] <= tol
        if decades:
            s64 = float(np.linalg.norm(panel[:, 0].double().cpu().numpy()))
            dev = abs(abs(float(alpha[0])) - s64) / s64
            tol_dec = TOL_DECADES_F64 if dtype == torch.float64 \
                else TOL_DECADES
            row.update(alpha0_rel_dev=dev, tol_decades=tol_dec)
            ok = ok and dev < tol_dec
        if (main_shape or variant != "registers" or sms
                or ((name, m, nb) in timed and not decades)
                or (dtype == torch.float64 and not decades and m > 1024)):
            row["ms"] = cuda_ms(lambda: hp._panel_qr_kernel(panel, off, sms),
                                5)
            at2 = panel.T.contiguous()
            row["plain_ms"] = cuda_ms(
                lambda: hp._PLAIN[dtype](at2.copy_(panel.T), off),
                2 if main_shape else 1)
            row["library_ms"] = cuda_ms(lambda: torch.geqrf(panel), 5)
            row["bound_ms"], row["bound_by"] = panel_bound(m, nb, dtype)
            del at2
        row["ok"] = ok
        emit(row)
        if not ok:
            raise AssertionError(f"kernel check failed: {row}")
        st = stats.setdefault(name, {"max_abs_err": 0.0})
        st["max_abs_err"] = max(st["max_abs_err"], abs_err)
        if main_shape:
            st.update({k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")})
        del panel, pf, pf2, at, pf_p
    torch.cuda.empty_cache()
    for case in TALL_CASES:
        abs_err = phase_kernel_tall(hp, seed, *case)
        st = stats.setdefault(case[0], {"max_abs_err": 0.0})
        st["max_abs_err"] = max(st["max_abs_err"], abs_err)
    return stats


def _diff_in_pieces(a, b):
    """(max|a - b|, max|b|, a all finite) of two contiguous tensors of one
    shape, ``PIECE`` elements at a time: no temporary of their size."""
    fa, fb = a.view(-1), b.view(-1)
    diff = top = 0.0
    finite = True
    for i in range(0, fa.numel(), PIECE):
        x, y = fa[i:i + PIECE], fb[i:i + PIECE]
        diff = max(diff, float((x - y).abs().max()))
        top = max(top, float(y.abs().max()))
        finite = finite and bool(torch.isfinite(x).all())
    return diff, top, finite


# Heights cuSOLVER's geqrf takes: its 64-bit API (cusolverDnXgeqrf, which
# torch.geqrf calls) returned CUSOLVER_STATUS_INVALID_VALUE for 2^31 + 4097
# rows on an H100 with CUDA 12.8.
GEQRF_MAX_ROWS = 2**31 - 1
# Elements of A that torch.linalg.lstsq takes: its Q^H b, cuSOLVER's
# 32-bit ormqr, returned CUSOLVER_STATUS_INVALID_VALUE for (2^27 + 8191) x
# 16 f32 on the same card and CUDA.
LSTSQ_MAX_ELEMENTS = 2**31 - 1


def geqrf_room(m, nb, dtype):
    """(fits, reason): whether ``torch.geqrf`` takes a resident (m, nb)
    panel here, decided before the call: a height cuSOLVER takes, and room
    in the free device memory (the cache emptied) for its output (a copy
    of the panel), tau and an allowance of one more panel of workspace."""
    if m > GEQRF_MAX_ROWS:
        return False, (f"{m} rows > {GEQRF_MAX_ROWS}: cuSOLVER's geqrf "
                       "refuses the height")
    torch.cuda.empty_cache()
    need = (2 * m * nb + nb) * dtype.itemsize
    free = torch.cuda.mem_get_info()[0]
    return need <= free, (f"needs {need} B (output, tau and a panel of "
                          f"workspace), {free} B free")


def phase_kernel_tall(hp, seed, name, m, nb, off):
    """Phase 1 on a panel past 32-bit indices: the kernel against its plain
    version, compared in pieces (the panel and its copies take up to 51 GB
    of the card), a bit-identical repeat, and the times; returns the
    largest absolute difference."""
    dtype = next(d for d, k in hp.KERNELS.items() if k == name)
    tol = KERNEL_TOLS[name]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    grid = hp.kernel_launch_info(m, nb, off, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed + m + nb)
    panel = torch.randn((m, nb), generator=g, device="cuda", dtype=dtype)
    pf, alpha = hp._panel_qr_kernel(panel, off)
    pf2, alpha2 = hp._panel_qr_kernel(panel, off)
    torch.cuda.synchronize()
    repeat_equal = bool(torch.equal(pf, pf2) and torch.equal(alpha, alpha2))
    del pf2, alpha2
    at = panel.T.contiguous()
    alpha_p, plain_ms = once_ms(lambda: hp._PLAIN[dtype](at, off))
    abs_pf, top_pf, finite = _diff_in_pieces(pf.T, at)
    abs_alpha = float((alpha - alpha_p).abs().max())
    err_pf = abs_pf / max(top_pf, 1e-30)
    err_alpha = abs_alpha / max(float(alpha_p.abs().max()), 1e-30)
    kept = bool(torch.equal(pf[:off], panel[:off]))
    del pf, alpha, at, alpha_p
    ms = cuda_ms(lambda: hp._panel_qr_kernel(panel, off), 3)
    peak = torch.cuda.max_memory_allocated()
    fits, room = geqrf_room(m, nb, dtype)
    library_ms = once_ms(lambda: torch.geqrf(panel))[1] if fits else None
    bound_ms, bound_by = panel_bound(m, nb, dtype)
    row = {"phase": 1, "kernel": name, "m": m, "nb": nb, "offset": off,
           "elements": m * nb, "cta_cap": None, "grid": grid,
           "rel_err_pf": err_pf, "rel_err_alpha": err_alpha,
           "max_abs_err": max(abs_pf, abs_alpha), "tol": tol,
           "rows_above_kept": kept, "repeat_bit_identical": repeat_equal,
           "finite": finite, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "geqrf_room": room,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "peak_bytes": peak,
           "peak_bytes_with_geqrf": torch.cuda.max_memory_allocated()}
    row["ok"] = (err_pf <= tol and err_alpha <= tol and kept and finite
                 and repeat_equal and grid["variant"] == "streamed")
    emit(row)
    del panel
    torch.cuda.empty_cache()
    if not row["ok"]:
        raise AssertionError(f"kernel check failed: {row}")
    return row["max_abs_err"]


def expected_launches(m, n, dtype):
    """Kernel leaves the blocked engine's own routing chooses for (m, n)."""
    from dhqr_tpu_torch.ops import blocked

    from dhqr_tpu_torch.ops import hopper_panel as hp

    nb = blocked.DEFAULT_BLOCK_SIZE
    cuda = torch.device("cuda")
    kernel = blocked._resolve_kernel("auto", m, dtype, cuda)
    plan = blocked.panel_plan(m, n, nb, kernel, dtype, cuda)
    off = [k for k, w, leaf in plan if not leaf]
    if off:
        print(f"panels not on the kernel for {m}x{n} {dtype}: columns {off}",
              flush=True)
    limits = hp.device_limits(cuda)
    streamed = [k for k, w, leaf in plan
                if leaf and not hp.kernel_resident(m - k, leaf, dtype, *limits)]
    print(f"kernel leaf widths for {m}x{n} {dtype}: "
          f"{sorted({leaf for k, w, leaf in plan if leaf})}; panels streamed: "
          f"{len(streamed)} of {len(plan)}", flush=True)
    return sum(blocked.kernel_leaves(w, leaf) for k, w, leaf in plan if leaf)


def expected_layouts(m, n, dtype):
    """``LAYOUT_LAUNCHES`` of one factorization by the engine's own plan."""
    from dhqr_tpu_torch.ops import blocked

    cuda = torch.device("cuda")
    kernel = blocked._resolve_kernel("auto", m, dtype, cuda)
    plan = blocked.panel_plan(m, n, blocked.DEFAULT_BLOCK_SIZE, kernel, dtype,
                              cuda)
    return blocked.plan_layouts(m, plan, dtype, cuda)


def _diff(after, before):
    return {k: after[k] - before[k] for k in before}


def phase_square(dt, hp, seed, n=16384):
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.rand((n, n), generator=g, device="cuda", dtype=torch.float32)
    b = torch.rand((n,), generator=g, device="cuda", dtype=torch.float32)
    expect = expected_launches(n, n, torch.float32)
    l0 = hp.LAUNCHES["panel_qr_f32"]
    v0, y0 = dict(hp.VARIANT_LAUNCHES), dict(hp.LAYOUT_LAUNCHES)
    fact, t_factor_first = wall(lambda: dt.qr(A))  # first-use set-up inside
    l_qr = hp.LAUNCHES["panel_qr_f32"] - l0
    variants_qr = _diff(hp.VARIANT_LAUNCHES, v0)
    layouts_qr = _diff(hp.LAYOUT_LAUNCHES, y0)
    layouts_want = expected_layouts(n, n, torch.float32)
    del fact
    fact, t_factor = wall(lambda: dt.qr(A))
    x, t_solve_first = wall(lambda: fact.solve(b))  # first-use set-up inside
    x, t_solve = wall(lambda: fact.solve(b))
    x2, t_lstsq = wall(lambda: dt.lstsq(A, b))
    l_all = hp.LAUNCHES["panel_qr_f32"] - l0
    R = fact.r_matrix()
    QR = fact.matmul_q(R)
    backward = float(torch.linalg.vector_norm((QR - A).double())
                     / torch.linalg.vector_norm(A.double()))
    del QR, R
    agree = float(torch.linalg.vector_norm((x - x2).double())
                  / torch.linalg.vector_norm(x2.double()))
    finite = bool(torch.isfinite(x).all() and torch.isfinite(fact.H).all())
    del fact
    torch.cuda.empty_cache()
    torch.geqrf(A[:256, :256])  # solver handle warm-up
    _, t_geqrf = wall(lambda: torch.geqrf(A))
    flops = 4.0 / 3.0 * n ** 3
    row = {"phase": 2, "name": "main_f32_square", "shape": [n, n],
           "factor_first_s": t_factor_first, "factor_s": t_factor,
           "solve_first_s": t_solve_first,
           "solve_s": t_solve, "lstsq_s": t_lstsq,
           "gflops": flops / t_factor / 1e9, "geqrf_s": t_geqrf,
           "geqrf_gflops": flops / t_geqrf / 1e9,
           "backward_error": backward, "tol_backward": TOL_BACKWARD_F32,
           "x_vs_lstsq": agree, "bit_equal": bool(torch.equal(x, x2)),
           "launches_qr": l_qr, "launches_qr_lstsq": l_all,
           "variant_launches_qr": variants_qr,
           "layout_launches_qr": layouts_qr,
           "expected_layouts": layouts_want,
           "expected_per_factorization": expect, "finite": finite}
    row["ok"] = (backward < TOL_BACKWARD_F32 and agree <= TOL_SOLVE_AGREE
                 and finite and expect >= 1 and l_qr == expect
                 and l_all == 3 * expect
                 and sum(variants_qr.values()) == l_qr
                 and layouts_qr == layouts_want)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"main path f32 square failed: {row}")


def ne_residual_f64(A, x, b, rows=2**22):
    """||A^H (A x - b)|| in float64, ``rows`` rows of A at a time: no
    float64 copy of a tall A."""
    x64 = x.to(torch.complex128 if x.is_complex() else torch.float64)
    grad = torch.zeros_like(x64)
    for i in range(0, A.shape[0], rows):
        Ai = A[i:i + rows].to(x64.dtype)
        grad += Ai.mH @ (Ai @ x64 - b[i:i + rows].to(x64.dtype))
    return float(torch.linalg.vector_norm(grad))


def gels_lstsq(A, b):
    """``torch.linalg.lstsq``'s algorithm on the card (gels: geqrf, Q^H b,
    the triangular solve) with Q^H b spelled out, one reflector of
    ``torch.geqrf``'s at a time, for an A past the elements its ormqr takes
    (``LSTSQ_MAX_ELEMENTS``). A yardstick the port never calls."""
    a, tau = torch.geqrf(A)
    n = A.shape[1]
    c = b.clone()
    for j in range(n):
        v = a[j:, j].clone()
        v[0] = 1
        c[j:] -= (tau[j].conj() * (v.conj() @ c[j:])) * v
    R = torch.triu(a[:n])
    return torch.linalg.solve_triangular(R, c[:n, None], upper=True)[:, 0]


def phase_tall(dt, hp, seed, shapes=((65536, 256), (524288, 128),
                                     (2**27 + 8191, 16))):
    """The second shape is too tall for any leaf's slices to fit shared
    memory: its panel runs as streamed 16-wide leaves. The third is one
    such leaf of more than 2^31 elements (8.6 GB), on the kernel's 64-bit
    indices."""
    for i, (m, n) in enumerate(shapes):
        torch.cuda.reset_peak_memory_stats()
        g = torch.Generator(device="cuda").manual_seed(seed + 1 + 10 * i)
        A = torch.rand((m, n), generator=g, device="cuda", dtype=torch.float32)
        b = torch.rand((m,), generator=g, device="cuda", dtype=torch.float32)
        expect = expected_launches(m, n, torch.float32)
        l0 = hp.LAUNCHES["panel_qr_f32"]
        v0, y0 = dict(hp.VARIANT_LAUNCHES), dict(hp.LAYOUT_LAUNCHES)
        x, t_lstsq = wall(lambda: dt.lstsq(A, b))
        l_run = hp.LAUNCHES["panel_qr_f32"] - l0
        row_layouts = _diff(hp.LAYOUT_LAUNCHES, y0)
        layouts_want = expected_layouts(m, n, torch.float32)
        peak_lstsq = torch.cuda.max_memory_allocated()
        res = ne_residual_f64(A, x, b)
        row = {"phase": 3, "name": "main_f32_tall", "shape": [m, n],
               "variant_launches": _diff(hp.VARIANT_LAUNCHES, v0),
               "layout_launches": row_layouts,
               "expected_layouts": layouts_want}
        if m * n <= LSTSQ_MAX_ELEMENTS:
            x_ref, t_ref = wall(
                lambda: torch.linalg.lstsq(A, b[:, None]).solution[:, 0])
            # the spelled-out gels beside it, where both run
            x_gels, t_gels = wall(lambda: gels_lstsq(A, b))
            row.update(gels_s=t_gels, gels_residual=ne_residual_f64(
                A, x_gels, b))
            del x_gels
        else:
            x_ref, t_ref = wall(lambda: gels_lstsq(A, b))
            row["yardstick"] = (
                f"torch.geqrf + reflectors: {m * n} elements > "
                f"{LSTSQ_MAX_ELEMENTS}, torch.linalg.lstsq's ormqr refuses "
                "them")
        res_ref = ne_residual_f64(A, x_ref, b)
        row.update({"lstsq_s": t_lstsq, "torch_lstsq_s": t_ref,
                    "normal_eq_residual": res,
                    "torch_lstsq_residual": res_ref,
                    "ratio": res / res_ref, "criterion": CRITERION,
                    "launches": l_run, "expected": expect,
                    "peak_bytes_lstsq": peak_lstsq,
                    "peak_bytes": torch.cuda.max_memory_allocated()})
        row["ok"] = bool(np.isfinite(res)) and res <= CRITERION * res_ref \
            and l_run == expect and row_layouts == layouts_want
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"main path f32 tall failed: {row}")
        del A, b, x, x_ref
        torch.cuda.empty_cache()


def phase_complex(dt, hp, seed, m=8192, n=4096):
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    A = torch.complex(torch.rand((m, n), generator=g, device="cuda"),
                      torch.rand((m, n), generator=g, device="cuda"))
    b = torch.complex(torch.rand((m,), generator=g, device="cuda"),
                      torch.rand((m,), generator=g, device="cuda"))
    expect = expected_launches(m, n, torch.complex64)
    l0 = hp.LAUNCHES["panel_qr_c64"]
    fact, t_factor_first = wall(lambda: dt.qr(A))  # first-use set-up inside
    l_qr = hp.LAUNCHES["panel_qr_c64"] - l0
    del fact
    fact, t_factor = wall(lambda: dt.qr(A))
    x, t_solve = wall(lambda: fact.solve(b))
    R = torch.cat([fact.r_matrix(), A.new_zeros((m - n, n))])
    QR = fact.matmul_q(R)
    backward = float(torch.linalg.vector_norm((QR - A).to(torch.complex128))
                     / torch.linalg.vector_norm(A.to(torch.complex128)))
    finite = bool(torch.isfinite(torch.view_as_real(x)).all())
    row = {"phase": 4, "name": "main_c64", "shape": [m, n],
           "factor_first_s": t_factor_first, "factor_s": t_factor,
           "solve_s": t_solve,
           "gflops_real": 4 * (2 * m * n * n - 2.0 / 3.0 * n ** 3) / t_factor / 1e9,
           "backward_error": backward, "tol_backward": TOL_BACKWARD_C64,
           "launches_qr": l_qr, "expected": expect, "finite": finite}
    row["ok"] = backward < TOL_BACKWARD_C64 and finite and l_qr == expect
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"main path c64 failed: {row}")


def phase_reference(dt, hp, seed, m=4400, n=4000):
    from dhqr_tpu_torch.utils.testing import normal_equations_residual

    for dtype, name in ((np.float32, "panel_qr_f32"),
                        (np.complex64, "panel_qr_c64"),
                        (np.float64, "panel_qr_f64")):
        A, b, oracle = oracle_of(m, n, dtype, seed + 3)
        l0 = hp.LAUNCHES[name]
        x, t = wall(lambda: dt.lstsq(A, b))
        l_run = hp.LAUNCHES[name] - l0
        x = x.cpu().numpy()
        res = normal_equations_residual(A, x, b)
        row = {"phase": 5, "name": "reference_criterion",
               "dtype": np.dtype(dtype).name, "shape": [m, n], "lstsq_s": t,
               "normal_eq_residual": res, "lapack_residual": oracle,
               "ratio": res / oracle, "criterion": CRITERION,
               "launches": l_run}
        row["ok"] = bool(np.isfinite(res)) and res < CRITERION * oracle \
            and l_run >= 1
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"reference criterion failed: {row}")


def phase_breakdown(dt, seed, n=16384):
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.rand((n, n), generator=g, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, t_wall = wall(lambda: dt.qr(A))
    classes = {"panel_kernel": 0.0, "gemm": 0.0, "triangular_solve": 0.0,
               "other": 0.0}
    launches_by_class = dict.fromkeys(classes, 0)
    for evt in prof.key_averages():
        name = evt.key.lower()
        cls = ("panel_kernel" if "panel_qr" in name else
               "gemm" if "gemm" in name else
               "triangular_solve" if "trsm" in name else "other")
        classes[cls] += evt.self_device_time_total / 1e6  # us -> s
        launches_by_class[cls] += evt.count
    busy = sum(classes.values())
    row = {"phase": 6, "name": "breakdown_f32_square", "shape": [n, n],
           "wall_s": t_wall, "device_busy_s": busy if busy else None,
           "device_busy_share": busy / t_wall if busy else None,
           "device_s_by_class": classes, "launches_by_class": launches_by_class}
    if not busy:
        row["note"] = "torch.profiler recorded no device time: not measured"
    emit(row)


def phase_kernel_profile(seed):
    from dhqr_tpu_torch.ops import hopper_panel as hp

    rng = np.random.default_rng(seed + 7)
    for name, m, nb, off in (
            ("panel_qr_f32", 129, 128, 0), ("panel_qr_f32", 4224, 128, 0),
            ("panel_qr_f32", 16384, 128, 0), ("panel_qr_f32", 65536, 64, 0),
            ("panel_qr_c64", 8192, 128, 0),
            # the tall lstsq's leaves (131072 x 512: 16 leaves 32 wide, the
            # first and the fourth) and a c64 leaf of the same CTA slice
            ("panel_qr_f32", 131072, 32, 0), ("panel_qr_f32", 131072, 32, 96),
            ("panel_qr_c64", 65536, 32, 3),
            ("panel_qr_f32", 65536, 128, 0),  # streamed
            ("panel_qr_f32", 524288, 16, 0)):  # streamed leaf
        dtype = torch.float32 if name.endswith("f32") else torch.complex64
        panel = random_panel(rng, m, nb, dtype)
        grid = hp.kernel_launch_info(m, nb, off, dtype)
        ms = cuda_ms(lambda: hp._panel_qr_kernel(panel, off), 10)
        cycles = hp.kernel_section_cycles(panel, off)
        emit({"phase": 7, "name": "kernel_profile", "kernel": name, "m": m,
              "nb": nb, "offset": off, "ctas": grid["ctas"],
              "rows_per_cta": grid["rows_per_cta"],
              "variant": grid["variant"], "registers": grid["registers"],
              "spill_bytes": grid["spill_bytes"],
              "ms": ms, "us_per_column": 1e3 * ms / nb,
              "cycles_per_column": cycles})
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": 7, "name": "sm_clocks", "clocks_sm_now_and_max": clocks})


# -- phase 8: precision -----------------------------------------------------

def magnitude(a, b, c=None):
    """max over entries of |a||b| (+ |c|): the scale a product's rounding
    is measured against."""
    mag = torch.matmul(a.abs(), b.abs())
    if c is not None:
        mag += c.abs()
    return float(mag.max())


def phase_precision_gemms(seed, m=16384, k=128, n=16256):
    """The bf16 passes on the card against their plain versions, at the
    trailing update's shapes: the update product Y Z, the in-place update
    C - Y Z and the product Y^H C."""
    from dhqr_tpu_torch.ops import gemm

    g = torch.Generator(device="cuda").manual_seed(seed + 8)
    for dtype in (torch.float32, torch.complex64):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda", dtype=dtype)

        Y, Z, C = rnd(m, k), rnd(k, n), rnd(m, n)
        Yh = Y.mH
        ops = {  # name: (card, plain, full FP32, scale)
            "Y@Z": (lambda p: gemm.matmul(Y, Z, p),
                    lambda p: gemm.matmul_plain(Y, Z, p),
                    lambda: torch.matmul(Y, Z), magnitude(Y, Z)),
            "C-=Y@Z": (lambda p: gemm.addmm(D, Y, Z, p, inplace=True),
                       lambda p: gemm.addmm_plain(D, Y, Z, p, inplace=True),
                       lambda: D.addmm_(Y, Z, alpha=-1), magnitude(Y, Z, C)),
            "Y^H@C": (lambda p: gemm.matmul(Yh, C, p),
                      lambda p: gemm.matmul_plain(Yh, C, p),
                      lambda: torch.matmul(Yh, C), magnitude(Yh, C)),
        }
        for op, (card, plain, full, scale) in ops.items():
            for prec in ("high", "default"):
                D = C.clone()
                got = card(prec)
                D = C.clone()
                want = plain(prec)
                err = float((got - want).abs().max()) / scale
                row = {"phase": 8, "name": "bf16_gemm", "op": op,
                       "dtype": str(dtype).split(".")[-1], "precision": prec,
                       "shape": [m, k, n], "err_vs_plain": err,
                       "tol": TOL_BF16, "out_dtype": str(got.dtype),
                       "ms": cuda_ms(lambda: card(prec), 5),
                       "plain_ms": cuda_ms(lambda: plain(prec), 2),
                       "highest_ms": cuda_ms(full, 5)}
                row["ok"] = err <= TOL_BF16 and got.dtype == dtype
                emit(row)
                if not row["ok"]:
                    raise AssertionError(f"bf16 pass check failed: {row}")
                del got, want, D
        del Y, Z, C, Yh
        torch.cuda.empty_cache()


def phase_precision_qr(dt, hp, seed, n=16384):
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.rand((n, n), generator=g, device="cuda", dtype=torch.float32)
    expect = expected_launches(n, n, torch.float32)
    for trailing in ("highest", "high", "default"):
        l0 = hp.LAUNCHES["panel_qr_f32"]
        fact, t_first = wall(lambda: dt.qr(A, trailing_precision=trailing))
        del fact
        fact, t_factor = wall(lambda: dt.qr(A, trailing_precision=trailing))
        launches = hp.LAUNCHES["panel_qr_f32"] - l0
        R = fact.r_matrix()
        QR = fact.matmul_q(R)
        backward = float(torch.linalg.vector_norm((QR - A).double())
                         / torch.linalg.vector_norm(A.double()))
        del QR, R, fact
        torch.cuda.empty_cache()
        row = {"phase": 8, "name": "qr_trailing_precision", "shape": [n, n],
               "trailing_precision": trailing, "factor_first_s": t_first,
               "factor_s": t_factor,
               "gflops": 4.0 / 3.0 * n ** 3 / t_factor / 1e9,
               "backward_error": backward, "tol_backward": TOL_BACKWARD_F32,
               "meets_tol": backward < TOL_BACKWARD_F32,
               "launches": launches, "expected": 2 * expect}
        row["ok"] = (bool(np.isfinite(backward)) and launches == 2 * expect
                     and (trailing != "highest" or row["meets_tol"]))
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"qr trailing precision failed: {row}")


def phase_precision_lstsq(dt, seed, m=4400, n=4000):
    """Every POLICY_LADDER cell and preset at the reference's largest size,
    on the reference's criterion: the normal-equations residual evaluated
    with numpy in the input's precision (``utils/testing.py``; A^H A and
    A^H b are formed once per dtype, the same operations in the same
    order), as a ratio to numpy's LAPACK QR solution's. The same ratio
    evaluated in float64 on the card is printed beside it (printed only:
    it moves tenfold with summation order, see :func:`phase_factor_quality`),
    and both ratios of two witnesses: ``torch.linalg.lstsq`` on the card (a
    yardstick the port never calls) and the port's own factors with Q^H b
    through an explicit Q. The plain panel loop's ratios are printed by
    :func:`phase_factor_quality`."""
    from dhqr_tpu_torch.precision import POLICY_LADDER, PRECISION_POLICIES

    cells = [(f"highest/{p.resolved_trailing()}/r{p.refine}", p)
             for p in POLICY_LADDER] + list(PRECISION_POLICIES.items())
    for dtype in (np.float32, np.complex64):
        A, b, x_lapack = lapack_problem(m, n, dtype, seed + 3)
        Ah = A.conj().T
        gram, rhs = Ah @ A, Ah @ b
        At, bt = torch.from_numpy(A).cuda(), torch.from_numpy(b).cuda()
        wide = torch.complex128 if At.is_complex() else torch.float64
        A64, b64 = At.to(wide), bt.to(wide)

        def ne(x):  # normal_equations_residual(A, x, b)
            return float(np.linalg.norm(gram @ x - rhs))

        def ne64(x):
            x = torch.as_tensor(x, device="cuda").to(wide)
            return float(torch.linalg.vector_norm(A64.mH @ (A64 @ x - b64)))

        oracle, oracle64 = ne(x_lapack), ne64(x_lapack)
        for name, pol in cells:
            x, t = wall(lambda: dt.lstsq(At, bt, policy=pol))
            finite = bool(torch.isfinite(torch.view_as_real(x) if x.is_complex()
                                         else x).all())
            ratio = ne(x.cpu().numpy()) / oracle
            row = {"phase": 8, "name": "lstsq_policy", "policy": name,
                   "dtype": np.dtype(dtype).name, "shape": [m, n],
                   "lstsq_s": t, "ratio_to_lapack": ratio,
                   "ratio_to_lapack_f64_eval": ne64(x) / oracle64,
                   "criterion": CRITERION, "meets_8x": ratio < CRITERION,
                   "finite": finite}
            row["ok"] = finite and (name != "accurate" or row["meets_8x"])
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"lstsq policy cell failed: {row}")

        def explicit_q():  # the port's factors, Q^H b through Q formed whole
            fact = dt.qr(At)
            c = fact.q_columns().mH @ bt
            return torch.linalg.solve_triangular(
                fact.r_matrix(), c[:, None], upper=True)[:, 0]

        witnesses = {  # second opinions on the f64-evaluated ratio
            "torch_linalg_lstsq": lambda: torch.linalg.lstsq(
                At, bt[:, None]).solution[:, 0],
            "port_qr_explicit_q": explicit_q}  # the plain loop: factor_quality
        for name, fn in witnesses.items():
            x, t = wall(fn)
            emit({"phase": 8, "name": "lstsq_witness", "solver": name,
                  "dtype": np.dtype(dtype).name, "shape": [m, n], "s": t,
                  "ratio_to_lapack": ne(x.cpu().numpy()) / oracle,
                  "ratio_to_lapack_f64_eval": ne64(x) / oracle64})
        del At, bt, A64, b64
        torch.cuda.empty_cache()


def factor_quality(H, alpha, A, nb):
    """(||A - Q R|| / ||A||, ||I - Q^H Q||_F) of packed factors, evaluated
    in float64 (complex128) on the card: Q formed from the stored
    reflectors in double precision, R from H and alpha."""
    from dhqr_tpu_torch.ops import blocked, solve

    wide = torch.complex128 if H.is_complex() else torch.float64
    m, n = H.shape
    eye = torch.eye(m, n, dtype=wide, device=H.device)
    Q = blocked._apply_q_impl(H.to(wide), eye, nb)
    R = solve.r_matrix(H, alpha).to(wide)
    A64 = A.to(wide)
    backward = float(torch.linalg.matrix_norm(A64 - Q @ R)
                     / torch.linalg.matrix_norm(A64))
    orth = float(torch.linalg.matrix_norm(eye[:n] - Q.mH @ Q))
    return backward, orth


def phase_factor_quality(dt, hp, seed, n_seeds=1, m=4400, n=4000):
    """Queue C item 1: are the f32 (and c64) kernel's factors as good as
    the plain panel loop's? For the 4400 x 4000 problems of phase 8, the
    backward error and orthogonality (f64 on the card) and the ratio to
    numpy's LAPACK residual (in the input's precision, and in f64) of
    three sets of factors: the kernel's (the default route), the plain
    panel loop's (``use_pallas="never"``) and the kernel's schedule in
    eager PyTorch (``hopper_panel._panel_qr_grid_leaf`` as the blocked
    engine's leaf, on the card). The kernel must stay within 2x of the
    plain loop on both factor measures. ``n_seeds`` > 1 repeats the kernel
    and the plain loop, f32, for the next problem seeds."""
    from dhqr_tpu_torch.ops import blocked

    nb = blocked.DEFAULT_BLOCK_SIZE
    runs = [(np.float32, seed + 3 + i) for i in range(n_seeds)]
    runs.insert(1, (np.complex64, seed + 3))
    for k, (dtype, pseed) in enumerate(runs):
        A, b, x_lapack = lapack_problem(m, n, dtype, pseed)
        At, bt = torch.from_numpy(A).cuda(), torch.from_numpy(b).cuda()
        wide = torch.complex128 if At.is_complex() else torch.float64
        A64, b64 = At.to(wide), bt.to(wide)
        Ah = A.conj().T
        gram, rhs = Ah @ A, Ah @ b

        def ne64(x):
            x = torch.as_tensor(x, device="cuda").to(wide)
            return float(torch.linalg.vector_norm(A64.mH @ (A64 @ x - b64)))

        def ne(x):
            return float(np.linalg.norm(gram @ x - rhs))

        oracle, oracle64 = ne(x_lapack), ne64(x_lapack)
        sets = {"plain_loop": lambda: dt.qr(At, use_pallas="never"),
                "kernel": lambda: dt.qr(At)}
        if k < 2:  # the grid model on the base seed, f32 and c64
            sets["grid_model"] = lambda: dt.QRFactorization(
                *blocked._blocked_qr_impl(At.clone(), nb, kernel=True,
                                          leaf=hp._panel_qr_grid_leaf),
                block_size=nb)
        quality = {}
        for name, make in sets.items():
            fact, t = wall(make)
            backward, orth = factor_quality(fact.H, fact.alpha, At, nb)
            x = fact.solve(bt)
            quality[name] = (backward, orth)
            row = {"phase": 8, "name": "factor_quality", "factors": name,
                   "dtype": np.dtype(dtype).name, "shape": [m, n],
                   "problem_seed": pseed, "factor_s": t,
                   "backward_error_f64": backward,
                   "orthogonality_f64": orth,
                   "ratio_to_lapack": ne(x.cpu().numpy()) / oracle,
                   "ratio_to_lapack_f64_eval": ne64(x) / oracle64}
            if name != "plain_loop":
                row["vs_plain_loop"] = [backward / quality["plain_loop"][0],
                                        orth / quality["plain_loop"][1]]
            emit(row)
            del fact, x
        kb, ko = quality["kernel"]
        pb, po = quality["plain_loop"]
        ok = kb <= 2 * pb and ko <= 2 * po
        emit({"phase": 8, "name": "factor_quality_verdict",
              "dtype": np.dtype(dtype).name, "problem_seed": pseed,
              "kernel_over_plain_backward": kb / pb,
              "kernel_over_plain_orthogonality": ko / po, "bar": 2.0,
              "ok": ok})
        if not ok:
            raise AssertionError("the kernel's factors are more than 2x "
                                 "worse than the plain panel loop's")
        del At, bt, A64, b64
        torch.cuda.empty_cache()


# -- phase 9: the tall-skinny engines -----------------------------------------

def tsqr_expected_launches(m, n, n_blocks, dtype):
    """Kernel leaves of one TSQR call by the port's own panel plans for its
    leaves and its combine."""
    from dhqr_tpu_torch.ops import blocked, tsqr

    cuda = torch.device("cuda")
    kernel = blocked._resolve_kernel("auto", m // n_blocks, dtype, cuda)
    return sum(count * sum(blocked.kernel_leaves(w, leaf)
                           for _, w, leaf in plan if leaf)
               for plan, count in tsqr.tsqr_panel_plans(
                   m, n, n_blocks, blocked.DEFAULT_BLOCK_SIZE, kernel, dtype,
                   cuda))


def phase_engines(dt, hp, seed, shapes=((65536, 256, torch.float32),
                                        (32768, 256, torch.complex64))):
    for i, (m, n, dtype) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(seed + 9 + i)
        A = torch.rand((m, n), generator=g, device="cuda", dtype=dtype)
        b = torch.rand((m,), generator=g, device="cuda", dtype=dtype)
        kname = hp.KERNELS[dtype]
        wide = torch.complex128 if A.is_complex() else torch.float64
        A64, b64 = A.to(wide), b.to(wide)

        def ne(x):
            return float(torch.linalg.vector_norm(
                A64.mH @ (A64 @ x.to(wide) - b64)))

        ref = lambda: torch.linalg.lstsq(A, b[:, None]).solution[:, 0]  # noqa: E731
        wall(ref)
        x_ref, t_ref = wall(ref)
        res_ref = ne(x_ref)
        tsqr = tsqr_expected_launches(m, n, 8, dtype)
        cases = [("tsqr_lstsq", lambda: dt.tsqr_lstsq(A, b, n_blocks=8), tsqr),
                 ("lstsq_engine_tsqr", lambda: dt.lstsq(A, b, engine="tsqr"),
                  tsqr)]
        if dtype == torch.float32:
            cases += [
                ("cholesky_qr_lstsq", lambda: dt.cholesky_qr_lstsq(A, b), 0),
                ("cholesky_qr_lstsq_shift",
                 lambda: dt.cholesky_qr_lstsq(A, b, shift=True), 0),
                ("lstsq_engine_cholqr2",
                 lambda: dt.lstsq(A, b, engine="cholqr2"), 0),
                ("lstsq_engine_cholqr3",
                 lambda: dt.lstsq(A, b, engine="cholqr3"), 0)]
        for name, fn, expect in cases:
            l0 = hp.LAUNCHES[kname]
            x, t_first = wall(fn)
            launches = hp.LAUNCHES[kname] - l0
            x, t = wall(fn)
            res = ne(x)
            row = {"phase": 9, "name": name, "dtype": str(dtype).split(".")[-1],
                   "shape": [m, n], "first_s": t_first, "s": t,
                   "torch_lstsq_s": t_ref, "normal_eq_residual": res,
                   "torch_lstsq_residual": res_ref, "ratio": res / res_ref,
                   "criterion": CRITERION, "launches": launches,
                   "expected": expect}
            row["ok"] = (bool(np.isfinite(res)) and res <= CRITERION * res_ref
                         and launches == expect)
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"engine check failed: {row}")
        l0 = hp.LAUNCHES[kname]
        R, t_first = wall(lambda: dt.tsqr_r(A, n_blocks=8))
        launches = hp.LAUNCHES[kname] - l0
        R, t = wall(lambda: dt.tsqr_r(A, n_blocks=8))
        G = A64.mH @ A64
        R64 = R.to(wide)
        gram = float(torch.linalg.matrix_norm(R64.mH @ R64 - G)
                     / torch.linalg.matrix_norm(G))
        row = {"phase": 9, "name": "tsqr_r", "dtype": str(dtype).split(".")[-1],
               "shape": [m, n], "first_s": t_first, "s": t,
               "gram_rel_err": gram, "tol_gram": TOL_GRAM,
               "launches": launches, "expected": tsqr}
        row["ok"] = gram <= TOL_GRAM and launches == tsqr
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"tsqr_r check failed: {row}")
        del A, b, A64, b64, G, R, R64
        torch.cuda.empty_cache()


# -- phase 10: gradients ------------------------------------------------------

def phase_gradients(dt, hp, seed, shapes=((4096, 512, torch.float32),
                                          (2048, 256, torch.complex64))):
    for i, (m, n, dtype) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(seed + 10 + i)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda", dtype=dtype)

        A, b, w, dA, db = rnd(m, n), rnd(m), rnd(n), rnd(m, n), rnd(m)
        kname = hp.KERNELS[dtype]
        expect = expected_launches(m, n, dtype)

        def grads(A, b, solve):
            At = A.detach().clone().requires_grad_()
            bt = b.detach().clone().requires_grad_()
            x = solve(At, bt)
            torch.real(torch.vdot(w.to(x.dtype), x)).backward()
            return x, At.grad, bt.grad

        l0 = hp.LAUNCHES[kname]
        x, gA, gb = grads(A, b, dt.lstsq_diff)
        launches = hp.LAUNCHES[kname] - l0
        wide = torch.complex128 if A.is_complex() else torch.float64

        def normal_equations(A, b):  # the yardstick, float64 autograd
            return torch.linalg.solve(A.mH @ A, A.mH @ b)

        _, gA64, gb64 = grads(A.to(wide), b.to(wide), normal_equations)
        err = max(rel_err(gA.to(wide), gA64), rel_err(gb.to(wide), gb64))
        _, Ju = torch.func.jvp(dt.lstsq_diff, (A, b), (dA, db))
        lhs = float(torch.real(torch.vdot(w, Ju)))
        rhs = float(torch.real(torch.vdot(gA.flatten(), dA.flatten())
                               + torch.vdot(gb, db)))
        adjoint = abs(lhs - rhs) / abs(lhs)
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: dt.lstsq_diff(A, b), 3)
        fwd_bwd_ms = cuda_ms(lambda: grads(A, b, dt.lstsq_diff), 3)
        row = {"phase": 10, "name": "lstsq_diff_gradient",
               "dtype": str(dtype).split(".")[-1], "shape": [m, n],
               "grad_rel_err_vs_f64": err, "tol_grad": TOL_GRAD,
               "adjoint_rel_err": adjoint, "tol_adjoint": TOL_ADJOINT,
               "forward_ms": fwd_ms, "forward_backward_ms": fwd_bwd_ms,
               "backward_over_forward": fwd_bwd_ms / fwd_ms - 1.0,
               "launches_forward": launches, "expected": expect}
        row["ok"] = (err <= TOL_GRAD and adjoint <= TOL_ADJOINT
                     and launches == expect)
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"gradient check failed: {row}")
    phase_factor_gradients(dt, hp, seed)


def _real_dot(a, b) -> float:
    """Re<a, b> over every entry, in float64."""
    return float(torch.real(torch.vdot(a.flatten().to(_wide(a.dtype)),
                                       b.flatten().to(_wide(a.dtype)))))


def _wide(dtype):
    return torch.complex128 if dtype.is_complex else torch.float64


def _weighted(outs, ws):
    """The scalar loss sum_i Re<W_i, out_i>."""
    return sum(torch.real(torch.vdot(w.flatten().to(o.dtype), o.flatten()))
               for w, o in zip(ws, outs))


def _qr_fwd_bwd(A, ws):
    """torch.linalg.qr's forward + backward of Re<W1, Q> + Re<W2, R> (the
    yardstick's gradient; the port never calls it)."""
    At = A.detach().clone().requires_grad_()
    Q, R = torch.linalg.qr(At)
    _weighted((Q, R), ws).backward()
    return At.grad


def _factor_grad_cases(dt):
    """Part (b)'s cases: (name, (m, n), dtype, route, reference, {loss:
    output indices}, whether a kernel runs on the route).

    A route maps (A, b, **keywords) to a tuple of outputs, and a loss
    weighs some of them (sum_i Re<W_i, out_i>); ``qr``'s route gives H,
    alpha, Q and R of one factorization, so that its two losses share
    every forward. The reference computes the same outputs on the plain
    panels, for the f64 gradient and central difference (with the
    compensated norm off: f64 needs no compensation, and the norm takes
    most of the plain loop's launches)."""
    def factors(A, b, **kw):  # qr's packed factors and qr_explicit's
        f = dt.qr(A, device=A.device, **kw)
        return f.H, f.alpha, f.q_columns(), f.r_matrix()

    def packed(A, b, **kw):
        f = dt.qr(A, device=A.device, **kw)
        return f.H, f.alpha

    def tsqr(A, b, **kw):
        return (dt.lstsq(A, b, engine="tsqr", device=A.device, **kw),)

    def unblocked(A, b, **kw):
        return (dt.lstsq(A, b, blocked=False, device=A.device, **kw),)

    def lstsq(A, b, **kw):  # blocked: lstsq_diff's closed form; m < n:
        return (dt.lstsq(A, b, device=A.device, **kw),)  # minimum norm

    def plain(route):
        return lambda A, b: route(A, b, use_pallas="never", norm="fast")

    def fast(route):
        return lambda A, b: route(A, b, norm="fast")

    return [
        ("qr", (4400, 4000), torch.float32, factors, plain(factors),
         {"qr": (0, 1), "qr_explicit": (2, 3)}, True),
        ("tsqr", (65536, 256), torch.float32, tsqr, plain(lstsq),
         {"lstsq_tsqr": (0,)}, True),
        ("unblocked", (65536, 256), torch.float32, unblocked, plain(lstsq),
         {"lstsq_unblocked": (0,)}, False),
        ("min_norm", (256, 65536), torch.float32, lstsq, fast(lstsq),
         {"lstsq_min_norm": (0,)}, False),
        ("qr_c64", (2048, 256), torch.complex64, packed, plain(packed),
         {"qr": (0, 1)}, True),
    ]


def _normal_equations_x(A, b):
    """x of the normal equations (minimum norm for m < n): the lstsq
    routes' f64 autograd yardstick."""
    if A.shape[0] >= A.shape[1]:
        return (torch.linalg.solve(A.mH @ A, A.mH @ b),)
    return (A.mH @ torch.linalg.solve(A @ A.mH, b),)


def _with_grad(A, b):
    return (A.detach().clone().requires_grad_(),
            b.detach().clone().requires_grad_())


def _grads(loss, inputs, retain=False):
    """(A's, b's) gradients of ``loss``; b's is zero where it is unused."""
    gA, gb = torch.autograd.grad(loss, inputs, retain_graph=retain,
                                 allow_unused=True)
    return gA, torch.zeros_like(inputs[1]) if gb is None else gb


def _warm_factor_grad(dt, dtype, device):
    """One small ``qr`` forward + backward in ``dtype`` before its first
    case is measured: the first use of a complex op on the card may compile it at
    run time (PyTorch's jiterator), and a stream's first cuBLAS call
    allocates its workspace, so an unwarmed backward's time and peak
    memory measure those instead (seconds and ~48 MB at c64 2048 x 256)."""
    A = torch.randn(512, 64, device=device, dtype=dtype, requires_grad=True)
    f = dt.qr(A, device=device)
    _weighted((f.H, f.alpha), (f.H.detach(), f.alpha.detach())).backward()
    _sync(device)


def phase_factor_gradients(dt, hp, seed, device="cuda", cases=None):
    """Phase 10 (b): gradients through the factorization itself
    (``householder_factor``), with the forward on the panel kernels.
    ``device`` and ``cases`` (default :func:`_factor_grad_cases`) are for a
    rehearsal on the CPU at small shapes. The complex case's backward is
    also profiled: it runs the same column steps as the f32 ones, on few
    enough columns (256, ~10k kernels) for the profiler to sum quickly."""
    warmed = set()
    for i, (case, (m, n), dtype, route, ref, losses, kernel) in enumerate(
            cases or _factor_grad_cases(dt)):
        t_case = time.perf_counter()
        g = torch.Generator(device=device).manual_seed(seed + 40 + i)

        def rnd(*shape, dt_=dtype):
            return torch.randn(shape, generator=g, device=device, dtype=dt_)

        A, b, U, ub = rnd(m, n), rnd(m), rnd(m, n), rnd(m)
        wide = _wide(dtype)
        A64, b64, U64, ub64 = (t.to(wide) for t in (A, b, U, ub))
        kname = hp.KERNELS[dtype]
        if dtype not in warmed:
            _warm_factor_grad(dt, dtype, device)
            warmed.add(dtype)
        big = max(m, n), min(m, n)
        if case == "tsqr":
            plan = tsqr_expected_launches(m, n, 8, dtype)
        else:
            plan = expected_launches(*big, dtype) if kernel else 0
        # the route without grad, then with it: the forward's bits and
        # launches, the times, and each backward's peak memory over the
        # forward's
        with torch.no_grad():
            l0 = hp.LAUNCHES[kname]
            outs0, fwd_s = _timed(lambda: route(A, b), A.device)
            launches_off = hp.LAUNCHES[kname] - l0
        ws = {loss: [rnd(*outs0[k].shape, dt_=outs0[k].dtype) for k in idx]
              for loss, idx in losses.items()}

        def L(outs, loss):
            return _weighted([outs[k] for k in losses[loss]], ws[loss])

        At, bt = _with_grad(A, b)
        torch.cuda.reset_peak_memory_stats()
        l0 = hp.LAUNCHES[kname]
        outs, fwd_grad_s = _timed(lambda: route(At, bt), A.device)
        launches_on = hp.LAUNCHES[kname] - l0
        same = all(torch.equal(o.detach(), o0) for o, o0 in zip(outs, outs0))
        fwd_peak = torch.cuda.max_memory_allocated()
        port, bwd_over, bwd_s = {}, {}, {}
        for j, loss in enumerate(losses):
            torch.cuda.reset_peak_memory_stats()
            port[loss], bwd_s[loss] = _timed(lambda: _grads(
                L(outs, loss), (At, bt), retain=j + 1 < len(losses)),
                A.device)
            bwd_over[loss] = (torch.cuda.max_memory_allocated() - fwd_peak) \
                / A.nbytes
        del outs, At, bt
        # the other routes: every loss from one forward each
        others = {}
        if kernel:
            Ap, bp = _with_grad(A, b)
            outs = route(Ap, bp, use_pallas="never")
            others["plain_f32"] = {
                loss: _grads(L(outs, loss), (Ap, bp), j + 1 < len(losses))
                for j, loss in enumerate(losses)}
        Ar, br = _with_grad(A64, b64)
        outs = ref(Ar, br)
        others["plain_f64"] = {
            loss: _grads(L(outs, loss), (Ar, br), j + 1 < len(losses))
            for j, loss in enumerate(losses)}
        del outs
        eps = 1e-5 * float(A64.norm() / U64.norm())
        with torch.no_grad():
            plus = ref(A64 + eps * U64, b64 + eps * ub64)
            minus = ref(A64 - eps * U64, b64 - eps * ub64)
            cds = {loss: (float(L(plus, loss)) - float(L(minus, loss)))
                   / (2 * eps) for loss in losses}
            del plus, minus
        # the adjoint identity: d/dt L(A + t U) by jvp against <g, U>
        _, tangents = torch.func.jvp(lambda A, b: route(A, b), (A, b),
                                     (U, ub))
        rname = "kernel" if kernel else "port"
        # torch.linalg.qr's forward + backward of a loss on (Q, R) at the
        # factored shape, once per case
        F = A if m >= n else A.mH.contiguous()
        qr_ws = [rnd(*big, dt_=dtype), rnd(big[1], big[1], dt_=dtype)]
        torch_qr_ms = cuda_ms(lambda: _qr_fwd_bwd(F, qr_ws), 1)
        del F, qr_ws
        for loss, idx in losses.items():
            t_loss = time.perf_counter()
            grads = {rname: port[loss]} | {r: gs[loss]
                                           for r, gs in others.items()}
            cd = cds[loss]
            directional = {r: _real_dot(ga, U64) + _real_dot(gb, ub64)
                           for r, (ga, gb) in grads.items()}
            ref_gA, ref_gb = grads["plain_f64"]
            gA, gb = port[loss]
            jv = sum(_real_dot(w, tangents[k])
                     for w, k in zip(ws[loss], idx))
            adjoint = abs(jv - directional[rname]) / abs(directional[rname])
            row = {"phase": 10, "name": "factor_gradient", "loss": loss,
                   "dtype": str(dtype).split(".")[-1], "shape": [m, n],
                   "eps": eps, "central_difference_f64": cd,
                   "directional": directional,
                   "directional_rel_err": {r: abs(d - cd) / abs(cd)
                                           for r, d in directional.items()},
                   "tol_cd64": TOL_CD64,
                   "grad_rel_err_vs_f64_route": {
                       r: max(rel_err(ga.to(wide), ref_gA),
                              rel_err(gb_.to(wide), ref_gb))
                       for r, (ga, gb_) in grads.items() if r != "plain_f64"},
                   "adjoint_rel_err": adjoint, "tol_adjoint": TOL_ADJOINT,
                   "forward_bit_identical": same,
                   "launches_grad_on": launches_on,
                   "launches_grad_off": launches_off, "expected": plan,
                   "backward_peak_over_forward_in_A_bytes": bwd_over[loss],
                   "tol_memory": BACKWARD_MEM_FACTOR}
            err = row["grad_rel_err_vs_f64_route"]
            ok = (row["directional_rel_err"]["plain_f64"] <= TOL_CD64
                  and adjoint <= TOL_ADJOINT and same
                  and launches_on == launches_off == plan
                  and bwd_over[loss] <= BACKWARD_MEM_FACTOR)
            if kernel:
                ok = ok and err["kernel"] <= KERNEL_GRAD_FACTOR * \
                    err["plain_f32"]
            # the yardsticks, f64 autograd on the card
            if loss == "qr_explicit":
                yard = _qr_fwd_bwd(A64, [w.to(wide) for w in ws[loss]])
                row["torch_qr_f64_vs_f64_route"] = rel_err(ref_gA, yard)
                row["kernel_vs_torch_qr_f64"] = rel_err(gA.to(wide), yard)
                ok = ok and row["torch_qr_f64_vs_f64_route"] <= \
                    TOL_YARDSTICK64
            if loss.startswith("lstsq"):
                Ay, by = _with_grad(A64, b64)
                yA, yb = _grads(_weighted(_normal_equations_x(Ay, by),
                                          [w.to(wide) for w in ws[loss]]),
                                (Ay, by))
                row["grad_rel_err_vs_normal_equations_f64"] = max(
                    rel_err(gA.to(wide), yA), rel_err(gb.to(wide), yb))
                row["tol_grad"] = TOL_GRAD
                ok = ok and row["grad_rel_err_vs_normal_equations_f64"] \
                    <= TOL_GRAD
            # times of the calls above (host clock around synchronised
            # work: each runs 24 ms to 3 s, launch-bound), beside
            # torch.linalg.qr's; the qr case's forward computes both
            # losses' outputs (Q and R add ~6 ms at 4400 x 4000)
            row["forward_ms"] = 1e3 * fwd_s
            row["forward_with_grad_ms"] = 1e3 * fwd_grad_s
            row["backward_ms"] = 1e3 * bwd_s[loss]
            row["forward_backward_ms"] = 1e3 * (fwd_grad_s + bwd_s[loss])
            row["torch_qr_forward_backward_ms"] = torch_qr_ms
            if dtype.is_complex and device == "cuda":
                Ag, bg = _with_grad(A, b)
                loss_g = L(route(Ag, bg), loss)
                row["backward_profile"] = _solve_profile(
                    lambda: _grads(loss_g, (Ag, bg)), A.device)
                del Ag, bg, loss_g
            row["seconds"] = time.perf_counter() - (
                t_case if loss == next(iter(losses)) else t_loss)
            row["ok"] = bool(ok)
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"factor gradient check failed: {row}")
        del port, others, tangents, A, b, U, ub, A64, b64, U64, ub64
        torch.cuda.empty_cache()


# -- phase 11: the lookahead and aggregated schedules -------------------------

SCHEDULES = (("lookahead", {"lookahead": True}), ("agg2", {"agg_panels": 2}),
             ("agg4", {"agg_panels": 4}))
LOOKAHEAD_CAPS = (16, 33, 66, 132)


def schedule_launches(m, n, dtype, lookahead_ctas=None):
    """Kernel leaves of one factorization by the engine's own plan (the
    lookahead schedule's side-stream panels planned on ``lookahead_ctas``
    SMs)."""
    from dhqr_tpu_torch.ops import blocked

    cuda = torch.device("cuda")
    kernel = blocked._resolve_kernel("auto", m, dtype, cuda)
    plan = blocked.panel_plan(m, n, blocked.DEFAULT_BLOCK_SIZE, kernel, dtype,
                              cuda, lookahead_ctas)
    return sum(blocked.kernel_leaves(w, leaf) for _, w, leaf in plan if leaf)


def backward_error(fact, A):
    """||Q R - A|| / ||A|| with Q R formed by the factorization's own apply."""
    m, n = A.shape
    R = torch.cat([fact.r_matrix(), A.new_zeros((m - n, n))])
    QR = fact.matmul_q(R)
    wide = torch.complex128 if A.is_complex() else torch.float64
    return float(torch.linalg.vector_norm((QR - A).to(wide))
                 / torch.linalg.vector_norm(A.to(wide)))


def overlap_profile(fn):
    """(wall s, panel-kernel device s, GEMM device s, s where a panel kernel
    and a GEMM ran at once, device busy s) of one call of ``fn`` under
    ``torch.profiler``; None for the device figures when the profiler
    recorded no kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, t_wall = wall(fn)
    spans = {"panel": [], "gemm": [], "all": []}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        iv = (evt.time_range.start, evt.time_range.end)
        name = evt.name.lower()
        spans["all"].append(iv)
        if "panel_qr" in name:
            spans["panel"].append(iv)
        elif "gemm" in name:
            spans["gemm"].append(iv)

    def union(ivs):
        out = []
        for lo, hi in sorted(ivs):
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return out

    def length(ivs):
        return sum(hi - lo for lo, hi in ivs) / 1e6  # us -> s

    if not spans["all"]:
        return t_wall, None, None, None, None
    gemm = union(spans["gemm"])
    both = [(max(lo, g0), min(hi, g1)) for lo, hi in union(spans["panel"])
            for g0, g1 in gemm if min(hi, g1) > max(lo, g0)]
    return (t_wall, length(union(spans["panel"])), length(gemm),
            length(both), length(union(spans["all"])))


def phase_schedules(dt, hp, seed, cases=((16384, 16384, torch.float32),
                                         (8192, 4096, torch.complex64))):
    """``qr`` in each schedule against the default: steady seconds,
    GFLOP/s, backward error, distance of the factors from the default's,
    launches against the plan; for lookahead the CTA cap sweep and the
    profiler's overlap; then ``lstsq`` at 4400 x 4000 in each schedule on
    the reference's criterion."""
    from dhqr_tpu_torch.ops import blocked
    from dhqr_tpu_torch.utils.testing import normal_equations_residual

    for i, (m, n, dtype) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(seed + 11 + i)
        A = torch.rand((m, n), generator=g, device="cuda", dtype=dtype)
        kname = hp.KERNELS[dtype]
        tol = TOL_BACKWARD_F32 if dtype == torch.float32 else TOL_BACKWARD_C64
        real_flops = (1 if dtype == torch.float32 else 4) * (
            2 * m * n * n - 2.0 / 3.0 * n ** 3)
        dt.qr(A)
        ref, t_ref = wall(lambda: dt.qr(A))
        emit({"phase": 11, "name": "schedule", "schedule": "default",
              "dtype": str(dtype).split(".")[-1], "shape": [m, n],
              "factor_s": t_ref, "gflops": real_flops / t_ref / 1e9,
              "backward_error": backward_error(ref, A)})
        for sched, kw in SCHEDULES:
            expect = schedule_launches(
                m, n, dtype, hp.LOOKAHEAD_CTAS if "lookahead" in kw else None)
            l0 = hp.LAUNCHES[kname]
            fact, t_first = wall(lambda: dt.qr(A, **kw))
            launches = hp.LAUNCHES[kname] - l0
            del fact
            fact, t = wall(lambda: dt.qr(A, **kw))
            row = {"phase": 11, "name": "schedule", "schedule": sched,
                   "dtype": str(dtype).split(".")[-1], "shape": [m, n],
                   "factor_first_s": t_first, "factor_s": t,
                   "default_s": t_ref, "gflops": real_flops / t / 1e9,
                   "backward_error": backward_error(fact, A), "tol": tol,
                   "rel_diff_H": rel_err(fact.H, ref.H),
                   "rel_diff_alpha": rel_err(fact.alpha, ref.alpha),
                   "launches": launches, "expected": expect}
            row["ok"] = (row["backward_error"] < tol and launches == expect
                         and expect >= 1 and row["rel_diff_H"] < 1e-3)
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"schedule check failed: {row}")
            del fact
        for cap in LOOKAHEAD_CAPS:  # the side-stream grid's CTA cap
            run = lambda: blocked._blocked_qr_impl(  # noqa: E731
                A.clone(), blocked.DEFAULT_BLOCK_SIZE, kernel=True,
                lookahead=True, lookahead_ctas=cap)
            run()
            l0 = hp.LAUNCHES[kname]
            _, t = wall(run)
            launches = hp.LAUNCHES[kname] - l0
            t_wall, panel_s, gemm_s, both_s, busy_s = overlap_profile(run)
            row = {"phase": 11, "name": "lookahead_cap", "ctas": cap,
                   "dtype": str(dtype).split(".")[-1], "shape": [m, n],
                   "factor_s": t, "default_s": t_ref,
                   "profiled_wall_s": t_wall, "panel_device_s": panel_s,
                   "gemm_device_s": gemm_s, "overlap_device_s": both_s,
                   "device_busy_s": busy_s,
                   "launches": launches,
                   "expected": schedule_launches(m, n, dtype, cap)}
            if panel_s is None:
                row["note"] = "torch.profiler recorded no kernels: not measured"
            row["ok"] = launches == row["expected"]
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"lookahead cap check failed: {row}")
        t_wall, panel_s, gemm_s, both_s, busy_s = overlap_profile(
            lambda: dt.qr(A))
        emit({"phase": 11, "name": "default_profile",
              "dtype": str(dtype).split(".")[-1], "shape": [m, n],
              "profiled_wall_s": t_wall, "panel_device_s": panel_s,
              "gemm_device_s": gemm_s, "overlap_device_s": both_s,
              "device_busy_s": busy_s})
        del A, ref
        torch.cuda.empty_cache()
    for dtype, name in ((np.float32, "panel_qr_f32"),
                        (np.complex64, "panel_qr_c64")):
        A, b, oracle = oracle_of(4400, 4000, dtype, seed + 3)
        for sched, kw in SCHEDULES:
            l0 = hp.LAUNCHES[name]
            x, t = wall(lambda: dt.lstsq(A, b, **kw))
            res = normal_equations_residual(A, x.cpu().numpy(), b)
            row = {"phase": 11, "name": "schedule_criterion",
                   "schedule": sched, "dtype": np.dtype(dtype).name,
                   "shape": [4400, 4000], "lstsq_s": t,
                   "ratio": res / oracle, "criterion": CRITERION,
                   "launches": hp.LAUNCHES[name] - l0}
            row["ok"] = bool(np.isfinite(res)) and res < CRITERION * oracle \
                and row["launches"] >= 1
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"schedule criterion failed: {row}")


# -- phase 12: the reconstruct panel engine -----------------------------------

TOL_BACKWARD_F64 = 1e-12


def phase_reconstruct(dt, hp, seed, m=16384, n=2048):
    """``qr`` + ``solve`` with ``panel_impl="reconstruct"`` and
    ``"reconstruct:4096"``, f32 on the plain panel path and f64, beside the
    ``"loop"`` engine; then ``lstsq`` at 4400 x 4000 on the reference's
    criterion. No panel kernel runs here."""
    from dhqr_tpu_torch.utils.testing import normal_equations_residual

    for i, dtype in enumerate((torch.float32, torch.float64)):
        g = torch.Generator(device="cuda").manual_seed(seed + 12 + i)
        A = torch.rand((m, n), generator=g, device="cuda", dtype=dtype)
        b = torch.rand((m,), generator=g, device="cuda", dtype=dtype)
        tol = TOL_BACKWARD_F32 if dtype == torch.float32 else TOL_BACKWARD_F64
        kw = {"use_pallas": "never"}  # the kernel would take the panels
        _, t_loop = wall(lambda: dt.qr(A, **kw))
        for impl in ("reconstruct", "reconstruct:4096"):
            dt.qr(A, panel_impl=impl, **kw)
            fact, t = wall(lambda: dt.qr(A, panel_impl=impl, **kw))
            x, t_solve = wall(lambda: fact.solve(b))
            row = {"phase": 12, "name": "reconstruct", "panel_impl": impl,
                   "dtype": str(dtype).split(".")[-1], "shape": [m, n],
                   "factor_s": t, "solve_s": t_solve, "loop_factor_s": t_loop,
                   "backward_error": backward_error(fact, A), "tol": tol,
                   "finite": bool(torch.isfinite(x).all())}
            row["ok"] = row["backward_error"] < tol and row["finite"]
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"reconstruct check failed: {row}")
            del fact, x
        del A, b
        torch.cuda.empty_cache()
    for dtype in (np.float32, np.float64):
        A, b, oracle = oracle_of(4400, 4000, dtype, seed + 3)
        kw = {"use_pallas": "never"}
        for impl in ("reconstruct", "reconstruct:4096"):
            x, t = wall(lambda: dt.lstsq(A, b, panel_impl=impl, **kw))
            res = normal_equations_residual(A, x.cpu().numpy(), b)
            row = {"phase": 12, "name": "reconstruct_criterion",
                   "panel_impl": impl, "dtype": np.dtype(dtype).name,
                   "shape": [4400, 4000], "lstsq_s": t,
                   "ratio": res / oracle, "criterion": CRITERION}
            row["ok"] = bool(np.isfinite(res)) and res < CRITERION * oracle
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"reconstruct criterion failed: {row}")


# -- phase 13: the sketched solver --------------------------------------------

def phase_sketch(dt, seed, cases=((65536, 256, torch.float32),
                                  (131072, 256, torch.float32),
                                  (32768, 256, torch.complex64))):
    """``lstsq(engine="sketch")`` (the operator by "auto": SRHT at these
    power-of-two heights) and, at 65536 x 256, ``sketched_lstsq`` with the
    count sketch, against ``torch.linalg.lstsq`` (yardstick) on the
    normal-equations residual, timed beside it and ``engine="cholqr2"``;
    each new (operator, m, s, seed) draws its operator once."""
    from dhqr_tpu_torch.solvers import sketch

    for i, (m, n, dtype) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(seed + 13 + i)
        A = torch.rand((m, n), generator=g, device="cuda", dtype=dtype)
        b = torch.rand((m,), generator=g, device="cuda", dtype=dtype)
        wide = torch.complex128 if A.is_complex() else torch.float64
        A64, b64 = A.to(wide), b.to(wide)

        def ne(x):
            return float(torch.linalg.vector_norm(
                A64.mH @ (A64 @ x.to(wide) - b64)))

        ref = lambda: torch.linalg.lstsq(A, b[:, None]).solution[:, 0]  # noqa: E731
        wall(ref)
        x_ref, t_ref = wall(ref)
        res_ref = ne(x_ref)
        dt.lstsq(A, b, engine="cholqr2")
        _, t_chol = wall(lambda: dt.lstsq(A, b, engine="cholqr2"))
        calls = [("lstsq_engine_sketch", "auto",
                  lambda: dt.lstsq(A, b, engine="sketch"))]
        if i == 0:
            calls.append(("sketched_lstsq", "countsketch",
                          lambda: dt.sketched_lstsq(A, b,
                                                    operator="countsketch")))
        for name, op, fn in calls:
            d0 = sketch.COUNTERS.get("sketch_operator_draws")
            x, t_first = wall(fn)
            d1 = sketch.COUNTERS.get("sketch_operator_draws")
            x, t = wall(fn)
            d2 = sketch.COUNTERS.get("sketch_operator_draws")
            res = ne(x)
            row = {"phase": 13, "name": name, "operator":
                   sketch.resolve_operator(op, m),
                   "dtype": str(dtype).split(".")[-1], "shape": [m, n],
                   "s": t, "first_s": t_first, "torch_lstsq_s": t_ref,
                   "cholqr2_s": t_chol, "normal_eq_residual": res,
                   "torch_lstsq_residual": res_ref, "ratio": res / res_ref,
                   "criterion": CRITERION, "operator_draws_first": d1 - d0,
                   "operator_draws_second": d2 - d1}
            row["ok"] = (bool(np.isfinite(res)) and res <= CRITERION * res_ref
                         and d1 - d0 <= 1 and d2 == d1)
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"sketch check failed: {row}")
        del A, b, A64, b64
        torch.cuda.empty_cache()


# -- phase 14: the sharded tier ------------------------------------------------
#
# Each case runs in P spawned processes (dhqr_tpu_torch/parallel/_ranks.py)
# that share card 0: NCCL with one rank runs the NCCL code path end to end;
# gloo with 2 and 4 ranks runs real multi-rank collectives, carried through
# the host. Times are P processes time-sharing one H100, never a scaling
# number. The rank worker below runs in those processes.

SHARDED_SCHEDULES = (("block", "default", {}),
                     ("cyclic", "default", {}),
                     ("block", "lookahead", {"lookahead": True}),
                     ("cyclic", "lookahead", {"lookahead": True}),
                     ("block", "agg2", {"agg_panels": 2}),
                     ("cyclic", "agg2", {"agg_panels": 2}))
TOL_SHARDED_H = 1e-5   # max|H - H_single| / max|H_single| (one rank, the
# default), and max||R| - |R_single|| / max|R_single|, R up to row signs


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _solve_profile(fn, device):
    """One call of ``fn`` under ``torch.profiler`` (host and card): wall
    seconds, the card's busy seconds and idle share, kernels launched,
    and the ops that took the most device and host time."""
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, t = _timed(fn, device)
    events = prof.key_averages()
    # kernels only: an op on the host also carries its kernels' time
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    ops = [e for e in events if e.device_type.name == "CPU"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6

    def top(events, key):
        rows = sorted(events, key=lambda e: -getattr(e, key))[:6]
        return [[e.key[:60], getattr(e, key) / 1e6, e.count] for e in rows]

    return {"wall_s": t, "device_busy_s": busy if busy else None,
            "device_idle_share": 1 - busy / t if busy else None,
            "kernels": sum(e.count for e in kernels),
            "top_device_s": top(kernels, "self_device_time_total"),
            "top_host_s": top(ops, "self_cpu_time_total")}


def _rank_qr_case(dt, parallel, hp, device, seed, m, n, dtype, runs,
                  steady=True, probe=False, profile=False):
    """``qr`` + ``solve`` on this rank's column mesh, per (layout, schedule):
    seconds, launches, this rank's part of the backward error and of the
    distance from the single-device factors. ``probe`` also sets the
    single-device ``lookahead=True`` factors beside the default's (pivot
    sign flips, H distance) as the first row; ``profile`` traces the
    single-device solve and the first run's mesh solve. The kernel counts
    are zeroed after the single-device references: what the worker reads
    after the case is the mesh path's alone."""
    from dhqr_tpu_torch.ops import blocked
    from dhqr_tpu_torch.parallel import sharded_qr

    dtype = getattr(torch, dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype.is_complex:
        real = torch.float32
        A = torch.complex(torch.rand((m, n), generator=g, device=device,
                                     dtype=real),
                          torch.rand((m, n), generator=g, device=device,
                                     dtype=real))
        b = torch.complex(torch.rand((m,), generator=g, device=device,
                                     dtype=real),
                          torch.rand((m,), generator=g, device=device,
                                     dtype=real))
    else:
        A = torch.rand((m, n), generator=g, device=device, dtype=dtype)
        b = torch.rand((m,), generator=g, device=device, dtype=dtype)
    mesh = parallel.column_mesh(device=device)
    single = dt.qr(A, device=device)
    H_single, alpha_single = single.H, single.alpha
    wide = torch.complex128 if A.is_complex() else torch.float64
    A64, b64 = A.to(wide), b.to(wide)

    def ne(x):  # the normal-equations residual, in double
        return float(torch.linalg.vector_norm(
            A64.mH @ (A64 @ x.to(wide) - b64)))

    ne_single = ne(single.solve(b))
    single_profile = _solve_profile(lambda: single.solve(b), device) \
        if profile else None
    del single
    unit = lambda a: a / a.abs().clamp_min(1e-30)  # noqa: E731
    rows = []
    if probe:
        la = dt.qr(A, device=device, lookahead=True)
        rows.append({"single_lookahead_flips": int(
            ((unit(la.alpha) - unit(alpha_single)).abs() > 1e-3).sum()),
            "single_lookahead_h_diff": float(
                (la.H - H_single).abs().max() / H_single.abs().max())})
        del la
    hp.reset_launches()  # the mesh path starts here
    for i, (layout, sched, kw) in enumerate(runs):
        l0 = dict(hp.LAUNCHES)
        fact, t_first = _timed(lambda: dt.qr(A, mesh=mesh, layout=layout,
                                             **kw), device)
        launches = {k: hp.LAUNCHES[k] - l0[k] for k in l0}
        t = None
        if steady:
            del fact
            fact, t = _timed(lambda: dt.qr(A, mesh=mesh, layout=layout,
                                           **kw), device)
        x, t_solve = _timed(lambda: fact.solve(b), device)
        profiles = {"single_solve_profile": single_profile,
                    "mesh_solve_profile": _solve_profile(
                        lambda: fact.solve(b), device)} \
            if profile and i == 0 else {}
        nb = fact.block_size
        mine = sharded_qr._local_block(H_single, mesh, n, nb, layout)
        Hn = fact.natural_H()
        gidx = torch.as_tensor(sharded_qr._local_gidx(
            mesh.rank, n, n // mesh.size, nb, layout), device=device)
        upper = torch.arange(m, device=device)[:, None] < gidx
        R_mine = torch.where(upper, mine, 0).abs()
        Rp = torch.where(torch.arange(n, device=device)[:, None] < gidx,
                         Hn[:n].index_select(1, gidx), 0)
        Rp[gidx, torch.arange(gidx.numel(), device=device)] = \
            fact.alpha[gidx]
        QRp = blocked._apply_q_impl(Hn, torch.cat([Rp, Rp.new_zeros(
            (m - n, Rp.shape[1]))]), nb, fact.precision)
        Ap = A.index_select(1, gidx)
        # The first column whose pivot took the other sign, and on its
        # owner |a_jj| / ||x_j|| = |v_jj|^2 - 1 of both factorizations
        # (v the stored reflector, ||v||^2 = 2): near zero for a near-tie.
        flipped = ((unit(fact.alpha) - unit(alpha_single)).abs() > 1e-3)
        first = int(flipped.nonzero()[0]) if bool(flipped.any()) else None
        pivot = None
        if first is not None and first in gidx.tolist():
            jl = gidx.tolist().index(first)
            pivot = [float(fact.H[first, jl].abs() ** 2 - 1),
                     float(mine[first, jl].abs() ** 2 - 1)]
        rows.append({
            "layout": layout, "schedule": sched, "nb": nb,
            "first_s": t_first, "s": t, "solve_s": t_solve,
            "launches": launches,
            "backward_sq": float(torch.linalg.vector_norm(
                (QRp - Ap).to(wide)) ** 2),
            "a_sq": float(torch.linalg.vector_norm(Ap.to(wide)) ** 2),
            "h_diff": float((fact.H - mine).abs().max()),
            "h_max": float(mine.abs().max()),
            "r_diff": max(float((torch.where(upper, fact.H, 0).abs()
                                 - R_mine).abs().max()),
                          float((fact.alpha.abs() - alpha_single.abs())
                                .abs().max())),
            "r_max": max(float(R_mine.max()),
                         float(alpha_single.abs().max())),
            "sign_flips": int(flipped.sum()), "first_flip": first,
            "first_flip_pivot": pivot,
            "solve_residual": ne(x), "single_residual": ne_single,
            "finite": bool(torch.isfinite(torch.view_as_real(x)).all()
                           if x.is_complex() else torch.isfinite(x).all()),
            **profiles})
        del fact, x, Hn, Rp, QRp, Ap, mine, R_mine, upper
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def _rank_lstsq_case(dt, parallel, hp, device, seed, m, n, dtype, cols):
    """``lstsq(mesh=)`` of the reference's problem (numpy, from the seed),
    on its first ``cols`` columns; x comes back for the parent's LAPACK
    oracle."""
    A, b = random_problem(m, n, np.dtype(dtype), seed)
    A = np.ascontiguousarray(A[:, :cols])
    mesh = parallel.column_mesh(device=device)
    l0 = dict(hp.LAUNCHES)
    x, t = _timed(lambda: dt.lstsq(A, b, mesh=mesh), device)
    return [{"s": t, "x": x.cpu().numpy(),
             "launches": {k: hp.LAUNCHES[k] - l0[k] for k in l0}}]


def _rank_rows_case(dt, parallel, hp, device, seed, m, n, dtype, engines):
    """``lstsq(engine=..., mesh=row mesh)``; rank 0 also times
    ``torch.linalg.lstsq`` (yardstick) and both normal-equations
    residuals, in double."""
    dtype = getattr(torch, dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.rand((m, n), generator=g, device=device, dtype=dtype)
    b = torch.rand((m,), generator=g, device=device, dtype=dtype)
    mesh = parallel.row_mesh(device=device)
    A64, b64 = A.double(), b.double()

    def ne(x):
        return float(torch.linalg.vector_norm(
            A64.T @ (A64 @ x.double() - b64)))

    rows = []
    for engine in engines:
        l0 = dict(hp.LAUNCHES)
        x, t_first = _timed(lambda: dt.lstsq(A, b, mesh=mesh, engine=engine),
                            device)
        launches = {k: hp.LAUNCHES[k] - l0[k] for k in l0}
        x, t = _timed(lambda: dt.lstsq(A, b, mesh=mesh, engine=engine),
                      device)
        rows.append({"engine": engine, "first_s": t_first, "s": t,
                     "launches": launches, "residual": ne(x)})
    if mesh.rank == 0:
        x_ref, t_ref = _timed(
            lambda: torch.linalg.lstsq(A, b[:, None]).solution[:, 0], device)
        for row in rows:
            row["torch_lstsq_residual"] = ne(x_ref)
            row["torch_lstsq_s"] = t_ref
    return rows


TOL_GRAD_COMPRESSED = 1e-3   # compressed row engine's gradient vs exact


def _grad_route(dt, parallel, route, device, block_size):
    """``(mesh call, single-device call)`` of one phase-14 gradient route,
    each mapping (A, b) to its outputs (the single-device one takes the
    engine's keywords): "qr": (H, alpha) of ``qr(mesh=)`` (this rank's
    store-order block, and alpha) beside ``qr``'s; "lstsq": x of
    ``lstsq(mesh=)``; ("rows", engine, comms): x of the row engine; both
    beside the blocked ``lstsq``'s x, the exact solution's twin."""
    if route == "qr":
        mesh = parallel.column_mesh(device=device)

        def packed(f):
            return f.H, f.alpha

        return (lambda A, b: packed(dt.qr(A, mesh=mesh,
                                          block_size=block_size)),
                lambda A, b, **kw: packed(dt.qr(A, device=A.device, **kw)))
    single = (lambda A, b, **kw: (dt.lstsq(A, b, device=A.device, **kw),))
    if route == "lstsq":
        mesh = parallel.column_mesh(device=device)
        return (lambda A, b: (dt.lstsq(A, b, mesh=mesh,
                                       block_size=block_size),), single)
    _, engine, comms = route
    mesh = parallel.row_mesh(device=device)
    return (lambda A, b: (dt.lstsq(A, b, mesh=mesh, engine=engine,
                                   comms=comms),), single)


def _rank_grad_case(dt, parallel, hp, device, seed, m, n, dtype, routes,
                    block_size=128):
    """Gradients through the mesh on this rank, per route
    (:func:`_grad_route`): the forward without grad (timed after a warm-up
    call), then with it (bits, launches, seconds), the backward of the
    weighted loss (seconds, its collectives and bytes from the wire
    census, peak memory over A's bytes) and the tangent's part of the
    adjoint identity, with a digest of the gradient; rank 0 also holds
    the gradient to the single-device f64 route's (compensated norm off:
    f64 needs none), beside the single-device f32 plain route's error.
    The row routes share their data, so rank 0 computes their
    yardsticks once."""
    import hashlib

    import torch.autograd.forward_ad as fwAD

    from dhqr_tpu_torch.parallel import _ranks, wire

    dtype = getattr(torch, dtype)
    wide = _wide(dtype)
    rank0 = torch.distributed.get_rank() == 0
    _warm_factor_grad(dt, dtype, device)
    yardsticks = {}
    rows = []
    for i, route in enumerate(routes):
        t_route = time.perf_counter()
        shared = not isinstance(route, str)  # a row route
        g = torch.Generator(device=device).manual_seed(
            seed + (0 if shared else i))

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=device,
                               dtype=dtype)

        A, b, U, ub = rnd(m, n), rnd(m), rnd(m, n), rnd(m)
        mesh_call, single = _grad_route(dt, parallel, route, device,
                                        block_size)
        with torch.no_grad():
            mesh_call(A, b)  # warm-up: first-use costs of the route
            l0 = sum(hp.LAUNCHES.values())
            outs0, fwd_s = _timed(lambda: mesh_call(A, b), device)
            launches_off = sum(hp.LAUNCHES.values()) - l0
        natural = [rnd(m, n), rnd(n)] if route == "qr" else [rnd(n)]
        ws = list(natural)
        if route == "qr":  # this rank's store-order block of the H weight
            fact = dt.qr(A, mesh=parallel.column_mesh(device=device),
                         block_size=block_size)
            ws[0] = _ranks._weight(("store", natural[0]), fact, device)
            del fact
        At, bt = _with_grad(A, b)
        torch.cuda.reset_peak_memory_stats()
        l0 = sum(hp.LAUNCHES.values())
        outs, fwd_grad_s = _timed(lambda: mesh_call(At, bt), device)
        launches_on = sum(hp.LAUNCHES.values()) - l0
        same = all(torch.equal(o.detach(), o0) for o, o0 in zip(outs, outs0))
        fwd_peak = torch.cuda.max_memory_allocated()
        # autograd runs a CUDA backward on a thread of its own
        with wire.census(every_thread=True) as seen:
            (gA, gb), bwd_s = _timed(lambda: _grads(_weighted(outs, ws),
                                                    (At, bt)), device)
        peak = (torch.cuda.max_memory_allocated() - fwd_peak) / A.nbytes
        del outs, At, bt
        with fwAD.dual_level():
            tangents, jvp_s = _timed(lambda: [
                fwAD.unpack_dual(t).tangent for t in mesh_call(
                    fwAD.make_dual(A, U), fwAD.make_dual(b, ub))], device)
        digest = hashlib.sha256()
        for t in (gA, gb):
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
        row = {"route": route if isinstance(route, str) else
               "-".join(str(v) for v in route),
               "forward_s": fwd_s, "forward_with_grad_s": fwd_grad_s,
               "backward_s": bwd_s, "jvp_s": jvp_s,
               "forward_bit_identical": same,
               "launches_grad_off": launches_off,
               "launches_grad_on": launches_on,
               "backward_collectives": len(seen.entries),
               "backward_bytes": sum(e["bytes"] for e in seen.entries),
               "backward_families": {
                   f: v["collectives"] for f, v in seen.families().items()},
               "backward_peak_over_A_bytes": peak,
               "wJu": [_real_dot(w, t) for w, t in zip(ws, tangents)],
               "gu": _real_dot(gA, U) + _real_dot(gb, ub),
               "grad_digest": digest.hexdigest()}
        del tangents
        if rank0:  # the single-device yardsticks
            t_ref = time.perf_counter()
            key = "rows" if shared else route
            if key not in yardsticks:
                def grads_of(call, A_, b_, ws_):
                    Ar, br = _with_grad(A_, b_)
                    return _grads(_weighted(call(Ar, br), ws_), (Ar, br))

                yardsticks[key] = (  # both on the plain panels
                    grads_of(lambda A_, b_: single(A_, b_, norm="fast",
                                                   use_pallas="never"),
                             A.to(wide), b.to(wide),
                             [w.to(wide) for w in natural]),
                    grads_of(lambda A_, b_: single(A_, b_,
                                                   use_pallas="never"),
                             A, b, natural))
            (ref_A, ref_b), (plain_A, plain_b) = yardsticks[key]
            row["grad_rel_err_vs_f64_route"] = max(
                rel_err(gA.to(wide), ref_A), rel_err(gb.to(wide), ref_b))
            row["plain_f32_rel_err_vs_f64_route"] = max(
                rel_err(plain_A.to(wide), ref_A),
                rel_err(plain_b.to(wide), ref_b))
            row["yardstick_s"] = time.perf_counter() - t_ref
        row["seconds"] = time.perf_counter() - t_route
        rows.append(row)
        del A, b, U, ub, gA, gb, ws, natural
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def _check_sharded_grad(case, per_rank, P, where, smi):
    """Phase 14's gradient case: per route, every rank's forward with grad
    bit for bit the forward without it with the same launches (the plan's
    on the column mesh), every rank's gradient bit-identical to rank 0's,
    the adjoint identity with the conventions' global sums, and the
    gradient within 2x the single-device f32 plain route's error against
    the f64 route's (a compressed wire: within 1e-3 of it)."""
    m, n = case["m"], case["n"]
    dtype = getattr(torch, case["dtype"])
    for j, route in enumerate(case["routes"]):
        rows = [r[j] for r in per_rank]
        r0 = rows[0]
        if route == "qr":  # the blocks summed, alpha once
            wJu = sum(r["wJu"][0] for r in rows) + r0["wJu"][1]
        else:
            wJu = sum(r0["wJu"])
        adjoint = abs(wJu - r0["gu"]) / abs(r0["gu"])
        launches = sum(r["launches_grad_on"] for r in rows)
        compressed = not isinstance(route, str) and route[2] is not None
        expect = sharded_plan(m, n, dtype, P, case.get("block_size")) \
            if route in ("qr", "lstsq") else None
        err, plain = (r0["grad_rel_err_vs_f64_route"],
                      r0["plain_f32_rel_err_vs_f64_route"])
        row = {"phase": 14, "name": "sharded_gradient", **where,
               "card": smi, "route": r0["route"], "dtype": case["dtype"],
               "shape": [m, n],
               "forward_ms": 1e3 * max(r["forward_s"] for r in rows),
               "forward_with_grad_ms": 1e3 * max(
                   r["forward_with_grad_s"] for r in rows),
               "forward_backward_ms": 1e3 * max(
                   r["forward_with_grad_s"] + r["backward_s"] for r in rows),
               "jvp_ms": 1e3 * max(r["jvp_s"] for r in rows),
               "route_s": max(r["seconds"] for r in rows),
               "yardstick_s": r0["yardstick_s"],
               "backward_collectives_per_rank": r0["backward_collectives"],
               "backward_bytes_per_rank": r0["backward_bytes"],
               "backward_families": r0["backward_families"],
               "backward_peak_over_A_bytes": max(
                   r["backward_peak_over_A_bytes"] for r in rows),
               "grad_rel_err_vs_f64_route": err,
               "plain_f32_rel_err_vs_f64_route": plain,
               "tol_factor": KERNEL_GRAD_FACTOR,
               "adjoint_rel_err": adjoint, "tol_adjoint": TOL_ADJOINT,
               "forward_bit_identical": all(
                   r["forward_bit_identical"] for r in rows),
               "launches_grad_on": launches,
               "launches_grad_off": sum(r["launches_grad_off"]
                                        for r in rows),
               "expected": expect,
               "ranks_agree": len({r["grad_digest"] for r in rows}) == 1}
        bar = TOL_GRAD_COMPRESSED if compressed else KERNEL_GRAD_FACTOR * plain
        # the identity holds to the f32 rounding of both sides: where the
        # route's own gradient error exceeds TOL_ADJOINT (c64 at 1024
        # columns: a pivot's phase is sensitive), to 2x that error
        row["tol_adjoint"] = max(TOL_ADJOINT, KERNEL_GRAD_FACTOR * plain)
        row["ok"] = bool(
            row["forward_bit_identical"] and row["ranks_agree"]
            and all(r["launches_grad_on"] == r["launches_grad_off"]
                    for r in rows)
            and (expect is None or launches == expect)
            and adjoint <= row["tol_adjoint"] and err <= bar)
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"sharded gradient check failed: {row}")


_RANK_CASES = {"qr": _rank_qr_case, "lstsq": _rank_lstsq_case,
               "rows": _rank_rows_case, "grad": _rank_grad_case}


def sharded_worker(device, cases):
    """One rank of phase 14 (run by ``run_ranks``): each case on this
    rank's mesh; returns {"cases": per-case rows, "launches": this rank's
    kernel launches on the mesh path}. The counts are zeroed before each
    case (and by a case after its single-device references) and summed
    after it."""
    import dhqr_tpu_torch as dt
    from dhqr_tpu_torch import parallel
    from dhqr_tpu_torch.ops import hopper_panel as hp

    out = []
    launches = dict.fromkeys(hp.KERNELS.values(), 0)
    for case in cases:
        case = dict(case)
        hp.reset_launches()
        out.append(_RANK_CASES[case.pop("kind")](dt, parallel, hp, device,
                                                 **case))
        for name, count in hp.LAUNCHES.items():
            launches[name] += count
    return {"cases": out, "launches": launches}


def sharded_plan(m, n, dtype, P, nb=None):
    """Kernel launches of one single-device factorization of the (padded)
    (m, n) matrix by the mesh engine's panel width (``plan_padding``)."""
    from dhqr_tpu_torch.ops import blocked
    from dhqr_tpu_torch.parallel.layout import plan_padding

    nb, n_pad = plan_padding(n, P, nb or blocked.DEFAULT_BLOCK_SIZE)
    cuda = torch.device("cuda")
    m_pad = m + n_pad - n
    plan = blocked.panel_plan(m_pad, n_pad, nb, True, dtype, cuda)
    return sum(blocked.kernel_leaves(w, leaf) for _, w, leaf in plan if leaf)


def _mps_running() -> bool:
    import glob

    for path in glob.glob("/proc/[0-9]*/comm"):
        try:
            with open(path) as f:
                if f.read().startswith("nvidia-cuda-mps"):
                    return True
        except OSError:
            continue
    return False


def phase_sharded(hp, seed, smi=None):
    """The sharded tier on one card: (a) NCCL with one rank, ``qr`` +
    ``solve`` at 16384^2 f32, and (f) gradients through ``qr(mesh=)`` and
    ``lstsq(mesh=)`` at the reference's 4400 x 4000 f32; (b) gloo, 4 ranks
    on card 0, ``qr`` + ``solve`` at 16384^2 f32 per layout and schedule,
    (d) ``lstsq`` at the reference's 4400 x 4000 (and 4400 x 3998, padded)
    f32 and c64 under 8x, (e) TSQR and CholeskyQR2 on the row mesh at
    65536 x 256 f32, (f) gradients through the column mesh at 1024 x 512
    f32 and c64 (two 64-wide panels per rank) and the row mesh at 65536 x
    256 f32
    (tsqr, cholqr2, cholqr2 on the bf16 wire); (c) gloo, 2 ranks, c64
    ``qr`` + ``solve`` at 8192 x 4096. Launches of every rank are added
    into the parent's counts; ``smi`` (the card's name and power limit)
    marks the gradient rows."""
    from dhqr_tpu_torch.parallel._ranks import run_ranks
    from dhqr_tpu_torch.utils.testing import lapack_lstsq, \
        normal_equations_residual

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    mps = _mps_running()
    emit({"phase": 14, "name": "sharded_setup", "compute_mode": mode,
          "mps_running": mps, "card": torch.cuda.get_device_name(0)})
    if mps or mode != "Default":
        raise AssertionError(f"phase 14 shares card 0 between processes "
                             f"and needs compute mode Default without MPS: "
                             f"{mode}, MPS running: {mps}")
    torch.cuda.empty_cache()
    device = "cuda:0"
    f32, c64 = "float32", "complex64"
    square = {"kind": "qr", "m": 16384, "n": 16384, "dtype": f32,
              "seed": seed + 14}
    reference = {"kind": "lstsq", "m": 4400, "n": 4000, "seed": seed + 3}
    grads = {"kind": "grad", "seed": seed + 17}
    runs = [
        ("af", "nccl", 1, [dict(square, probe=True, profile=True,
                                runs=[("block", "default", {}),
                                      ("block", "lookahead",
                                       {"lookahead": True})]),
                           dict(grads, m=4400, n=4000, dtype=f32,
                                routes=["qr", "lstsq"])]),
        ("c", "gloo", 2, [{"kind": "qr", "m": 8192, "n": 4096, "dtype": c64,
                           "seed": seed + 15,
                           "runs": [("cyclic", "default", {})]}]),
        ("bde", "gloo", 4, [
            dict(square, runs=list(SHARDED_SCHEDULES)),
            dict(reference, dtype=f32, cols=4000),
            dict(reference, dtype=f32, cols=3998),
            dict(reference, dtype=c64, cols=4000),
            {"kind": "rows", "m": 65536, "n": 256, "dtype": f32,
             "seed": seed + 16, "engines": ["tsqr", "cholqr2"]},
            dict(grads, m=1024, n=512, dtype=f32, block_size=64,
                 routes=["qr", "lstsq"]),
            dict(grads, m=1024, n=512, dtype=c64, block_size=64,
                 routes=["qr"]),
            dict(grads, m=65536, n=256, dtype=f32,
                 routes=[("rows", "tsqr", None), ("rows", "cholqr2", None),
                         ("rows", "cholqr2", "bf16")])]),
    ]
    for label, backend, P, cases in runs:
        t0 = time.perf_counter()
        ranks = run_ranks(sharded_worker, P, backend=backend, device=device,
                          timeout_s=420, cases=cases)
        wall_s = time.perf_counter() - t0
        for r in ranks:
            for name, count in r["launches"].items():
                hp.LAUNCHES[name] += count
        where = {"backend": backend, "ranks": P, "ranks_per_card": P,
                 "rank_device": device}
        for i, case in enumerate(cases):
            per_rank = [r["cases"][i] for r in ranks]
            if case["kind"] == "qr":
                _check_sharded_qr(case, per_rank, P, where)
            elif case["kind"] == "grad":
                _check_sharded_grad(case, per_rank, P, where, smi)
            elif case["kind"] == "lstsq":
                dtype = np.dtype(case["dtype"])
                A, b, _ = lapack_problem(case["m"], case["n"], dtype,
                                         case["seed"])
                A = A[:, :case["cols"]]
                oracle = normal_equations_residual(
                    A, lapack_lstsq(A, b), b) if case["cols"] != case["n"] \
                    else oracle_of(case["m"], case["n"], dtype,
                                   case["seed"])[2]
                row0 = per_rank[0][0]
                res = normal_equations_residual(A, row0["x"], b)
                launches = sum(sum(r[0]["launches"].values())
                               for r in per_rank)
                expect = sharded_plan(case["m"], case["cols"],
                                      getattr(torch, case["dtype"]), P)
                row = {"phase": 14, "name": "sharded_lstsq", **where,
                       "dtype": dtype.name, "shape": [case["m"], case["cols"]],
                       "s": max(r[0]["s"] for r in per_rank),
                       "normal_eq_residual": res, "lapack_residual": oracle,
                       "ratio": res / oracle, "criterion": CRITERION,
                       "launches": launches, "expected": expect}
                row["ok"] = bool(np.isfinite(res)) and \
                    res < CRITERION * oracle and launches == expect
                emit(row)
                if not row["ok"]:
                    raise AssertionError(f"sharded lstsq failed: {row}")
            else:
                _check_sharded_rows(case, per_rank, P, where)
        emit({"phase": 14, "name": "sharded_run", "case": label, **where,
              "wall_s": wall_s})


def _check_sharded_qr(case, per_rank, P, where):
    from dhqr_tpu_torch.ops import hopper_panel as hp_

    m, n = case["m"], case["n"]
    dtype = getattr(torch, case["dtype"])
    tol = TOL_BACKWARD_F32 if dtype == torch.float32 else TOL_BACKWARD_C64
    plan = sharded_plan(m, n, dtype, P)
    if case.get("probe"):  # the single-device lookahead beside the default
        emit({"phase": 14, "name": "single_device_lookahead_probe",
              "shape": [m, n], **per_rank[0][0]})
        per_rank = [r[1:] for r in per_rank]
    for j, (layout, sched, kw) in enumerate(case["runs"]):
        rows = [r[j] for r in per_rank]
        backward = (sum(r["backward_sq"] for r in rows)
                    / sum(r["a_sq"] for r in rows)) ** 0.5
        launches = sum(r["launches"][hp_.KERNELS[dtype]] for r in rows)
        expect = plan * (P if "agg_panels" in kw else 1)
        row = {"phase": 14, "name": "sharded_qr", **where,
               "dtype": case["dtype"], "shape": [m, n], "layout": layout,
               "schedule": sched, "nb": rows[0]["nb"],
               "factor_first_s": max(r["first_s"] for r in rows),
               "factor_s": max(r["s"] for r in rows)
               if rows[0]["s"] is not None else None,
               "solve_s": max(r["solve_s"] for r in rows),
               "backward_error": backward, "tol_backward": tol,
               "rel_diff_H_single": max(r["h_diff"] for r in rows)
               / max(r["h_max"] for r in rows),
               "rel_diff_R_up_to_signs": max(r["r_diff"] for r in rows)
               / max(r["r_max"] for r in rows),
               "alpha_sign_flips": rows[0]["sign_flips"],
               "first_flip_column": rows[0]["first_flip"],
               "first_flip_pivot_over_norm": next(
                   (r["first_flip_pivot"] for r in rows
                    if r["first_flip_pivot"] is not None), None),
               "tol_diff": TOL_SHARDED_H,
               "solve_normal_eq_residual": rows[0]["solve_residual"],
               "single_device_residual": rows[0]["single_residual"],
               "solve_ratio": rows[0]["solve_residual"]
               / rows[0]["single_residual"], "criterion": CRITERION,
               "launches": launches, "expected": expect}
        # The default schedule on one rank runs the single-device engine's
        # panels and GEMMs in order: its H must match. Other schedules and
        # several ranks split the GEMMs otherwise, and at 16384^2 a pivot
        # within roundoff of zero can take the other sign (then that
        # reflector and everything after it differ, H by percents): those
        # are held to R, unique up to row signs, and to the backward error.
        dist = row["rel_diff_H_single"] if (P, sched) == (1, "default") \
            else row["rel_diff_R_up_to_signs"]
        row["ok"] = (backward < tol and all(r["finite"] for r in rows)
                     and dist < TOL_SHARDED_H
                     and row["solve_ratio"] <= CRITERION
                     and expect >= 1 and launches == expect)
        emit(row)
        if "mesh_solve_profile" in rows[0]:
            emit({"phase": 14, "name": "sharded_solve_profile", **where,
                  "shape": [m, n], "layout": layout, "schedule": sched,
                  **{k: rows[0][k] for k in ("single_solve_profile",
                                             "mesh_solve_profile")}})
        if not row["ok"]:
            raise AssertionError(f"sharded qr failed: {row}")


def _check_sharded_rows(case, per_rank, P, where):
    from dhqr_tpu_torch.ops import blocked, hopper_panel as hp_

    m, n = case["m"], case["n"]
    dtype = getattr(torch, case["dtype"])
    cuda = torch.device("cuda")
    nb = min(blocked.DEFAULT_BLOCK_SIZE, n)
    leaf = blocked.panel_plan(m // P, n, nb, True, dtype, cuda)
    combine = blocked.panel_plan(P * n, n, nb, True, dtype, cuda)
    per_rank_plan = sum(blocked.kernel_leaves(w, lw)
                        for _, w, lw in leaf + combine if lw)
    for j, engine in enumerate(case["engines"]):
        rows = [r[j] for r in per_rank]
        launches = sum(r["launches"][hp_.KERNELS[dtype]] for r in rows)
        expect = P * per_rank_plan if engine == "tsqr" else 0
        ref = rows[0]["torch_lstsq_residual"]
        row = {"phase": 14, "name": "sharded_rows", **where,
               "engine": engine, "dtype": case["dtype"], "shape": [m, n],
               "first_s": max(r["first_s"] for r in rows),
               "s": max(r["s"] for r in rows),
               "torch_lstsq_s": rows[0]["torch_lstsq_s"],
               "normal_eq_residual": rows[0]["residual"],
               "torch_lstsq_residual": ref,
               "ratio": rows[0]["residual"] / ref, "criterion": CRITERION,
               "launches": launches, "expected": expect}
        row["ok"] = (bool(np.isfinite(rows[0]["residual"]))
                     and rows[0]["residual"] <= CRITERION * ref
                     and launches == expect)
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"sharded row engine failed: {row}")


# -- phase 15: the guarded path and the updatable QR -------------------------

TOL_ROUND_TRIP = 1e-3   # ||R' - R|| / ||R||, rows to a positive diagonal,
# after an update and a downdate with the same vectors (f32)


def _ne_in(A, x, b) -> float:
    """||A^H (A x - b)|| evaluated on the card in the input's precision."""
    return float(torch.linalg.vector_norm(A.mH @ (A @ x - b)))


def _torch_lstsq(A, b):
    return torch.linalg.lstsq(A, b[:, None]).solution[:, 0]


def _path_of(res):
    return [[a.engine, a.outcome, a.policy, a.detail] for a in res.attempts]


def _launches_of(hp, fn):
    """(fn(), {kernel: launches during it}, seconds)."""
    l0 = dict(hp.LAUNCHES)
    out, t = wall(fn)
    return out, {k: hp.LAUNCHES[k] - l0[k] for k in l0}, t


def _counted(hp, fn, tally):
    """:func:`_launches_of`, adding the launches to ``tally``, the phase's
    own account of what its path launched."""
    out, launched, t = _launches_of(hp, fn)
    for k, n in launched.items():
        tally[k] = tally.get(k, 0) + n
    return out, launched, t


def _uncounted(hp, fn):
    """:func:`_launches_of` for a yardstick run inside a counted path (the
    unguarded call a guarded one is held to, a fresh factorization an
    update is timed against): its launches are taken back out of the
    counts, so that the path's count holds the path's own calls only."""
    out, launched, t = _launches_of(hp, fn)
    for k, n in launched.items():
        hp.LAUNCHES[k] -= n
    return out, launched, t


def _ill_conditioned(m, n, cond, seed):
    """A Gaussian (m, n) f32 matrix with singular values scaled by a
    geometric ladder from 1 to 1/cond (cond(A) within a small factor of
    ``cond``), and b, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = torch.randn((m, n), generator=g, device="cuda", dtype=torch.float32)
    V, _ = torch.linalg.qr(torch.randn((n, n), generator=g, device="cuda",
                                       dtype=torch.float64))
    s = torch.logspace(0, -np.log10(cond), n, device="cuda",
                       dtype=torch.float64)
    A = (G.double() @ (s[:, None] * V.T)).float()
    b = torch.randn((m,), generator=g, device="cuda", dtype=torch.float32)
    return A, b


def phase_guarded(dt, hp, seed, card):
    """(a) ``guarded_lstsq`` at 16384^2 f32 in the default "fallback"
    mode against the unguarded ``lstsq``: the same x bit for bit, one "ok"
    attempt, the same launches, and the guard's cost; (b) the same under an
    injected ``numeric.breakdown:1.0:1``, which escalates to the policy
    rung (the fault fires before rung 0 runs, so one factorization
    launches), within 8x of ``torch.linalg.lstsq`` in the input's
    precision; (c) ``engine="cholqr2"``, ``guards="full"`` at 65536 x 256
    f32 with cond 1e5 (past CholeskyQR2's window, inside the shifted
    form's): rung 0 breaks down, the answer meets the residual gate; then a
    ``numeric.breakdown:1.0:2`` schedule that lands on the tsqr rung, its
    launches the TSQR plan; (d) ``guarded_qr`` at 8192 x 4096 c64 (32
    launches, backward error), and the same with a zero column, refused
    before any launch; (e) ``guards="full"`` at the reference's 4400 x 4000
    f32. Returns the launches of its guarded calls; the unguarded calls of
    (a) are yardsticks and stay out of the path's count."""
    from dhqr_tpu_torch import faults
    from dhqr_tpu_torch.numeric import guards, ladder
    from dhqr_tpu_torch.utils.config import FaultConfig

    f32 = "panel_qr_f32"
    n = 16384
    g = torch.Generator(device="cuda").manual_seed(seed + 15)
    A = torch.rand((n, n), generator=g, device="cuda", dtype=torch.float32)
    b = torch.rand((n,), generator=g, device="cuda", dtype=torch.float32)
    expect = expected_launches(n, n, torch.float32)
    tally = {}  # the launches of this phase's guarded calls
    _uncounted(hp, lambda: dt.lstsq(A, b))  # warm-up of both paths
    _counted(hp, lambda: ladder.guarded_lstsq(A, b), tally)
    times = {"unguarded": [], "guarded": []}
    for _ in range(2):
        x0, l_u, t = _uncounted(hp, lambda: dt.lstsq(A, b))
        times["unguarded"].append(t)
        res, l_g, t = _counted(hp, lambda: ladder.guarded_lstsq(A, b), tally)
        times["guarded"].append(t)
    l_u, l_g = l_u[f32], l_g[f32]
    t_u, t_g = min(times["unguarded"]), min(times["guarded"])
    row = {"phase": 15, "name": "guarded_lstsq_square", "shape": [n, n],
           "card": card, "mode": "fallback", "unguarded_s": times["unguarded"],
           "guarded_s": times["guarded"],
           "overhead_pct": 100.0 * (t_g - t_u) / t_u,
           "bit_equal": bool(torch.equal(x0, res.x)),
           "attempts": _path_of(res), "launches_unguarded": l_u,
           "launches_guarded": l_g, "expected": expect}
    row["ok"] = (row["bit_equal"] and [a.outcome for a in res.attempts]
                 == ["ok"] and l_u == l_g == expect)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"guarded square check failed: {row}")
    del x0
    with faults.injected(FaultConfig(sites=(("numeric.breakdown", 1.0, 1),))):
        res, launches, t = _counted(
            hp, lambda: ladder.guarded_lstsq(A, b), tally)
    launches = launches[f32]
    x_ref, t_ref = wall(lambda: _torch_lstsq(A, b))
    ratio = _ne_in(A, res.x, b) / _ne_in(A, x_ref, b)
    row = {"phase": 15, "name": "guarded_lstsq_injected", "shape": [n, n],
           "s": t, "attempts": _path_of(res), "launches": launches,
           "expected": expect, "ratio_to_torch_lstsq": ratio,
           "torch_lstsq_s": t_ref, "criterion": CRITERION}
    row["ok"] = ([(a.outcome, a.detail) for a in res.attempts]
                 == [("breakdown", "injected numeric.breakdown"),
                     ("ok", None)]
                 and res.escalations == 1 and launches == expect
                 and ratio <= CRITERION)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"guarded injected check failed: {row}")
    del A, b, res, x_ref
    torch.cuda.empty_cache()

    m, k = 65536, 256
    A, b = _ill_conditioned(m, k, 1e5, seed + 16)
    tsqr_plan = tsqr_expected_launches(m, k, 8, torch.float32)
    x_ref, t_ref = wall(lambda: _torch_lstsq(A, b))
    res, launches, t = _counted(hp, lambda: ladder.guarded_lstsq(
        A, b, engine="cholqr2", guards="full"), tally)
    launches = launches[f32]
    _, t_probe = wall(lambda: guards.residual_ratio(A, b, res.x))
    row = {"phase": 15, "name": "guarded_cholqr2_ill_conditioned",
           "shape": [m, k], "cond": 1e5, "s": t, "probe_s": t_probe,
           "attempts": _path_of(res),
           "residual_ratio": res.residual_ratio, "launches": launches,
           "ratio_to_torch_lstsq": _ne_in(A, res.x, b) / _ne_in(A, x_ref, b),
           "torch_lstsq_s": t_ref, "criterion": CRITERION}
    row["ok"] = (res.attempts[0].outcome == "breakdown"
                 and res.residual_ratio is not None
                 and res.residual_ratio <= CRITERION)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"guarded cholqr2 check failed: {row}")
    with faults.injected(FaultConfig(sites=(("numeric.breakdown", 1.0, 2),))):
        res, launches, t = _counted(hp, lambda: ladder.guarded_lstsq(
            A, b, engine="cholqr2"), tally)
    launches = launches[f32]
    row = {"phase": 15, "name": "guarded_to_tsqr_rung", "shape": [m, k],
           "s": t, "attempts": _path_of(res), "launches": launches,
           "expected": tsqr_plan,
           "ratio_to_torch_lstsq": _ne_in(A, res.x, b) / _ne_in(A, x_ref, b)}
    row["ok"] = res.engine == "tsqr" and launches == tsqr_plan == 18
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"guarded tsqr rung check failed: {row}")
    del A, b, res, x_ref
    torch.cuda.empty_cache()

    m, k = 8192, 4096
    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    A = torch.rand((m, k), generator=g, device="cuda", dtype=torch.complex64)
    expect = expected_launches(m, k, torch.complex64)
    res, launches, t = _counted(
        hp, lambda: ladder.guarded_qr(A, guards="full"), tally)
    launches = launches["panel_qr_c64"]
    back = backward_error(res.factorization, A)
    A[:, 7] = 0
    refused = []

    def refuse():
        try:
            ladder.guarded_qr(A, guards="full")
        except dt.IllConditioned as exc:
            refused.append(str(exc)[:80])

    _, l_zero, _ = _counted(hp, refuse, tally)
    refused = refused[0] if refused else None
    l_zero = sum(l_zero.values())
    row = {"phase": 15, "name": "guarded_qr_c64", "shape": [m, k], "s": t,
           "attempts": _path_of(res), "cond_estimate": res.cond_estimate,
           "launches": launches, "expected": expect,
           "backward_error": back, "tol_backward": TOL_BACKWARD_C64,
           "zero_column_refused": refused, "zero_column_launches": l_zero}
    row["ok"] = (launches == expect == 32 and back < TOL_BACKWARD_C64
                 and refused is not None and l_zero == 0)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"guarded qr c64 check failed: {row}")
    del A, res
    torch.cuda.empty_cache()

    A, b = random_problem(4400, 4000, np.float32, seed + 3)
    res, launches, t = _counted(hp, lambda: ladder.guarded_lstsq(
        A, b, guards="full"), tally)
    launches = launches[f32]
    row = {"phase": 15, "name": "guarded_lstsq_reference", "shape":
           [4400, 4000], "s": t, "attempts": _path_of(res),
           "residual_ratio": res.residual_ratio, "launches": launches,
           "criterion": CRITERION}
    row["ok"] = (res.residual_ratio is not None
                 and res.residual_ratio <= CRITERION and launches >= 1)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"guarded reference check failed: {row}")
    return tally


def _positive_rows(R):
    """R with each row scaled to a positive diagonal (R is unique up to
    those signs)."""
    d = torch.diagonal(R)
    return R * (d.abs() / d)[:, None].conj()


def _gram_gap(R, A) -> float:
    """||R^H R - A^H A||_F / ||A^H A||_F in double: how far R is from a
    QR factor of A, whatever the signs of its rows."""
    R64, A64 = R.double(), A.double()
    G = A64.mH @ A64
    return float(torch.linalg.matrix_norm(R64.mH @ R64 - G)
                 / torch.linalg.matrix_norm(G))


GRAM_STEPS = (7, 15, 23, 30, 47, 63)  # steps of phase 15 (f) that sweep
# (no refactor), 30 the last before the threshold refactor at 31


def phase_update(dt, hp, seed, card, m=65536, n=256, steps=64):
    """``UpdatableQR`` at ``BASELINE.json``'s tall-skinny shape: a seeded
    stream of 64 rank-1 steps (update and downdate in turn) with the
    default refactor policy (after 32) and one injected
    ``numeric.breakdown`` refactor (step 40). Holds the initial
    factorization and each refactor to the blocked plan's launches and
    every other step to none; at :data:`GRAM_STEPS` the sweeps' R against
    the live A (``_gram_gap`` within ``TOL_GRAM``), beside the gap that R
    from before the step would read (a sweep that left R as it was), which
    must lie past the limit; every 8 steps ``solve`` on the live A within
    8x of ``torch.linalg.lstsq`` of that A (in the input's precision); an
    update and a downdate with the same vectors bring R back within 1e-3.
    Times per update and per solve, the kernels one update launches
    (``torch.profiler``), and, as yardsticks outside the path's count, a
    fresh ``qr`` and a fresh ``lstsq`` at the shape. Returns the launches
    of the stream's calls."""
    from dhqr_tpu_torch import faults
    from dhqr_tpu_torch.utils.config import FaultConfig

    f32 = "panel_qr_f32"
    tally = {}
    expect = expected_launches(m, n, torch.float32)
    g = torch.Generator(device="cuda").manual_seed(seed + 18)
    A = torch.rand((m, n), generator=g, device="cuda", dtype=torch.float32)
    b = torch.rand((m,), generator=g, device="cuda", dtype=torch.float32)
    live, l_init, t_init = _counted(hp, lambda: dt.UpdatableQR(A), tally)
    reasons = [[-1, live.last_refactor["reason"]]]
    refactor_launches = [l_init[f32]]
    stray = 0  # launches of the steps that did not refactor, and of solves
    t_steps, solves, worst, grams, xs = [], [], 0.0, [], []
    for step in range(steps):
        u = 0.01 * torch.randn((m,), generator=g, device="cuda")
        v = torch.randn((n,), generator=g, device="cuda")
        op = live.update if step % 2 == 0 else live.downdate
        R_before = live.r_matrix().clone() if step in GRAM_STEPS else None
        if step == 40:
            with faults.injected(FaultConfig(
                    sites=(("numeric.breakdown", 1.0, 1),))):
                info, launched, t = _counted(hp, lambda: op(u, v), tally)
        else:
            info, launched, t = _counted(hp, lambda: op(u, v), tally)
        if info["refactored"]:
            reasons.append([step, info["reason"]])
            refactor_launches.append(launched[f32])
        else:
            t_steps.append(t)
            stray += sum(launched.values())
        if R_before is not None:
            grams.append([step, _gram_gap(live.r_matrix(), live.matrix),
                          _gram_gap(R_before, live.matrix)])
            del R_before
        if step % 8 == 7:
            x, launched, t_solve = _counted(hp, lambda: live.solve(b), tally)
            stray += sum(launched.values())
            solves.append(t_solve)
            xs.append(x)
            Al = live.matrix
            ratio = _ne_in(Al, x, b) / _ne_in(Al, _torch_lstsq(Al, b), b)
            worst = max(worst, ratio)
    _SHARED["update_reference"] = {
        "shape": (m, n, steps), "reasons": [list(r) for r in reasons],
        "xs": xs, "R": live.r_matrix().clone()}
    R0 = _positive_rows(live.r_matrix())
    u = 0.01 * torch.randn((m,), generator=g, device="cuda")
    v = torch.randn((n,), generator=g, device="cuda")
    _, launched, _ = _counted(
        hp, lambda: (live.update(u, v), live.downdate(u, v)), tally)
    stray += sum(launched.values())
    drift = float(torch.linalg.matrix_norm(_positive_rows(live.r_matrix())
                                           - R0)
                  / torch.linalg.matrix_norm(R0))
    prof, launched, _ = _counted(
        hp, lambda: _solve_profile(lambda: live.update(u, v), "cuda"), tally)
    stray += sum(launched.values())
    _uncounted(hp, lambda: dt.qr(A))  # warm-up
    _, _, t_qr = _uncounted(hp, lambda: dt.qr(A))
    _, _, t_lstsq = _uncounted(hp, lambda: dt.lstsq(A, b))
    row = {"phase": 15, "name": "updatable_qr_stream", "shape": [m, n],
           "card": card, "steps": steps, "init_s": t_init,
           "refactors": reasons, "refactor_launches": refactor_launches,
           "expected": expect, "stray_launches": stray,
           "update_ms_median": 1e3 * float(np.median(t_steps)),
           "update_ms_min": 1e3 * min(t_steps),
           "solve_ms": [1e3 * t for t in solves],
           "worst_solve_ratio_to_torch_lstsq": worst,
           "criterion": CRITERION,
           "gram_step_sweep_noop": grams, "tol_gram": TOL_GRAM,
           "round_trip_r_drift": drift, "tol_round_trip": TOL_ROUND_TRIP,
           "update_kernels_profiled": prof["kernels"],
           "update_profiled_wall_s": prof["wall_s"],
           "update_device_busy_s": prof["device_busy_s"],
           "fresh_qr_s": t_qr, "fresh_lstsq_s": t_lstsq}
    row["ok"] = (reasons == [[-1, "initial"], [31, "threshold"],
                             [40, "injected_breakdown"]]
                 and refactor_launches == [expect] * 3 and expect == 4
                 and stray == 0
                 and len(grams) == len(GRAM_STEPS)
                 and all(sweep <= TOL_GRAM < noop for _, sweep, noop in grams)
                 and worst <= CRITERION and drift <= TOL_ROUND_TRIP)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"updatable QR check failed: {row}")
    return tally


# -- phase 16: the wire --------------------------------------------------------
#
# The compressed wire, the two-tier pod mesh, the depth-k pipeline and pulse,
# in spawned processes that share card 0 as phase 14's: one NCCL rank, then
# gloo with 4 and with 2 ranks. Each collective is read from the wire seam's
# census, whose bytes are held to ``wire_bytes_formula``; times are processes
# time-sharing one H100, never a scaling number.

WIRE_BACKWARD = 0.05   # a bf16-wire factor's backward error stays below
# this, and above the uncompressed one's (the compression is real): the
# JAX package's bound (tests/test_wire.py, bf16 comms backward error). An
# int8-wire factor's is printed and held above the uncompressed one's
# (0.041 at 1024^2 and 0.095 at 4096^2 on the CPU: no bound is claimed)
# Corrected semi-normal sweeps a caller adds to a bf16 column-mesh lstsq at
# the reference's 4400 x 4000 (condition ~2e3): the model tier's floor of 2
# (the JAX package's CSNE_MODEL_SWEEPS) leaves it ~100x off the 8x bar, as
# it leaves the JAX package's own solve; int8's sweeps diverge there. The
# floor runs are printed, the runs with these sweeps held to 8x.
WIRE_SWEEPS = 6
WIRE_RUNS_4 = (("none", "cols", {}),
               ("bf16", "cols", {"comms": "bf16"}),
               ("int8", "cols", {"comms": "int8"}),
               ("pod2x2", "pod:2x2", {}),
               ("pod2x2_dcn_bf16", "pod:2x2", {"comms": "dcn:bf16"}),
               ("pod2x2f", "pod:2x2", {"flat": True}),
               ("pod2x2f_dcn_bf16", "pod:2x2", {"flat": True,
                                                 "comms": "dcn:bf16"}),
               ("depth2", "cols", {"lookahead": True, "overlap_depth": 2}),
               ("depth3", "cols", {"lookahead": True, "overlap_depth": 3}),
               ("depth2_bf16", "cols", {"lookahead": True, "overlap_depth": 2,
                                        "comms": "bf16"}),
               ("depth3_bf16", "cols", {"lookahead": True, "overlap_depth": 3,
                                        "comms": "bf16"}))


def wire_bytes_formula(entry) -> int:
    """The bytes a census entry's collective must carry, from its parts'
    shapes alone: a word at its own size uncompressed and for complex
    payloads; 2 bytes under bf16 (and an int8 dense sum, which carries
    bf16); under int8 1 byte plus one word of the payload's dtype per
    (32-row block, column) of a matrix, per vector otherwise. A gather
    carries every rank's share."""
    itemsize = {"float32": 4, "float64": 8, "complex64": 8,
                "complex128": 16}[entry["dtype"]]
    comms = entry["comms"]
    mode = None if comms is None or entry["dtype"].startswith("complex") \
        else "int8" if comms == "int8" and entry["onehot"] else "bf16"
    total = 0
    for shape in entry["shapes"]:
        n = int(np.prod(shape))
        if mode is None:
            total += n * itemsize
        elif mode == "bf16":
            total += 2 * n
        else:
            if len(shape) == 2:
                r, c = shape
                scales = -(-r // min(32, max(r, 1))) * c
            else:
                scales = shape[-1] if len(shape) > 2 else 1
            total += n + scales * itemsize
    return total * (entry["ranks"] if entry["family"] == "all_gather" else 1)


def _census_summary(entries) -> dict:
    """Per family and per leg bytes of a census, its ratio to the same
    payloads uncompressed, and whether every entry carried exactly what
    :func:`wire_bytes_formula` says."""
    fams, legs = {}, {}
    for e in entries:
        row = fams.setdefault(e["family"], {"collectives": 0, "launches": 0,
                                            "bytes": 0, "raw_bytes": 0})
        row["collectives"] += 1
        row["launches"] += e["launches"]
        row["bytes"] += e["bytes"]
        row["raw_bytes"] += e["raw_bytes"]
        legs[e["leg"]] = legs.get(e["leg"], 0) + e["bytes"]
    total = sum(e["bytes"] for e in entries)
    raw = sum(e["raw_bytes"] for e in entries)
    return {"families": fams, "legs": legs, "bytes": total,
            "raw_bytes": raw, "ratio": total / raw if raw else None,
            "formula_bytes": sum(wire_bytes_formula(e) for e in entries),
            "formula_ok": all(e["bytes"] == wire_bytes_formula(e)
                              for e in entries),
            "complex_compressed": any(
                e["dtype"].startswith("complex") and e["wire"] != e["dtype"]
                for e in entries),
            "compressed": any(e["bytes"] != e["raw_bytes"] for e in entries),
            "int8": any("int8" in e["wire"] for e in entries)}


def _local_backward(fact, A):
    """(||(QR - A)[:, mine]||^2, ||A[:, mine]||^2), in double, over this
    rank's columns of a mesh factorization (summed over the ranks by the
    caller)."""
    from dhqr_tpu_torch.ops import blocked
    from dhqr_tpu_torch.parallel import sharded_qr

    m, n = A.shape
    mesh, nb = fact.mesh, fact.block_size
    gidx = torch.as_tensor(sharded_qr._local_gidx(
        mesh.rank, n, n // mesh.size, nb, fact.layout), device=A.device)
    Hn = fact.natural_H()
    Rp = torch.where(torch.arange(n, device=A.device)[:, None] < gidx,
                     Hn[:n].index_select(1, gidx), 0)
    Rp[gidx, torch.arange(gidx.numel(), device=A.device)] = fact.alpha[gidx]
    QRp = blocked._apply_q_impl(Hn, torch.cat([Rp, Rp.new_zeros(
        (m - n, Rp.shape[1]))]), nb, fact.precision)
    Ap = A.index_select(1, gidx)
    wide = torch.complex128 if A.is_complex() else torch.float64
    return (float(torch.linalg.vector_norm((QRp - Ap).to(wide)) ** 2),
            float(torch.linalg.vector_norm(Ap.to(wide)) ** 2))


def _wire_problem(m, n, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype.is_complex:
        def draw(shape):
            return torch.complex(
                torch.rand(shape, generator=g, device=device),
                torch.rand(shape, generator=g, device=device))
    else:
        def draw(shape):
            return torch.rand(shape, generator=g, device=device, dtype=dtype)
    return draw((m, n)), draw((m,))


def _wire_qr_case(ctx, m, n, dtype, seed, runs, pulse_run=None):
    """``qr`` + ``solve`` per run (label, mesh, knobs): seconds, launches,
    this rank's share of the backward error, the solve's normal-equations
    residual, and the census of both calls. ``pulse_run`` repeats one run
    with pulse armed and returns its reports (the dispatches run twice
    there: warm, then profiled)."""
    dt, hp, wire, pulse = ctx["dt"], ctx["hp"], ctx["wire"], ctx["pulse"]
    device, dtype = ctx["device"], getattr(torch, dtype)
    A, b = _wire_problem(m, n, dtype, seed, device)
    wide = torch.complex128 if dtype.is_complex else torch.float64
    A64, b64 = A.to(wide), b.to(wide)
    # one untimed factorization first: the process's first call holds
    # cuBLAS's and the communicator's set-up
    dt.qr(A, mesh=ctx["mesh"](runs[0][1])).solve(b)
    rows = []
    for label, spec, kw in runs:
        mesh, kw = ctx["mesh"](spec), dict(kw)
        if kw.pop("flat", False):
            kw["mesh_axis"] = dataclasses.replace(
                ctx["tier"](spec), hierarchical=False)
        l0 = dict(hp.LAUNCHES)
        with wire.census() as cen_qr:
            fact, t = _timed(lambda: dt.qr(A, mesh=mesh, **kw), device)
        with wire.census() as cen_solve:
            x, t_solve = _timed(lambda: fact.solve(b), device)
        launches = {k: hp.LAUNCHES[k] - l0[k] for k in l0}
        census = _census_summary(cen_qr.entries + cen_solve.entries)
        factor = _census_summary(cen_qr.entries)
        census["factor_compressed"] = factor["compressed"]
        census["factor_int8"] = factor["int8"]
        bsq, asq = _local_backward(fact, A)
        rows.append({
            "run": label, "mesh": spec, "s": t, "solve_s": t_solve,
            "launches": launches, "backward_sq": bsq, "a_sq": asq,
            "residual": float(torch.linalg.vector_norm(
                A64.mH @ (A64 @ x.to(wide) - b64))),
            "finite": bool(torch.isfinite(torch.view_as_real(x)).all()
                           if x.is_complex() else torch.isfinite(x).all()),
            "census": census})
        del fact, x
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    if pulse_run is not None:
        label, spec, kw = pulse_run
        mesh = ctx["mesh"](spec)
        with pulse.pulsed() as store:
            fact = dt.qr(A, mesh=mesh, **kw)
            fact.solve(b)
        rows.append({"run": label, "mesh": spec, "pulse": [
            r.to_json() for r in store.reports()]})
    return rows


def _wire_lstsq_case(ctx, m, n, seed, runs):
    """``lstsq(mesh=)`` of the reference's problem (numpy, from the seed)
    per (mesh, comms, refine): ``refine`` 0 leaves the model tier's floor
    of corrected semi-normal sweeps, more adds the caller's; x comes back
    for the parent's LAPACK oracle."""
    dt, hp, wire = ctx["dt"], ctx["hp"], ctx["wire"]
    A, b = random_problem(m, n, np.float32, seed)
    rows = []
    for spec, comms, refine in runs:
        mesh = ctx["mesh"](spec)
        l0 = dict(hp.LAUNCHES)
        with wire.census() as cen:
            x, t = _timed(lambda: dt.lstsq(A, b, mesh=mesh, comms=comms,
                                           refine=refine), ctx["device"])
        rows.append({"mesh": spec, "comms": comms, "refine": refine, "s": t,
                     "x": x.cpu().numpy(),
                     "launches": {k: hp.LAUNCHES[k] - l0[k] for k in l0},
                     "census": _census_summary(cen.entries)})
    return rows


def _wire_rows_case(ctx, m, n, seed, runs):
    """``lstsq(engine=..., comms=...)`` on the row mesh, of a problem made
    with numpy from the seed; x comes back for the parent's LAPACK oracle,
    and rank 0's ``torch.linalg.lstsq`` x beside it (a yardstick)."""
    dt, hp, wire, device = ctx["dt"], ctx["hp"], ctx["wire"], ctx["device"]
    A, b = (torch.from_numpy(a).to(device)
            for a in random_problem(m, n, np.float32, seed))
    mesh = ctx["mesh"]("rows")
    rows = []
    for engine, comms in runs:
        l0 = dict(hp.LAUNCHES)
        with wire.census() as cen:
            x, t = _timed(lambda: dt.lstsq(A, b, mesh=mesh, engine=engine,
                                           comms=comms), device)
        rows.append({"engine": engine, "comms": comms, "s": t,
                     "x": x.cpu().numpy(),
                     "launches": {k: hp.LAUNCHES[k] - l0[k] for k in l0},
                     "census": _census_summary(cen.entries)})
    if mesh.rank == 0:
        x_ref = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
        rows[0]["torch_lstsq_x"] = x_ref.cpu().numpy()
    return rows


def _wire_complex_case(ctx, m, n, seed):
    """c64 ``qr`` + ``solve`` at None and at bf16: complex payloads pass
    uncompressed, so the two runs agree bit for bit (H, alpha, x)."""
    dt, hp, wire, device = ctx["dt"], ctx["hp"], ctx["wire"], ctx["device"]
    A, b = _wire_problem(m, n, torch.complex64, seed, device)
    mesh = ctx["mesh"]("cols")
    out = {}
    for comms in (None, "bf16"):
        l0 = dict(hp.LAUNCHES)
        with wire.census() as cen:
            fact, t = _timed(lambda: dt.qr(A, mesh=mesh, comms=comms),
                             device)
            x = fact.solve(b)
        out[comms] = (fact.H, fact.alpha, x, t,
                      {k: hp.LAUNCHES[k] - l0[k] for k in l0},
                      _census_summary(cen.entries))
    (H0, a0, x0, _, _, _), (H1, a1, x1, t, launches, cen) = \
        out[None], out["bf16"]
    return [{"s": t, "launches": launches, "census": cen,
             "none_launches": out[None][4],
             "bit_identical": bool(torch.equal(H0, H1) and torch.equal(a0, a1)
                                   and torch.equal(x0, x1))}]


_WIRE_CASES = {"qr": _wire_qr_case, "lstsq": _wire_lstsq_case,
               "rows": _wire_rows_case, "complex": _wire_complex_case}


def wire_worker(device, cases):
    """One rank of phase 16 (run by ``run_ranks``): each case on this
    rank's meshes; returns {"cases": per-case rows, "launches": this
    rank's kernel launches in the cases}."""
    import dhqr_tpu_torch as dt
    from dhqr_tpu_torch import parallel
    from dhqr_tpu_torch.obs import pulse
    from dhqr_tpu_torch.ops import hopper_panel as hp
    from dhqr_tpu_torch.parallel import wire

    meshes, tiers = {}, {}

    def mesh_of(spec):
        if spec not in meshes:
            if spec.startswith("pod:"):
                meshes[spec], tiers[spec] = parallel.pod_mesh(
                    topo=spec[4:], device=device)
            elif spec == "rows":
                meshes[spec] = parallel.row_mesh(device=device)
            else:
                meshes[spec] = parallel.column_mesh(device=device)
        return meshes[spec]

    def tier_of(spec):
        mesh_of(spec)
        return tiers[spec]

    ctx = {"dt": dt, "hp": hp, "wire": wire, "pulse": pulse,
           "device": device, "mesh": mesh_of, "tier": tier_of}
    out = []
    launches = dict.fromkeys(hp.KERNELS.values(), 0)
    for case in cases:
        case = dict(case)
        hp.reset_launches()
        out.append(_WIRE_CASES[case.pop("kind")](ctx, **case))
        for name, count in hp.LAUNCHES.items():
            launches[name] += count
    return {"cases": out, "launches": launches}


def _wire_census_row(cen) -> dict:
    return {"census_bytes_by_family": {
                f: r["bytes"] for f, r in cen["families"].items()},
            "census_launches_by_family": {
                f: r["launches"] for f, r in cen["families"].items()},
            "census_bytes_by_leg": cen["legs"],
            "census_ratio": cen["ratio"], "census_bytes": cen["bytes"],
            "formula_bytes": cen["formula_bytes"],
            "formula_ok": cen["formula_ok"]}


def _check_wire_qr(case, per_rank, P, where):
    """Each run of a ``qr`` case: the launches summed over the ranks are
    the plan's, the census carried what the formula says, the backward
    error stays in its bound (a run whose factorization compressed a
    payload: below ``WIRE_BACKWARD`` and above the uncompressed run's; the
    flat pod schedule has no cross-host leg to compress, though its solve,
    on the default hierarchical axis, has); pulse rows
    print their reports, whose DHQR306 must read skip with the reason (no
    collective of one card crosses a link with a known bandwidth)."""
    from dhqr_tpu_torch.ops import hopper_panel as hp_

    m, n = case["m"], case["n"]
    dtype = getattr(torch, case["dtype"])
    plan = sharded_plan(m, n, dtype, P)
    base = None
    for j in range(len(per_rank[0])):
        rows = [r[j] for r in per_rank]
        if "pulse" in rows[0]:
            for rank, r in enumerate(rows):
                if len(r["pulse"]) != 2:  # the qr and the solve dispatch
                    raise AssertionError(f"pulse captured {r['pulse']}")
                for rep in r["pulse"]:
                    emit({"phase": 16, "name": "wire_pulse", **where,
                          "rank": rank, "run": r["run"],
                          "label": rep["label"],
                          "measured": rep["measured"],
                          "measured_unavailable": rep.get(
                              "measured_unavailable"),
                          "census": rep["analytic"],
                          "dhqr306": rep["dhqr306"]["status"],
                          "dhqr306_reason": rep["dhqr306"].get("reason"),
                          "comms": rep.get("comms")})
                    if rep["dhqr306"]["status"] != "skip" \
                            or not rep["dhqr306"].get("reason") \
                            or not rep["analytic"]:
                        raise AssertionError(f"pulse failed: {rep}")
            continue
        backward = (sum(r["backward_sq"] for r in rows)
                    / sum(r["a_sq"] for r in rows)) ** 0.5
        launches = sum(r["launches"][hp_.KERNELS[dtype]] for r in rows)
        cen = rows[0]["census"]
        comms = any(r["census"]["factor_compressed"] for r in rows)
        int8 = any(r["census"]["factor_int8"] for r in rows)
        if rows[0]["run"] == "none":
            base = backward
        row = {"phase": 16, "name": "wire_qr", **where, "run": rows[0]["run"],
               "mesh": rows[0]["mesh"], "dtype": case["dtype"],
               "shape": [m, n], "s": max(r["s"] for r in rows),
               "solve_s": max(r["solve_s"] for r in rows),
               "backward_error": backward,
               "solve_normal_eq_residual": rows[0]["residual"],
               "launches": launches, "expected": plan,
               "compressed": comms, "int8": int8,
               "uncompressed_backward_error": base,
               **_wire_census_row(cen),
               "formula_ok_all_ranks": all(r["census"]["formula_ok"]
                                           for r in rows)}
        bound = np.inf if int8 else WIRE_BACKWARD if comms \
            else TOL_BACKWARD_F32
        row["ok"] = (all(r["finite"] for r in rows) and launches == plan
                     and row["formula_ok_all_ranks"] and backward < bound
                     and (not comms or base is None or backward > base))
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"wire qr failed: {row}")


def phase_wire(hp, seed):
    """The wire on one card: (a) one NCCL rank, ``qr`` + ``solve`` at
    16384^2 f32 per wire format, then one run with pulse armed; (b) 4 gloo
    ranks at 16384^2 f32: flat bf16 and int8, a 2x2 pod mesh hierarchical
    and flat at None and dcn:bf16, the depth-2 and depth-3 pipeline at None
    and bf16, then one run with pulse armed; (c) ``lstsq`` 4400 x 4000 f32
    per wire format at the model tier's floor of sweeps (printed), and the
    bf16 formats with ``WIRE_SWEEPS`` under 8x; (d) 65536 x 256 f32 TSQR
    and CholeskyQR2 on the row mesh, uncompressed and at bf16 and int8,
    under 8x of numpy's LAPACK QR; (e) 2 gloo ranks, 8192 x 4096
    c64 at bf16: no complex payload compressed, every result bit-identical
    to None's. Launches of every rank are added into the parent's."""
    from dhqr_tpu_torch.parallel._ranks import run_ranks
    from dhqr_tpu_torch.utils.testing import normal_equations_residual

    torch.cuda.empty_cache()
    device = "cuda:0"
    square = {"kind": "qr", "m": 16384, "n": 16384, "dtype": "float32",
              "seed": seed + 16}
    runs = [
        ("a", "nccl", 1, [dict(
            square, runs=[("none", "cols", {}),
                          ("bf16", "cols", {"comms": "bf16"}),
                          ("int8", "cols", {"comms": "int8"})],
            pulse_run=("pulse_bf16", "cols", {"comms": "bf16"}))]),
        ("bcd", "gloo", 4, [
            dict(square, runs=list(WIRE_RUNS_4),
                 pulse_run=("pulse_bf16", "cols", {"comms": "bf16"})),
            {"kind": "lstsq", "m": 4400, "n": 4000, "seed": seed + 3,
             "runs": [("cols", "bf16", 0), ("cols", "int8", 0),
                      ("pod:2x2", "dcn:bf16", 0), ("pod:2x2", "dcn:int8", 0),
                      ("cols", "bf16", WIRE_SWEEPS),
                      ("pod:2x2", "dcn:bf16", WIRE_SWEEPS)]},
            {"kind": "rows", "m": 65536, "n": 256, "seed": seed + 17,
             "runs": [("tsqr", None), ("tsqr", "bf16"), ("tsqr", "int8"),
                      ("cholqr2", None), ("cholqr2", "bf16"),
                      ("cholqr2", "int8")]}]),
        ("e", "gloo", 2, [{"kind": "complex", "m": 8192, "n": 4096,
                           "seed": seed + 18}]),
    ]
    for label, backend, P, cases in runs:
        t0 = time.perf_counter()
        ranks = run_ranks(wire_worker, P, backend=backend, device=device,
                          timeout_s=420, cases=cases)
        wall_s = time.perf_counter() - t0
        for r in ranks:
            for name, count in r["launches"].items():
                hp.LAUNCHES[name] += count
        where = {"backend": backend, "ranks": P, "ranks_per_card": P}
        for i, case in enumerate(cases):
            per_rank = [r["cases"][i] for r in ranks]
            kind = case["kind"]
            if kind == "qr":
                _check_wire_qr(case, per_rank, P, where)
            elif kind == "lstsq":
                A, b, oracle = oracle_of(case["m"], case["n"], np.float32,
                                         case["seed"])
                expect = sharded_plan(case["m"], case["n"], torch.float32, P)
                for j, r0 in enumerate(per_rank[0]):
                    res = normal_equations_residual(A, r0["x"], b)
                    launches = sum(r[j]["launches"]["panel_qr_f32"]
                                   for r in per_rank)
                    row = {"phase": 16, "name": "wire_lstsq", **where,
                           "mesh": r0["mesh"], "comms": r0["comms"],
                           "refine": r0["refine"],
                           "shape": [case["m"], case["n"]],
                           "s": max(r[j]["s"] for r in per_rank),
                           "normal_eq_residual": res,
                           "lapack_residual": oracle,
                           "ratio": res / oracle, "criterion": CRITERION,
                           "launches": launches, "expected": expect,
                           **_wire_census_row(r0["census"])}
                    row["meets_criterion"] = bool(res < CRITERION * oracle)
                    row["ok"] = (bool(np.isfinite(res))
                                 and (row["meets_criterion"]
                                      or not r0["refine"])
                                 and launches == expect
                                 and all(r[j]["census"]["formula_ok"]
                                         for r in per_rank))
                    emit(row)
                    if not row["ok"]:
                        raise AssertionError(f"wire lstsq failed: {row}")
            elif kind == "rows":
                _check_wire_rows(case, per_rank, P, where,
                                 normal_equations_residual)
            else:
                r0 = per_rank[0][0]
                launches = sum(r[0]["launches"]["panel_qr_c64"]
                               for r in per_rank)
                expect = sharded_plan(case["m"], case["n"],
                                      torch.complex64, P)
                row = {"phase": 16, "name": "wire_complex", **where,
                       "comms": "bf16", "shape": [case["m"], case["n"]],
                       "s": max(r[0]["s"] for r in per_rank),
                       "launches": launches, "expected": expect,
                       "complex_compressed": any(
                           r[0]["census"]["complex_compressed"]
                           for r in per_rank),
                       "any_compressed": any(r[0]["census"]["compressed"]
                                             for r in per_rank),
                       "bit_identical_to_none": all(r[0]["bit_identical"]
                                                    for r in per_rank),
                       **_wire_census_row(r0["census"])}
                row["ok"] = (not row["complex_compressed"]
                             and not row["any_compressed"]
                             and row["bit_identical_to_none"]
                             and launches == expect
                             and sum(r[0]["none_launches"]["panel_qr_c64"]
                                     for r in per_rank) == expect)
                emit(row)
                if not row["ok"]:
                    raise AssertionError(f"wire complex failed: {row}")
        emit({"phase": 16, "name": "wire_run", "case": label, **where,
              "wall_s": wall_s})


def _check_wire_rows(case, per_rank, P, where, ne):
    """Each row-engine run against numpy's LAPACK QR (the reference's
    criterion), ``torch.linalg.lstsq``'s ratio printed beside it; the
    launches summed over the ranks are TSQR's plan (none for CholeskyQR)."""
    from dhqr_tpu_torch.ops import blocked

    m, n = case["m"], case["n"]
    A, b, oracle = oracle_of(m, n, np.float32, case["seed"])
    cuda = torch.device("cuda")
    nb = min(blocked.DEFAULT_BLOCK_SIZE, n)
    leaf = blocked.panel_plan(m // P, n, nb, True, torch.float32, cuda)
    combine = blocked.panel_plan(P * n, n, nb, True, torch.float32, cuda)
    per_rank_plan = sum(blocked.kernel_leaves(w, lw)
                        for _, w, lw in leaf + combine if lw)
    torch_ratio = ne(A, per_rank[0][0]["torch_lstsq_x"], b) / oracle
    for j, r0 in enumerate(per_rank[0]):
        rows = [r[j] for r in per_rank]
        launches = sum(r["launches"]["panel_qr_f32"] for r in rows)
        expect = P * per_rank_plan if r0["engine"] == "tsqr" else 0
        res = ne(A, r0["x"], b)
        row = {"phase": 16, "name": "wire_rows", **where,
               "engine": r0["engine"], "comms": r0["comms"],
               "shape": [m, n], "s": max(r["s"] for r in rows),
               "normal_eq_residual": res, "lapack_residual": oracle,
               "ratio": res / oracle, "torch_lstsq_ratio": torch_ratio,
               "criterion": CRITERION, "launches": launches,
               "expected": expect, **_wire_census_row(r0["census"])}
        row["ok"] = (bool(np.isfinite(res)) and res < CRITERION * oracle
                     and launches == expect
                     and all(r["census"]["formula_ok"] for r in rows))
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"wire row engine failed: {row}")


# -- phase 17: the serving tier ----------------------------------------------
#
# The JAX package's serving workload (benchmarks/serving_throughput.py:
# SHAPE_LADDER at :43, MICRO_BATCH at :47): a Zipf-weighted stream of small
# least-squares requests, served in micro-batches through the batched entry
# points, each bucket a CUDA graph captured once per cache key.

SERVE_LADDER = [(64, 16), (100, 36), (128, 48), (192, 64),
                (250, 100), (384, 128), (500, 180), (640, 256)]
SERVE_MICRO_BATCH = 32
SERVE_REQUESTS = 256
SERVE_WARM_PASSES = 5
SERVE_SKETCH_SHAPES = ((16500, 64), (16500, 256))  # sketched_lstsq.py:56-63
TOL_SERVE_SOLVE = 1e-5    # ||fact.solve(b) - x|| / ||x||, (b) against (a)


def _serve_stream(rng, n_requests, dtype):
    """The benchmark's stream: shapes drawn with weights 1/(rank+1)^1.1,
    entries uniform in [0, 1) (real and imaginary parts for complex)."""
    w = 1.0 / (np.arange(len(SERVE_LADDER)) + 1.0) ** 1.1
    picks = rng.choice(len(SERVE_LADDER), size=n_requests, p=w / w.sum())
    As, bs = [], []
    for i in picks:
        m, n = SERVE_LADDER[i]
        A, b = rng.random((m, n)), rng.random(m)
        if np.issubdtype(np.dtype(dtype), np.complexfloating):
            A, b = A + 1j * rng.random((m, n)), b + 1j * rng.random(m)
        As.append(A.astype(dtype))
        bs.append(b.astype(dtype))
    return As, bs


def _micro(n):
    return [list(range(lo, min(lo + SERVE_MICRO_BATCH, n)))
            for lo in range(0, n, SERVE_MICRO_BATCH)]


def _serve_pass(fn, As, bs, lat=None):
    """One pass of the stream in micro-batches: (results in input order,
    seconds); per-micro-batch latencies go to ``lat``."""
    out = [None] * len(As)
    t0 = time.perf_counter()
    for mb in _micro(len(As)):
        _, t = wall(lambda: [out.__setitem__(i, x) for i, x in zip(
            mb, fn([As[i] for i in mb], [bs[i] for i in mb]))])
        if lat is not None:
            lat.append(t)
    return out, time.perf_counter() - t0


def _ratios(As, bs, xs):
    """Each request's normal-equations residual over numpy LAPACK's."""
    from dhqr_tpu_torch.utils.testing import (normal_equations_residual,
                                              oracle_residual)

    return [normal_equations_residual(A, x.cpu().numpy(), b)
            / oracle_residual(A, b) for A, b, x in zip(As, bs, xs)]


def _kernel_count(fn, device):
    """(kernels, device busy seconds, wall seconds) of ``fn()`` under
    ``torch.profiler``, tracing the card only and reading the raw events
    (a dispatch launches tens of thousands of kernels: building the
    profiler's event tree for them would cost more than the dispatch)."""
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    card = torch.device(device).type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if card
                             else ProfilerActivity.CPU]) as prof:
        _, t = _timed(fn, device)
    want = torch.autograd.DeviceType.CUDA if card \
        else torch.autograd.DeviceType.CPU
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == want]
    busy = sum(e.duration_ns() for e in events) / 1e9
    return len(events), busy or None, t


def phase_serve(dt, hp, seed, card, device="cuda"):
    """(a) the serving mix through ``batched_lstsq``: a cold pass (the
    captures) and warm passes (zero misses; requests/s, p50/p99 per
    micro-batch), every residual under 8x numpy LAPACK's, beside the same
    passes with every key's program run eager and a loop of single
    ``lstsq`` calls; kernels per dispatch replayed and eager at the
    smallest and the middle key (``torch.profiler``); (b) ``batched_qr`` on the mix: backward errors,
    solves against (a), the stack factored in place, results unchanged by
    a later replay of the same keys; (c) complex64; (d)
    ``batched_sketched_lstsq`` at the sketch benchmark's 16500 x 64 and
    16500 x 256; (e) replay bit-identical to eager, ``guards=`` on a NaN
    request, the ``serve.dispatch`` and ``serve.compile`` fault sites;
    (f) xray armed: one report per captured key of the two smallest
    shapes, with the profiled capture's device seconds, and the
    registry's ``serve.cache.*`` names."""
    from dhqr_tpu_torch import faults, obs
    from dhqr_tpu_torch.serve import cache as scache
    from dhqr_tpu_torch.serve import engine as seng
    from dhqr_tpu_torch.utils.config import FaultConfig, ObsConfig
    from dhqr_tpu_torch.utils.profiling import LatencyHistogram

    t_phase = time.perf_counter()
    sections = {}

    def section(name):
        sections[name] = round(time.perf_counter() - t_phase
                               - sum(sections.values()), 3)

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(seed + 17)
    As, bs = _serve_stream(rng, SERVE_REQUESTS, np.float32)
    # room for phase 18's prewarm of every power-of-two batch per bucket
    cache = scache.ExecutableCache(max_size=128)
    _SHARED["serve_cache"] = cache

    def serve(A_mb, b_mb, cache=cache):
        return dt.batched_lstsq(A_mb, b_mb, cache=cache, device=dev)

    # (a) cold pass: every key is captured once
    xs, t_cold = _serve_pass(serve, As, bs)
    section("setup+cold")
    cold = cache.stats()
    keys = list(cache._entries)
    modes = {v["program"] for v in cache.program_stats().values()}
    ratios = _ratios(As, bs, xs)
    hist, lat, rates = LatencyHistogram(), [], []
    for _ in range(SERVE_WARM_PASSES):
        xs_w, t = _serve_pass(serve, As, bs, lat)
        rates.append(SERVE_REQUESTS / t)
    for t in lat:
        hist.record(t)
    warm = cache.stats()
    section("warm")
    eager_cache = scache.ExecutableCache(max_size=64)
    for key in keys:
        eager_cache.get_or_compile(key, lambda key=key: scache.LoweredProgram(
            seng._key_program(key, dev), None, dev,
            eager_reason="the capture's yardstick: the same program eager"))
    half = SERVE_REQUESTS // 2       # the eager yardstick on half the mix
    xs_e, t = _serve_pass(lambda a, b: serve(a, b, eager_cache), As[:half],
                          bs[:half])
    eager_rates = [half / t]
    section("eager")

    def singles():
        return [dt.lstsq(A, b, device=dev) for A, b in zip(As, bs)]

    # the single-request path is a yardstick: its panel kernel launches
    # are taken back out of the serve path's count
    _uncounted(hp, singles)          # warm
    single_rates = [SERVE_REQUESTS / _uncounted(hp, singles)[2]
                    for _ in range(2)]
    section("singles")
    per_key = []
    by_size = sorted(keys, key=lambda k: (k.m * k.n * k.n * k.batch))
    # the smallest key, and the middle one (the largest's 32k-kernel eager
    # trace alone costs ~10 s of profiler time)
    for key in (by_size[0], by_size[len(by_size) // 2]):
        prog = cache._entries[key]
        ins = tuple(s.clone() for s in prog.static_inputs)
        k_graph, busy_graph, t_graph = _kernel_count(lambda: prog(*ins), dev)
        k_eager, busy_eager, t_eager = _kernel_count(
            lambda: prog.fn(*(s.clone() for s in ins)), dev)
        per_key.append({"key": list(key)[:6], "graph_kernels": k_graph,
                        "eager_kernels": k_eager, "graph_wall_s": t_graph,
                        "eager_wall_s": t_eager,
                        "graph_device_busy_s": busy_graph,
                        "eager_device_busy_s": busy_eager})
    row = {"phase": 17, "name": "serve_lstsq", "card": card,
           "requests": SERVE_REQUESTS, "micro_batch": SERVE_MICRO_BATCH,
           "keys": len(keys), "programs": sorted(modes),
           "cold_s": t_cold, "captures": cold["misses"],
           "capture_s": cold["compile_seconds"],
           "warm_misses": warm["misses"] - cold["misses"],
           "warm_hits": warm["hits"] - cold["hits"],
           "requests_per_s_captured": rates,
           "requests_per_s_eager": eager_rates,
           "requests_per_s_single_lstsq": single_rates,
           "micro_batch_ms": hist.snapshot(),
           "max_ratio": max(ratios), "criterion": CRITERION,
           "per_key": per_key}
    section("kernel_counts")
    row["section_s"] = dict(sections)
    row["ok"] = (row["warm_misses"] == 0 and modes == {"cuda_graph"}
                 and all(np.isfinite(r) and r <= CRITERION for r in ratios)
                 and all(torch.equal(a, b) for a, b in zip(xs, xs_w)))
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve lstsq check failed: {row}")

    # (b) batched_qr on the same mix
    qcache = scache.ExecutableCache(max_size=64)
    facts, t_qr_cold = wall(lambda: [f for mb in _micro(len(As)) for f in
                                     dt.batched_qr([As[i] for i in mb],
                                                   cache=qcache,
                                                   device=dev)])
    saved = [(f.H.clone(), f.alpha.clone()) for f in facts]
    _, t_qr = wall(lambda: [dt.batched_qr([As[i] for i in mb], cache=qcache,
                                          device=dev)
                            for mb in _micro(len(As))])
    unchanged = all(torch.equal(f.H, h) and torch.equal(f.alpha, a)
                    for f, (h, a) in zip(facts, saved))
    back, agree = [], []
    for A, b, f, x in zip(As, bs, facts, xs):
        At = torch.from_numpy(A).to(dev)
        back.append(float(torch.linalg.norm(f.q_columns() @ f.r_matrix()
                                            - At) / torch.linalg.norm(At)))
        agree.append(rel_err(f.solve(b), x))
    qkey = next(iter(qcache._entries))
    qprog = qcache._entries[qkey]
    in_place = (qprog.static_outputs[0].data_ptr()
                == qprog.static_inputs[0].data_ptr())
    row = {"phase": 17, "name": "serve_qr", "keys": len(qcache),
           "captures": qcache.stats()["misses"],
           "capture_s": qcache.stats()["compile_seconds"],
           "cold_s": t_qr_cold, "warm_s": t_qr,
           "requests_per_s": SERVE_REQUESTS / t_qr,
           "max_backward_error": max(back), "max_solve_vs_lstsq": max(agree),
           "stack_in_place": in_place, "unchanged_after_replay": unchanged}
    section("qr")
    row["ok"] = (max(back) < TOL_BACKWARD_F32 and max(agree) < TOL_SERVE_SOLVE
                 and in_place and unchanged)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve qr check failed: {row}")

    # (c) complex64: 64 requests from the ladder
    Ac, bc = _serve_stream(rng, 64, np.complex64)
    ccache = scache.ExecutableCache(max_size=64)
    xc, t_c = wall(lambda: [x for mb in _micro(len(Ac)) for x in
                            dt.batched_lstsq([Ac[i] for i in mb],
                                             [bc[i] for i in mb],
                                             cache=ccache, device=dev)])
    rc = _ratios(Ac, bc, xc)
    section("c64")
    row = {"phase": 17, "name": "serve_c64", "requests": len(Ac),
           "keys": len(ccache), "cold_s": t_c, "max_ratio": max(rc),
           "criterion": CRITERION}
    row["ok"] = all(np.isfinite(r) and r <= CRITERION for r in rc)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve c64 check failed: {row}")

    # (d) the sketched kind at the sketch benchmark's shapes, held to the
    # card's torch.linalg.lstsq as phase 13 is
    for m, n in SERVE_SKETCH_SHAPES:
        Ak = [rng.random((m, n)).astype(np.float32) for _ in range(8)]
        bk = [rng.random(m).astype(np.float32) for _ in range(8)]
        kcache = scache.ExecutableCache(max_size=4)
        xk, t_first = wall(lambda: dt.batched_sketched_lstsq(
            Ak, bk, cache=kcache, device=dev))
        xk, t_k = wall(lambda: dt.batched_sketched_lstsq(
            Ak, bk, cache=kcache, device=dev))
        rk = []
        for A, b, x in zip(Ak, bk, xk):     # the card's QR solve: yardstick
            At, bt = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)
            rk.append(_ne_in(At, x, bt) / _ne_in(At, _torch_lstsq(At, bt),
                                                 bt))
        key = next(iter(kcache._entries))
        row = {"phase": 17, "name": "serve_sketch", "shape": [m, n],
               "key": list(key), "program": kcache._entries[key].mode,
               "first_s": t_first, "s": t_k, "max_ratio": max(rk),
               "criterion": CRITERION}
        row["ok"] = all(np.isfinite(r) and r <= CRITERION for r in rk)
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"serve sketch check failed: {row}")
        del Ak, bk, xk, kcache
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    section("sketch")

    # (e) behaviour: replay against eager, guards, the fault sites
    key = by_size[-1]
    prog = cache._entries[key]
    group = [i for i, A in enumerate(As)
             if seng.plan_bucket(*A.shape, A.dtype) == seng.Bucket(
                 key.m, key.n, key.dtype)][:key.batch]
    A_buf, b_buf = seng.pad_group([(As[i], bs[i]) for i in group],
                                  seng.Bucket(key.m, key.n, key.dtype),
                                  key.batch, dev)
    replay = prog(A_buf, b_buf)
    eager = prog.fn(A_buf.clone(), b_buf.clone())
    bit_identical = torch.equal(replay, eager)
    A8 = [a.copy() for a in As[:8]]
    A8[3][1, 1] = np.nan
    try:
        dt.batched_lstsq(A8, bs[:8], guards="fallback", cache=cache,
                         device=dev)
        breakdown = False
    except dt.Breakdown:
        breakdown = True
    try:
        with faults.injected(FaultConfig(sites=(("serve.dispatch", 1.0, 1),))):
            dt.batched_lstsq(As[:4], bs[:4], cache=cache, device=dev)
        dispatch = None
    except dt.DispatchFailed as e:
        dispatch = type(e).__name__
    fcache = scache.ExecutableCache(max_size=4, quarantine_s=60)
    outcomes = []
    with faults.injected(FaultConfig(sites=(("serve.compile", 1.0, 1),))):
        for _ in range(2):
            try:
                dt.batched_lstsq(As[:2], bs[:2], cache=fcache, device=dev)
                outcomes.append("ok")
            except (dt.CompileFailed, dt.Quarantined) as e:
                outcomes.append([type(e).__name__,
                                 getattr(e, "retry_after", None)])
    section("behaviour")
    row = {"phase": 17, "name": "serve_behaviour", "key": list(key)[:6],
           "replay_bit_identical": bit_identical,
           "nan_request_breakdown": breakdown, "dispatch_fault": dispatch,
           "compile_fault": outcomes}
    row["ok"] = (bit_identical and breakdown and dispatch == "DispatchFailed"
                 and outcomes[0][0] == "CompileFailed"
                 and outcomes[1][0] == "Quarantined" and outcomes[1][1] > 0)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve behaviour check failed: {row}")

    # (f) xray armed on a fresh cache, over the requests of the stream's
    # two smallest shapes (each capture is profiled once)
    xcache = scache.ExecutableCache(max_size=64)
    small = [i for i, A in enumerate(As)
             if A.shape in SERVE_LADDER[:2]][:SERVE_MICRO_BATCH]
    obs.arm(ObsConfig(xray=True))
    try:
        dt.batched_lstsq([As[i] for i in small], [bs[i] for i in small],
                         cache=xcache, device=dev)
        reports = obs.xray.active().reports()
        names = sorted(k for k in obs.registry().snapshot()
                       if k.startswith("serve.cache."))
    finally:
        obs.disarm()
    rows = []
    for rep in reports:
        meas = rep.measured or {}
        sec = meas.get("device_seconds")
        rows.append({"key": rep.key[:80], "analytic_flops": rep.analytic_flops,
                     "device_s": sec, "kernels": meas.get("kernels"),
                     "achieved_gflops": rep.achieved_gflops(sec) if sec
                     else None, "mfu": rep.mfu(sec) if sec else None,
                     "by_class": meas.get("by_class"),
                     "profiler_flops": meas.get("flops"),
                     "memory": rep.memory,
                     "roofline_reason": rep.roofline_reason})
    section("xray")
    row = {"phase": 17, "name": "serve_xray", "reports": rows,
           "captured_keys": len(xcache), "registry_names": names,
           "section_s": dict(sections),
           "phase_s": time.perf_counter() - t_phase}
    row["ok"] = (len(reports) == len(xcache) > 0
                 and all(r["device_s"] and r["analytic_flops"]
                         and r["achieved_gflops"] for r in rows)
                 and "serve.cache.hits" in names)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"serve xray check failed: {row}")
    del cache, eager_cache, qcache, ccache, xcache, fcache
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# -- phase 18: the async scheduler, the fleet router and the key store -------
#
# The JAX package's async and fleet serving workloads at full width:
# benchmarks/serving_async.py:59-76 (SHAPE_LADDER, Zipf 1/(rank+1)^1.1, 512
# f32 requests, max_batch 32, SLO 1000 ms, flush interval 300 ms, offered
# at 0.92 of the measured capacity) and benchmarks/serving_fleet.py:1-26
# (K = 3 replicas, the kill ladder), over phase 17's captured programs.

SERVE_ASYNC_REQUESTS = 512
SERVE_ASYNC_SLO_MS = 1000.0
SERVE_ASYNC_FLUSH_MS = 300.0
SERVE_ASYNC_RATE = 0.92
SERVE_ASYNC_ROUNDS = 3
SERVE_ROUTER_BURST = 256
SERVE_REPLAYS = 200       # per thread, step 0's concurrent-replay check
RESULT_S = 120.0          # every Future.result's timeout in phase 18

_STORE_CHILD = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from dhqr_tpu_torch.serve import cache as scache, engine as seng
from dhqr_tpu_torch.serve import store as sstore
from dhqr_tpu_torch.serve.router import Router
from dhqr_tpu_torch.utils.config import FleetConfig, ServeConfig

device, shapes = sys.argv[2], json.loads(sys.argv[3])
qkey = scache.CacheKey(*json.loads(sys.argv[4]))
t0 = time.perf_counter()
dev = torch.device(device)
if dev.type == "cuda":
    dev = torch.device("cuda", torch.cuda.current_device())
cache = scache.default_cache(dev)
store = sstore.default_store()
router = Router(replicas=1, fleet=FleetConfig.from_env(), workers=1,
                serve_config=ServeConfig(max_batch=32), cache=cache,
                device=dev)
recorded = store.cache_keys()
sstore.prewarm_keys(recorded, cache=cache, device=dev)
captured = cache.stats()
reason = store.last_reason
rng = np.random.default_rng(5)
futs = [router.submit("lstsq", rng.random((m, n)).astype(np.float32),
                      rng.random(m).astype(np.float32), deadline=60.0)
        for m, n in shapes for _ in range(5)]
ok = all(bool(torch.isfinite(f.result(timeout=120)).all()) for f in futs)
try:
    cache.get_or_compile(qkey, lambda: seng._lower_for_key(qkey, dev))
    adopted = None
except Exception as e:
    adopted = type(e).__name__
router.shutdown()
print(json.dumps({"recorded": len(recorded), "captures": captured["misses"],
                  "capture_s": captured["compile_seconds"],
                  "store": store.stats(), "reason": reason,
                  "warm_misses": cache.stats()["misses"] - captured["misses"],
                  "results_finite": ok, "adopted_quarantine": adopted,
                  "child_s": time.perf_counter() - t0}))
'''


def _update_stream(seed, m, n, steps, dev):
    """Phase 15 (f)'s stream, drawn again in its order: A, b and each
    step's (u, v) from the same generator."""
    g = torch.Generator(device=dev).manual_seed(seed + 18)
    A = torch.rand((m, n), generator=g, device=dev, dtype=torch.float32)
    b = torch.rand((m,), generator=g, device=dev, dtype=torch.float32)
    ops = []
    for step in range(steps):
        u = 0.01 * torch.randn((m,), generator=g, device=dev)
        v = torch.randn((n,), generator=g, device=dev)
        ops.append(("update" if step % 2 == 0 else "downdate", u, v))
    return A, b, ops


def _update_direct(dt, A, b, ops, dev):
    """The stream driven on the session directly (phase 15 (f)'s calls):
    the refactors by step, the solves every 8 steps, the final R."""
    from dhqr_tpu_torch import faults
    from dhqr_tpu_torch.utils.config import FaultConfig

    live = dt.UpdatableQR(A, device=dev)
    reasons, xs = [[-1, live.last_refactor["reason"]]], []
    for step, (op, u, v) in enumerate(ops):
        fn = live.update if op == "update" else live.downdate
        if step == 40:
            with faults.injected(FaultConfig(
                    sites=(("numeric.breakdown", 1.0, 1),))):
                info = fn(u, v)
        else:
            info = fn(u, v)
        if info["refactored"]:
            reasons.append([step, info["reason"]])
        if step % 8 == 7:
            xs.append(live.solve(b))
    return {"reasons": reasons, "xs": xs, "R": live.r_matrix().clone()}


def _replay_inputs(key, dev, seed, count=4):
    """``count`` distinct random input sets of a cache key's shapes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(count):
        A = torch.rand((key.batch, key.m, key.n), generator=g, device=dev)
        A += torch.eye(key.m, key.n, device=dev)
        if key.kind == "qr":
            out.append((A,))
        else:
            out.append((A, torch.rand((key.batch, key.m), generator=g,
                                      device=dev)))
    return out


def _concurrent_replays(calls, inputs, refs, capture):
    """Two threads replay two programs SERVE_REPLAYS times each while the
    calling thread runs ``capture`` (the thread whose cuBLAS handle
    captured the programs, when they were captured here); returns
    (mismatches against the serial references, outputs compared,
    seconds)."""
    import threading

    got = [[None] * SERVE_REPLAYS for _ in calls]
    errors = []

    def replay(k):
        try:
            for i in range(SERVE_REPLAYS):
                got[k][i] = calls[k](*inputs[k][i % len(inputs[k])])
        except BaseException as e:  # reported, fails the check
            errors.append(e)

    threads = [threading.Thread(target=replay, args=(k,)) for k in (0, 1)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    try:
        capture()
    except BaseException as e:
        errors.append(e)
    for t in threads:
        t.join(timeout=600)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent replays failed: {errors!r}")
    bad = 0
    for k in (0, 1):
        for i, out in enumerate(got[k]):
            ref = refs[k][i % len(refs[k])]
            outs = out if isinstance(out, tuple) else (out,)
            rs = ref if isinstance(ref, tuple) else (ref,)
            bad += sum(not torch.equal(o, r) for o, r in zip(outs, rs))
    return bad, 2 * SERVE_REPLAYS, seconds


def _per_program_lock_replays(cache, keys, cold_key, inputs, refs, dev):
    """The design without lanes, rebuilt outside the cache to settle
    whether it races: both keys captured by this thread on one pooled
    stream (so their cuBLAS workspace is one), each replayed under a lock
    of its own on its own thread's stream, while this thread warms up and
    captures a cold key on that stream (the same workspace again)."""
    import threading

    from dhqr_tpu_torch.serve import engine as seng

    stream = torch.cuda.Stream(device=dev)

    def capture(key):
        low = seng._lower_for_key(key, dev)
        static = tuple(low.make_inputs())
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream), torch.no_grad():
            low.fn(*(x.clone() for x in static))
            stream.synchronize()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = low.fn(*static)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        lock = threading.Lock()

        def call(*args):
            with lock:
                for s_, a in zip(static, args):
                    s_.copy_(a)
                graph.replay()
                res = tuple(o.clone() for o in outs)
            return res if len(res) > 1 else res[0]
        return call

    calls = [capture(k) for k in keys]

    def threaded(k):
        side = torch.cuda.Stream(device=dev)

        def call(*args):
            with torch.cuda.stream(side):
                side.wait_stream(torch.cuda.default_stream(dev))
                return calls[k](*args)
        return call

    torch.cuda.synchronize(dev)
    return _concurrent_replays([threaded(0), threaded(1)], inputs, refs,
                               lambda: capture(cold_key))


def phase_serve_async(dt, hp, seed, card, device="cuda",
                      requests=SERVE_ASYNC_REQUESTS, update_shape=None):
    """(a) capacity: the 512-request mix queued, then one timed ``drain()``
    of a manual-mode scheduler, interleaved with phase 17's synchronous
    ``batched_lstsq`` ceiling on the same list (zero misses after
    ``prewarm``, the drain's x bit-identical to the sync tier's, every
    residual under 8x numpy LAPACK's); (b) open loop: Poisson arrivals at
    0.92 x (a) through a scheduler with two workers, requests/s over the
    arrival window, p50 / p99 submit to done, zero admission rejects; (c)
    faults: ``serve.worker`` crashes respawned, a transient
    ``serve.dispatch`` retried, a NaN request under ``guards=`` isolated by
    bisection, ``BackpressureError`` past ``queue_depth``; (d) the
    ``"update"`` kind: phase 15 (f)'s 65536 x 256 f32 stream submitted
    through the scheduler, R and the solves bit-identical to the session
    driven directly, ``panel_qr_f32`` launches 4 x (1 + refactors); (e)
    step 0: two threads replay two keys of one lane 200 times each while a
    third captures a cold key, then two keys of two lanes (and those with
    no capture beside them, and from one thread, timed), every output
    bit-identical to the serial replays (and the same without lanes, a
    lock per program, rebuilt, on the first pair, printed); (f) the
    router:
    K = 3 replicas over the shared cache beside one scheduler on the same
    burst, the per-tenant spread, the kill ladder (every accepted future a
    result or a typed ``ServeError``), a sticky ``"update"`` session; (g)
    the store: a child interpreter on a store this process recorded
    recaptures the recorded keys (counted misses with the reason), serves
    with zero warm misses, and adopts a quarantine through
    ``FleetConfig.state_path``."""
    import os
    import tempfile
    import threading

    from dhqr_tpu_torch import faults
    from dhqr_tpu_torch.serve import AsyncScheduler, Router
    from dhqr_tpu_torch.serve import cache as scache
    from dhqr_tpu_torch.serve import engine as seng
    from dhqr_tpu_torch.serve import store as sstore
    from dhqr_tpu_torch.utils.config import (FaultConfig, FleetConfig,
                                             SchedulerConfig, ServeConfig)
    from dhqr_tpu_torch.utils.profiling import LatencyHistogram

    t_phase = time.perf_counter()
    sections = {}

    def section(name):
        sections[name] = round(time.perf_counter() - t_phase
                               - sum(sections.values()), 3)

    def check(row):
        row["card"] = card
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"serve_async {row['name']} failed: {row}")

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(seed + 18)
    n_req = requests
    As, bs = _serve_stream(rng, n_req, np.float32)
    tenants = [f"t{SERVE_LADDER.index(A.shape)}" for A in As]
    scfg = ServeConfig(max_batch=SERVE_MICRO_BATCH)
    cache = _SHARED.get("serve_cache") or scache.ExecutableCache(max_size=128)
    reused, before = len(cache), cache.stats()
    pow2 = [1 << i for i in range(SERVE_MICRO_BATCH.bit_length())]
    keys = seng.prewarm([(c, m, n) for m, n in SERVE_LADDER for c in pow2],
                        serve_config=scfg, cache=cache, device=dev)
    warm0 = cache.stats()
    section("prewarm")

    # (a) capacity against the sync ceiling, interleaved
    cap = AsyncScheduler(serve_config=scfg, cache=cache, start=False,
                         device=dev, sched_config=SchedulerConfig(
                             slo_ms=30e3, flush_interval_ms=SERVE_ASYNC_FLUSH_MS,
                             queue_depth=4 * n_req))
    sync_rates, cap_rates = [], []
    for _ in range(SERVE_ASYNC_ROUNDS):
        xs_sync, t = _timed(lambda: dt.batched_lstsq(
            As, bs, serve_config=scfg, cache=cache, device=dev), dev)
        sync_rates.append(n_req / t)
        futs = [cap.submit("lstsq", A, b, deadline=30.0)
                for A, b in zip(As, bs)]
        _, t = _timed(cap.drain, dev)
        cap_rates.append(n_req / t)
        xs_cap = [f.result(timeout=RESULT_S) for f in futs]
    cap_stats = cap.stats()
    cap.shutdown()
    misses_a = cache.stats()["misses"] - warm0["misses"]
    ratios = _ratios(As, bs, xs_cap)
    identical = all(torch.equal(a, b) for a, b in zip(xs_cap, xs_sync))
    section("capacity")
    capacity = float(np.median(cap_rates))
    check({"phase": 18, "name": "capacity", "requests": n_req,
           "keys_prewarmed": len(keys), "keys_from_phase_17": reused,
           "prewarm_captures": warm0["misses"] - before["misses"],
           "prewarm_capture_s": round(warm0["compile_seconds"]
                                      - before["compile_seconds"], 3),
           "requests_per_s_sync": sync_rates,
           "requests_per_s_async_drain": cap_rates,
           "drain_over_sync": [c / s for c, s in zip(cap_rates, sync_rates)],
           "flushes": cap_stats["flushes"],
           "dispatches": cap_stats["dispatches"],
           "misses_timed": misses_a, "max_ratio": max(ratios),
           "drain_bit_identical_to_sync": identical,
           "ok": (misses_a == 0 and identical
                  and all(np.isfinite(r) and r <= CRITERION
                          for r in ratios))})

    # (b) open loop: Poisson arrivals at 0.92 x the capacity
    offered = SERVE_ASYNC_RATE * capacity
    arrivals = np.cumsum(np.random.default_rng(seed + 1).exponential(
        1.0 / offered, size=n_req))
    lat = LatencyHistogram()
    done_at = [0.0] * n_req
    sched = AsyncScheduler(serve_config=scfg, cache=cache, device=dev,
                           sched_config=SchedulerConfig(
                               slo_ms=SERVE_ASYNC_SLO_MS,
                               flush_interval_ms=SERVE_ASYNC_FLUSH_MS,
                               queue_depth=4096))
    misses0 = cache.stats()["misses"]

    def on_done(i, t_submit):
        def cb(_):
            now = time.perf_counter()
            lat.record(now - t_submit)
            done_at[i] = now
        return cb

    rejected, futs = 0, [None] * n_req
    t_start = time.perf_counter()
    for i in range(n_req):
        delay = t_start + arrivals[i] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t_submit = time.perf_counter()
        try:
            fut = sched.submit("lstsq", As[i], bs[i],
                               deadline=SERVE_ASYNC_SLO_MS / 1e3,
                               tenant=tenants[i])
        except dt.BackpressureError:
            rejected += 1
            continue
        fut.add_done_callback(on_done(i, t_submit))
        futs[i] = fut
    xs_open = [f.result(timeout=RESULT_S) if f is not None else None
               for f in futs]
    sched_stats = sched.stats()
    sched.shutdown()
    t_arr = arrivals[-1]
    in_window = sum(1 for d in done_at if 0.0 < d <= t_start + t_arr)
    ok_open = [i for i, x in enumerate(xs_open) if x is not None]
    r_open = _ratios([As[i] for i in ok_open], [bs[i] for i in ok_open],
                     [xs_open[i] for i in ok_open])
    section("open_loop")
    check({"phase": 18, "name": "open_loop", "requests": n_req,
           "offered_rps": offered, "rate_frac_of_capacity": SERVE_ASYNC_RATE,
           "requests_per_s": in_window / t_arr,
           "end_to_end_rps": len(ok_open) / (max(done_at) - t_start),
           "rejected": rejected, "slo_ms": SERVE_ASYNC_SLO_MS,
           "client_latency_ms": lat.snapshot(),
           "deadline_misses": sched_stats["deadline_misses"],
           "flushes": sched_stats["flushes"],
           "dispatches": sched_stats["dispatches"],
           "misses": cache.stats()["misses"] - misses0,
           "max_ratio": max(r_open),
           "ok": (rejected == 0 and len(ok_open) == n_req
                  and all(np.isfinite(r) and r <= CRITERION
                          for r in r_open))})

    # (c) faults
    small = [i for i, A in enumerate(As) if A.shape == SERVE_LADDER[0]]
    with faults.injected(FaultConfig(sites=(("serve.worker", 1.0, 2),))):
        s = AsyncScheduler(serve_config=scfg, cache=cache, device=dev,
                           workers=1, sched_config=SchedulerConfig(
                               slo_ms=1e4, flush_interval_ms=5.0))
        futs = [s.submit("lstsq", As[i], bs[i], deadline=30.0)
                for i in small[:16]]
        crash_x = [f.result(timeout=RESULT_S) for f in futs]
        crash = s.stats()
        s.shutdown(timeout=RESULT_S)
    s = AsyncScheduler(serve_config=scfg, cache=cache, device=dev,
                       start=False)
    with faults.injected(FaultConfig(sites=(("serve.dispatch", 1.0, 1),))):
        futs = [s.submit("lstsq", As[i], bs[i], deadline=30.0)
                for i in small[:8]]
        s.drain()
    retry_x = [f.result(timeout=RESULT_S) for f in futs]
    retry = s.stats()
    s = AsyncScheduler(serve_config=scfg, cache=cache, device=dev,
                       start=False, guards="fallback")
    A_nan = [As[i].copy() for i in small[:8]]
    A_nan[5][1, 1] = np.nan
    futs = [s.submit("lstsq", A, bs[i], deadline=30.0)
            for A, i in zip(A_nan, small[:8])]
    s.drain()
    nan_out = [type(f.exception(timeout=RESULT_S)).__name__
               if f.exception(timeout=RESULT_S) is not None else "ok"
               for f in futs]
    nan = s.stats()
    s = AsyncScheduler(serve_config=scfg, cache=cache, device=dev,
                       start=False, sched_config=SchedulerConfig(
                           queue_depth=8))
    for i in small[:8]:
        s.submit("lstsq", As[i], bs[i], deadline=30.0)
    try:
        s.submit("lstsq", As[small[8]], bs[small[8]], deadline=30.0)
        backpressure = None
    except dt.BackpressureError as e:
        backpressure = e.retry_after
    s.shutdown(drain=False)
    r_fault = _ratios([As[i] for i in small[:16]], [bs[i] for i in small[:16]],
                      crash_x) + _ratios([As[i] for i in small[:8]],
                                         [bs[i] for i in small[:8]], retry_x)
    section("faults")
    check({"phase": 18, "name": "faults",
           "worker_crashes": crash["worker_crashes"],
           "crash_completed": crash["completed"],
           "dispatch_retries": retry["retries"],
           "retry_completed": retry["completed"],
           "nan_outcomes": nan_out, "bisections": nan["bisections"],
           "backpressure_retry_after": backpressure,
           "max_ratio": max(r_fault),
           "ok": (crash["worker_crashes"] == 2 and crash["completed"] == 16
                  and retry["retries"] >= 1 and retry["completed"] == 8
                  and nan_out == ["ok"] * 5 + ["Breakdown"] + ["ok"] * 2
                  and nan["bisections"] >= 1
                  and backpressure is not None and backpressure > 0
                  and all(r <= CRITERION for r in r_fault))})

    # (d) the "update" kind: phase 15 (f)'s stream through the scheduler
    m, n, steps = update_shape or (65536, 256, 64)
    A, b, ops = _update_stream(seed, m, n, steps, dev)
    ref = _SHARED.get("update_reference")
    ref_from = "phase 15 (f)"
    if ref is None or ref["shape"] != (m, n, steps):
        ref_from = "this phase, direct"
        ref = _uncounted(hp, lambda: _update_direct(dt, A, b, ops, dev))[0]
    per_factor = expected_launches(m, n, torch.float32) \
        if dev.type == "cuda" else 0      # the CPU launches no kernel
    l0 = dict(hp.LAUNCHES)
    t0 = time.perf_counter()
    live = dt.UpdatableQR(A, device=dev)
    reasons = [[-1, live.last_refactor["reason"]]]
    usched = AsyncScheduler(device=dev, cache=cache)
    ufuts = []
    for step, (op, u, v) in enumerate(ops):
        if step == 40:
            usched.drain(timeout=600)
            with faults.injected(FaultConfig(
                    sites=(("numeric.breakdown", 1.0, 1),))):
                ufuts.append((step, usched.submit("update", live, (op, u, v),
                                                  deadline=600.0)))
                usched.drain(timeout=600)
        else:
            ufuts.append((step, usched.submit("update", live, (op, u, v),
                                              deadline=600.0)))
        if step % 8 == 7:
            ufuts.append((step, usched.submit("update", live, ("solve", b),
                                              deadline=600.0)))
    usched.drain(timeout=600)
    t_update = time.perf_counter() - t0
    xs_u = []
    for step, f in ufuts:
        val = f.result(timeout=RESULT_S)
        if isinstance(val, dict):
            if val["refactored"]:
                reasons.append([step, val["reason"]])
        else:
            xs_u.append(val)
    update_launches = {k: hp.LAUNCHES[k] - l0[k] for k in l0}
    ustats = usched.stats()
    usched.shutdown()
    refactors = len(reasons) - 1
    bit_r = torch.equal(live.r_matrix(), ref["R"])
    bit_x = len(xs_u) == len(ref["xs"]) and all(
        torch.equal(x, y) for x, y in zip(xs_u, ref["xs"]))
    section("update")
    check({"phase": 18, "name": "update_kind", "shape": [m, n],
           "steps": steps, "reference": ref_from, "refactors": reasons,
           "reference_refactors": ref["reasons"],
           "launches": update_launches, "per_factorization": per_factor,
           "expected_f32": per_factor * (1 + refactors),
           "seconds": t_update,
           "dispatches": ustats["dispatches"],
           "r_bit_identical": bit_r, "solves_bit_identical": bit_x,
           "ok": (bit_r and bit_x and reasons == ref["reasons"]
                  and update_launches["panel_qr_f32"]
                  == per_factor * (1 + refactors)
                  and (per_factor == 4 or update_shape is not None
                       or dev.type != "cuda")
                  and update_launches["panel_qr_c64"] == 0)})
    del live, A, ops, ref

    # (e) step 0: concurrent replays of two keys while a third captures,
    # two keys of one lane (their stream shared), then two of two lanes
    if dev.type == "cuda":
        by_size = sorted((k for k in cache._entries if k.batch >= 4),
                         key=lambda k: k.m * k.n * k.n * k.batch)
        lane_of = {k: cache._entries[k].lane for k in by_size}
        first = by_size[len(by_size) // 4]
        same = next(k for k in by_size[len(by_size) // 4 + 1:]
                    if lane_of[k] is lane_of[first])
        other = next(k for k in by_size[len(by_size) // 4 + 1:]
                     if lane_of[k] is not lane_of[first])
        rows = {}
        for name, pair in (("one_lane", [first, same]),
                           ("two_lanes", [first, other])):
            progs = [cache._entries[k] for k in pair]
            inputs = [_replay_inputs(k, dev, seed + j)
                      for j, k in enumerate(pair)]
            refs = [[p_(*x) for x in ins] for p_, ins in zip(progs, inputs)]
            torch.cuda.synchronize(dev)
            # a width prewarm never mints (it takes min(32, n) >= 16)
            cold = pair[1]._replace(block_size=8 if rows else 4)
            lanes = scache.device_lanes(dev)   # the cold key joins pair[1]'s
            while scache.next_lane(dev) is not lanes[
                    (lanes.index(lane_of[pair[1]]) - 1) % len(lanes)]:
                pass
            rows[name] = _concurrent_replays(
                progs, inputs, refs, lambda cold=cold: cache.get_or_compile(
                    cold, lambda: seng._lower_for_key(cold, dev)))
            rows[name] += ([list(k)[:6] for k in pair],)
            if name == "two_lanes":
                # the overlap two lanes buy: the same 400 replays from two
                # threads with no capture beside them, then from one
                quiet = _concurrent_replays(progs, inputs, refs,
                                            lambda: None)
                _, serial_s = _timed(lambda: [
                    progs[k](*inputs[k][i % len(inputs[k])])
                    for i in range(SERVE_REPLAYS) for k in (0, 1)], dev)
            if name == "one_lane":
                rows["per_program_locks"] = _per_program_lock_replays(
                    cache, pair, pair[1]._replace(block_size=8), inputs,
                    refs, dev)
        section("replays")
        check({"phase": 18, "name": "concurrent_replays",
               "replays_per_thread": SERVE_REPLAYS,
               **{f"{name}_{field}": row[i] for name, row in rows.items()
                  for i, field in enumerate(("mismatches", "compared", "s",
                                             "keys")) if i < len(row)},
               "two_lanes_quiet_s": quiet[2],
               "two_lanes_quiet_mismatches": quiet[0],
               "two_lanes_serial_s": serial_s,
               "ok": (rows["one_lane"][0] == 0
                      and rows["two_lanes"][0] == 0 and quiet[0] == 0)})

    # (f) the router: K = 3 replicas beside one scheduler, the kill ladder
    burst = list(range(min(SERVE_ROUTER_BURST, n_req)))
    kcfg = SchedulerConfig(slo_ms=60e3, flush_interval_ms=20.0,
                           queue_depth=4096)

    def run_burst(submit):
        t0 = time.perf_counter()
        fs = [submit(i) for i in burst]
        out = [f.result(timeout=RESULT_S) for f in fs]
        return out, len(burst) / (time.perf_counter() - t0)

    single = AsyncScheduler(serve_config=scfg, cache=cache, device=dev,
                            workers=1, sched_config=kcfg)
    x_single, single_rps = run_burst(lambda i: single.submit(
        "lstsq", As[i], bs[i], deadline=60.0, tenant=tenants[i]))
    single.shutdown()
    router = Router(replicas=3, fleet=FleetConfig(replicas=3, failovers=1),
                    serve_config=scfg, cache=cache, device=dev, workers=1,
                    sched_config=kcfg)
    counts = [dict() for _ in range(3)]
    for k, rep in enumerate(router.replicas):
        inner = rep.submit

        def counting(*a, _inner=inner, _k=k, **kw):
            t = kw.get("tenant", "default")
            counts[_k][t] = counts[_k].get(t, 0) + 1
            return _inner(*a, **kw)
        rep.submit = counting
    x_router, router_rps = run_burst(lambda i: router.submit(
        "lstsq", As[i], bs[i], deadline=60.0, tenant=tenants[i]))
    spread = [dict(sorted(c.items())) for c in counts]  # the burst's
    agree = max(rel_err(a, b) for a, b in zip(x_router, x_single))
    outcomes = {"ok": 0, "lost": 0, "typed": 0, "untyped": 0}
    waves, survivors = [], True
    for kill in (None, 0, 1):
        idx = [burst[(len(waves) * 20 + j) % len(burst)] for j in range(20)]
        waves.extend((i, router.submit("lstsq", As[i], bs[i], deadline=120.0,
                                       tenant=tenants[i])) for i in idx)
        if kill is not None:
            router.kill(kill)
            x = router.submit("lstsq", As[0], bs[0],
                              deadline=120.0).result(timeout=RESULT_S)
            survivors &= rel_err(x, xs_sync[0]) < 1e-4
    for i, f in waves:
        try:
            x = f.result(timeout=RESULT_S)
            outcomes["ok" if rel_err(x, xs_sync[i]) < 1e-4
                     else "untyped"] += 1
        except dt.ReplicaLost:
            outcomes["lost"] += 1
        except dt.ServeError:
            outcomes["typed"] += 1
        except BaseException:
            outcomes["untyped"] += 1
    snap = router.metrics_snapshot()
    router.shutdown()
    sticky_live = _uncounted(hp, lambda: dt.UpdatableQR(
        torch.rand((8192, 64), device=dev), device=dev))[0]
    srouter = Router(replicas=2, fleet=FleetConfig(replicas=2),
                     serve_config=scfg, cache=cache, device=dev, workers=1)
    for _ in range(4):
        srouter.submit("update", sticky_live, (
            "update", 0.01 * torch.randn(8192, device=dev),
            torch.randn(64, device=dev)), deadline=60.0)
    srouter.drain(timeout=RESULT_S)
    sticky = sorted(r.stats()["completed"] for r in srouter.replicas)
    srouter.shutdown()
    section("router")
    check({"phase": 18, "name": "router", "replicas": 3,
           "burst": len(burst), "single_rps": single_rps,
           "router_rps": router_rps, "router_over_single":
           router_rps / single_rps, "x_router_vs_single": agree,
           "tenant_spread": spread, "kill_outcomes": outcomes,
           "survivors_served": bool(survivors),
           "failovers": snap["failovers"],
           "replicas_healthy": snap["replicas_healthy"],
           "sticky_completed_per_replica": sticky,
           "ok": (outcomes["untyped"] == 0 and sum(outcomes.values()) == 60
                  and survivors and snap["replicas_healthy"] == 1
                  and agree < 1e-4 and sticky == [0, 4]
                  and all(max(c.get(t, 0) for c in spread)
                          - min(c.get(t, 0) for c in spread) <= 1
                          for t in {tenants[i] for i in burst}))})

    # (g) the store: a child interpreter on the records this process wrote
    small_shapes = [list(SERVE_LADDER[0]), list(SERVE_LADDER[1])]
    small_keys = [k for k in keys if (k.m, k.n) in {
        (seng.plan_bucket(m_, n_, "float32", scfg).m,
         seng.plan_bucket(m_, n_, "float32", scfg).n)
        for m_, n_ in small_shapes}]
    with tempfile.TemporaryDirectory() as root:
        store = sstore.ExecutableStore(os.path.join(root, "store"))
        for k in small_keys:
            store.save(k, cache._entries[k])
        qkey = small_keys[0]._replace(kind="qr", refine=0,
                                      apply_precision=None)
        qcache = scache.ExecutableCache(quarantine_s=600.0)
        with faults.injected(FaultConfig(sites=(("serve.compile", 1.0, 1),))):
            try:
                qcache.get_or_compile(qkey, lambda: None)
            except dt.CompileFailed:
                pass
        state = os.path.join(root, "fleet.json")
        sstore.save_fleet_state(state, cache=qcache)
        env = dict(os.environ, DHQR_FLEET_STORE=os.path.join(root, "store"),
                   DHQR_FLEET_STATE=state)
        here = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.run(
            [sys.executable, "-c", _STORE_CHILD, here, str(device),
             json.dumps(small_shapes), json.dumps(list(qkey))],
            env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"store child failed: {proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    section("store")
    check({"phase": 18, "name": "store", "records": len(small_keys),
           "child": child, "section_s": dict(sections),
           "phase_s": time.perf_counter() - t_phase,
           "ok": (child["recorded"] == len(small_keys)
                  and child["captures"] == len(small_keys)
                  and child["store"]["records_found"] == len(small_keys)
                  and child["reason"] == sstore.NOT_A_PROGRAM
                  and child["warm_misses"] == 0
                  and child["results_finite"]
                  and child["adopted_quarantine"] == "Quarantined")})
    launches = dict(hp.LAUNCHES)
    if launches != update_launches:
        raise AssertionError(
            f"the serve_async path launched {launches}, the update kind's "
            f"{update_launches}: a batched dispatch launched a panel kernel")
    return update_launches


# -- phase 19: the tuner and the armor seam ----------------------------------

TUNE_TALL = (65536, 256)          # BASELINE.json's tall-skinny lstsq
TUNE_SQUARE = (16384, 16384)      # BASELINE.json's square qr
TUNE_SQUARE_BUDGET, TUNE_SQUARE_REPEATS = 8, 2
TUNE_SERVE_REQUESTS = 256
ARMOR_SEPARATION = 100.0   # corrupted / honest qr_gap, at least 2 decades
ARMOR_REFERENCE = (4400, 4000)    # the reference's lstsq, 4 gloo ranks
ARMOR_C64 = (8192, 4096)


def _rank_matrix(m, n, dtype, seed, device):
    """A deterministic uniform (m, n) matrix and m-vector on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype.is_complex:
        real = torch.float32
        A = torch.complex(torch.rand((m, n), generator=g, device=device,
                                     dtype=real),
                          torch.rand((m, n), generator=g, device=device,
                                     dtype=real))
        b = torch.complex(torch.rand(m, generator=g, device=device,
                                     dtype=real),
                          torch.rand(m, generator=g, device=device,
                                     dtype=real))
        return A, b
    return (torch.rand((m, n), generator=g, device=device, dtype=dtype),
            torch.rand(m, generator=g, device=device, dtype=dtype))


def _armor_clean_case(dt, parallel, hp, device, m, n, dtype, seed, warm):
    """``qr(mesh=)`` disarmed and armed on this rank's column mesh: each
    twice after an optional warm-up (best seconds), launches per call,
    the armed calls' verifications, and whether the armed factors are the
    disarmed ones bit for bit."""
    from dhqr_tpu_torch import armor
    from dhqr_tpu_torch.utils.config import ArmorConfig

    A, _ = _rank_matrix(m, n, dtype, seed, device)
    mesh = parallel.column_mesh(device=device)

    def call():
        return dt.qr(A, mesh=mesh)

    if warm:
        call()
    rows = {}
    for armed in (False, True, False, True):
        scope = armor.armored(ArmorConfig(enabled=True)) if armed \
            else contextlib.nullcontext()
        with scope as state:
            l0 = dict(hp.LAUNCHES)
            fact, t = _timed(call, device)
            launched = {k: hp.LAUNCHES[k] - l0[k] for k in l0}
            snap = state.metrics_snapshot() if armed else None
        row = rows.setdefault(armed, {"s": [], "fact": fact})
        row["s"].append(t)
        row["launches"] = launched
        row["metrics"] = snap
    off, on = rows[False], rows[True]
    same = bool(torch.equal(off["fact"].H, on["fact"].H)
                and torch.equal(off["fact"].alpha, on["fact"].alpha))
    return {"s_disarmed": min(off["s"]), "s_armed": min(on["s"]),
            "launches_disarmed": off["launches"],
            "launches_armed": on["launches"],
            "armed_metrics": on["metrics"], "bit_identical": same}


def _armor_faults_case(dt, parallel, hp, device, m, n, seed):
    """The recovery ladder under injected wire faults on this rank's
    column mesh at (m, n) f32: a one-shot corrupt in the ``lstsq``'s solve
    stage and one in a ``qr`` panel (both re-dispatched away), the same
    hit on an ``lstsq`` panel (printed: the normal-equations checksum does
    not see it at this size, in the JAX package's invariant too), a
    persistent drop on ``qr`` (typed, with a shard index), the tags on a
    corrupted bf16 sum, two one-shot corruptions on the bf16 wire and a
    NaN on two dispatches (the degrade), then ``resolve_plan`` on a stored
    bf16 plan of the key those trips demote."""
    from dhqr_tpu_torch import armor, faults, tune
    from dhqr_tpu_torch.parallel import wire
    from dhqr_tpu_torch.parallel.layout import plan_padding
    from dhqr_tpu_torch.utils.config import ArmorConfig, FaultConfig

    A, b = _rank_matrix(m, n, torch.float32, seed, device)
    mesh = parallel.column_mesh(device=device)
    armor.reset_wire_trips()
    out = {}

    def scenario(name, fn, *sites, armed=True):
        scope = armor.armored(ArmorConfig(enabled=True)) if armed \
            else contextlib.nullcontext()
        with scope as state, faults.injected(FaultConfig(
                sites=tuple(sites))) as harness:
            t0 = time.perf_counter()
            try:
                value, error = fn(), None
            except armor.ArmorError as err:
                value, error = None, {
                    "class": type(err).__name__, "label": err.label,
                    "shard_index": err.shard_index,
                    "recovery": list(err.recovery)}
            _sync(device)
            out[name] = {
                "s": time.perf_counter() - t0, "error": error,
                "metrics": state.metrics_snapshot() if armed else None,
                "visits": {k: v["visits"]
                           for k, v in harness.stats().items()},
                "fired": {k: v["fired"] for k, v in harness.stats().items()}}
        return value

    # the factorization's collectives come first, two parts per panel
    nb, n_pad = plan_padding(n, mesh.size, 128)
    solve_visit = 2 * (n_pad // nb) + 1
    x = scenario("corrupt_once", lambda: dt.lstsq(A, b, mesh=mesh),
                 ("parallel.collective.corrupt", 1.0, 1, solve_visit))
    out["corrupt_once"]["x"] = x.cpu().numpy()
    out["corrupt_once"]["visit"] = solve_visit
    scenario("corrupt_qr", lambda: dt.qr(A, mesh=mesh),
             ("parallel.collective.corrupt", 1.0, 1, 3))
    # the same one-shot hit on a factorization panel of the lstsq: the
    # normal-equations checksum's known blind spot at this size (printed)
    x = scenario("corrupt_factor_lstsq", lambda: dt.lstsq(A, b, mesh=mesh),
                 ("parallel.collective.corrupt", 1.0, 1, 3))
    out["corrupt_factor_lstsq"]["x"] = x.cpu().numpy()
    scenario("drop_qr", lambda: dt.qr(A, mesh=mesh),
             ("parallel.collective.drop", 1.0, None))
    payload = A[:, :128].contiguous()
    for armed in (True, False):
        y = scenario(f"tag_{armed}", lambda: wire.wire_psum(
            payload, mesh, "bf16", onehot=False),
            ("parallel.collective.corrupt", 1.0, 1), armed=armed)
        out[f"tag_{armed}"].update(
            all_nan=bool(torch.isnan(y).all()),
            finite=bool(torch.isfinite(y).all()))

    def bf16():
        return parallel.sharded_lstsq(A, b, mesh, comms="bf16")

    # one dispatch's collective visits, from a clean bf16 run
    scenario("bf16_clean", bf16, ("parallel.collective.nan", 0.0, None))
    visits = out["bf16_clean"]["visits"]["parallel.collective.nan"]
    for i in range(2):
        scenario(f"bf16_corrupt_{i}", bf16,
                 ("parallel.collective.corrupt", 1.0, 1))
    x = scenario("bf16_nan_degrade", bf16,
                 ("parallel.collective.nan", 1.0, visits + 1))
    out["bf16_nan_degrade"]["x"] = x.cpu().numpy()
    out["trips"] = armor.export_wire_trips()
    out["degraded"] = armor.degraded_labels()
    db = tune.PlanDB()
    db.record(tune.plan_key("lstsq", m, n, "float32", nproc=mesh.size,
                            device=device),
              tune.Plan(block_size=128, comms="bf16"))
    plan = tune.resolve_plan("lstsq", m, n, "float32", nproc=mesh.size,
                             db=db, device=device)
    out["resolved_plan"] = plan.to_dict()
    armor.reset_wire_trips()
    return out


_ARMOR_CASES = {"clean": _armor_clean_case, "faults": _armor_faults_case}


def armor_worker(device, cases):
    """One rank of phase 19 (e): each case on this rank's mesh; returns
    {"cases": per-case rows, "launches": this rank's kernel launches}
    (every call here is on the tune_armor path)."""
    import dhqr_tpu_torch as dt
    from dhqr_tpu_torch import parallel
    from dhqr_tpu_torch.ops import hopper_panel as hp

    hp.reset_launches()
    out = []
    for case in cases:
        case = dict(case)
        out.append(_ARMOR_CASES[case.pop("kind")](dt, parallel, hp, device,
                                                  **case))
    return {"cases": out, "launches": dict(hp.LAUNCHES)}


def _tune_tall(dt, hp, seed, tune):
    """(a) the default-budget tune of ``lstsq`` at 65536 x 256 f32 into the
    process-default DB, each candidate's launches, and ``plan="auto"``
    hitting the DB with no second tune, bit-identical to the winner's
    knobs."""
    from dhqr_tpu_torch.tune import search
    from dhqr_tpu_torch.utils.config import DHQRConfig

    m, n = TUNE_TALL
    res, t = wall(lambda: tune.tune("lstsq", m, n, torch.float32,
                                    seed=seed))
    A, b = random_problem(m, n, np.float32, seed + 19)
    At, bt = torch.from_numpy(A).cuda(), torch.from_numpy(b).cuda()
    rows = []
    for meas in res.measurements:
        cfg = tune.apply_plan_to_config(DHQRConfig(), meas.plan)
        try:
            _, launched, _ = _launches_of(
                hp, lambda: dt.lstsq(At, bt, config=cfg))
        except Exception as exc:  # printed: the tune skipped it too
            launched = f"{type(exc).__name__}: {exc}"[:120]
        rows.append({"plan": meas.plan.describe(),
                     "ms": None if meas.seconds is None
                     else 1e3 * meas.seconds,
                     "ratio_to_lapack": meas.residual, "reason": meas.reason,
                     "launches": launched})
        emit({"phase": 19, "name": "tune_tall_candidate", **rows[-1]})
    emit({"phase": 19, "name": "tune_tall", "shape": [m, n],
          "key": res.key, "winner": res.plan.describe(),
          "winner_ms": 1e3 * res.seconds,
          "default_ms": 1e3 * res.baseline_seconds,
          "speedup": res.speedup, "candidates": len(res.measurements),
          "tune_s": t, "entry": tune.default_db().get_entry(res.key)})
    real_tune = search.tune

    def no_second_tune(*args, **kwargs):
        raise AssertionError("plan='auto' re-tuned a key the DB holds")

    search.tune = no_second_tune
    try:
        x_auto, l_auto, _ = _launches_of(
            hp, lambda: dt.lstsq(At, bt, plan="auto"))
    finally:
        search.tune = real_tune
    x_ref = dt.lstsq(At, bt, config=tune.apply_plan_to_config(
        DHQRConfig(), res.plan))
    same = bool(torch.equal(x_auto, x_ref))
    _, _, oracle = oracle_of(m, n, np.float32, seed + 19)
    from dhqr_tpu_torch.utils.testing import normal_equations_residual

    ratio = normal_equations_residual(A, x_auto.cpu().numpy(), b) / oracle
    row = {"phase": 19, "name": "tune_tall_auto", "bit_identical": same,
           "launches": l_auto, "ratio_to_lapack": ratio}
    row["ok"] = same and ratio < CRITERION and res.speedup >= 1.0
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"phase 19 (a) failed: {row}")
    return res, At, bt


def _tune_square(dt, hp, seed, tune):
    """(b) the square tune at 16384^2 f32 (budget 8, 2 repeats, the f64
    Gram gate on the card), then ``qr(plan="auto")``'s launches against
    the winner's panel plan; returns the factorization and A."""
    from dhqr_tpu_torch.ops import blocked
    from dhqr_tpu_torch.tune import search

    m, n = TUNE_SQUARE
    res, t = wall(lambda: tune.tune(
        "qr", m, n, torch.float32, budget=TUNE_SQUARE_BUDGET,
        repeats=TUNE_SQUARE_REPEATS, seed=seed))
    cuda = torch.device("cuda")
    for meas in res.measurements:
        nb = meas.plan.block_size or blocked.DEFAULT_BLOCK_SIZE
        plan = blocked.panel_plan(m, n, nb, True, torch.float32, cuda)
        emit({"phase": 19, "name": "tune_square_candidate",
              "plan": meas.plan.describe(),
              "ms": None if meas.seconds is None else 1e3 * meas.seconds,
              "gram_gap": meas.residual, "reason": meas.reason,
              "planned_launches": sum(blocked.kernel_leaves(w, leaf)
                                      for _, w, leaf in plan if leaf)})
    emit({"phase": 19, "name": "tune_square", "shape": [m, n],
          "key": res.key, "winner": res.plan.describe(),
          "winner_ms": 1e3 * res.seconds,
          "default_ms": 1e3 * res.baseline_seconds, "speedup": res.speedup,
          "budget": TUNE_SQUARE_BUDGET, "repeats": TUNE_SQUARE_REPEATS,
          "tune_s": t})
    g = torch.Generator(device="cuda").manual_seed(seed + 191)
    A = torch.rand((m, n), generator=g, device="cuda")
    fact, launched, t_qr = _launches_of(hp, lambda: dt.qr(A, plan="auto"))
    nb = res.plan.block_size or blocked.DEFAULT_BLOCK_SIZE
    plan = blocked.panel_plan(m, n, nb, True, torch.float32, cuda)
    expect = sum(blocked.kernel_leaves(w, leaf) for _, w, leaf in plan
                 if leaf)
    gate = search._verify("qr", (fact.H, fact.alpha), (A,), None)
    row = {"phase": 19, "name": "tune_square_auto", "nb": fact.block_size,
           "n_over_nb": n // nb, "launches": launched,
           "expected_launches": expect, "qr_s": t_qr,
           "gram_gap": gate[1]}
    row["ok"] = fact.block_size == nb and \
        launched["panel_qr_f32"] == expect and gate[0]
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"phase 19 (b) failed: {row}")
    return fact, A


def _tune_serve(dt, seed, tune):
    """(c) ``prewarm(plan="auto")`` of ``serve_lstsq`` on phase 17's two
    most frequent shapes, then a 256-request run in micro-batches of 32
    (16 of each) with zero misses, every residual under 8x."""
    from dhqr_tpu_torch import serve
    from dhqr_tpu_torch.serve.buckets import plan_bucket
    from dhqr_tpu_torch.serve.cache import canonical_key, default_cache

    shapes = SERVE_LADDER[:2]   # the Zipf stream's two heaviest ranks
    half = SERVE_MICRO_BATCH // 2
    cache = default_cache(torch.device("cuda", torch.cuda.current_device()))
    keys, t = wall(lambda: serve.prewarm(
        [(half, m, n) for m, n in shapes], kind="lstsq", plan="auto"))
    for m, n in shapes:
        bucket = plan_bucket(m, n, "float32")
        stored = tune.default_db().get_entry(tune.plan_key(
            "serve_lstsq", bucket.m, bucket.n, "float32"))
        emit({"phase": 19, "name": "tune_serve_bucket", "shape": [m, n],
              "bucket": [bucket.m, bucket.n], "entry": stored})
    rng = np.random.default_rng(seed + 192)
    As, bs = [], []
    for _ in range(TUNE_SERVE_REQUESTS // SERVE_MICRO_BATCH):
        for m, n in shapes:
            for _ in range(half):
                As.append(rng.random((m, n)).astype(np.float32))
                bs.append(rng.random(m).astype(np.float32))
    misses0 = cache.stats()["misses"]
    xs, t_run = _serve_pass(
        lambda A_, b_: serve.batched_lstsq(A_, b_, plan="auto"), As, bs)
    misses = cache.stats()["misses"] - misses0
    ratios = _ratios(As, bs, xs)
    row = {"phase": 19, "name": "tune_serve", "prewarm_s": t,
           "keys": [canonical_key(k) for k in keys],
           "requests": len(As), "run_s": t_run,
           "requests_per_s": len(As) / t_run, "warm_misses": misses,
           "worst_ratio": max(ratios)}
    row["ok"] = misses == 0 and max(ratios) < CRITERION and all(
        "householder+nb" in canonical_key(k) for k in keys)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"phase 19 (c) failed: {row}")


def _tune_demotion(dt, tune, At, bt):
    """(d) three rung-0 gate failures of ``guarded_lstsq(plan="auto")``
    under an injected ``numeric.breakdown`` demote the tall key."""
    from dhqr_tpu_torch import faults, obs
    from dhqr_tpu_torch.utils.config import FaultConfig

    m, n = TUNE_TALL
    tune.reset_gate_failures()
    paths = []
    for _ in range(tune.PLAN_DEMOTE_AFTER):
        with faults.injected(FaultConfig(
                sites=(("numeric.breakdown", 1.0, 1),))):
            res = dt.guarded_lstsq(At, bt, plan="auto")
        paths.append(_path_of(res))
    demoted = tune.resolve_plan("lstsq", m, n, torch.float32)
    snap = obs.registry().snapshot()
    gate = {k: v for k, v in snap.items()
            if k.startswith("tune.plan_gate.")}
    row = {"phase": 19, "name": "tune_demotion", "paths": paths,
           "resolve_plan": demoted, "registry": gate}
    row["ok"] = demoted is None and all(p[0][1] == "breakdown"
                                        for p in paths) and \
        gate.get("tune.plan_gate.failures", 0) >= tune.PLAN_DEMOTE_AFTER \
        and gate.get("tune.plan_gate.demoted_keys", 0) >= 1
    emit(row)
    tune.reset_gate_failures()
    if not row["ok"]:
        raise AssertionError(f"phase 19 (d) failed: {row}")


def _armor_on_card(hp, seed, fact, A):
    """(e) the armor seam on the card: ``qr_gap`` honest against corrupted
    factors at 16384^2; one NCCL rank armed and disarmed at 16384^2; 4
    gloo ranks under injected faults at the reference's 4400 x 4000; 2
    gloo ranks armed at 8192 x 4096 c64. The ranks' launches join the
    parent's counts."""
    from dhqr_tpu_torch.armor import checks
    from dhqr_tpu_torch.parallel._ranks import run_ranks
    from dhqr_tpu_torch.utils.testing import (lapack_lstsq,
                                              normal_equations_residual)

    honest, _ = checks.qr_gap(fact.H, fact.alpha, A, fact.block_size)
    H = fact.H.clone()
    col = A.shape[1] // 2
    H[col // 3, col] += 1e4 * (1.0 + float(H.abs().max()))
    corrupt, worst = checks.qr_gap(H, fact.alpha, A, fact.block_size)
    _, t_gap = wall(lambda: checks.qr_gap(fact.H, fact.alpha, A,
                                          fact.block_size))
    row = {"phase": 19, "name": "armor_qr_gap", "shape": list(A.shape),
           "honest": honest, "corrupted": corrupt, "worst_col": worst,
           "corrupted_col": col, "separation": corrupt / max(honest, 1e-30),
           "gap_ms": 1e3 * t_gap}
    row["ok"] = honest < 1e-4 and row["separation"] >= ARMOR_SEPARATION \
        and worst == col
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"phase 19 (e) qr_gap failed: {row}")
    device = "cuda:0"
    m, n = ARMOR_REFERENCE
    runs = [("nccl", 1, [{"kind": "clean", "m": TUNE_SQUARE[0],
                          "n": TUNE_SQUARE[1], "dtype": "float32",
                          "seed": seed + 193, "warm": True}]),
            ("gloo", 4, [{"kind": "faults", "m": m, "n": n,
                          "seed": seed + 194}]),
            ("gloo", 2, [{"kind": "clean", "m": ARMOR_C64[0],
                          "n": ARMOR_C64[1], "dtype": "complex64",
                          "seed": seed + 195, "warm": False}])]
    for backend, P, cases in runs:
        t0 = time.perf_counter()
        ranks = run_ranks(armor_worker, P, backend=backend, device=device,
                          timeout_s=420, cases=cases)
        for r in ranks:
            for name, count in r["launches"].items():
                hp.LAUNCHES[name] += count
        rows = [r["cases"][0] for r in ranks]
        where = {"backend": backend, "ranks": P, "rank_device": device,
                 "wall_s": time.perf_counter() - t0}
        if cases[0]["kind"] == "clean":
            r0 = rows[0]
            row = {"phase": 19, "name": "armor_clean", **where,
                   "shape": [cases[0]["m"], cases[0]["n"]],
                   "dtype": cases[0]["dtype"],
                   "s_disarmed": max(r["s_disarmed"] for r in rows),
                   "s_armed": max(r["s_armed"] for r in rows),
                   "armed_overhead_ms": 1e3 * (
                       max(r["s_armed"] for r in rows)
                       - max(r["s_disarmed"] for r in rows)),
                   "launches_disarmed": [r["launches_disarmed"]
                                         for r in rows],
                   "launches_armed": [r["launches_armed"] for r in rows],
                   "armed_metrics": r0["armed_metrics"],
                   "bit_identical": all(r["bit_identical"] for r in rows)}
            row["ok"] = row["bit_identical"] and all(
                r["armed_metrics"]["verifications"] == 1
                and r["armed_metrics"]["detections"] == 0
                and r["launches_armed"] == r["launches_disarmed"]
                for r in rows) and sum(
                sum(l.values()) for l in row["launches_armed"]) > 0
            emit(row)
            if not row["ok"]:
                raise AssertionError(f"phase 19 (e) armor failed: {row}")
            continue
        r0 = rows[0]
        A_, b_ = _rank_matrix(m, n, torch.float32, seed + 194, device)
        A_, b_ = A_.cpu().numpy(), b_.cpu().numpy()
        oracle = normal_equations_residual(A_, lapack_lstsq(A_, b_), b_)
        for name in ("corrupt_once", "corrupt_factor_lstsq",
                     "bf16_nan_degrade"):
            r0[name]["ratio_to_lapack"] = normal_equations_residual(
                A_, r0[name].pop("x"), b_) / oracle
        for name, sc in r0.items():
            if isinstance(sc, dict) and "metrics" in sc:
                emit({"phase": 19, "name": f"armor_{name}", **where,
                      "shape": [m, n], **sc})
        emit({"phase": 19, "name": "armor_trips", **where,
              "trips": r0["trips"], "degraded": r0["degraded"],
              "resolved_plan": r0["resolved_plan"]})
        checks_ = {
            "corrupt_once": r0["corrupt_once"]["error"] is None
            and r0["corrupt_once"]["metrics"]["detections"] == 1
            and r0["corrupt_once"]["metrics"]["recovered_redispatch"] == 1
            and r0["corrupt_once"]["ratio_to_lapack"] < CRITERION,
            "corrupt_qr": r0["corrupt_qr"]["error"] is None
            and r0["corrupt_qr"]["metrics"]["detections"] == 1
            and r0["corrupt_qr"]["metrics"]["recovered_redispatch"] == 1,
            "corrupt_factor_lstsq_finite": bool(np.isfinite(
                r0["corrupt_factor_lstsq"]["ratio_to_lapack"])),
            "drop_qr": r0["drop_qr"]["error"] is not None
            and r0["drop_qr"]["error"]["class"] == "ShardFailure"
            and r0["drop_qr"]["error"]["shard_index"] is not None,
            "tags": r0["tag_True"]["all_nan"] and r0["tag_False"]["finite"],
            "bf16_clean": r0["bf16_clean"]["error"] is None
            and r0["bf16_clean"]["metrics"]["detections"] == 0,
            "bf16_corrupt": all(
                r0[f"bf16_corrupt_{i}"]["metrics"]["recovered_redispatch"]
                == 1 for i in range(2)),
            "degrade": r0["bf16_nan_degrade"]["error"] is None
            and r0["bf16_nan_degrade"]["metrics"]["recovered_degrade"] == 1
            and r0["bf16_nan_degrade"]["ratio_to_lapack"] < CRITERION,
            "trips": r0["trips"].get(f"lstsq|{m}|{n}|float32|{P}", 0) >= 3,
            "stripped": r0["resolved_plan"].get("comms") is None,
            "ranks_agree": all(r["drop_qr"]["error"] == r0["drop_qr"]["error"]
                               for r in rows)}
        emit({"phase": 19, "name": "armor_faults_checks", **checks_})
        if not all(checks_.values()):
            raise AssertionError(f"phase 19 (e) faults failed: {checks_}")


def _pulse_on_card(dt, At, bt):
    """(f) a mesh-less pulse measurement of a card dispatch traces the
    card: CUDA events in its profile (the CPU-only default of the past
    had none), beside the same call measured on request on the CPU's
    activities only."""
    from dhqr_tpu_torch.obs import pulse

    real = pulse._events
    seen = []

    def spy(prof, device_type):
        seen.append(real(prof, device_type))
        return seen[-1]

    pulse._events = spy
    try:
        _, report = pulse.measure("card_lstsq",
                                  lambda: dt.lstsq(At, bt))
    finally:
        pulse._events = real
    cuda_events = sum(e["device"] for e in seen[0])
    row = {"phase": 19, "name": "pulse_card", "cuda_events": cuda_events,
           "events": len(seen[0]), "device_kind": report.device_kind,
           "measured_unavailable": report.measured_unavailable,
           "wall_s": report.wall_s}
    row["ok"] = cuda_events > 0 and report.device_kind == \
        torch.cuda.get_device_name(0)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"phase 19 (f) failed: {row}")


def phase_tune_armor(dt, hp, seed, card):
    """Phase 19: the tuner on the card ((a) tall, (b) square, (c) serve,
    (d) demotion, into a temporary plan DB) and the armor seam ((e)), and
    (f) pulse's mesh-less device."""
    from dhqr_tpu_torch import tune

    with tempfile.TemporaryDirectory(prefix="dhqr_plans_") as tmp:
        saved = {k: os.environ.get(k) for k in ("DHQR_TUNE_DB",
                                                "DHQR_TUNE_SEEDS")}
        os.environ["DHQR_TUNE_DB"] = os.path.join(tmp, "plans.json")
        os.environ["DHQR_TUNE_SEEDS"] = "0"
        tune.reset_default_db()
        try:
            t0 = time.perf_counter()
            _, At, bt = _tune_tall(dt, hp, seed, tune)
            t_a = time.perf_counter()
            fact, A = _tune_square(dt, hp, seed, tune)
            t_b = time.perf_counter()
            _tune_serve(dt, seed, tune)
            t_c = time.perf_counter()
            _tune_demotion(dt, tune, At, bt)
            t_d = time.perf_counter()
            _armor_on_card(hp, seed, fact, A)
            del fact, A
            t_e = time.perf_counter()
            _pulse_on_card(dt, At, bt)
            with open(os.environ["DHQR_TUNE_DB"]) as fh:
                emit({"phase": 19, "name": "tune_db", "card": card,
                      "plans": json.load(fh)["plans"]})
            emit({"phase": 19, "name": "tune_armor_seconds",
                  "a": t_a - t0, "b": t_b - t_a, "c": t_c - t_b,
                  "d": t_d - t_c, "e": t_e - t_d,
                  "f": time.perf_counter() - t_e,
                  "total": time.perf_counter() - t0})
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            tune.reset_default_db()


HARNESS_SWEEP = ["1", "--sizes", "110x100,1100x1000,4400x4000",
                 "--dtypes", "float32,complex64", "--bench"]
HARNESS_MESH = ["4", "--sizes", "4400x4000", "--dtypes", "float32"]
DRYRUN_TIMEOUT_S = 480


def _harness_rows(argv):
    """``harness.main(argv)`` in this process: (exit code, its output, the
    sweep's rows parsed from it, seconds)."""
    from dhqr_tpu_torch import harness

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = harness.main(argv)
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    rows = []
    for line in out.splitlines():
        head = line.split()
        if head and head[0] in ("ok", "FAIL") and "residual" in head:
            rows.append({"status": head[0], "shape": head[1],
                         "dtype": head[2],
                         "residual": float(head[head.index("residual")
                                                 + 1]),
                         "lapack": float(head[head.index("(LAPACK") + 1]
                                         .rstrip(",")),
                         "t_s": float(line.rsplit("t=", 1)[1].rstrip("s"))})
        elif line.strip().startswith("slowdown vs LAPACK") and rows:
            rows[-1]["slowdown"] = float(line.rsplit(":", 1)[1].strip()
                                         .rstrip("x"))
    return rc, out, rows, secs


def phase_harness(dt, hp, seed, card):
    """Phase 20: the harness sweep in process (a) and on four gloo ranks
    sharing the card (b), the dry run in a child process (c), and the
    graft entry's step (d)."""
    from dhqr_tpu_torch import graft_entry

    torch.cuda.empty_cache()  # (b) and (c) share the card with this process
    rc, out, rows, secs = _harness_rows(HARNESS_SWEEP)
    devices = [ln for ln in out.splitlines() if ln.startswith("# devices")]
    row = {"phase": 20, "name": "harness_sweep", "argv": HARNESS_SWEEP,
           "card": card, "devices": devices, "rc": rc, "rows": rows,
           "s": secs}
    row["ok"] = rc == 0 and len(rows) == 6 and all(
        r["status"] == "ok" and r["residual"] < CRITERION * r["lapack"]
        and "slowdown" in r for r in rows)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"phase 20 (a) harness sweep failed:\n{out}")
    l0 = dict(hp.LAUNCHES)
    rc, out, rows, secs = _harness_rows(HARNESS_MESH)
    devices = [ln for ln in out.splitlines() if ln.startswith("# devices")]
    row = {"phase": 20, "name": "harness_mesh", "argv": HARNESS_MESH,
           "card": card, "devices": devices, "rc": rc, "rows": rows,
           "s": secs, "launches": {k: hp.LAUNCHES[k] - l0[k] for k in l0},
           "expected": sharded_plan(4400, 4000, torch.float32, 4)}
    row["ok"] = rc == 0 and len(rows) == 1 and rows[0]["status"] == "ok" \
        and "backend: gloo, ranks per card: 4" in out \
        and row["launches"]["panel_qr_f32"] == row["expected"]
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"phase 20 (b) harness mesh failed: {row}\n"
                             f"{out}")
    saved = {k: os.environ.get(k) for k in ("DHQR_DRYRUN_FULL",
                                            "DHQR_DRYRUN_TIMEOUT")}
    os.environ["DHQR_DRYRUN_FULL"] = "1"
    os.environ["DHQR_DRYRUN_TIMEOUT"] = str(DRYRUN_TIMEOUT_S)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            graft_entry.dryrun_multichip(4)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = buf.getvalue()
    print(out, end="", flush=True)
    stage_s = json.loads(next(
        ln for ln in out.splitlines()
        if ln.startswith("dryrun: stage seconds ")).split(" ", 3)[3])
    row = {"phase": 20, "name": "dryrun", "ranks": 4, "card": card,
           "full": True, "s": time.perf_counter() - t0,
           "stage_s": stage_s,
           "skipped": [ln for ln in out.splitlines() if "SKIPPED" in ln]}
    row["ok"] = out.rstrip().endswith("dryrun: all paths ok") \
        and not row["skipped"]
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"phase 20 (c) dry run failed: {row}")
    fn, (A, b) = graft_entry.entry()
    x_ref = _torch_lstsq(A, b)
    ne_ref = _ne_in(A, x_ref, b)
    for call in range(2):
        x, launched, t = _launches_of(hp, lambda: fn(A, b))
        ratio = _ne_in(A, x, b) / ne_ref
        row = {"phase": 20, "name": "entry", "call": call,
               "shape": list(A.shape), "dtype": "float32", "s": t,
               "launches": launched, "ratio_to_torch_lstsq": ratio,
               "criterion": CRITERION}
        row["ok"] = launched == {**dict.fromkeys(hp.KERNELS.values(), 0),
                                 "panel_qr_f32": 4} \
            and bool(torch.isfinite(x).all()) and ratio < CRITERION
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"phase 20 (d) entry failed: {row}")


# -- phase 21: the port's lint on the card ------------------------------------

SKETCH_REPEATS = ((768, 12), (65536, 256))   # f32, the count sketch


def index_add_sketch(A, b, rows, signs, s):
    """The count sketch as ``index_add_`` sums it (its CUDA adds are atomic,
    so their order varies): the version the bucket table replaced, kept
    here as a yardstick only."""
    rows = rows.long()
    SA = A.new_zeros((s, A.shape[-1])).index_add_(0, rows, signs[:, None] * A)
    Sb = b.new_zeros((s,)).index_add_(0, rows, signs * b)
    return SA, Sb


def phase_analysis(seed, card):
    """Phase 21: (a) the self-scan, (b) the concurrency pass with its
    witness burst on the card, (c) the count sketch's repeat bit for bit
    and its bucket sum's time beside ``index_add_``'s."""
    from dhqr_tpu_torch.analysis import api_check, cli
    from dhqr_tpu_torch.analysis.ast_rules import (
        iter_python_files,
        scan_paths,
    )
    from dhqr_tpu_torch.analysis.concurrency_pass import (
        run_concurrency_pass,
    )
    from dhqr_tpu_torch.solvers import sketch

    t_phase = t0 = time.perf_counter()
    paths = cli.default_paths()
    findings = scan_paths(paths, rel_to=cli._repo_root())
    findings += api_check.check_api()
    active = [f for f in findings if not f.suppressed]
    by_rule: "dict[str, int]" = {}
    for f in findings:
        if f.suppressed:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    row = {"phase": 21, "name": "self_scan",
           "files": len(list(iter_python_files(paths))),
           "active": len(active),
           "active_rules": sorted({f.rule for f in active}),
           "suppressed_by_rule": dict(sorted(by_rule.items())),
           "s": time.perf_counter() - t0}
    row["ok"] = not active
    emit(row)
    if not row["ok"]:
        raise AssertionError("phase 21 (a) self-scan findings:\n"
                             + "\n".join(f.render() for f in active))

    t0 = time.perf_counter()
    stats: dict = {}
    every = run_concurrency_pass(witness=True, device="cuda", stats=stats)
    conc = [f for f in every if not f.suppressed]
    row = {"phase": 21, "name": "concurrency", "card": card,
           "findings": [f.render() for f in conc],
           "suppressed": sum(f.suppressed for f in every),
           "witnessed_edges": [list(e) for e in stats["edges"]],
           "lane_edges": [list(e) for e in stats["lane_edges"]],
           "violations": stats["violations"],
           "requests": stats["requests"], "captures": stats["captures"],
           "programs": stats["programs"], "s": time.perf_counter() - t0}
    row["ok"] = not conc and stats["violations"] == 0 \
        and bool(stats["lane_edges"]) \
        and stats["programs"].get("cuda_graph", 0) >= 1
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"phase 21 (b) concurrency pass failed: {row}")

    for i, (m, n) in enumerate(SKETCH_REPEATS):
        g = torch.Generator(device="cuda").manual_seed(seed + 21 + i)
        A = torch.rand((m, n), generator=g, device="cuda")
        b = torch.rand((m,), generator=g, device="cuda")
        x1 = sketch.sketched_lstsq(A, b, operator="countsketch")
        x2 = sketch.sketched_lstsq(A, b, operator="countsketch")
        wide_A, wide_b = A.double(), b.double()
        res = float(torch.linalg.vector_norm(
            wide_A.mT @ (wide_A @ x2.double() - wide_b)))
        x_ref = _torch_lstsq(A, b)
        res_ref = float(torch.linalg.vector_norm(
            wide_A.mT @ (wide_A @ x_ref.double() - wide_b)))
        row = {"phase": 21, "name": "sketch_repeat", "shape": [m, n],
               "dtype": "float32", "operator": "countsketch",
               "equal": bool(torch.equal(x1, x2)),
               "ratio_to_torch_lstsq": res / res_ref,
               "criterion": CRITERION}
        if (m, n) == SKETCH_REPEATS[-1]:
            s = sketch.sketch_dim(m, n)
            rows, _ = sketch.count_sketch_operator(m, s, 0)
            signs_np, table_np = sketch._operator_arrays(
                "countsketch", m, s, 0, torch.float32)
            signs = torch.from_numpy(signs_np).cuda()
            table = torch.from_numpy(table_np).cuda()
            rows_t = torch.from_numpy(rows).cuda()
            new = lambda: sketch._count_sketch(A, b, signs, table)  # noqa: E731
            old = lambda: index_add_sketch(A, b, rows_t, signs, s)  # noqa: E731
            SA, _ = new()
            SA_old, _ = old()
            c_max = table.shape[1]
            # A, b and the signs read, the table read, (S A, S b) written
            moved = 4 * (m * n + 2 * m + s * n + s) + 8 * s * c_max
            row.update(
                s_rows=s, c_max=c_max,
                bucket_ms=cuda_ms(new, 20), index_add_ms=cuda_ms(old, 20),
                bound_ms=1e3 * moved / HBM_BYTES_PER_S,
                rel_to_index_add=float(torch.linalg.vector_norm(SA - SA_old)
                                       / torch.linalg.vector_norm(SA_old)),
                bucket_equal=bool(torch.equal(new()[0], SA)))
        row["ok"] = row["equal"] and row.get("bucket_equal", True) \
            and row["ratio_to_torch_lstsq"] < CRITERION \
            and row.get("rel_to_index_add", 0.0) <= 1e-6
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"phase 21 (c) sketch repeat failed: {row}")
        del A, b
    torch.cuda.empty_cache()
    emit({"phase": 21, "name": "phase", "s": time.perf_counter() - t_phase,
          "ok": True})


# -- phase 22: the graph passes of the port's lint on the card ----------------

#: The spread of steady-state ``qr`` 16384^2 f32 over PRs 1-12 (PERF.md),
#: and the run-to-run noise allowed above it (steady ``qr`` agrees within
#: 1% across PRs): the disarmed op-log seam must cost nothing measurable.
QR_SPREAD_S = (0.245, 0.250)
QR_NOISE = 0.02
GRAPH_P = (2, 4)              # the comms pass's rank counts, as phase 14
GRAPH_C64 = (16, 8)           # the jaxpr pass's shape, for the c64 routes


def _kernel_events(logs) -> dict:
    """Panel-kernel events of op logs, by kernel and path."""
    out: dict = {}
    for log in logs:
        for e in log.kernel_events():
            key = f"{e.name}:{e.path}"
            out[key] = out.get(key, 0) + 1
    return out


def phase_graph(dt, hp, seed, card):
    """Phase 22: the graph passes on the card. (a) the jaxpr pass over
    every preset (and the c64 ``qr`` / ``lstsq``), its panel events from
    the kernel path and as many as the launch counter; (b) the comms pass
    at P = 2 and 4 (gloo ranks sharing card 0), bytes against each
    contract's budget; (c) the xray and pulse smokes with numbers; (d) the
    atlas with the serve keys' CUDA-graph captures compared; (e) the CLI
    with every pass; and the disarmed seam's guard, ``qr`` 16384^2."""
    from dhqr_tpu_torch.analysis import (atlas, comms_pass, jaxpr_pass,
                                         oplog, pulse_smoke, xray_smoke)
    from dhqr_tpu_torch.analysis.cost_model import (budget_bytes,
                                                    tiered_budget_bytes)
    from dhqr_tpu_torch.analysis.findings import apply_graph_suppressions

    t_phase = time.perf_counter()
    dev = torch.device("cuda")

    # (a) the jaxpr pass: f32 routes over every preset, then c64 main path
    t0 = time.perf_counter()
    before = dict(hp.LAUNCHES)
    runs = jaxpr_pass.run_routes(device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 22)
    c64 = []
    for name, call in (("qr[c64]", lambda A, b: dt.qr(A)),
                       ("lstsq[c64]", lambda A, b: dt.lstsq(A, b))):
        A = torch.randn(GRAPH_C64, generator=g, device="cuda",
                        dtype=torch.complex64)
        b = torch.randn(GRAPH_C64[:1], generator=g, device="cuda",
                        dtype=torch.complex64)
        with oplog.record(name) as log:
            call(A, b)
        c64.append((name, log, ()))
    torch.cuda.synchronize()
    launched = {k: hp.LAUNCHES[k] - before[k] for k in hp.LAUNCHES}
    raised = [f"{label}: {log!r}" for label, log, _ in runs
              if isinstance(log, Exception)]
    logs = [log for _, log, _ in runs + c64 if not isinstance(log, Exception)]
    findings = jaxpr_pass.run_jaxpr_pass(runs=runs + c64)
    active = [f for f in findings if not f.suppressed]
    events = _kernel_events(logs)
    f64 = [f.render() for f in active if f.rule == "DHQR101"]
    row = {"phase": 22, "name": "jaxpr_pass", "card": card,
           "routes": len(runs), "raised": raised,
           "active": [f.render() for f in active],
           "suppressed_by_rule": {r: sum(f.rule == r and f.suppressed
                                         for f in findings)
                                  for r in sorted({f.rule for f in findings})},
           "kernel_events": events, "launches": launched,
           "f64_in_f32_routes": f64,
           "host_syncs": {label: len(log.syncs()) for label, log, _ in
                          runs + c64 if not isinstance(log, Exception)},
           "s": time.perf_counter() - t0}
    row["ok"] = (not raised and not active
                 and not any(k.endswith(":plain") for k in events)
                 and all(events.get(f"{k}:kernel", 0) == v
                         for k, v in launched.items())
                 and all(launched[k] >= 1
                         for k in ("panel_qr_f32", "panel_qr_c64")))
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"phase 22 (a) jaxpr pass failed: {row}")

    # (b) the comms pass on P gloo ranks sharing the card, as phase 14
    contracts = comms_pass.load_contracts()
    for P in GRAPH_P:
        t0 = time.perf_counter()
        ranks = comms_pass.census(P, device="cuda", stability=P == 2)
        found = apply_graph_suppressions(
            comms_pass.check_census(ranks, contracts))
        per_contract = []
        for i, r0 in enumerate(ranks[0]):
            c = contracts[r0["engine"]]
            p = r0["params"]
            st = comms_pass.merge_ranks([r[i]["stats"] for r in ranks])
            if p.topology is not None:
                tb = tiered_budget_bytes(
                    c["model"], p.m, p.n, p.nb, P, p.itemsize,
                    comms=c.get("comms"), topology=p.topology,
                    hierarchical=bool(c.get("hierarchical", True)))
                budget, dcn_budget = tb["total"], tb["dcn"]
            else:
                budget = budget_bytes(c["model"], p.m, p.n, p.nb, P,
                                      p.itemsize, comms=c.get("comms"))
                dcn_budget = None
            per_contract.append({
                "route": r0["label"], "contract": r0["engine"],
                "launches": st.launches(), "bytes": st.total_volume_bytes(),
                "budget": budget, "slack": c.get("slack", 1.5),
                "dcn_bytes": st.dcn_volume_bytes(), "dcn_budget": dcn_budget})
        row = {"phase": 22, "name": "comms_pass", "P": P, "card": card,
               "backend": "gloo", "routes": per_contract,
               "active": [f.render() for f in found if not f.suppressed],
               "suppressed": sum(f.suppressed for f in found),
               "s": time.perf_counter() - t0}
        row["ok"] = not row["active"] and len(per_contract) > 0
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"phase 22 (b) comms pass failed: {row}")
    t0 = time.perf_counter()
    donation = comms_pass.check_donation(device="cuda")
    emit({"phase": 22, "name": "donation", "card": card,
          "active": [f.render() for f in donation],
          "s": time.perf_counter() - t0, "ok": not donation})
    if donation:
        raise AssertionError("phase 22 (b) donation findings: "
                             + "; ".join(f.render() for f in donation))

    # (c) the smokes, with the card's numbers
    for name, smoke in (("xray_smoke", xray_smoke.run_xray_smoke),
                        ("pulse_smoke", pulse_smoke.run_pulse_smoke)):
        t0 = time.perf_counter()
        got: dict = {}
        bad = smoke(device="cuda", stats=got)
        row = {"phase": 22, "name": name, "card": card,
               "findings": [f.render() for f in bad], "report": got,
               "s": time.perf_counter() - t0}
        row["ok"] = not bad and bool(got)
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"phase 22 (c) {name} failed: {row}")

    # (d) the atlas, the collided serve cells compared on their captures
    t0 = time.perf_counter()
    st: dict = {}
    found = atlas.run_atlas_pass(device="cuda", stats=st)
    row = {"phase": 22, "name": "atlas", "card": card,
           "findings": [f.render() for f in found], **st,
           "s": time.perf_counter() - t0}
    row["ok"] = not found and st.get("collided_groups_run", 0) >= 1 \
        and st.get("events_compared", 0) > 0
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"phase 22 (d) atlas failed: {row}")

    # (e) the CLI with every pass, in a child process (uncounted)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dhqr_tpu_torch.analysis", "check"],
        capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    tail = [ln for ln in proc.stderr.splitlines()
            if ln.startswith("dhqr-lint:")]
    row = {"phase": 22, "name": "cli", "card": card, "rc": proc.returncode,
           "summary": tail[-1] if tail else None,
           "findings": [ln for ln in proc.stdout.splitlines()
                        if ": DHQR" in ln and "[suppressed" not in ln],
           "wall_s": time.perf_counter() - t0}
    row["ok"] = proc.returncode == 0 and bool(tail) \
        and tail[-1].startswith("dhqr-lint: 0 finding(s)")
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"phase 22 (e) CLI failed: {row}; stderr tail "
                             f"{proc.stderr[-3000:]}")

    # the disarmed seam's guard: steady-state qr 16384^2 f32
    assert oplog.ARMED is None
    A = torch.rand((16384, 16384), generator=g, device="cuda")
    wall(lambda: dt.qr(A))
    _, t_qr = wall(lambda: dt.qr(A))
    row = {"phase": 22, "name": "seam_guard", "card": card,
           "qr_16384_s": t_qr, "spread_s": list(QR_SPREAD_S),
           "noise": QR_NOISE}
    row["ok"] = t_qr <= QR_SPREAD_S[1] * (1 + QR_NOISE)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"phase 22 seam guard failed: {row}")
    del A
    torch.cuda.empty_cache()
    emit({"phase": 22, "name": "phase", "s": time.perf_counter() - t_phase,
          "ok": True})


def phase_in_place(hp, seed):
    """Phase 23: each ``IN_PLACE_CASES`` panel factored in place in a
    copy of H by the engine's leaf and by the wrapper on its transposed
    copy, compared bit for bit, with the device times of both entries and
    of the kernel alone in each layout (CUDA events; a repeated launch
    factors the factors again, which takes the same time)."""
    dtypes = {name: dtype for dtype, name in hp.KERNELS.items()}
    l0, v0, y0 = (dict(c) for c in (hp.LAUNCHES, hp.VARIANT_LAUNCHES,
                                     hp.LAYOUT_LAUNCHES))
    for i, (name, shape, c, w, off, sms, layout) in enumerate(IN_PLACE_CASES):
        dtype = dtypes[name]
        g = torch.Generator(device="cuda").manual_seed(seed + 23 + i)
        H = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
        view = H[:, c:c + w]
        pf, alpha = hp._panel_qr_kernel(view, off, sms)
        H2 = H.clone()
        alpha2 = torch.zeros(shape[1], dtype=dtype, device="cuda")
        v2, a2 = H2[:, c:c + w], alpha2[c:c + w]
        took = hp._panel_qr_kernel_in_place(v2, off, a2, sms)
        torch.cuda.synchronize()
        kept = bool(torch.equal(H2[:, :c], H[:, :c])
                    and torch.equal(H2[:, c + w:], H[:, c + w:])
                    and torch.equal(v2[:off], view[:off])
                    and not alpha2[:c].any() and not alpha2[c + w:].any())
        equal = bool(torch.equal(v2[off:], pf[off:])
                     and torch.equal(a2, alpha))
        plan = hp._plan(shape[0], w, off, dtype, H.device, sms)
        at = view.T.contiguous()
        a = torch.empty(w, dtype=dtype, device="cuda")
        row = {"phase": 23, "kernel": name, "H": list(shape), "column": c,
               "m": shape[0], "nb": w, "offset": off, "cta_cap": sms,
               "variant": plan[2], "layout": took, "want_layout": layout,
               "bit_equal": equal, "outside_kept": kept,
               "ms_in_place_entry": cuda_ms(
                   lambda: hp._panel_qr_kernel_in_place(v2, off, a2, sms), 5),
               "ms_wrapper": cuda_ms(
                   lambda: hp._panel_qr_kernel(view, off, sms), 5)}
        if took == "in_place":
            row["ms_kernel_in_place"] = cuda_ms(
                lambda: hp._launch(v2, a2, off, plan, "in_place"), 5)
        row["ms_kernel_transposed"] = cuda_ms(
            lambda: hp._launch(at.T, a, off, plan, "transposed"), 5)
        row["bound_ms"], row["bound_by"] = panel_bound(shape[0] - off, w,
                                                       dtype)
        row["ok"] = equal and kept and took == layout
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"in-place check failed: {row}")
        del H, H2, pf, at, view, v2
        torch.cuda.empty_cache()
    emit({"phase": 23, "launches": _diff(hp.LAUNCHES, l0),
          "variant_launches": _diff(hp.VARIANT_LAUNCHES, v0),
          "layout_launches": _diff(hp.LAYOUT_LAUNCHES, y0)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases",
                    default="0,1,2,3,4,5,6,8,9,10,11,12,13,14,15,16,17,18,19,"
                            "20,21,22,23",
                    help="comma-separated phases to run (0 always runs; 7, "
                         "the section timers, only on request)")
    ap.add_argument("--accuracy-seeds", type=int, default=1,
                    help="problem seeds of phase 8's factor-quality check "
                         "(kernel and plain loop, f32; default 1)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")} | {0}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import dhqr_tpu_torch as dt
        from dhqr_tpu_torch.ops import hopper_panel as hp
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2

    smi = phase_setup()
    stats = phase_kernels(args.seed) if 1 in phases else {}
    paths = {}  # launches per counted path: zeroed before it, read after

    def main_path():
        if 2 in phases:
            phase_square(dt, hp, args.seed)
        if 3 in phases:
            phase_tall(dt, hp, args.seed)
        if 4 in phases:
            phase_complex(dt, hp, args.seed)
        if 5 in phases:
            phase_reference(dt, hp, args.seed)

    def counted(key, drive):
        hp.reset_launches()
        drive()
        paths[key] = dict(hp.LAUNCHES)

    if phases & {2, 3, 4, 5}:
        counted("main", main_path)
    if 6 in phases:
        phase_breakdown(dt, args.seed)
    if 7 in phases:
        phase_kernel_profile(args.seed)
    if 8 in phases:
        counted("precision", lambda: (
            phase_precision_gemms(args.seed),
            phase_precision_qr(dt, hp, args.seed),
            phase_precision_lstsq(dt, args.seed),
            phase_factor_quality(dt, hp, args.seed, args.accuracy_seeds)))
    if 9 in phases:
        counted("tsqr", lambda: phase_engines(dt, hp, args.seed))
    if 10 in phases:
        counted("gradients", lambda: phase_gradients(dt, hp, args.seed))
    if 11 in phases:
        counted("schedules", lambda: phase_schedules(dt, hp, args.seed))
    if 12 in phases:
        counted("reconstruct", lambda: phase_reconstruct(dt, hp, args.seed))
    if 13 in phases:
        counted("sketch", lambda: phase_sketch(dt, args.seed))
    if 14 in phases:
        counted("sharded", lambda: phase_sharded(hp, args.seed, smi))
    if 15 in phases:
        tallies = {}  # each path's launches as its own calls counted them
        counted("guarded", lambda: tallies.update(
            guarded=phase_guarded(dt, hp, args.seed, smi)))
        counted("update", lambda: tallies.update(
            update=phase_update(dt, hp, args.seed, smi)))
        for key, tally in tallies.items():
            if any(paths[key][k] != tally.get(k, 0) for k in paths[key]):
                raise AssertionError(f"the {key} path's count {paths[key]} "
                                     f"is not its calls' {tally}")
    if 16 in phases:
        counted("wire", lambda: phase_wire(hp, args.seed))
    if 17 in phases:
        counted("serve", lambda: phase_serve(dt, hp, args.seed, smi))
    if 18 in phases:
        async_tally = {}
        counted("serve_async", lambda: async_tally.update(
            phase_serve_async(dt, hp, args.seed, smi)))
        if paths["serve_async"] != async_tally:
            raise AssertionError(f"the serve_async path's count "
                                 f"{paths['serve_async']} is not its update "
                                 f"kind's {async_tally}")
    if 19 in phases:
        counted("tune_armor", lambda: phase_tune_armor(dt, hp, args.seed,
                                                        smi))
    if 20 in phases:
        counted("harness", lambda: phase_harness(dt, hp, args.seed, smi))
    if 21 in phases:
        counted("analysis", lambda: phase_analysis(args.seed, smi))
    if 22 in phases:
        counted("graph", lambda: phase_graph(dt, hp, args.seed, smi))
    if 23 in phases:
        phase_in_place(hp, args.seed)
    emit({"launches_by_path": paths})
    # paths with no panel kernel on them
    for key in ("reconstruct", "sketch", "serve"):
        if key in paths and any(paths[key].values()):
            raise AssertionError(f"the {key} path launched a panel kernel: "
                                 f"{paths[key]}")
    kernels = []
    on_paths = ("main", "tsqr", "gradients", "schedules", "sharded",
                "guarded", "wire", "tune_armor", "harness", "graph")
    # the main path's phases that launch each kernel (c64: 4 and 5, f64:
    # 5); f64 must launch there, and runs on the other paths only where
    # they factor a float64 matrix on "auto"
    main_phases = {"panel_qr_f32": {2, 3, 5}, "panel_qr_c64": {4, 5},
                   "panel_qr_f64": {5}}
    for name in hp.KERNELS.values():
        st = stats.get(name, {})
        required = ("main",) if name == "panel_qr_f64" else on_paths + (
            ("update", "serve_async") if name == "panel_qr_f32" else ())
        for key in required:
            if key == "main" and not phases & main_phases[name]:
                continue
            if key in paths and paths[key][name] < 1:
                raise AssertionError(f"{name} never launched on the {key} "
                                     "path")
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {key: c[name] for key, c in paths.items()},
            "max_abs_err": st.get("max_abs_err"), "ms": st.get("ms"),
            "plain_ms": st.get("plain_ms"), "bound_ms": st.get("bound_ms"),
            "bound_by": st.get("bound_by"),
            "library_ms": st.get("library_ms")})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
