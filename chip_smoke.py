"""Smoke run of the PyTorch port (waveform_ot_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line or more each; any failure raises and the exit code
is non-zero:

  1. setup      card name and power limit (the nvidia-smi line, printed as
                it comes), kernel build time, what ptxas reported for the
                kernel's variants (registers, spills);
  2. kernel     the CUDA distance-field kernel against its plain PyTorch
                version on the card, at the main path's five shapes
                (loc64 batch, Ricker, 800x600 fingerprint, one evaluation of
                the 64-start study, the 1,764-node scan), float32 and
                float64, and whether the two are bit for bit identical;
  3. loc64      the headline: batched loc/CMT W2 misfit + gradient w.r.t.
                the source location, 64 stations x 3 components, float32 on
                the card, through exactly one kernel launch, against the same
                problem in float64 on the CPU;
  4. ricker     the Ricker objective in float64 on the card, through exactly
                one kernel launch, against the golden reference values in
                tests_golden_ref.json;
  5. timing     loc64 value+grad in float32 and float64 (host clock, median
                of 20 calls); per shape and dtype the kernel's device time
                (CUDA events around runs of back-to-back launches, see
                device_ms), its bound from the shapes (kernel_bound), its
                share of the bound, the plain version's time, and the
                kernel variant's ptxas line;
  6. multistart the bench's Fig 12 study on 11 stations, float32: 64 random
                starts through minimize_multi_start and through
                minimize_lbfgs_batched_host, every start within 0.1 km of
                the source, one kernel launch per batched evaluation of all
                64 lanes; per study its time, outer iterations, line-search
                trials, evaluations, launches and failed lanes;
  7. scan       the bench's 21x21x4 misfit-surface scan on 11 stations,
                float32: value and gradient at all 1,764 nodes in one call
                through one kernel launch, 8 nodes against float64 on the
                CPU; its time, peak device memory and the kernel's share;
  8. inversion  the Ricker scipy L-BFGS-B inversion in float64 on the card,
                recorded by an InversionTrace: within 0.02 of the truth and
                within 1e-6 of the same inversion on the CPU, in as many
                iterations;
  9. layered    first the stage-A kernel alone (stage_a_phase): at the
                cells' quadrature (Fukuoka, nk 1024, kmax 2.5) and 1, 4 and
                64 sources with the tangent, one launch held against the
                plain _surface_operator on its card inputs (check_stage_a:
                vs and rho bit for bit, the well-conditioned fields within 16
                ulps, the P-SV fields by their error against the recursion in
                long double, at most 4x the plain version's), its device
                time, the plain version's, its bound and share. Then
                the bench's Figs 9-11 physics (build_layered_problem): W2
                misfit + gradient through the six-layer Fukuoka f-k forward,
                11 stations x 3 components, nk 512, float32 on the card,
                through exactly one kernel launch, against float64 on the CPU
                (seismograms within 1e-4 of the peak, value within 1e-3,
                gradient direction cosine > 0.97 and norm ratio in (0.5, 2)),
                and float64 on the card against float64 on the CPU; host-clock
                median of 20 calls. In phases 9-11 every stage-A launch
                outside the timing runs is held the same way (held_stage_a)
                and counted: one per stage-A call, one per batched
                evaluation of the study;
 10. layered_scan  values and (x, y, z) gradients at the 21x21x4 = 1,764
                scan nodes through the layered physics in one call
                (layered_misfit_grid) and one kernel launch; one node per
                depth slice against loc_cmt_value_and_grad of the layered
                forward at that node (f32), and a 4 x 3 sub-grid in f64
                against its nodes alone; time (median of 3), peak memory;
 11. layered_ms the Fig 12 study through the layered physics: 64 starts,
                minimize_lbfgs_batched_host(max_iter 25, tol 1e-4, ls_max 8),
                unchunked; at least 75% of starts within 1 km of the source,
                one kernel launch per batched evaluation; time, iterations,
                evaluations, launches, the share converged, the worst error;
 12. toolbox    the reference's OT and fingerprint toolbox through the port's
                compat layer, float64 (toolbox_phase): the FingerprintLib
                demo's 800x600 fingerprints of a 626-sample receiver function
                and of a delayed copy, and the two 40x120 fingerprints of
                examples/reference_migration.py (each calcpdf in one kernel
                launch, bit for bit the plain field on the card, the CPU's
                pdf within 1e-12; 4 launches on the path, asserted; the
                vertex-NN fields; PDFderivMarg against autograd); between the
                800x600 pair MargWasserstein, SlicedWasserstein (10 slices),
                wasser W12 with plan and plan Jacobian on the time marginals,
                both barypaths and the Gaussian Sinkhorn at 1, 16 and 64 px
                (held by its fixed-point residual at 64 px); on the 40x120 pair
                Sinkhorn_MS and sinkhorn_log (card vs CPU over their first 20
                steps, in full on the card held by their plans' marginals and
                by each other) and the plan Jacobians; that script's n = 10
                flow with its assertions. Every card result against the same
                call on the CPU's inputs and fingerprints (closed forms 1e-9
                relative, Sinkhorns 1e-8); a host-clock median per call; the
                blur's band products against conv1d at 1 and 64 px.
 13. drivers    the reference's two inversion drivers (Ricker_Figs_3_8,
                Figs 9-12) through compat_ricker and compat_loc_cmt, float64,
                NumPy in and out (drivers_phase). 13a, compat_ricker at
                Ricker_Figs_3_8's settings (40x128 grid, lambda 0.03, arctan
                transform, alpha 0.5): one optfunc value+grad on the card
                within 1e-10 of the CPU's, one kernel launch per call, then
                scipy L-BFGS-B from the same x on the card and on the CPU:
                within 0.02 of (0, 1.6, 1), within 1e-6 of each other in as
                many iterations. 13b, compat_loc_cmt at Figs 9-12's width
                (Fukuoka, 11 stations, nt 61, nk 1024, 79x61 windows, Wavg W2,
                lambda 0.04): prop8seis with drv loc, mt and full, cartesian
                and spherical, optfunc_OT and optfunc_L2 at LOC + DM, card
                against CPU; Moment_LS at LOC; a loc-only scipy L-BFGS-B
                inversion from LOC + DM on the card ending within 1 km of LOC.
                Every kernel launch of the phase outside its timing runs
                (the 40x128 and 79x61 single-trace fingerprints) is held bit
                for bit against distance_field_torch on its own card inputs
                (held_launches). Launches per call counted and asserted (0
                per prop8seis, one per trace per optfunc_OT), in the timing
                runs too; a host-clock median per call.
 14. native     the native slice (native_phase). 14a, the fast-marching
                route at the FingerprintLib demo's full size (626-sample RF,
                800x600, lambda 0.04): calcpdf(method="FMM") on the card (0
                launches; the field is host C++) against calcpdf(Enumerate)
                (1 launch), median and max |d| over the band d > 2/nu bound
                at twice the CPU's reading, the FMM pdf within 1e-12 of the
                CPU object's, calcFMM_dist_deriv's ray end points finite.
                14b, the POT bridges on 12x16 migration fingerprints (192
                points): wasserPOT W2 and W1 against the LP oracle solved to
                feasibility 1e-10 (1e-9 relative) and against Wasser_LinProg
                at HiGHS's defaults (1e-6), W2 on two 200-point 1-D densities
                against the closed-form wasser (1e-9), sinkhornPOT at three
                gammas card vs CPU (1e-10) with its gap to the EMD falling.
                14c, the zoom L-BFGS: minimize_lbfgs on the Ricker inversion
                (examples/ricker_inversion.py:49-53, phase 8's problem, f64,
                max_iter 100) within 0.02 of the truth, and its first 20
                iterations on the card within 1e-6 of the CPU's in as many
                calls (ZOOM_RICKER_HELD says why not all 100); the 64-start far-field
                study (11 stations, f32, max_iter 30, tol 3e-5) through
                minimize_multi_start(method="zoom"), every start within 0.1 km,
                its time beside phase 6's "batched" one. Each zoom trial is
                one batched value+grad call and one launch, asserted. 14d,
                utils.profiling.top_device_ops on loc64 f32, value+grad
                (the kernel traced, its rank printed) and value alone (the
                kernel among the top five). Every launch outside the timing
                runs is held bit for bit (held_launches); host-clock medians
                per call.
 15. parallel   the parallel layer (parallel_phase): waveform_ot_torch.parallel
                and the two sharded inversion entry points on the mesh of the
                visible cards and on 4 shards of cuda:0 (a (2, 2) mesh for
                dp x sp): trace-sharded loc64 value+grad (f32, f64) through
                pjit_batched_misfit; phase 7's 1,764 nodes through
                misfit_grid_sharded (peak memory); phase 6's 64 starts through
                minimize_multi_start_sharded (every start within 0.1 km,
                evaluations per shard); phase 12's 800x600 RF through
                grid_sharded_marg_misfit and grid_sharded_density (f64); two
                delayed RFs through dp_sp_marg_misfit; phase 9's layered
                problem at 12 stations (f32, f64). Each against the same call
                unsharded on the card (f64 1e-12 / 1e-11 of max |g|, layered
                1e-9; f32 the card-vs-CPU bars above), one kernel launch per
                shard per evaluation (asserted), every launch outside the
                timing runs held bit for bit (held_launches); host-clock
                medians of 3, unsharded and per mesh.
 16. examples   the port's nine example scripts (examples/torch_*.py;
                examples_phase), each through its run() at the script's
                defaults on the card, ricker_inversion also with zoom=True,
                and multi_start_basins's joint far-field mode (cmt=True,
                physics="farfield") through its build_study and solve cut to
                EXAMPLE_CMT_ITERS iterations: each script's own assertions;
                its kernel launches
                counted and asserted (one per objective evaluation, per
                surface or profile, per scan call; none for the point masses
                or the least-squares moment tensors); every launch outside
                the scaling study's timing runs held bit for bit
                (held_launches); the point masses, the migration self-test,
                the derivative walkthrough, the Ricker scipy inversion and the
                receiver function's fields held against the same run on the
                CPU (1e-9 relative; the same iterations and 1e-6; phase 14a's
                bars); each script's host wall time; the scaling study's
                value+grad time and traces/s at 64, 256 and 1,024 stations,
                and the kernel at loc1024's 3,072 traces (bit for bit, device
                time, bound, share).
 17. entry      the system's own entry points (entry_phase), the port's
                __graft_entry__ (waveform_ot_torch.entry): entry() at JAX's
                sizes (4 stations, nt 61, nk 96, f32) in one kernel launch
                against the same call in float64 on the CPU (the layered f32
                bars), its host ms; dryrun_multichip(4) and (8) on shards of
                the card, each step against the same call on the CPU (f32),
                one launch per shard per step; the trace-sharded Adam step at
                loc64 width and the station-sharded layered Adam step at 12
                stations, nk 512, unsharded, on the mesh of the visible cards
                and on 4 shards, each against the unsharded step: ms per step,
                launches, m1, peak memory. Every launch outside the timing
                runs held bit for bit (held_launches).
 18. bench      the port's benchmark program (bench_phase): python -m
                waveform_ot_torch.bench, bench.py's ten stages at its
                accelerator repeat counts, each in a process of its own; its
                stderr echoed under [bench]; its last line held to bench.py's
                schema and metric strings, every status "ok", every value
                finite, f32dev (loc16 f32 on the card against f64 on the CPU)
                within phase 3's bars, and each stage's kernel launches 1 per
                call, 1 per batched evaluation of the two studies.
 19. surface    the names the port binds as the JAX package does
                (surface_phase; tests/test_torch_surface.py holds the whole
                public surface on the CPU): ops.wasser, the function, on the
                800x600 RF marginals and their copy delayed 0.01 s (float64,
                one launch for both fingerprints), W1/W2/W12 within 1e-12 of
                the same call on the CPU; top_device_ops on loc64 f32
                value+grad with trace_dir, its trace file left there and
                naming the kernel, the kernel in its ranking (2 launches);
                save_checkpoint(pytree=...)/restore_checkpoint of CUDA
                tensors, bit for bit on their device. Every launch held bit
                for bit (held_launches).

In phases 13-17 and 19 held_launches holds every stage-A launch as phases
9-11 do, and every stage-A launch the phase counts must have been held or
recorded by a CUDA graph capture; phase 18's bench runs in processes of its
own, where nothing is held. The line before the last is the kernels'
JSON record (the distance field, then the stage-A kernel); the last line is
{"ok": true, "device": {...}}. Without a CUDA card it exits non-zero before
printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from waveform_ot_torch.bench import STAGES as BENCH_STAGES
from waveform_ot_torch.bench import layered_scan_axes as scan_axes
from waveform_ot_torch.bench import scan_nodes
from waveform_ot_torch.entry import LOC, NT
from waveform_ot_torch.utils.profiling import device_ms, events_ms, host_median_ms

REPO = Path(__file__).resolve().parent
DM = (4.0, -3.0, 2.0)           # the bench's evaluation point is LOC + DM
N_TIMED = 20
TOL = {torch.float64: 1e-12, torch.float32: 1e-6}
VALUE_RTOL_F32 = 1e-4            # loc64 f32 on the card vs f64 on the CPU
GRAD_TOL_F32 = 1e-3              # ... in units of max |g|
RICKER_W2_TOL = 1e-8             # the JAX package's golden bars
RICKER_GRAD_TOL = 5e-7
BACK_TO_BACK = 50                # kernel launches per timed run
SAMPLES = 5                      # timed runs; their median is reported
PLAIN_BACK_TO_BACK = 5           # plain-version calls per timed run (~100s of launches each)
# the scan's kernel takes ~10 ms and its plain version ~10^5 small launches:
# fewer kernel launches per run, and the plain version once, by one event pair
BACK_TO_BACK_BY_SHAPE = {"scan": 5}
PLAIN_ONCE = {"scan"}
NR_STUDY = 11                    # stations of the bench's scan and multistart
N_STARTS = 64
STUDY_RADIUS_KM = 0.1            # every start must end this close to LOC
LAYERED_NK, LAYERED_KMAX = 512, 2.0
SEIS_TOL_F32 = 1e-4              # layered f32 on the card vs f64 on the CPU, of the peak
LAYERED_VALUE_RTOL_F32 = 1e-3
GRAD_COS_F32 = 0.97              # the JAX package's f32 gradient contract
# Float64 on the card vs float64 on the CPU. On the omega = 0 lane the stack
# algebra cancels digits (tests/test_torch_layered.py): both packages carry
# ~6e-8 relative error there at a 12 km source, and another order of rounding
# (the card's FMA, exp and division) moves the result by as much: measured
# 1.6e-8 (seismograms), 4.4e-8 (value), 1.3e-7 (gradient) at LOC + DM.
SEIS_TOL_F64 = VALUE_RTOL_F64 = GRAD_TOL_F64 = 1e-6
# a scan node against the same node alone: f32 (the f32 noise of two orders of
# summation; gradients at the f32 bar of every other check), and f64 on a
# 4 x 3 sub-grid, where only the order of the sums differs
SCAN_VALUE_RTOL_F32, SCAN_GRAD_TOL_F32 = 1e-5, GRAD_TOL_F32
SCAN_TOL_F64 = 1e-10
LAYERED_MS_RADIUS_KM = 1.0
LAYERED_MS_SHARE = 0.75          # the bench's bar: this share of starts within 1 km
STUDY_TIMED = 3                  # study and scan timings: median of 3
KERNEL_NAME = "distance_field_kernel"  # the kernel's symbol, as ptxas and the profiler name it
SCAN_CHECKED = 8                 # scan nodes held against float64 on the CPU
RICKER_TRUTH = (0.0, 1.6, 1.0)
RICKER_TRUTH_TOL = 0.02          # inversion result against the truth
RICKER_X_TOL = 1e-6              # card inversion against the CPU one
# The bound counts the operations these inputs need, against the H100 SXM's
# peaks outside the tensor cores at a 700 W limit, and each input read once and
# each output written once against HBM3. bx = px - x0x and bx*cx depend only on
# the grid column and the segment, by = py - x0y and by*cy only on the row and
# the segment: 2 operations per (column, segment) and per (row, segment) pair.
# Each point-segment pair then needs 12: 1 add for b.c, 1 scale by 1/|c|^2, 2
# for the clip, 4 for dx and dy, 3 for dsq, 1 compare. The per-segment 1/|c|^2
# and the per-point sqrt are left out (under 0.1% at every shape here).
OPS_PER_PAIR = 12
OPS_PER_LINE = 2
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12
# phase 12: FingerprintLib's self-demo (examples/receiver_function_demo.py:35-45)
RF_NT, RF_NU, RF_NTG, RF_LAMBDA = 626, 800, 600, 0.04
RF_SHIFT = 0.01                  # s: the predicted RF is the observed one delayed
TOOLBOX_NPROJ = 10               # the reference's _checkderivSliced default
BARY_NPOINTS = 50000
SINKHORN_ITERS = 250             # the reference Sinkhorn's default
# Gaussian Sinkhorn's sigma in pixels. No reference flow sets one for an
# 800x600 grid: the reference default gamma 0.005 is an identity blur, and the
# repo's tests use 1 px (tests/test_parity_reference.py:506). 64 px is a
# stand-in at which the reference's 250 steps reach the fixed point; the phase
# runs and prints every sigma of SINKHORN_SIGMAS, holds the fixed point at
# SINKHORN_SIGMA_PX only, and times the call at 1 px and at SINKHORN_SIGMA_PX.
SINKHORN_SIGMA_PX = 64.0
SINKHORN_SIGMAS = (1.0, 16.0, SINKHORN_SIGMA_PX)
SINKHORN_RESIDUAL = 1e-4         # max |v K(w) - mu0| / max mu0 after the steps
SINKHORN_LAST_HALF_STEP = 1e-12  # max |w K(v) - mu1| / max mu1: w's own update
# The 4,800-point Sinkhorns are held card vs CPU over their first steps (a
# step is the same arithmetic at every count) and run in full on the card
# only. There the plan's marginal that the last half step sets must hold to
# 1e-12; Sinkhorn_MS's other marginal (the fixed point, 3.6e-6 in a float64
# CPU run of the same call) to DENSE_RESIDUAL; sinkhorn_log, 500 steps short of
# its fixed point (2.6e-2), must equal Sinkhorn_MS stopped at 500 steps, the
# same iteration in scaling form.
SINKHORN_PREFIX = 20
DENSE_RESIDUAL = 1e-4
TOOLBOX_LAUNCHES = 4             # one per calcpdf(Enumerate): 2 RF, 2 migration
MIG_SEED, MIG_N = 61254557, 10   # examples/reference_migration.py:31-33
CLOSED_RTOL = 1e-9               # card vs CPU, closed forms (scatter order differs)
ITERATED_RTOL = 1e-8             # card vs CPU, the iterated Sinkhorns
PDF_ATOL = 1e-12                 # calcpdf's pdf, card vs CPU
# calcpdf's grid positions (within [0, 1]), card vs CPU: the card divides by a
# host scalar as a product with its reciprocal, so linspace's i / (n - 1)
# parts from the CPU's by an ulp at some points
POS_ATOL = 1e-15
CHAIN_RTOL = 1e-8                # PDFderivMarg vs autograd
TOOLBOX_TIMED = 5                # host-clock median of 5 (Sinkhorns: 3)
# phase 13: the reference's two inversion workflows through compat_ricker and
# compat_loc_cmt. 13a at Ricker_Figs_3_8's settings (tests/test_compat_l3.py:84-96)
DRIVER_RICKER_GRID = (-2.0, 7.0, -2.0, 2.6, 40, 128)
DRIVER_RICKER_TRANGE = (-2.0, 7.0)
DRIVER_RICKER_LAMBDA = 0.03
DRIVER_RICKER_X = (0.25, 1.45, 1.08)
DRIVER_RICKER_ATOL = 1e-10     # one optfunc value and gradient, card vs CPU
# 13b at Figs 9-12's width: Fukuoka, NR_STUDY stations on the 60 km circle, nt 61,
# compat's quadrature defaults (nk 1024, kmax 2.5); strike/dip/rake 30/60/45 and
# the M0 5e6 of build_layered_problem, given in Nm as prop8data wants it
DRIVER_SDRM = (30.0, 60.0, 45.0, 5.0e6 / 1.0e-13)
DRIVER_LAMBDA = 0.04
# Card vs CPU of compat_loc_cmt's seismograms, Jacobian channels, misfits and
# gradients. The omega = 0 lane of the stack recursion (the note above
# SEIS_TOL_F64) moves float64 results by ~1e-8 between the card and the CPU, so
# the bars are phase 9's f64 ones and not the 1e-9 of the CPU parity tests,
# which hold JAX and the port at a damping where the lane is well conditioned.
DRIVER_F64_TOL = SEIS_TOL_F64
DRIVER_MLS_RTOL = 1e-6         # Moment_LS at the source of noiseless data
DRIVER_LOC_KM = 1.0            # the loc-only scipy inversion's end point
DRIVER_TIMED = 5               # host-clock median of 5 per call
# phase 14: the native slice. The fast-marching field is host code, so its
# bars are twice what the same comparison gives on the CPU (800x600 RF
# fingerprint, band d > 2/nu: median 3.5103e-4, max 1.6140e-3)
FMM_MEDIAN_BOUND = 2 * 3.5103e-4
FMM_MAX_BOUND = 2 * 1.6140e-3
NATIVE_TIMED = 5               # host-clock median of 5 per call
POT_GRID = (12, 16)            # the 2-D EMD pair: 192 points each
POT_1D = 200                   # points of the 1-D EMD pair
POT_RTOL = 1e-9                # EMD against the LP oracle and the closed form
LP_FEASIBILITY = 1e-10         # HiGHS primal/dual tolerances of the tight LP oracle
LINPROG_DEFAULT_RTOL = 1e-6    # Wasser_LinProg at HiGHS's default tolerances
SINKHORN_POT_GAMMAS = (3e-2, 1e-2, 3e-3)
SINKHORN_POT_RTOL = 1e-10      # sinkhornPOT card vs CPU
ZOOM_RICKER_ITERS = 100        # examples/ricker_inversion.py:49-53
# card vs CPU over the zoom's first iterations: the solve reaches the
# objective's noise floor by iteration ~10-20 (|g| ~3e-6 against tol 1e-8)
# and wanders there until max_iter; beyond ~25 iterations last-bit
# differences change its line-search decisions (a 1e-15 relative change of
# the objective: the same 131 calls and x within 1.6e-12 at 20 iterations,
# 220 against 254 calls at 30), and two card runs of the full solve made
# 982 and 1,163 calls
ZOOM_RICKER_HELD = 20
TOP_OPS = 5
ALL_OPS = 1000                 # more than any call here has
# phase 15: the parallel layer on a mesh of the visible cards and on PAR_SHARDS
# shards of cuda:0
PAR_SHARDS = 4
PAR_NR_LAYERED = 12            # stations of the station-sharded layered case (see parallel_phase)
PAR_VALUE_RTOL_F64 = 1e-12     # sharded vs unsharded on the card, float64
PAR_GRAD_TOL_F64 = 1e-11       # ... of max |g|
PAR_LAYERED_TOL_F64 = 1e-9     # JAX's station-sharded contract (tests/test_parallel.py:411-431)
PAR_DP_SP_SHIFTS = (RF_SHIFT, -RF_SHIFT)
PAR_TIMED = 3                  # host-clock median of 3 per call
# phase 16: the port's example scripts (examples/torch_*.py) at their defaults.
# Launches per run where they do not depend on the data: derivative
# walkthrough, stage 1 one gradient and 4 x 2 central differences, stage 2 the
# observed fingerprint, one gradient and 3 x 2, stage 3 one gradient and 3 x 2;
# misfit surfaces, the observed fingerprint, the W1 and W2 profiles, the W2
# surface twice (its timing) and the W1 surface
EXAMPLE_FIXED_LAUNCHES = {"point_mass_demo": 0, "reference_migration": 2,
                          "derivative_walkthrough": 9 + 8 + 7,
                          "ricker_misfit_surfaces": 1 + 2 + 3, "receiver_function_demo": 1}
# the joint far-field study (multi_start_basins --cmt --physics farfield) at its
# default 600 iterations made 3,919 OT evaluations on an H100: 25.0 s of runs and
# ~80 s of held checks (PERF.md), past the phase's budget alone; phase 16 runs
# it through the script's build_study and solve at this many
EXAMPLE_CMT_ITERS = 100
SCALING_SIZES = (64, 256, 1024)   # stations of the scaling study's timings
# per size: the observed fingerprints, benchmark's 2 warm-up and 30 timed calls, one more
SCALING_CALLS = 1 + 2 + 30 + 1
# phase 17: the system's own entry points (waveform_ot_torch.entry)
ENTRY_DRYRUN_SHARDS = (4, 8)   # dryrun_multichip's meshes, shards of the one card
ENTRY_STEP_KEYS = {"trace_sharded": "grad", "seq_parallel": "grad_verts", "dp_sp": "grad",
                   "layered": "grad"}
# phase 18: the port's bench program (python -m waveform_ot_torch.bench), its
# line's metric strings as bench.py's _emit writes them (bench.py:537-560)
BENCH_HEADLINE = "batched W2 misfit+grad, 64 stations x 3 comps"
BENCH_METRICS = [
    "ricker objective 80x512 misfit+grad",
    "batched W2 misfit+grad, 1024 stations x 3 comps",
    "throughput at 1024x3",
    "misfit grid scan 21x21x4 (1764 nodes), 11 stations x 3 comps",
    "64-start repeat inversion study, on-device LBFGS",
    "fingerprint density 800x600 grid, 625 segments (w/ deriv precompute)",
    "layered-physics W2 misfit+grad (6-layer Fukuoka f-k), 11 stations x 3 comps "
    "[vs own f64 CPU 1-core oracle]",
    "LAYERED misfit grid scan 21x21x4 (1764 nodes), depth-amortized stage A "
    "[vs own f64 CPU 1-core oracle]",
    "LAYERED 64-start repeat study, on-device LBFGS [vs own f64 CPU 1-core oracle x ref nfev]",
    "f32 vs f64 relative deviation (value)",
    "f32 vs f64 relative deviation (grad, max)",
]
BENCH_STUDIES = {"multistart", "layered_ms"}   # 1 launch per batched evaluation; others per call
BENCH_BUDGET_S = 600           # the bench's own budget (WOT_BENCH_BUDGET_S) in this phase
BENCH_TIMEOUT_S = 660
SURFACE_RTOL = 1e-12           # ops.wasser on the card vs the CPU, relative
SURFACE_TIMED = 5
# Adam's first step moves each coordinate by about lr: card and CPU (f32 both)
# part by rounding only, unless a gradient component is near 0, which none of
# these is (the smallest is ~5% of the largest)
ENTRY_M1_RTOL = 1e-5
# the stage-A kernel (csrc/surface_operator.cu, through layered._KernelStageA,
# its one caller): every launch is held against the plain _surface_operator on
# the same card inputs at tests/test_torch_stage_a.py's bars. The source
# layer's vs and rho bit for bit; the well-conditioned fields (ga, gb, chi, the
# SH scalars and their tangents) within STAGE_A_ULPS of each field's largest
# entry; the P-SV fields (W2, RA2, RB2, inner2 and their tangents), which the
# low-frequency lanes' recursion parts from the exact answer by as much in both
# versions, by their error against the recursion in long double
# (tests/ld_surface.py): at most STAGE_A_ACCURACY times the plain version's
# own, plus 64 ulps, per lane, over all its wavenumbers (a lane's largest error
# over a sample of them is too noisy for the bar: up to 5.4x at every 16th in a
# host build of the kernel, against 2.1x over all). The long-double recursion
# takes ~1.5 s per source at nk 1024 on the host, and the examples and drivers
# make hundreds of launches, so it holds one source of a launch, in turn: the
# first STAGE_A_LD_FIRST launches of each (phase, K, nf, nk, tangent) and every
# STAGE_A_LD_EVERY-th after. Every launch gets the other checks.
STAGE_A_ULPS = 16
STAGE_A_ACCURACY = 4.0
STAGE_A_LD_FIRST, STAGE_A_LD_EVERY = 4, 16
STAGE_A_SMOOTH = ("ga", "gb", "chi", "Wsh", "RAsh", "RBsh", "innersh")
STAGE_A_PSV = ("W2", "RA2", "RB2", "inner2")
# the kernel timed at the cells' quadrature (otbench/configs/fukuoka11.json) and
# the main path's source counts: one (the single-model calls), 4 (the scan's
# depths), 64 (the batched study's lanes), with the tangent
STAGE_A_NK, STAGE_A_KMAX = 1024, 2.5
STAGE_A_SOURCES = {"calls": 1, "scan": 4, "study": 64}
# The bound counts the kernel's float64 operations per point at the peak the
# distance field's bound takes (PEAK_OPS), and the outputs written once at
# HBM3's rate (the inputs are a few kB). Operations, counted from the source
# with a complex add as 2, a complex product as 6 and Smith's quotient as 10
# (a real division, sqrt, exp, sin and cos as 1 each): a layer's material 31,
# an interface (two layers' blocks, the P-SV and SH R/T and their compositions
# into a stack) 1,878, a layer phase 134, the receiver map 751, the tangent
# 416, and 6 for omega^2. Each point evaluates 2 nlay + 2 layers, every
# interface once and about nlay phases (one fewer where a source sits on an
# interface or at the surface).
STAGE_A_OPS = {"layer": 31, "interface": 1878, "phase": 134, "receiver": 751,
               "tangent": 416, "omega": 6}
STAGE_A_BYTES = {False: 368, True: 688}    # outputs per point, without and with the tangent
STAGE_A_HELD: dict = {}                    # stage-A launches held, by phase


def build_loc64_problem(nr: int, dtype, device):
    """The bench's loc/CMT problem, ``waveform_ot_torch.entry._build_problem``
    (``__graft_entry__._build_problem``): nr stations on a 60 km circle,
    source at LOC, strike/dip/rake 30/60/45 with M0 5e6, noise 0.002*max|s|
    from numpy default_rng(0), 79x61 grids, lambda 0.04, W2. Returns (loc,
    cfg, prob)."""
    from waveform_ot_torch.entry import _build_problem

    return _build_problem(nr, dtype, device)


def build_layered_problem(dtype, device, nr: int = NR_STUDY):
    """The bench's Figs 9-11 problem (``bench._build_layered_problem``),
    ``waveform_ot_torch.entry._build_layered_problem`` at the bench's nk 512:
    the six-layer Fukuoka model, nr stations on a 60 km circle, nt 61, dt 1,
    nk 512, kmax 2.0, source at LOC with strike/dip/rake 30/60/45 and M0
    5e6, observed data from the layered forward plus 0.002*max|s| noise from
    numpy default_rng(0), 79x61 grids, lambda 0.04, W2. Returns (loc, cfg,
    prob, forward, stages)."""
    from waveform_ot_torch.entry import _build_layered_problem
    from waveform_ot_torch.models import fukuoka_model, make_layered_stages

    model = fukuoka_model(device=device)
    kw = dict(nk=LAYERED_NK, kmax=LAYERED_KMAX)
    return (*_build_layered_problem(nr, model=model, dtype=dtype, device=device, **kw),
            make_layered_stages(model=model, nt=NT, dt=1.0, **kw))


def build_ricker_problem(golden: dict, dtype, device):
    """The Ricker_Figs_3_8 problem from the golden observed waveform:
    80x512 grid, arctan transform, W2, alpha 0.5. Returns (prob, cfg)."""
    from waveform_ot_torch.inversion import (
        TraceConfig, build_target, grid6_to_window, make_ricker_problem,
    )

    gd = golden["ricker_full"]
    win, spec = grid6_to_window(gd["grid"], dtype=dtype, device=device)
    cfg = TraceConfig(nu=spec.nu, ntg=spec.ntg, lambdav=gd["lambdav"], q=None,
                      p=2, transform=True)
    arr = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    with torch.no_grad():
        targets = build_target(arr(gd["tobs"]), arr(gd["wobs"])[None], win, cfg)
    prob, cfg = make_ricker_problem(targets, gd["grid"], trange=(-2.0, 7.0),
                                    alpha=0.5, lambdav=gd["lambdav"])
    return prob, cfg


def study_starts(dtype, device) -> torch.Tensor:
    """The bench's 64 multistart starts: LOC + uniform(-15, 15) km from
    numpy default_rng(1)."""
    rng = np.random.default_rng(1)
    return torch.as_tensor(np.asarray(LOC) + rng.uniform(-15, 15, size=(N_STARTS, 3)),
                           dtype=dtype, device=device)


def build_ricker_inversion(dtype, device):
    """The bench's Ricker inversion (``bench.bench_ricker``), which is
    examples/torch_ricker_inversion.py's problem: observed double Ricker at
    the truth plus 0.005*max|w| noise from numpy default_rng(42), grid6
    (-2, 7, -2, 2.6, 80, 512), lambda 0.03, alpha 0.5. Returns (prob, cfg,
    start)."""
    return example("ricker_inversion").build_problem(device, dtype=dtype)


def rf_waveform(shift: float = 0.0):
    """FingerprintLib's synthetic receiver function, 2 sin(6 pi t) -
    3 cos(2 pi (2t + 0.3)) on RF_NT samples of [0, 1], delayed by ``shift`` s."""
    t = np.linspace(0.0, 1.0, RF_NT)
    s = t - shift
    return t, 2 * np.sin(s * 6 * np.pi) - 3 * np.cos((2 * s + 0.30) * 2 * np.pi)


def rf_grid6():
    """The demo's (t0, t1, u0, u1, nu, ntg): the time span, the observed RF's
    amplitude range padded by 15% of itself on both sides, the 800x600 grid."""
    t, rf = rf_waveform()
    du = rf.max() - rf.min()
    return (t[0], t[-1], rf.min() - 0.15 * du, rf.max() + 0.15 * du, RF_NU, RF_NTG)


def migration_waveforms():
    """examples/reference_migration.py:70-73: (t, predicted, observed, grid6)
    of the 40x120 fingerprint flow."""
    t = np.linspace(0.0, 6.0, 120)
    return (t, np.sin(3 * (t - 0.15)) * np.exp(-0.3 * t), np.sin(3 * t) * np.exp(-0.3 * t),
            (t[0], t[-1], -1.4, 1.4, 40, len(t)))


def fingerprint_pdfs(t, waves, grid, lambdav, device, deriv=False):
    """compat.waveformFP objects of each waveform, calcpdf'd (Enumerate)."""
    from waveform_ot_torch import compat

    out = []
    for w in waves:
        wf = compat.waveformFP(t, w, grid, device=device)
        wf.calcpdf(lambdav=lambdav, method="Enumerate", deriv=deriv)
        out.append(wf)
    return out


def conv_blur(image, sigma):
    """The zero-padded Gaussian blur of a 2-D image as two conv1d calls (one
    per axis), the plain alternative to the port's band-matrix products."""
    from waveform_ot_torch.ops.sinkhorn import _gaussian_kernel_1d

    k = _gaussian_kernel_1d(sigma, image.device)[None, None]
    r = (k.shape[-1] - 1) // 2
    rows = torch.nn.functional.conv1d(image[:, None], k, padding=r)[:, 0]
    return torch.nn.functional.conv1d(rows.T.contiguous()[:, None], k, padding=r)[:, 0].T


def _field_inputs(t, w, win, spec):
    """(verts, tgrid, ugrid), contiguous, as fingerprint_density forms them."""
    from waveform_ot_torch.ops.fingerprint import grid_axes, normalize_vertices

    verts = normalize_vertices(t, w, win)
    tg, ug = grid_axes(t, win, spec)
    bsz = verts.shape[0]
    return (verts.contiguous(), tg.expand(bsz, spec.ntg).contiguous(),
            ug.expand(bsz, spec.nu).contiguous())


def loc_field_inputs(ms, prob, cfg, forward=None):
    """The distance-field inputs of one loc/CMT evaluation of the models
    ``ms`` (k, 3) through ``forward`` (the far-field default or the layered
    physics): k*nr*3 traces, as misfit_from_seis forms them."""
    from waveform_ot_torch.inversion import InvOptions
    from waveform_ot_torch.inversion.loc_cmt import (
        _flat_unit_windows, predicted_seismograms,
    )
    from waveform_ot_torch.ops import arctan_transform

    s = predicted_seismograms(ms, prob, InvOptions(), forward=forward)
    k, nr, nc, nt = s.shape
    un = arctan_transform(s, prob.windows.u0[..., None], prob.windows.u1[..., None])
    return _field_inputs(prob.t, un.reshape(k * nr * nc, nt),
                         _flat_unit_windows(prob.windows, nr, nc, k), cfg.spec)


def main_path_shapes(dtype, device, golden):
    """The distance-field inputs of the main path: {name: (verts, tgrid, ugrid)}."""
    from waveform_ot_torch.inversion import apply_transform
    from waveform_ot_torch.models import ricker_wavelet
    from waveform_ot_torch.ops import FingerprintSpec, make_window

    with torch.no_grad():
        loc, cfg, prob = build_loc64_problem(64, dtype, device)
        loc64 = loc_field_inputs((loc + torch.tensor(DM, dtype=dtype, device=device))[None],
                                 prob, cfg)
        _, cfg11, prob11 = build_loc64_problem(NR_STUDY, dtype, device)
        multistart = loc_field_inputs(study_starts(dtype, device), prob11, cfg11)
        scan = loc_field_inputs(scan_nodes(dtype, device), prob11, cfg11)
        lloc, lcfg, lprob, lfwd, _ = build_layered_problem(dtype, device)
        layered = loc_field_inputs((lloc + torch.tensor(DM, dtype=dtype, device=device))[None],
                                   lprob, lcfg, forward=lfwd)

        rprob, rcfg = build_ricker_problem(golden, dtype, device)
        m = torch.tensor([0.5, 1.2, 1.1], dtype=dtype, device=device)
        t, w = ricker_wavelet(m[0], m[1], m[2], trange=rprob.trange)
        wn, win01 = apply_transform(w[None], rprob.window, rcfg)
        ricker = _field_inputs(t, wn, win01, rcfg.spec)

        # FingerprintLib's demo at full scale: 626 samples, 800x600 grid
        tb, wb = (torch.as_tensor(a, dtype=dtype, device=device) for a in rf_waveform())
        t0, t1, u0, u1, nu, ntg = rf_grid6()
        bwin = make_window(t0, t1, u0, u1, dtype=dtype, device=device)
        bigfp = _field_inputs(tb, wb[None], bwin, FingerprintSpec(nu=nu, ntg=ntg))
    return {"loc64": loc64, "ricker": ricker, "bigfp": bigfp,
            "multistart": multistart, "scan": scan, "layered": layered}


def compare_fields(got, ref, tol: float) -> dict:
    """The kernel's bars: d to rtol ``tol``; winners differ only at exact
    ties; lam and dvec within ``tol`` where the winners agree."""
    err_d = (got.d - ref.d).abs()
    if not bool((err_d <= tol * ref.d.abs() + 1e-30).all()):
        raise AssertionError(f"d differs: max abs {err_d.max().item():.3e}")
    same = got.iclose == ref.iclose
    tie_err = torch.where(same, 0.0, err_d).max().item()
    if tie_err > tol * max(1.0, ref.d.abs().max().item()):
        raise AssertionError(f"winners differ away from ties ({tie_err:.3e})")
    lam_err = torch.where(same, (got.lam - ref.lam).abs(), 0.0).max().item()
    dvec_err = torch.where(same[..., None], (got.dvec - ref.dvec).abs(), 0.0).max().item()
    if lam_err > tol or dvec_err > tol:
        raise AssertionError(f"lam/dvec differ where winners agree: {lam_err:.3e} {dvec_err:.3e}")
    return {"max_abs_err_d": err_d.max().item(), "tie_flips": int((~same).sum()),
            "lam_err": lam_err, "dvec_err": dvec_err}


def kernel_bound(verts, tgrid, ugrid) -> tuple[float, str]:
    """(least time in ms, "operations" or "bytes") for the distance field of
    these inputs on the card: OPS_PER_PAIR per point-segment pair and
    OPS_PER_LINE per grid row or column and segment at the dtype's peak, or
    the inputs read once and d, iclose, lam, dvec written once at the HBM
    rate, whichever is longer."""
    bsz, nt = verts.shape[:2]
    ntg, nu = tgrid.shape[1], ugrid.shape[1]
    npts = bsz * ntg * nu
    es = verts.element_size()
    ops = bsz * (nt - 1) * (OPS_PER_PAIR * nu * ntg + OPS_PER_LINE * (nu + ntg))
    ops_ms = ops / PEAK_OPS[verts.dtype] * 1e3
    nbytes = es * (verts.numel() + tgrid.numel() + ugrid.numel()) + npts * (4 * es + 4)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def stage_a_bound(nsrc: int, nf: int, nk: int, nlay: int, tangent: bool) -> tuple[float, str]:
    """(least time in ms, "operations" or "bytes") for one launch of the
    stage-A kernel on these sizes: STAGE_A_OPS per point at the float64
    peak, or the outputs written once at the HBM rate, whichever is
    longer."""
    o = STAGE_A_OPS
    per_point = (o["omega"] + (2 * nlay + 2) * o["layer"] + (nlay - 1) * o["interface"]
                 + nlay * o["phase"] + o["receiver"] + (o["tangent"] if tangent else 0))
    points = nsrc * nf * nk
    ops_ms = points * per_point / PEAK_OPS[torch.float64] * 1e3
    bytes_ms = points * STAGE_A_BYTES[bool(tangent)] / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def check_stage_a(out, z, model, grid, free_surface, tangent,
                  turn: int | None) -> tuple[float, float]:
    """One launch of the stage-A kernel (``out``, the fields in
    ``_KernelStageA.forward``'s order) held against the plain
    ``_surface_operator`` on the same card inputs at the bars above the
    STAGE_A_ constants: every field finite, vs and rho bit for bit, the
    well-conditioned fields in ulps, and, unless ``turn`` is None, the P-SV
    fields of source ``turn`` mod K against the long-double recursion.
    Raises, else returns (the well-conditioned fields' largest deviation in
    ulps, the P-SV fields' largest error over the plain version's, per
    lane, or 0.0 unchecked)."""
    import ld_surface
    from waveform_ot_torch.models import layered as TL

    names = TL._Reverb._fields + TL._SourceLayer._fields
    names += tuple("d" + n for n in TL._Reverb._fields) if tangent else ()
    got = dict(zip(names, out))
    with torch.no_grad():
        op, dop = TL._surface_operator(model, z, grid, free_surface, tangent)
    want = dict(zip(TL._Reverb._fields, op.rev))
    want.update(zip(TL._SourceLayer._fields, op.src))
    want.update(("d" + n, v) for n, v in zip(TL._Reverb._fields, dop or ()))
    want = {n: w.expand(got[n].shape) for n, w in want.items()}
    eps = torch.finfo(torch.float64).eps
    for n, v in got.items():
        if not bool(torch.isfinite(torch.view_as_real(v) if v.is_complex() else v).all()):
            raise AssertionError(f"stage A: the kernel's {n} is not finite")
    for n in ("vs", "rho"):
        if not torch.equal(got[n], want[n]):
            raise AssertionError(f"stage A: the kernel's {n} differs from the plain version's")
    smooth = STAGE_A_SMOOTH + (("dWsh", "dRAsh", "dRBsh") if tangent else ())
    scales = {n: want[n].abs().max() for n in smooth}
    if tangent:   # d(innersh)/dz is 0 in exact arithmetic: the scale of its terms
        scales["dinnersh"] = (want["innersh"].abs() ** 2
                              * (want["dRAsh"] * want["RBsh"]).abs()).max()
    worst = 0.0
    for n, scale in scales.items():
        u = ((got[n] - want[n]).abs().max() / (scale * eps)).item() if scale > 0 else 0.0
        if not u <= STAGE_A_ULPS:
            raise AssertionError(f"stage A: the kernel's {n} is {u:.1f} ulps of its largest "
                                 f"entry from the plain version's (bound {STAGE_A_ULPS})")
        worst = max(worst, u)
    ratio = 0.0
    if turn is None:
        return worst, ratio
    j = turn % z.shape[0]
    exact = ld_surface.surface_operator(
        model, np.longdouble(z[j].item()), grid.k.cpu().numpy().astype(np.longdouble),
        grid.om_c.cpu().numpy().astype(ld_surface.LD)[:, None], free_surface, tangent)
    for n, w in exact.items():
        scale = np.abs(w).max(axis=(-3, -2, -1))                  # per lane
        scale = np.where(scale > 0, scale, 1.0)
        err = lambda v: np.abs(v[j].cpu().numpy() - w).max(axis=(-3, -2, -1)) / scale
        ours, theirs = err(got[n]), err(want[n])
        if not (ours <= STAGE_A_ACCURACY * theirs + 64 * eps).all():
            bad = np.flatnonzero(ours > STAGE_A_ACCURACY * theirs + 64 * eps)
            raise AssertionError(f"stage A: the kernel's {n} at z {z[j].item()!r} is further "
                                 f"from the long-double recursion than {STAGE_A_ACCURACY:g}x "
                                 f"the plain version's on lanes {bad.tolist()}: "
                                 f"{ours[bad].tolist()} against {theirs[bad].tolist()}")
        ratio = max(ratio, float(np.max(ours / np.maximum(theirs, 64 * eps))))
    return worst, ratio


@contextlib.contextmanager
def held_stage_a(phase: str):
    """Every launch of the stage-A kernel inside the block, that is every
    call of ``layered._KernelStageA.forward`` (the kernel's one caller),
    held against the plain version on its card inputs (check_stage_a). A
    launch recorded into a CUDA graph runs no kernel: it is counted as
    "recorded" and not held, and a replay runs no Python. Yields {"shapes":
    {(K, nf, nk, tangent): launches held}, "recorded", "counted"
    (counted_stage_a's), "exact" (launches held against the long-double
    recursion too), "ulps" and "ratio" (the worst of check_stage_a's two
    readings), "check_s"}; on leaving,
    STAGE_A_HELD[phase] gains the launches held."""
    from waveform_ot_torch.models import layered as TL

    real = TL._KernelStageA.__dict__["forward"]
    held = {"shapes": {}, "recorded": 0, "counted": 0, "exact": 0, "ulps": 0.0,
            "ratio": 0.0, "check_s": 0.0}
    lock = threading.Lock()      # a mesh's per-device threads launch at once

    def checked(z, model, grid, free_surface, tangent):
        out = real.__func__(z, model, grid, free_surface, tangent)
        if torch.cuda.is_current_stream_capturing():
            with lock:
                held["recorded"] += 1
            return out
        t0 = time.perf_counter()
        key = (z.shape[0], grid.om_c.shape[0], grid.k.shape[0], bool(tangent))
        with lock:
            i = held["shapes"].get(key, 0)
            held["shapes"][key] = i + 1
        exact = i < STAGE_A_LD_FIRST or i % STAGE_A_LD_EVERY == 0
        ulps, ratio = check_stage_a(out, z, model, grid, free_surface, tangent,
                                    i if exact else None)
        with lock:
            held["exact"] += exact
            held["ulps"], held["ratio"] = max(held["ulps"], ulps), max(held["ratio"], ratio)
            held["check_s"] += time.perf_counter() - t0
        return out

    sys.path.insert(0, str(REPO / "tests"))      # ld_surface, the long-double recursion
    TL._KernelStageA.forward = staticmethod(checked)
    try:
        yield held
    finally:
        setattr(TL._KernelStageA, "forward", real)
        sys.path.remove(str(REPO / "tests"))
        STAGE_A_HELD[phase] = STAGE_A_HELD.get(phase, 0) + sum(held["shapes"].values())


def stage_a_report(tag: str, held: dict, counted: int) -> None:
    """Print the stage-A holds of a block; raise unless every launch the
    counter saw (``counted``) was held or recorded by a capture."""
    n_held = sum(held["shapes"].values())
    print(f"[{tag}] stage-A kernel launches held against the plain _surface_operator on their "
          f"card inputs: {n_held}, and {held['recorded']} recorded by CUDA graph captures, of "
          f"{counted} counted; by (K, nf, nk, tangent) {held['shapes']}; worst well-conditioned "
          f"field {held['ulps']:.2f} ulps (bound {STAGE_A_ULPS}); P-SV fields of {held['exact']} "
          f"launches against the long-double recursion, worst error {held['ratio']:.3f}x the "
          f"plain version's (bound {STAGE_A_ACCURACY:g}x + 64 ulps); "
          f"{held['check_s']:.2f} s of checks")
    if n_held + held["recorded"] < counted:
        raise AssertionError(f"{tag}: {counted - n_held - held['recorded']} of {counted} "
                             f"stage-A launches went past the check")


def counted_stage_a(fn, held: dict, calls: int | None, what: str):
    """fn() with the stage-A kernel's counter set to 0 just before and read
    just after: (result, launches run). Raises unless the counter equals
    the launches run (held) and those a CUDA graph capture recorded, and,
    where ``calls`` is given, unless one launch ran per band of ``calls``
    stage-A calls (one band each here). ``held["counted"]`` sums the
    counter's readings."""
    from waveform_ot_torch.models import cuda_surface

    torch.cuda.synchronize()
    cuda_surface.LAUNCHES = 0
    runs0, rec0 = sum(held["shapes"].values()), held["recorded"]
    out = fn()
    torch.cuda.synchronize()
    runs, rec = sum(held["shapes"].values()) - runs0, held["recorded"] - rec0
    held["counted"] += cuda_surface.LAUNCHES
    if cuda_surface.LAUNCHES != runs + rec or calls is not None and runs != calls:
        raise AssertionError(f"{what}: {runs} stage-A launches run and {rec} recorded, counter "
                             f"{cuda_surface.LAUNCHES}; want {calls} run")
    return out, runs


def ptxas_by_variant(log: str) -> dict:
    """{(dtype, S): "N registers, ... spill ..."} from ptxas -v output of
    the distance-field library."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(rf"Compiling entry function '.*{KERNEL_NAME}I([fd])Li(\d+)E", line)
        if m:
            key = ({"f": torch.float32, "d": torch.float64}[m[1]], int(m[2]))
            out[key] = ""
        elif key is not None and ("spill" in line or "Used" in line):
            out[key] = (out[key] + "; " if out[key] else "") + line.split(":")[-1].strip()
    return out


class CountedObjective:
    """A batched objective that counts its calls: value-only calls (the
    solvers' line-search trials) and value+grad calls (grad mode on). ``log``
    keeps each call's kind (True: value+grad) by the device of its models;
    a mesh's per-device threads each write their own device's list."""

    def __init__(self, fn):
        self.fn, self.values, self.value_grads, self.log = fn, 0, 0, {}
        self._lock = threading.Lock()

    def __call__(self, ms):
        grad = torch.is_grad_enabled()
        with self._lock:
            if grad:
                self.value_grads += 1
            else:
                self.values += 1
        self.log.setdefault(ms.device, []).append(grad)
        return self.fn(ms)


def solver_runs(calls: list) -> list:
    """One device's call log split into the batched solves that ran on it in
    turn: [value+grad calls, trials] each. A solve opens with a value+grad
    call and makes at least one trial before each later one, so two
    value+grad calls in a row mark the next solve."""
    runs = []
    for i, grad in enumerate(calls):
        if grad and (i == 0 or calls[i - 1]):
            runs.append([0, 0])
        runs[-1][0 if grad else 1] += 1
    return runs


@contextlib.contextmanager
def held_launches(phase: str):
    """Every launch of the distance-field kernel inside the block held field
    for field against its plain version on the same card inputs: d, iclose,
    lam and dvec must equal distance_field_torch's bit for bit, or the launch
    raises. A launch recorded into a CUDA graph runs no kernel and is not
    held; the launches its replays make are counted apart (a replay equals
    the eager call bit for bit, tests/test_torch_graph.py, and the first
    call of each graph runs eagerly, held here). Every launch of the
    stage-A kernel inside the block is held too (held_stage_a). Yields
    {"shapes": {(B, nt, nu, ntg, dtype): launches held}, "replayed":
    launches made by graph replays, "check_s": host seconds the checks
    took, "stage_a": held_stage_a's record}."""
    from waveform_ot_torch.inversion import cuda_graph
    from waveform_ot_torch.ops import cuda_distance, distance_field_torch

    real, real_replay = cuda_distance.distance_field_cuda, cuda_graph._replay
    held = {"shapes": {}, "replayed": 0, "check_s": 0.0}

    def replay(entry, ms):
        held["replayed"] += entry.launches
        return real_replay(entry, ms)

    def checked(verts, tgrid, ugrid):
        out = real(verts, tgrid, ugrid)
        if torch.cuda.is_current_stream_capturing():
            return out
        t0 = time.perf_counter()
        with torch.no_grad():
            plain = distance_field_torch(verts, tgrid, ugrid)
        same = [torch.equal(a, b) for a, b in zip(out, plain)]
        key = (*verts.shape[:2], ugrid.shape[1], tgrid.shape[1], str(verts.dtype)[6:])
        if not all(same):
            raise AssertionError(f"{phase}: the kernel's launch at (B, nt, nu, ntg, dtype) "
                                 f"{key} differs from distance_field_torch on its inputs "
                                 f"(d, iclose, lam, dvec equal: {same})")
        held["shapes"][key] = held["shapes"].get(key, 0) + 1
        held["check_s"] += time.perf_counter() - t0
        return out

    cuda_distance.distance_field_cuda, cuda_graph._replay = checked, replay
    try:
        with held_stage_a(phase) as held["stage_a"]:
            yield held
    finally:
        cuda_distance.distance_field_cuda, cuda_graph._replay = real, real_replay


class PhaseChecks:
    """The counted, held and timed calls of a phase whose lines start with
    ``[tag]`` (phases 13 and 14). ``n_counted`` sums the launches of every
    counted call, to be held against ``held_launches``' count, and
    ``n_stage_a`` the stage-A kernel's."""

    def __init__(self, tag: str, card: str):
        self.tag, self.card, self.n_counted, self.n_stage_a = tag, card, 0, 0

    def counted(self, fn, want=None, what=""):
        """fn() with the kernel's launch count set to 0 just before and read
        just after: (result, launches); raises unless launches == want, when
        given. The stage-A kernel's launches are counted alike."""
        from waveform_ot_torch.models import cuda_surface
        from waveform_ot_torch.ops import cuda_distance

        torch.cuda.synchronize()
        cuda_distance.LAUNCHES = cuda_surface.LAUNCHES = 0
        out = fn()
        torch.cuda.synchronize()
        n = cuda_distance.LAUNCHES
        self.n_counted += n
        self.n_stage_a += cuda_surface.LAUNCHES
        if want is not None and n != want:
            raise AssertionError(f"{what}: {n} kernel launches, not {want}")
        return out, n

    def hold(self, name, dev_, bound):
        print(f"[{self.tag}] {name}: {dev_:.4e} (bound {bound:g})")
        if not dev_ <= bound:
            raise AssertionError(f"{self.tag} {name}: {dev_!r} exceeds {bound:g}")

    def timed(self, name, fn, want, n: int) -> float:
        """Host-clock median of n calls of fn(); the launches counted over
        every call of the timing, the warm-up included, must be ``want`` per
        call."""
        from waveform_ot_torch.ops import cuda_distance

        torch.cuda.synchronize()
        cuda_distance.LAUNCHES = 0
        ms = host_median_ms(fn, n=n, warm=1)
        torch.cuda.synchronize()
        per = cuda_distance.LAUNCHES / (n + 1)
        print(f"[timing] {self.tag} {name}: {ms:.4f} ms/call (host clock, synchronized, median "
              f"of {n}), kernel launches per call {per:g} (counted over the {n + 1} calls) "
              f"{self.card}")
        if per != want:
            raise AssertionError(f"{name}: {per} kernel launches per timed call, not {want}")
        return ms

    def check_held(self, held):
        """Every counted launch went through held_launches' check or was a
        CUDA graph's replay."""
        n_held = sum(held["shapes"].values())
        print(f"[{self.tag}] launches held bit for bit against distance_field_torch on their "
              f"card inputs: {n_held}, and {held['replayed']} made by CUDA graph replays, of "
              f"{self.n_counted} counted outside the timing runs; by (B, nt, nu, ntg, dtype) "
              f"{held['shapes']}; {held['check_s']:.2f} s of checks")
        if n_held + held["replayed"] < self.n_counted:
            raise AssertionError(f"{self.n_counted - n_held - held['replayed']} of "
                                 f"{self.n_counted} counted "
                                 f"launches went past the check")
        stage_a_report(self.tag, held["stage_a"], self.n_stage_a)


def _rel(a, b) -> float:
    """max |a - b| over max |b|, both moved to float64 on the CPU."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


def layered_phases(dev, opts, card: str, per_eval: dict) -> dict:
    """Phases 9-11: the layered physics on the card. Returns the
    distance-field kernel's launches of each path, the stage-A kernel's,
    and the stage-A kernel's per call (per batched evaluation of the
    study); ``per_eval`` gains the distance field's per evaluation."""
    from waveform_ot_torch.inversion import (
        layered_misfit_grid, loc_cmt_misfit, loc_cmt_value_and_grad,
        minimize_lbfgs_batched_host,
    )
    from waveform_ot_torch.ops import cuda_distance

    cpu, f32, f64 = torch.device("cpu"), torch.float32, torch.float64
    launches, stage_a = {}, {}
    dm = torch.tensor(DM)
    # 9. value and gradient at LOC + DM; every stage-A launch of phases 9-11
    # outside their timing runs held (held_stage_a) and counted, one per call
    loc, cfg, prob32, fwd32, stages32 = build_layered_problem(f32, dev)
    m32 = loc + dm.to(dev, f32)
    res, built = {}, {}
    with held_stage_a("layered") as held:
        torch.cuda.synchronize()
        cuda_distance.LAUNCHES = 0
        (v32, g32), stage_a["layered"] = counted_stage_a(
            lambda: loc_cmt_value_and_grad(m32, prob32, opts, cfg, forward=fwd32), held, 1,
            "layered value+grad f32")
        launches["layered"] = cuda_distance.LAUNCHES
        if launches["layered"] != 1:
            raise AssertionError(f"layered value+grad launched the kernel "
                                 f"{launches['layered']} times, not once")
        if not (bool(torch.isfinite(v32)) and bool(torch.isfinite(g32).all())):
            raise AssertionError(f"non-finite layered result {v32} {g32}")
        for where, device in (("cpu", cpu), ("card", dev)):
            locd, cfgd, probd, fwdd, stagesd = built[where] = build_layered_problem(f64, device)
            md = locd + dm.to(device, f64)
            calls = int(device.type == "cuda")
            with torch.no_grad():
                sd, _ = counted_stage_a(lambda: fwdd(md[0], md[1], md[2], probd.mxyz_fixed),
                                        held, calls, f"layered forward f64 on the {where}")
            vg, _ = counted_stage_a(lambda: loc_cmt_value_and_grad(md, probd, opts, cfgd,
                                                                   forward=fwdd),
                                    held, calls, f"layered value+grad f64 on the {where}")
            res[where] = (sd, *vg)
        with torch.no_grad():
            s32, _ = counted_stage_a(lambda: fwd32(m32[0], m32[1], m32[2], prob32.mxyz_fixed),
                                     held, 1, "layered forward f32")
    stage_a_report("layered", held, held["counted"])
    s64, v64, g64 = res["cpu"]
    g32c, g64c = g32.double().cpu(), g64.cpu()
    dev_f32 = {"seis": _rel(s32, s64), "value": abs(v32.item() - v64.item()) / abs(v64.item()),
               "cos": (g32c @ g64c / (g32c.norm() * g64c.norm())).item(),
               "norm_ratio": (g32c.norm() / g64c.norm()).item()}
    s64d, v64d, g64d = res["card"]
    dev_f64 = {"seis": _rel(s64d, s64), "value": abs(v64d.item() - v64.item()) / abs(v64.item()),
               "grad": _rel(g64d, g64)}
    print(f"[layered] f32 on {torch.cuda.get_device_name(0)}: value {v32.item()!r} grad "
          f"{g32.tolist()}, kernel launches {launches['layered']}, stage-A launches "
          f"{stage_a['layered']}; f64 on cpu: value {v64.item()!r} grad {g64.tolist()}")
    print(f"[layered] f32-card vs f64-cpu: seismograms {dev_f32['seis']:.3e} of the peak "
          f"(bound {SEIS_TOL_F32:g}), value rel {dev_f32['value']:.3e} (bound "
          f"{LAYERED_VALUE_RTOL_F32:g}), gradient cosine {dev_f32['cos']:.6f} (bound > "
          f"{GRAD_COS_F32}), norm ratio {dev_f32['norm_ratio']:.6f} (bound (0.5, 2))")
    print(f"[layered] f64-card vs f64-cpu: seismograms {dev_f64['seis']:.3e} of the peak "
          f"(bound {SEIS_TOL_F64:g}), value rel {dev_f64['value']:.3e} (bound "
          f"{VALUE_RTOL_F64:g}), gradient {dev_f64['grad']:.3e} of max|g| (bound "
          f"{GRAD_TOL_F64:g})")
    if (dev_f32["seis"] > SEIS_TOL_F32 or dev_f32["value"] > LAYERED_VALUE_RTOL_F32
            or dev_f32["cos"] <= GRAD_COS_F32 or not 0.5 < dev_f32["norm_ratio"] < 2.0):
        raise AssertionError("layered f32 on the card deviates from f64 on the CPU")
    if (dev_f64["seis"] > SEIS_TOL_F64 or dev_f64["value"] > VALUE_RTOL_F64
            or dev_f64["grad"] > GRAD_TOL_F64):
        raise AssertionError("layered f64 on the card deviates from f64 on the CPU")
    ms_call = host_median_ms(lambda: loc_cmt_value_and_grad(m32, prob32, opts, cfg,
                                                            forward=fwd32), n=N_TIMED)
    print(f"[timing] layered value+grad f32: {ms_call:.4f} ms/call (host clock, "
          f"synchronized, median of {N_TIMED}) {card}")

    # 10. the depth-amortized scan
    zs, xy = scan_axes(f32, dev)
    _, cfgd, probd, fwdd, stagesd = built["card"]
    with held_stage_a("layered_scan") as held:
        torch.cuda.synchronize()
        cuda_distance.LAUNCHES = 0
        (sv, sg), stage_a["layered_scan"] = counted_stage_a(
            lambda: layered_misfit_grid(zs, xy, prob32, opts, cfg, stages32), held, 1,
            "the layered scan")
        launches["layered_scan"] = cuda_distance.LAUNCHES
        if launches["layered_scan"] != 1:
            raise AssertionError(f"the layered scan launched the kernel "
                                 f"{launches['layered_scan']} times, not once")
        if sv.shape != (4, len(xy)) or sg.shape != (4, len(xy), 3) or not (
                bool(torch.isfinite(sv).all()) and bool(torch.isfinite(sg).all())):
            raise AssertionError(f"layered scan result of shapes {sv.shape} {sg.shape} "
                                 f"is not finite")
        pick = np.random.default_rng(11).integers(0, len(xy), size=4)
        worst_v = worst_g = 0.0
        for iz, ixy in enumerate(pick):
            node = torch.stack([xy[ixy, 0], xy[ixy, 1], zs[iz]])
            (v1, g1), _ = counted_stage_a(
                lambda: loc_cmt_value_and_grad(node, prob32, opts, cfg, forward=fwd32), held,
                None, "a scan node alone (a graph replay or capture)")
            worst_v = max(worst_v, abs(sv[iz, ixy].item() - v1.item()) / abs(v1.item()))
            worst_g = max(worst_g, _rel(sg[iz, ixy], g1))
        sub = xy[::147].double()
        (v64, g64), _ = counted_stage_a(
            lambda: layered_misfit_grid(zs.double(), sub, probd, opts, cfgd, stagesd), held, 1,
            "the f64 sub-grid")
        nodes = torch.cat([torch.cat([sub, z.expand(len(sub), 1)], 1)
                           for z in zs.double()[:, None]])
        (v1, g1), _ = counted_stage_a(
            lambda: loc_cmt_value_and_grad(nodes, probd, opts, cfgd, forward=fwdd), held, 1,
            "the f64 sub-grid's nodes")
    stage_a_report("layered_scan", held, held["counted"])
    dev64 = max((v64.reshape(-1) - v1).abs().max().item() / v1.abs().max().item(),
                _rel(g64.reshape(-1, 3), g1))
    print(f"[layered_scan] f32 nodes {pick.tolist()} (one per depth) vs the node alone: value "
          f"rel dev max {worst_v:.3e} (bound {SCAN_VALUE_RTOL_F32:g}), grad dev / max|g| max "
          f"{worst_g:.3e} (bound {SCAN_GRAD_TOL_F32:g}); f64 {v64.numel()}-node sub-grid vs "
          f"its nodes alone: {dev64:.3e} (bound {SCAN_TOL_F64:g})")
    if worst_v > SCAN_VALUE_RTOL_F32 or worst_g > SCAN_GRAD_TOL_F32 or dev64 > SCAN_TOL_F64:
        raise AssertionError("layered scan nodes deviate from the same nodes alone")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()      # over the timing runs, which hold nothing
    scan_ms = host_median_ms(lambda: layered_misfit_grid(zs, xy, prob32, opts, cfg, stages32),
                             n=STUDY_TIMED, warm=0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[layered_scan] {sv.numel()} nodes x {NR_STUDY} stations x 3 = {3 * NR_STUDY * sv.numel()} "
          f"traces, f32, values and gradients in one call: {scan_ms:.4f} ms per scan (host "
          f"clock, synchronized, median of {STUDY_TIMED}); kernel launches "
          f"{launches['layered_scan']}, stage-A launches {stage_a['layered_scan']}; peak device "
          f"memory {peak_gb:.3f} GB (over the timed scans) {card}")
    del sv, sg
    torch.cuda.empty_cache()

    # 11. the 64-start study through the layered physics
    starts = study_starts(f32, dev)
    misfit = lambda ms: loc_cmt_misfit(ms, prob32, opts, cfg, forward=fwd32)
    solve = lambda f: minimize_lbfgs_batched_host(f, starts, max_iter=25, tol=1e-4, ls_max=8)
    fun = CountedObjective(misfit)
    with held_stage_a("layered_ms") as held:
        torch.cuda.synchronize()
        cuda_distance.LAUNCHES = 0
        res, stage_a["layered_ms"] = counted_stage_a(lambda: solve(fun), held, None,
                                                     "the layered study")
        launches["layered_ms"] = cuda_distance.LAUNCHES
    stage_a_report("layered_ms", held, held["counted"])
    evals = fun.values + fun.value_grads
    if stage_a["layered_ms"] != evals:
        raise AssertionError(f"layered_ms: {stage_a['layered_ms']} stage-A launches for {evals} "
                             f"batched evaluations")
    per_eval["layered_ms"] = launches["layered_ms"] / evals
    err = torch.linalg.vector_norm(res.x.double() - torch.tensor(LOC, dtype=f64, device=dev),
                                   dim=1)
    share = (err < LAYERED_MS_RADIUS_KM).double().mean().item()
    study_ms = host_median_ms(lambda: solve(misfit), n=STUDY_TIMED, warm=0)
    print(f"[layered_ms] {N_STARTS} starts, {NR_STUDY} stations, f32: {study_ms:.4f} ms per "
          f"study (host clock, synchronized, median of {STUDY_TIMED}); outer iterations "
          f"{fun.value_grads - 1}, line-search trials {fun.values}, batched evaluations "
          f"{evals}, kernel launches {launches['layered_ms']}; ls_failed lanes "
          f"{int(res.ls_failed.sum())}; within {LAYERED_MS_RADIUS_KM:g} km: {share:.4f} "
          f"(bound {LAYERED_MS_SHARE:g}); distance to the source max {err.max().item():.6f} "
          f"km, median {err.median().item():.6f} km {card}")
    if launches["layered_ms"] != evals:
        raise AssertionError(f"layered_ms: {launches['layered_ms']} kernel launches for "
                             f"{evals} batched evaluations")
    if not (share >= LAYERED_MS_SHARE and bool(torch.isfinite(err).all())):
        raise AssertionError(f"layered_ms: only {share:.0%} of starts within "
                             f"{LAYERED_MS_RADIUS_KM:g} km: {err.tolist()}")
    per_call = {"layered": stage_a["layered"], "layered_scan": stage_a["layered_scan"],
                "layered_ms": stage_a["layered_ms"] / evals}
    return launches, stage_a, per_call


def stage_a_phase(dev, card: str) -> list:
    """Phase 9's start: the stage-A kernel alone at the cells' quadrature
    (STAGE_A_NK, STAGE_A_KMAX, the Fukuoka model) and the main path's
    source counts (STAGE_A_SOURCES), with the tangent: one launch held
    against the plain version (check_stage_a, each source's long-double
    check in turn over the counts), its device time, the plain version's,
    the bound (stage_a_bound) and the share. Returns the rows."""
    from waveform_ot_torch import _build
    from waveform_ot_torch.models import cuda_surface
    from waveform_ot_torch.models import layered as TL

    model = TL.fukuoka_model(device=dev)
    plan = TL._synth_plan(NT, 1.0, 2, ("clp_step", 0.05, 0.2), STAGE_A_NK, STAGE_A_KMAX,
                          float("inf"))
    (grid,) = [TL._band_grid(b, plan.k_np, 0.023, dev) for b in plan.bands]
    t0 = time.perf_counter()
    cuda_surface._library()
    ptxas = "; ".join(line.split(":")[-1].strip()
                      for line in _build.ptxas_log("surface_operator").splitlines()
                      if "spill" in line or "Used" in line)
    print(f"[stage_a] {_build.library_path('surface_operator').relative_to(REPO)} loaded in "
          f"{time.perf_counter() - t0:.2f} s; ptxas -v: {ptxas}")
    rows = []
    sys.path.insert(0, str(REPO / "tests"))      # ld_surface, the long-double recursion
    try:
        for turn, (name, k) in enumerate(STAGE_A_SOURCES.items()):
            z = torch.linspace(0.5, 45.0, k, dtype=torch.float64, device=dev) if k > 1 else \
                torch.tensor([float(LOC[2])], dtype=torch.float64, device=dev)
            args = (grid.k, grid.om_c, model.interfaces(), model.vp, model.vs, model.rho, z,
                    True, True)
            cuda_surface.LAUNCHES = 0
            rev, src, drev = cuda_surface.surface_operator_cuda(*args)
            torch.cuda.synchronize()
            if cuda_surface.LAUNCHES != 1:
                raise AssertionError(f"stage A at {k} sources: {cuda_surface.LAUNCHES} launches")
            ulps, ratio = check_stage_a(rev + src + drev, z, model, grid, True, True, turn)
            ms = device_ms(lambda: cuda_surface.surface_operator_cuda(*args),
                           launches=BACK_TO_BACK, samples=SAMPLES)
            plain = device_ms(lambda: TL._surface_operator(model, z, grid, True, True),
                              launches=PLAIN_BACK_TO_BACK)
            nf, nk = grid.om_c.shape[0], grid.k.shape[0]
            bound, bound_by = stage_a_bound(k, nf, nk, model.nlayers, True)
            rows.append({"shape": name, "sources": k, "nf": nf, "nk": nk, "ms": ms,
                         "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                         "share": bound / ms, "ulps": ulps, "accuracy_ratio": ratio})
            print(f"[timing] stage A {name}: {k} sources x {nf} frequencies x {nk} wavenumbers, "
                  f"tangent: kernel {ms:.6f} ms (device, {BACK_TO_BACK} back-to-back launches, "
                  f"median of {SAMPLES}), bound {bound:.6f} ms ({bound_by}), share "
                  f"{bound / ms:.4f}, plain {plain:.4f} ms ({PLAIN_BACK_TO_BACK} back-to-back "
                  f"calls); against the plain version: well-conditioned fields {ulps:.2f} ulps "
                  f"(bound {STAGE_A_ULPS}), P-SV error {ratio:.3f}x the plain version's (bound "
                  f"{STAGE_A_ACCURACY:g}x + 64 ulps) {card}")
    finally:
        sys.path.remove(str(REPO / "tests"))
    return rows


def _nested_dev(got, ref) -> float:
    """max |got - ref| / max |ref| over (nested lists of) arrays and numbers."""
    if isinstance(ref, (list, tuple)):
        return max(_nested_dev(a, b) for a, b in zip(got, ref))
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"shapes differ: {got.shape} vs {ref.shape}")
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def toolbox_phase(dev, card: str) -> tuple[dict, dict]:
    """Phase 12: the reference's OT and fingerprint toolbox on the card through
    the port's compat layer, float64. Returns the kernel launches of the path
    ({"toolbox": n}) and of one calcpdf."""
    from waveform_ot_torch import compat
    from waveform_ot_torch.ops import (
        FingerprintSpec, cuda_distance, distance_field_torch, fingerprint_density, grid_axes,
    )
    from waveform_ot_torch.ops.fingerprint import nearest_vertex
    from waveform_ot_torch.ops.sinkhorn import gaussian_filter, sinkhorn_log
    from waveform_ot_torch.ops.sliced import sliced_plan_jacobian
    from waveform_ot_torch.ops.validate import monge_1d

    cpu, f64 = torch.device("cpu"), torch.float64
    t_phase = time.perf_counter()
    checks = []

    def hold(name, dev_, bound):
        checks.append(name)
        print(f"[toolbox] {name}: {dev_:.3e} (bound {bound:g})")
        if not dev_ <= bound:
            raise AssertionError(f"toolbox {name}: {dev_!r} exceeds {bound:g}")

    def both(name, call, card_args, cpu_args, bound):
        """call(*args) on the card's and on the CPU's twin inputs, each run
        timed once; holds the card's result against the CPU's at ``bound``
        (largest relative deviation) and returns the card's."""
        t0 = time.perf_counter()
        got = call(*card_args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = call(*cpu_args)
        t2 = time.perf_counter()
        hold(f"{name}, card vs cpu (one run each: card {t1 - t0:.3f} s, cpu {t2 - t1:.3f} s)",
             _nested_dev(got, ref), bound)
        return got

    def held_fingerprints(t_, waves, grid_, lambdav, name, deriv=False):
        """calcpdf (Enumerate) of each waveform on the card and on the CPU.
        Each card call launches the kernel exactly once, its d, iclose, lam
        and dvec equal distance_field_torch on the card's inputs bit for bit,
        its pdf the CPU's within PDF_ATOL and its grid positions the CPU's
        within POS_ATOL. Returns (card, cpu) objects."""
        card, host = [], []
        for i, w in enumerate(waves):
            torch.cuda.synchronize()
            before = cuda_distance.LAUNCHES
            wfo = compat.waveformFP(t_, w, grid_, device=dev)
            wfo.calcpdf(lambdav=lambdav, method="Enumerate", deriv=deriv)
            torch.cuda.synchronize()
            n = cuda_distance.LAUNCHES - before
            tg_, ug_ = grid_axes(wfo._t, wfo._win, wfo._spec)
            plain = distance_field_torch(wfo._pn[None].contiguous(), tg_[None].contiguous(),
                                         ug_[None].contiguous())
            same = [torch.equal(a, b[0]) for a, b in zip(wfo._fld, plain)]
            print(f"[toolbox] calcpdf(Enumerate{', deriv' if deriv else ''}) {name}[{i}] "
                  f"{wfo.nug}x{wfo.ntg}, {len(t_)} samples: kernel launches {n}; d, iclose, "
                  f"lam, dvec bit for bit the plain field: {same}")
            if n != 1:
                raise AssertionError(f"calcpdf {name}[{i}] launched the kernel {n} times")
            if not all(same):
                raise AssertionError(f"calcpdf {name}[{i}]: field differs from "
                                     f"distance_field_torch on the card")
            (wfc,) = fingerprint_pdfs(t_, [w], grid_, lambdav, cpu)
            hold(f"calcpdf {name}[{i}] pdf, card vs cpu, max abs",
                 float(np.abs(wfo.pdf - wfc.pdf).max()), PDF_ATOL)
            hold(f"calcpdf {name}[{i}] grid positions, card vs cpu, max abs",
                 float(np.abs(wfo.pos - wfc.pos).max()), POS_ATOL)
            card.append(wfo)
            host.append(wfc)
        return card, host

    def otpdfs(fps, dev_):
        return [compat.OTpdf((w.pdf, w.pos), dev_) for w in fps]

    # 12a. the 800x600 fingerprints through the reference API
    t, rf = rf_waveform()
    _, rfd = rf_waveform(RF_SHIFT)
    grid = rf_grid6()
    torch.cuda.synchronize()
    cuda_distance.LAUNCHES = 0
    (wfp, wf), fps_cpu = held_fingerprints(t, [rfd, rf], grid, RF_LAMBDA, "RF (delayed, observed)",
                                           deriv=True)
    tg, ug = grid_axes(wf._t, wf._win, wf._spec)

    wfn = compat.waveformFP(t, rf, grid, device=dev)
    wfn.calcpdf(lambdav=RF_LAMBDA, method="NNsearch")
    nn0 = compat.NNsearch(wf)
    nn2 = compat.NNsearch(wf, ni=2)
    flips = wfn.irays != wf.irays
    gap = np.abs(wfn.dfield - wf.dfield).ravel()
    print(f"[toolbox] calcpdf(NNsearch): irays differ from Enumerate's at {flips.mean():.6f} of "
          f"the grid, largest |d_nn - d| there {gap[flips].max(initial=0.0):.3e}; NNsearch(wf) "
          f"vs calcpdf(NNsearch) max |dd| {np.abs(nn0[0] - wfn.dfield).max():.3e}; "
          f"NNsearch(wf, ni=2) largest |d - d_exact| {np.abs(nn2[0] - wf.dfield).max():.3e}")
    for name, d in (("NNsearch", wfn.dfield), ("NNsearch ni=0", nn0[0]),
                    ("NNsearch ni=2", nn2[0])):
        hold(f"{name} below the exact field (it never undershoots)",
             float(np.maximum(wf.dfield - d, 0.0).max()), 1e-12)
    hold("calcpdf(NNsearch) vs NNsearch(wf)", float(np.abs(nn0[0] - wfn.dfield).max()), 1e-12)
    pts = torch.stack([tg.expand(RF_NU, RF_NTG), ug[:, None].expand(RF_NU, RF_NTG)], dim=-1)
    ivert = np.clip(nearest_vertex(wf._pn, pts.reshape(-1, 2)).cpu().numpy(), 0, RF_NT - 2)
    adjacent = (wf.irays == ivert) | (wf.irays == np.maximum(ivert - 1, 0))
    hold("grid points where NNsearch differs though the exact winner is adjacent to the "
         "nearest vertex", float((adjacent & (gap > 1e-12)).sum()), 0.0)

    ot = {"card": otpdfs((wfp, wf), dev), "cpu": otpdfs(fps_cpu, cpu)}

    # 12b. OT between the predicted (delayed) and the observed fingerprint
    marg = both("MargWasserstein(derivatives, returnmargW)",
                lambda s, o: compat.MargWasserstein(s, o, derivatives=True, returnmargW=True),
                ot["card"], ot["cpu"], CLOSED_RTOL)
    rows = wfp.PDFderivMarg(marg[1])
    wt = torch.tensor(rfd, dtype=f64, device=dev, requires_grad=True)
    before = cuda_distance.LAUNCHES      # the check's own launch is not the path's
    pdf, _ = fingerprint_density(torch.tensor(t, dtype=f64, device=dev), wt[None], wfp._win,
                                 FingerprintSpec(nu=RF_NU, ntg=RF_NTG), lambdav=RF_LAMBDA)
    auto = [torch.autograd.grad((pdf[0] * torch.tensor(cm, device=dev)).sum(), wt,
                                retain_graph=True)[0].cpu().numpy() for cm in marg[1]]
    oracle = cuda_distance.LAUNCHES - before
    hold("PDFderivMarg vs autograd through fingerprint_density", _nested_dev(rows, auto),
         CHAIN_RTOL)
    sliced = both(f"SlicedWasserstein({TOOLBOX_NPROJ}, derivatives), {RF_NU * RF_NTG} points "
                  f"per slice",
                  lambda s, o: compat.SlicedWasserstein(s, o, TOOLBOX_NPROJ, derivatives=True),
                  ot["card"], ot["cpu"], CLOSED_RTOL)
    for pair in ot.values():
        for o in pair:
            o.setMarginals()
    tm = {where: (pair[0].marg[0], pair[1].marg[0]) for where, pair in ot.items()}
    w12 = both(f"wasser W12 + plan + plan Jacobian ({RF_NTG}^3) on the time marginals",
               lambda s, o: compat.wasser(s, o, "W12", derivatives=True, returnplan=True),
               tm["card"], tm["cpu"], CLOSED_RTOL)
    plan = w12[6]
    hold("the plan's marginals vs the pdfs", max(
        float(np.abs(plan.sum(1) - tm["card"][0].pdf).max()),
        float(np.abs(plan.sum(0) - tm["card"][1].pdf).max())), 1e-12)
    weights = np.linspace(0.0, 1.0, 5)
    both(f"barypath continuous ({BARY_NPOINTS} points)",
         lambda s, o: compat.barypath(s, o, weights, npoints=BARY_NPOINTS),
         tm["card"], tm["cpu"], CLOSED_RTOL)
    both("barypath pointmass", lambda s, o: compat.barypath(s, o, weights, pointmass=True),
         tm["card"], tm["cpu"], CLOSED_RTOL)
    mu0, mu1 = ot["card"][0].pdf, ot["card"][1].pdf
    for sigma in SINKHORN_SIGMAS:
        # card vs CPU over all 250 steps at SINKHORN_SIGMA_PX, over the first
        # SINKHORN_PREFIX elsewhere (the CPU's products are slow at 1 px)
        steps = SINKHORN_ITERS if sigma == SINKHORN_SIGMA_PX else SINKHORN_PREFIX
        sk = both(f"Gaussian Sinkhorn ({RF_NU}x{RF_NTG}, sigma {sigma:g} px), the first "
                  f"{steps} steps", lambda s, o: compat.Sinkhorn(s, o, gamma=sigma, iter=steps),
                  ot["card"], ot["cpu"], ITERATED_RTOL)
        if steps != SINKHORN_ITERS:
            sk = compat.Sinkhorn(*ot["card"], gamma=sigma, iter=SINKHORN_ITERS)
        d_, v_, w_ = sk
        blur = lambda a: compat.filter(a, sigma, device=dev)
        res0 = float(np.abs(v_ * blur(w_) - mu0).max() / mu0.max())
        res1 = float(np.abs(w_ * blur(v_) - mu1).max() / mu1.max())
        print(f"[toolbox] Gaussian Sinkhorn sigma {sigma:g} px, {SINKHORN_ITERS} steps: distance "
              f"{d_!r}; max |v K(w) - mu0| / max mu0 {res0:.3e}; max |w K(v) - mu1| / max mu1 "
              f"{res1:.3e}")
        hold(f"... sigma {sigma:g} px: max |w K(v) - mu1| / max mu1 (w's own update)", res1,
             SINKHORN_LAST_HALF_STEP)
        if sigma == SINKHORN_SIGMA_PX:
            hold(f"... sigma {sigma:g} px: max |v K(w) - mu0| / max mu0 (the fixed point)",
                 res0, SINKHORN_RESIDUAL)
        both(f"gaussian blur at {RF_NU}x{RF_NTG}, sigma {sigma:g} px", lambda a, d: compat.filter(
            a, sigma, device=d), (mu1, dev), (mu1, cpu), 1e-12)
        hold(f"gaussian blur sigma {sigma:g} px vs conv1d", _nested_dev(
            conv_blur(torch.tensor(mu1, device=dev), sigma).cpu().numpy(),
            compat.filter(mu1, sigma, device=dev)), 1e-12)
    print(f"[toolbox] MargWasserstein [Wt, Wu] {marg[0]}; sliced W2 {sliced[0]!r}; W1, W2 of the "
          f"time marginals {w12[0]!r}, {w12[3]!r}")

    # 12c. dense and log-domain Sinkhorn, plan Jacobians (40x120, 4,800 points)
    tm_, wpred, wobs, mgrid = migration_waveforms()
    mfp, mfp_cpu = held_fingerprints(tm_, [wpred, wobs], mgrid, 0.04, "migration")
    mig = {"card": otpdfs(mfp, dev), "cpu": otpdfs(mfp_cpu, cpu)}
    both(f"Sinkhorn_MS (gamma 5e-4) at 4,800 points, the first {SINKHORN_PREFIX} steps",
         lambda s, o: compat.Sinkhorn_MS(s, o, maxiters=SINKHORN_PREFIX),
         mig["card"], mig["cpu"], ITERATED_RTOL)
    both(f"sinkhorn_log (gamma 5e-4) at 4,800 points, the first {SINKHORN_PREFIX} steps",
         lambda s, o: [v.cpu().numpy() for v in sinkhorn_log(s.density, o.density,
                                                             iters=SINKHORN_PREFIX)],
         mig["card"], mig["cpu"], ITERATED_RTOL)
    # the full-length runs, on the card only
    src = mfp[0].pdf.ravel() / mfp[0].pdf.sum()
    tgt = mfp[1].pdf.ravel() / mfp[1].pdf.sum()
    dist, pi = compat.Sinkhorn_MS(*mig["card"])
    if not (np.isfinite(dist) and np.isfinite(pi).all()):
        raise AssertionError("Sinkhorn_MS on the card: distance or plan not finite")
    print(f"[toolbox] Sinkhorn_MS (5001 steps) on the card: W2^2 estimate {float(dist)!r}")
    hold("Sinkhorn_MS (5001 steps): the plan's target marginal (its last half step)",
         _nested_dev(pi.sum(1), tgt), SINKHORN_LAST_HALF_STEP)
    hold("Sinkhorn_MS (5001 steps): the plan's source marginal (the fixed point)",
         _nested_dev(pi.sum(0), src), DENSE_RESIDUAL)
    ld, lpi = (v.cpu().numpy() for v in sinkhorn_log(mig["card"][0].density,
                                                      mig["card"][1].density, iters=500))
    print(f"[toolbox] sinkhorn_log (500 steps) on the card: W2^2 estimate {float(ld)!r}; its "
          f"plan's source marginal {_nested_dev(lpi.sum(1), src):.3e} from the source")
    hold("sinkhorn_log (500 steps): the plan's target marginal (its last half step)",
         _nested_dev(lpi.sum(0), tgt), SINKHORN_LAST_HALF_STEP)
    md, mpi = compat.Sinkhorn_MS(*mig["card"], maxiters=500)
    hold("sinkhorn_log (500 steps) vs Sinkhorn_MS (500 steps), the same iteration in scaling "
         "form, on the card", _nested_dev([ld, lpi], [md, mpi.T]), ITERATED_RTOL)
    rng = np.random.default_rng(MIG_SEED)
    jac_in = {10: (rng.random(10), rng.random(10), np.linspace(0.0, 1.0, 10)),
              200: (rng.random(200), rng.random(200), np.linspace(0.0, 1.0, 200))}
    for n, (f, g, x) in jac_in.items():
        pair = {w: (compat.OTpdf((f, x), d), compat.OTpdf((g, x), d))
                for w, d in (("card", dev), ("cpu", cpu))}
        both(f"transport_plan_jacobian n={n}",
             lambda s, o: compat.wasser(s, o, "W2", derivatives=True, returnplan=True)[-1],
             pair["card"], pair["cpu"], CLOSED_RTOL)
        nx = 2 if n == 10 else 10
        pos = np.dstack(np.meshgrid(np.linspace(0, 1, n // nx), np.linspace(0, 1, nx)))
        pair = {w: (compat.OTpdf((f.reshape(nx, -1), pos), d),
                    compat.OTpdf((g.reshape(nx, -1), pos), d))
                for w, d in (("card", dev), ("cpu", cpu))}
        both(f"sliced_plan_jacobian n={n} ({nx}x{n // nx} grid, {TOOLBOX_NPROJ} slices)",
             lambda s, o: sliced_plan_jacobian(s.density, o.density,
                                               TOOLBOX_NPROJ).cpu().numpy(),
             pair["card"], pair["cpu"], CLOSED_RTOL)

    # 12d. examples/reference_migration.py's n = 10 flow on the card
    rng = np.random.default_rng(MIG_SEED)
    f, g = rng.random(MIG_N), rng.random(MIG_N)
    x = np.linspace(0.0, 1.0, MIG_N)
    src, tgt = compat.OTpdf((f, x), dev), compat.OTpdf((g, x), dev)
    w1, _, _, w2, _, _ = compat.wasser(src, tgt, "W12", derivatives=True)
    w1n, w2n = compat.wasserNumInt(src, tgt)
    wlp, _ = compat.Wasser_LinProg(src, tgt, distfunc="W2")
    _, c = monge_1d(f, g)
    ws, _ = compat.Sinkhorn_MS(src, tgt, gamma=2e-3, maxiters=800)
    print(f"[toolbox] reference_migration n={MIG_N}: wasser W1 {w1!r} W2^2 {w2!r}; numint "
          f"{w1n!r} {w2n!r}; LP {wlp!r}; Monge {c!r}; Sinkhorn_MS {ws!r}")
    hold("LP vs Monge", abs(wlp - c), 1e-8)
    hold("wasser vs LP and Monge", max(abs(wlp - w2), abs(c - w2)), 1e-8)
    hold("wasser vs numerical integration", max(abs(w1n - w1), abs(w2n - w2)), 5e-4)
    hold("wasser vs Sinkhorn_MS (gamma 2e-3, 800 steps)", abs(ws - w2), 5e-3)
    cpu_pair = (compat.OTpdf((f, x), cpu), compat.OTpdf((g, x), cpu))
    both("migration wasser W12 + plan + Jacobian",
         lambda s, o: compat.wasser(s, o, "W12", derivatives=True, returnplan=True),
         (src, tgt), cpu_pair, CLOSED_RTOL)
    both("migration Sinkhorn_MS", lambda s, o: compat.Sinkhorn_MS(s, o, gamma=2e-3, maxiters=800),
         (src, tgt), cpu_pair, ITERATED_RTOL)
    mw = both("migration MargWasserstein",
              lambda s, o: compat.MargWasserstein(s, o, "W2", derivatives=True, returnmargW=True),
              mig["card"], mig["cpu"], CLOSED_RTOL)
    if not (mw[0][0] > 0 and np.all(np.isfinite(mw[1][0]))):
        raise AssertionError(f"migration MargWasserstein {mw[0]} is not positive and finite")
    both("migration SlicedWasserstein(8)", lambda s, o: compat.SlicedWasserstein(s, o, 8),
         mig["card"], mig["cpu"], CLOSED_RTOL)
    torch.cuda.synchronize()
    launches = cuda_distance.LAUNCHES - oracle
    checked_s = time.perf_counter() - t_phase
    print(f"[toolbox] {len(checks)} checks held in {checked_s:.1f} s (card and CPU runs); "
          f"distance-field kernel launches on the path {launches}, one per calcpdf(Enumerate)")
    if launches != TOOLBOX_LAUNCHES:
        raise AssertionError(f"the toolbox path launched the distance-field kernel {launches} "
                             f"times, not {TOOLBOX_LAUNCHES}")

    # timings, after the path's launches are read
    calls = [
        ("calcpdf Enumerate+deriv 800x600", lambda: wf.calcpdf(
            lambdav=RF_LAMBDA, method="Enumerate", deriv=True), TOOLBOX_TIMED),
        ("calcpdf NNsearch 800x600", lambda: wfn.calcpdf(
            lambdav=RF_LAMBDA, method="NNsearch"), TOOLBOX_TIMED),
        ("NNsearch ni=2 800x600", lambda: compat.NNsearch(wf, ni=2), TOOLBOX_TIMED),
        ("MargWasserstein derivatives", lambda: compat.MargWasserstein(
            *ot["card"], derivatives=True, returnmargW=True), TOOLBOX_TIMED),
        (f"SlicedWasserstein {TOOLBOX_NPROJ} derivatives", lambda: compat.SlicedWasserstein(
            *ot["card"], TOOLBOX_NPROJ, derivatives=True), TOOLBOX_TIMED),
        ("wasser W12 + plan + Jacobian 600", lambda: compat.wasser(
            *tm["card"], "W12", derivatives=True, returnplan=True), TOOLBOX_TIMED),
        ("barypath continuous", lambda: compat.barypath(
            *tm["card"], weights, npoints=BARY_NPOINTS), TOOLBOX_TIMED),
        ("barypath pointmass", lambda: compat.barypath(*tm["card"], weights, pointmass=True),
         TOOLBOX_TIMED),
        *((f"Sinkhorn Gaussian {SINKHORN_ITERS} steps 800x600 sigma {sigma:g} px",
           lambda sigma=sigma: compat.Sinkhorn(*ot["card"], gamma=sigma, iter=SINKHORN_ITERS),
           3) for sigma in (1.0, SINKHORN_SIGMA_PX)),
        ("Sinkhorn_MS 5001 steps 4800", lambda: compat.Sinkhorn_MS(*mig["card"]), 3),
        ("sinkhorn_log 500 steps 4800", lambda: sinkhorn_log(
            mig["card"][0].density, mig["card"][1].density, iters=500), 3),
    ]
    for name, fn, n in calls:
        ms_call = host_median_ms(fn, n=n, warm=1)
        print(f"[timing] toolbox {name}: {ms_call:.4f} ms/call (host clock, synchronized, "
              f"median of {n}) {card}")
    img = torch.tensor(mu1, device=dev)
    for sigma in (1.0, SINKHORN_SIGMA_PX):
        taps = 2 * int(32 * sigma + 0.5) + 1
        band = device_ms(lambda: gaussian_filter(img, sigma), launches=20)
        conv = device_ms(lambda: conv_blur(img, sigma), launches=20)
        print(f"[timing] toolbox gaussian blur 800x600 sigma {sigma:g} px ({taps} taps): band "
              f"products {band:.4f} ms, conv1d {conv:.4f} ms (device, 20 back-to-back calls, "
              f"median of {SAMPLES}) {card}")
    print(f"[toolbox] phase {time.perf_counter() - t_phase:.1f} s")
    return {"toolbox": launches}, {"toolbox_calcpdf": 1}


def drivers_phase(dev, card: str) -> tuple[dict, dict]:
    """Phase 13: the reference's two inversion drivers through compat_ricker
    and compat_loc_cmt, on the card through their entry points, float64, each
    single call held against the same call on the CPU, each inversion by its
    end point, and every kernel launch outside the timing runs held bit for
    bit against the plain field on its own card inputs (held_launches).
    Returns the kernel launches of the two inversions and the launches per
    call of each entry point, as counted."""
    import scipy.optimize

    from waveform_ot_torch import compat_loc_cmt as lc
    from waveform_ot_torch import compat_ricker as ru
    from waveform_ot_torch.models.seismo import moment_tensor_from_sdr, upper_from_mxyz

    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    launches, per_call = {}, {}
    checks = PhaseChecks("drivers", card)
    counted, hold = checks.counted, checks.hold
    timed = lambda name, fn, want: checks.timed(name, fn, want, DRIVER_TIMED)

    def ricker_data(device):
        t, w = ru.rickerwavelet(*RICKER_TRUTH, trange=DRIVER_RICKER_TRANGE, device=device)
        _, obs = ru.BuildOTobjfromWaveform(t, w, DRIVER_RICKER_GRID,
                                           lambdav=DRIVER_RICKER_LAMBDA, transform=True,
                                           device=device)
        return [obs, "W2", DRIVER_RICKER_TRANGE, DRIVER_RICKER_GRID, DRIVER_RICKER_LAMBDA,
                True, 0.5, 45.0]

    with held_launches("drivers") as held:
        # 13a. Ricker_Figs_3_8 through compat_ricker.optfunc
        rdata = {"card": counted(lambda: ricker_data(dev), 1, "the observed fingerprint")[0],
                 "cpu": ricker_data(cpu)}
        x0 = np.asarray(DRIVER_RICKER_X)
        ru.init()
        (w_card, g_card), n = counted(lambda: ru.optfunc(x0, rdata["card"]))
        w_cpu, g_cpu = ru.optfunc(x0, rdata["cpu"])
        print(f"[drivers] compat_ricker.optfunc at {x0.tolist()} on the card: w2 {w_card!r} "
              f"grad {g_card.tolist()}, kernel launches {n}; on the cpu: w2 {w_cpu!r}")
        if n != 1 or len(ru.Wdata) != 2 or not np.all(np.isfinite(g_card)):
            raise AssertionError(f"compat_ricker.optfunc: {n} kernel launches, "
                                 f"{len(ru.Wdata)} records, gradient {g_card}")
        hold("compat_ricker.optfunc card vs cpu, value, abs", abs(w_card - w_cpu),
             DRIVER_RICKER_ATOL)
        hold("compat_ricker.optfunc card vs cpu, gradient, max abs",
             float(np.abs(g_card - g_cpu).max()), DRIVER_RICKER_ATOL)
        per_call["ricker_driver_optfunc"] = n
        inv = {}
        for where in ("card", "cpu"):
            ru.init()
            t0, c0 = time.perf_counter(), held["check_s"]
            inv[where], n = counted(lambda: scipy.optimize.minimize(
                ru.optfunc, x0, args=(rdata[where],), jac=True, method="L-BFGS-B"))
            wall = (time.perf_counter() - t0 - (held["check_s"] - c0)) * 1e3
            res = inv[where]
            print(f"[drivers] compat_ricker scipy L-BFGS-B on the {where}: x {res.x.tolist()} "
                  f"after {res.nit} iterations, {res.nfev} evaluations ({len(ru.Wdata)} Wdata "
                  f"records), w2 {res.fun!r}, kernel launches {n}, {wall:.1f} ms (host clock, "
                  f"one run, the launch checks' time taken out), scipy: {res.message!r} {card}")
            if where == "card":
                launches["ricker_driver"] = n
                if n != res.nfev or len(ru.Wdata) != res.nfev:
                    raise AssertionError(f"{n} launches and {len(ru.Wdata)} records for "
                                         f"{res.nfev} evaluations")
        hold("compat_ricker inversion on the card, max |x - truth|",
             float(np.abs(inv["card"].x - np.asarray(RICKER_TRUTH)).max()), RICKER_TRUTH_TOL)
        hold("compat_ricker inversion card vs cpu, max |x diff|",
             float(np.abs(inv["card"].x - inv["cpu"].x).max()), RICKER_X_TOL)
        if inv["card"].nit != inv["cpu"].nit:
            raise AssertionError(f"the card's inversion took {inv['card'].nit} iterations, the "
                                 f"cpu's {inv['cpu'].nit}")
        ru.init()

        # 13b. Figs 9-12 through compat_loc_cmt
        ang = np.linspace(0, 2 * np.pi, NR_STUDY, endpoint=False)
        p8 = {"sdrm": DRIVER_SDRM, "recx": 60.0 * np.cos(ang), "recy": 60.0 * np.sin(ang),
              "model": None}
        prop8_launches = set()
        (t, seis), n = counted(lambda: lc.prop8seis(*LOC, p8, device=dev))
        prop8_launches.add(n)
        _, seis_cpu = lc.prop8seis(*LOC, p8, device=cpu)
        if seis.shape != (NR_STUDY, 3, NT) or not np.all(np.isfinite(seis)):
            raise AssertionError(f"prop8seis gave {seis.shape} seismograms")
        hold("prop8seis at LOC card vs cpu, of the peak", _nested_dev(seis, seis_cpu),
             DRIVER_F64_TOL)
        p8["obs_seis"] = seis
        grids = lc.buildFingerprintwindows(t, seis, device=dev)
        if {(g[4], g[5]) for row in grids for g in row} != {(79, NT)}:
            raise AssertionError(f"fingerprint windows are not 79x{NT}: {grids[0][0]}")
        ot = {"Wopt": "Wavg", "distfunc": "W2", "plambda": DRIVER_LAMBDA, "theta": 45.0,
              "obs_grids": grids,
              "obs_grids01": [[g[:2] + [0.0, 1.0] + g[4:] for g in row] for row in grids]}
        invopt = {"loc": True, "cmt": False, "mistype": "OT", "precon": False,
                  "mscal": np.ones(3), "mref": np.zeros(3)}

        def loc_data(device):
            wfo, tgt = lc.BuildOTobjfromWaveform(t, seis, grids, ot, lambdav=DRIVER_LAMBDA,
                                                 device=device)
            return {"invopt": invopt, "prop8data": p8, "device": device,
                    "OTdata": dict(ot, wfobs=wfo, wfobs_target=tgt)}

        ldata = {"card": counted(lambda: loc_data(dev), NR_STUDY * 3,
                                 "the observed fingerprints")[0],
                 "cpu": loc_data(cpu)}
        m0 = np.asarray(LOC) + np.asarray(DM)
        for name, kw in (("loc cartesian", dict(x=True, y=True, z=True)),
                         ("loc spherical", dict(r=True, phi=True, z=True)),
                         ("mt", dict(moment_tensor=True)),
                         ("full cartesian", dict(x=True, y=True, z=True, moment_tensor=True)),
                         ("full spherical", dict(r=True, phi=True, z=True, moment_tensor=True))):
            drv = lc.DerivativeSwitches(**kw)
            (_, s_card, d_card), n = counted(lambda: lc.prop8seis(*m0, p8, drv=drv, device=dev))
            prop8_launches.add(n)
            _, s_c, d_c = lc.prop8seis(*m0, p8, drv=drv, device=cpu)
            if d_card.shape != (NR_STUDY, drv.nderiv, 3, NT):
                raise AssertionError(f"prop8seis drv {name}: {d_card.shape}")
            cols = max(_nested_dev(d_card[:, c], d_c[:, c]) for c in range(drv.nderiv))
            hold(f"prop8seis drv {name} at LOC + DM card vs cpu, seismograms of the peak",
                 _nested_dev(s_card, s_c), DRIVER_F64_TOL)
            hold(f"prop8seis drv {name} card vs cpu, worst of {drv.nderiv} channels, of the "
                 f"channel's max", cols, DRIVER_F64_TOL)
        print(f"[drivers] compat_loc_cmt.prop8seis kernel launches per call, over its 6 counted "
              f"calls: {sorted(prop8_launches)}")
        if prop8_launches != {0}:
            raise AssertionError(f"prop8seis launched the kernel: {sorted(prop8_launches)}")
        per_call["loc_cmt_driver_prop8seis"] = prop8_launches.pop()
        for name, fn in (("optfunc_OT", lc.optfunc_OT), ("optfunc_L2", lc.optfunc_L2)):
            data = {k: dict(ldata[k], invopt=dict(invopt, mistype=name[-2:])) for k in ldata}
            (v_card, g_card), n = counted(lambda: fn(m0, data["card"]))
            v_c, g_c = fn(m0, data["cpu"])
            want = NR_STUDY * 3 if name == "optfunc_OT" else 0
            print(f"[drivers] compat_loc_cmt.{name} loc-only at LOC + DM on the card: value "
                  f"{v_card!r} grad {g_card.tolist()}, kernel launches {n}; on the cpu: value "
                  f"{v_c!r} grad {g_c.tolist()}")
            if n != want or not np.all(np.isfinite(g_card)):
                raise AssertionError(f"{name}: {n} kernel launches (not {want}), grad {g_card}")
            hold(f"{name} card vs cpu, value, relative", abs(v_card - v_c) / abs(v_c),
                 VALUE_RTOL_F64)
            hold(f"{name} card vs cpu, gradient, of max|g|", _nested_dev(g_card, g_c),
                 GRAD_TOL_F64)
            per_call[f"loc_cmt_driver_{name}"] = n
        m6 = upper_from_mxyz(moment_tensor_from_sdr(*DRIVER_SDRM[:3], DRIVER_SDRM[3] * 1e-13,
                                                    device=cpu)).numpy()
        mls, n = counted(lambda: lc.Moment_LS(list(LOC), p8, device=dev))
        print(f"[drivers] compat_loc_cmt.Moment_LS at LOC on the card: {mls.tolist()}, true "
              f"{m6.tolist()}, kernel launches {n}")
        hold("Moment_LS at LOC against the true moment tensor, of its max",
             _nested_dev(mls, m6), DRIVER_MLS_RTOL)
        lc.init()
        t0, c0 = time.perf_counter(), held["check_s"]
        res, n = counted(lambda: scipy.optimize.minimize(
            lc.optfunc_OT, m0, args=(ldata["card"],), jac=True, method="L-BFGS-B"))
        wall = (time.perf_counter() - t0 - (held["check_s"] - c0)) * 1e3
        err = float(np.linalg.norm(res.x - np.asarray(LOC)))
        launches["loc_cmt_driver"] = n
        print(f"[drivers] compat_loc_cmt loc-only scipy L-BFGS-B on the card from LOC + DM: x "
              f"{res.x.tolist()} after {res.nit} iterations, {res.nfev} evaluations "
              f"({len(lc.opt_history_data)} records), misfit {res.fun!r}, {err:.6f} km from "
              f"LOC, kernel launches {n}, {wall:.1f} ms (host clock, one run, the launch "
              f"checks' time taken out), scipy: {res.message!r} {card}")
        if n != NR_STUDY * 3 * res.nfev:
            raise AssertionError(f"{n} kernel launches for {res.nfev} evaluations of "
                                 f"{NR_STUDY * 3} traces")
        hold("compat_loc_cmt inversion on the card, km from LOC", err, DRIVER_LOC_KM)
        lc.init()
    checks.check_held(held)

    timed("compat_ricker.optfunc 40x128", lambda: ru.optfunc(x0, rdata["card"]),
          per_call["ricker_driver_optfunc"])
    ru.init()
    l2data = dict(ldata["card"], invopt=dict(invopt, mistype="L2"))
    for name, fn, key in (
            ("compat_loc_cmt.prop8seis, value only", lambda: lc.prop8seis(*m0, p8, device=dev),
             "prop8seis"),
            ("compat_loc_cmt.prop8seis, loc Jacobian", lambda: lc.prop8seis(
                *m0, p8, drv=lc.DerivativeSwitches(x=True, y=True, z=True), device=dev),
             "prop8seis"),
            ("compat_loc_cmt.prop8seis, full Jacobian", lambda: lc.prop8seis(
                *m0, p8, drv=lc.DerivativeSwitches(x=True, y=True, z=True, moment_tensor=True),
                device=dev), "prop8seis"),
            ("compat_loc_cmt.optfunc_OT loc-only", lambda: lc.optfunc_OT(m0, ldata["card"]),
             "optfunc_OT"),
            ("compat_loc_cmt.optfunc_L2 loc-only", lambda: lc.optfunc_L2(m0, l2data),
             "optfunc_L2")):
        timed(name, fn, per_call[f"loc_cmt_driver_{key}"])
    lc.init()
    print(f"[drivers] phase {time.perf_counter() - t_phase:.1f} s")
    return launches, per_call


def native_phase(dev, card: str, batched_study_ms: float) -> tuple[dict, dict]:
    """Phase 14: the native slice on the card. 14a the fast-marching route of
    compat.waveformFP.calcpdf against the exact field at the FingerprintLib
    demo's full size; 14b the POT bridges (exact EMD, entropic Sinkhorn)
    against the LP oracle, the closed form and the CPU; 14c the zoom L-BFGS:
    the Ricker on-device inversion in f64 against the CPU's, and the
    64-start far-field study in f32; 14d top_device_ops on loc64 f32. Every
    kernel launch outside the timing runs is held bit for bit against the
    plain field (held_launches); launches are counted and asserted per call.
    Returns the path's launches and the launches per call."""
    import types

    import scipy.optimize

    from waveform_ot_torch import compat
    from waveform_ot_torch.inversion import (
        InvOptions, loc_cmt_misfit, loc_cmt_value_and_grad, minimize_lbfgs,
        minimize_multi_start, ricker_misfit,
    )
    from waveform_ot_torch.ops import cuda_distance
    from waveform_ot_torch.ops.validate import build_linprog
    from waveform_ot_torch.utils.profiling import top_device_ops

    cpu, f32, f64 = torch.device("cpu"), torch.float32, torch.float64
    t_phase = time.perf_counter()
    launches, per_call = {}, {}
    checks = PhaseChecks("native", card)
    counted, hold = checks.counted, checks.hold
    timed = lambda name, fn, want: checks.timed(name, fn, want, NATIVE_TIMED)

    t, rf = rf_waveform()
    grid = rf_grid6()
    with held_launches("native") as held:
        # 14a. the fast-marching route at the demo's full size
        fps = {}
        for method, want in (("FMM", 0), ("Enumerate", 1)):
            wfo = compat.waveformFP(t, rf, grid, device=dev)
            _, n = counted(lambda: wfo.calcpdf(lambdav=RF_LAMBDA, method=method), want,
                           f"calcpdf({method})")
            per_call[f"calcpdf_{method.lower()}"] = n
            fps[method] = wfo
        fmm_cpu = compat.waveformFP(t, rf, grid, device=cpu)
        fmm_cpu.calcpdf(lambdav=RF_LAMBDA, method="FMM")
        exact = fps["Enumerate"].dfield
        band = exact > 2.0 / RF_NU
        gap = np.abs(fps["FMM"].dfield - exact)[band]
        print(f"[native] calcpdf(FMM) {RF_NU}x{RF_NTG}, {RF_NT} samples, on the card: type "
              f"{fps['FMM'].type!r}, kernel launches {per_call['calcpdf_fmm']}; against the exact "
              f"field (calcpdf(Enumerate), {per_call['calcpdf_enumerate']} launch) over the band "
              f"d > 2/nu ({band.mean():.4f} of the grid): median |d| {np.median(gap):.6e}, max "
              f"{gap.max():.6e}")
        hold("FMM vs exact field, median |d| over d > 2/nu", float(np.median(gap)),
             FMM_MEDIAN_BOUND)
        hold("FMM vs exact field, max |d| over d > 2/nu", float(gap.max()), FMM_MAX_BOUND)
        hold("calcpdf(FMM) pdf, card vs cpu, max abs",
             float(np.abs(fps["FMM"].pdf - fmm_cpu.pdf).max()), PDF_ATOL)
        xw, yw = compat.calcFMM_dist_deriv(fps["FMM"].dfield, fps["FMM"].delgrid)
        print(f"[native] calcFMM_dist_deriv: ray end points {xw.shape}, finite "
              f"{bool(np.isfinite(xw).all() and np.isfinite(yw).all())}")
        if xw.shape != exact.shape or not (np.isfinite(xw).all() and np.isfinite(yw).all()):
            raise AssertionError("calcFMM_dist_deriv's ray end points are not finite")
        launches["native_fmm"] = per_call["calcpdf_enumerate"]

        # 14b. the POT bridges on the migration waveforms and on 1-D densities
        tm, pred, obs, g6 = migration_waveforms()
        pgrid = (*g6[:4], *POT_GRID)
        wfs, launches["native_pot"] = counted(
            lambda: fingerprint_pdfs(tm, [pred, obs], pgrid, RF_LAMBDA, dev), 2,
            "the POT pair's fingerprints")
        ot = {"card": [compat.OTpdf((w.pdf, w.pos), dev) for w in wfs],
              "cpu": [compat.OTpdf((w.pdf, w.pos), cpu)
                      for w in fingerprint_pdfs(tm, [pred, obs], pgrid, RF_LAMBDA, cpu)]}
        emd = {}
        for dist, p in (("W2", 2), ("W1", 1)):
            t0 = time.perf_counter()
            emd[dist] = compat.wasserPOT(*ot["card"], dist)[0]
            emd_s = time.perf_counter() - t0
            flat = [types.SimpleNamespace(pdf=o.pdf.ravel(), x=o.x.reshape(-1, 2))
                    for o in ot["card"]]
            lp_default = compat.Wasser_LinProg(*flat, distfunc=dist)[0]
            c, a_eq, b_eq = build_linprog(flat[0].pdf, flat[0].x, flat[1].pdf, flat[1].x, p)
            lp = scipy.optimize.linprog(
                c, A_eq=a_eq[:-1], b_eq=b_eq[:-1], method="highs",
                options={"primal_feasibility_tolerance": LP_FEASIBILITY,
                         "dual_feasibility_tolerance": LP_FEASIBILITY})
            if not lp.success:
                raise AssertionError(f"the {dist} LP oracle failed: {lp.message}")
            print(f"[native] wasserPOT {dist}, {POT_GRID[0]}x{POT_GRID[1]} fingerprints: "
                  f"{emd[dist]!r} ({emd_s:.3f} s, one run); LP at feasibility "
                  f"{LP_FEASIBILITY:g} {lp.fun!r}; Wasser_LinProg at HiGHS's defaults "
                  f"{lp_default!r}")
            hold(f"wasserPOT {dist} vs the LP oracle at feasibility {LP_FEASIBILITY:g}, relative",
                 abs(emd[dist] - lp.fun) / abs(lp.fun), POT_RTOL)
            hold(f"wasserPOT {dist} vs Wasser_LinProg at HiGHS's defaults, relative",
                 abs(emd[dist] - lp_default) / abs(lp_default), LINPROG_DEFAULT_RTOL)
        rng = np.random.default_rng(14)
        one_d = [compat.OTpdf((rng.random(POT_1D) + 0.1, np.sort(rng.random(POT_1D))), dev)
                 for _ in range(2)]
        w1d = compat.wasserPOT(*one_d, "W2")[0]
        closed = compat.wasser(*one_d, "W2")[0]
        hold(f"wasserPOT W2 vs the closed-form wasser, {POT_1D}-point 1-D pair, relative",
             abs(w1d - closed) / abs(closed), POT_RTOL)
        gaps = []
        for gamma in SINKHORN_POT_GAMMAS:
            got = compat.sinkhornPOT(*ot["card"], "W2", gamma=gamma, returnplan=True)
            ref = compat.sinkhornPOT(*ot["cpu"], "W2", gamma=gamma, returnplan=True)
            hold(f"sinkhornPOT gamma {gamma:g} card vs cpu (value, plan), relative",
                 _nested_dev(got, ref), SINKHORN_POT_RTOL)
            gaps.append(abs(got[0] - emd["W2"]))
        print(f"[native] sinkhornPOT - EMD at gamma {list(SINKHORN_POT_GAMMAS)}: {gaps}")
        if not gaps[0] > gaps[1] > gaps[2]:
            raise AssertionError(f"the entropic gap to the EMD does not fall with gamma: {gaps}")

        # 14c(i). the Ricker on-device inversion in float64: the full solve on the
        # card against the truth; card against CPU over its first iterations
        inv, calls = {}, {}
        for where, device, iters in (("card", dev, ZOOM_RICKER_ITERS),
                                     ("card", dev, ZOOM_RICKER_HELD),
                                     ("cpu", cpu, ZOOM_RICKER_HELD)):
            rp, rc, x0 = build_ricker_inversion(f64, device)
            fun = CountedObjective(lambda ms, rp=rp, rc=rc: ricker_misfit(ms, rp, rc))
            t0, c0 = time.perf_counter(), held["check_s"]
            res, n = counted(lambda: minimize_lbfgs(fun, x0, max_iter=iters))
            wall = (time.perf_counter() - t0 - (held["check_s"] - c0)) * 1e3
            inv[where, iters], calls[where, iters] = res, fun.value_grads
            print(f"[native] zoom minimize_lbfgs Ricker f64 on the {where}, max_iter {iters}: x "
                  f"{res.x.tolist()} after {int(res.n_iter)} iterations, {fun.value_grads} "
                  f"value+grad calls ({fun.values} value-only), w2 {res.fun.item()!r}, |g| "
                  f"{res.grad_norm.item():.3e}, kernel launches {n}, {wall:.1f} ms (host clock, "
                  f"one run, the launch checks' time taken out) {card}")
            if where == "card":
                if n != fun.value_grads or fun.values:
                    raise AssertionError(f"zoom Ricker: {n} launches for {fun.value_grads} "
                                         f"value+grad calls and {fun.values} value calls")
                launches[f"native_zoom_ricker_{iters}it"] = n
                per_call["native_zoom_ricker"] = n / fun.value_grads
        xc = inv["card", ZOOM_RICKER_ITERS].x.cpu().numpy()
        hold(f"zoom Ricker on the card, max_iter {ZOOM_RICKER_ITERS}, max |x - truth|",
             float(np.abs(xc - np.asarray(RICKER_TRUTH)).max()), RICKER_TRUTH_TOL)
        held_c, held_h = inv["card", ZOOM_RICKER_HELD], inv["cpu", ZOOM_RICKER_HELD]
        hold(f"zoom Ricker card vs cpu, max_iter {ZOOM_RICKER_HELD}, max |x diff|",
             float(np.abs(held_c.x.cpu().numpy() - held_h.x.numpy()).max()), RICKER_X_TOL)
        if (int(held_c.n_iter), calls["card", ZOOM_RICKER_HELD]) != (
                int(held_h.n_iter), calls["cpu", ZOOM_RICKER_HELD]):
            raise AssertionError(f"zoom Ricker over {ZOOM_RICKER_HELD} iterations: "
                                 f"{int(held_c.n_iter)} iterations and "
                                 f"{calls['card', ZOOM_RICKER_HELD]} calls on the card, "
                                 f"{int(held_h.n_iter)} and {calls['cpu', ZOOM_RICKER_HELD]} "
                                 f"on the cpu")

        # 14c(ii). the 64-start far-field study through the zoom, float32
        _, cfg11, prob11 = build_loc64_problem(NR_STUDY, f32, dev)
        opts = InvOptions(loc=True, cmt=False, mistype="OT")
        misfit11 = lambda ms: loc_cmt_misfit(ms, prob11, opts, cfg11)
        starts = study_starts(f32, dev)
        solve = lambda f: minimize_multi_start(f, starts, max_iter=30, tol=3e-5, method="zoom")
        fun = CountedObjective(misfit11)
        res, n = counted(lambda: solve(fun))
        err = torch.linalg.vector_norm(res.x.double() - torch.tensor(LOC, dtype=f64, device=dev),
                                       dim=1)
        launches["native_zoom_study"] = n
        per_call["native_zoom_study"] = n / fun.value_grads
        if n != fun.value_grads or fun.values:
            raise AssertionError(f"zoom study: {n} launches for {fun.value_grads} value+grad "
                                 f"calls and {fun.values} value calls")
    checks.check_held(held)

    # float32 sums by atomics may end a timed study after other calls: count them
    tfun = CountedObjective(misfit11)
    torch.cuda.synchronize()
    cuda_distance.LAUNCHES = 0
    study_ms = host_median_ms(lambda: solve(tfun), n=STUDY_TIMED, warm=0)
    torch.cuda.synchronize()
    if cuda_distance.LAUNCHES != tfun.value_grads or tfun.values:
        raise AssertionError(f"timed zoom studies: {cuda_distance.LAUNCHES} launches for "
                             f"{tfun.value_grads} value+grad and {tfun.values} value calls")
    print(f"[native] zoom study: {N_STARTS} starts, {NR_STUDY} stations, f32: {study_ms:.4f} ms "
          f"per study (host clock, synchronized, median of {STUDY_TIMED}) against "
          f"{batched_study_ms:.4f} ms for method 'batched' (phase 6, this run); iterations max "
          f"{int(res.n_iter.max())}, median {float(res.n_iter.float().median()):g}; batched "
          f"value+grad calls {fun.value_grads} (timed runs {tfun.value_grads / STUDY_TIMED:g} "
          f"per study), kernel launches {launches['native_zoom_study']}; "
          f"distance to the source max {err.max().item():.6f} km, median "
          f"{err.median().item():.6f} km (bound {STUDY_RADIUS_KM:g}) {card}")
    if not bool((err < STUDY_RADIUS_KM).all()):
        far = torch.nonzero(err >= STUDY_RADIUS_KM).flatten().tolist()
        raise AssertionError(f"zoom study: starts {far} end up to {err.max().item()} km from "
                             f"the source")
    timed(f"calcpdf(FMM) {RF_NU}x{RF_NTG}",
          lambda: fps["FMM"].calcpdf(lambdav=RF_LAMBDA, method="FMM"), 0)
    timed(f"calcpdf(Enumerate) {RF_NU}x{RF_NTG}",
          lambda: fps["Enumerate"].calcpdf(lambdav=RF_LAMBDA, method="Enumerate"), 1)
    timed(f"wasserPOT W2 {POT_GRID[0]}x{POT_GRID[1]}",
          lambda: compat.wasserPOT(*ot["card"], "W2"), 0)
    timed(f"sinkhornPOT W2 {POT_GRID[0]}x{POT_GRID[1]} gamma {SINKHORN_POT_GAMMAS[-1]:g}",
          lambda: compat.sinkhornPOT(*ot["card"], "W2", gamma=SINKHORN_POT_GAMMAS[-1]), 0)

    # 14d. the profiler's view of loc64 f32: the value+grad call (the headline;
    # there the kernel is ~5% of device time, near the fifth op) and its
    # forward alone, where the top five must hold the kernel
    _, cfg64, prob64 = build_loc64_problem(64, f32, dev)
    m64 = torch.tensor(LOC, dtype=f32, device=dev) + torch.tensor(DM, dtype=f32, device=dev)
    for what, call, top_five in (
            ("value+grad", lambda: loc_cmt_value_and_grad(m64, prob64, opts, cfg64), False),
            ("value", lambda: loc_cmt_misfit(m64, prob64, opts, cfg64), True)):
        ranked, _ = counted(lambda: top_device_ops(call, top=ALL_OPS), 2,
                            f"top_device_ops on loc64 {what} (a warm-up call and a profiled one)")
        for ms, name in ranked[:TOP_OPS]:
            print(f"[native] top_device_ops loc64 f32 {what}: {ms:.4f} ms  {name[:110]}")
        rank = [i for i, (_, name) in enumerate(ranked) if KERNEL_NAME in name]
        print(f"[native] top_device_ops loc64 f32 {what}: the distance-field kernel ranks "
              f"{rank[0] + 1 if rank else None} of {len(ranked)} device ops by time"
              + (f", {ranked[rank[0]][0]:.4f} ms" if rank else ""))
        if not rank:
            raise AssertionError(f"the profile of loc64 {what} holds no distance-field kernel")
        if top_five and rank[0] >= TOP_OPS:
            raise AssertionError(f"the distance-field kernel is not among loc64 {what}'s top "
                                 f"{TOP_OPS} device ops")
    print(f"[native] phase {time.perf_counter() - t_phase:.1f} s")
    return launches, per_call


def _value_and_grads(fn, *leaves):
    """(value, all gradients flattened into one vector) of the scalar
    fn(*leaves), by one autograd pass."""
    xs = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        v = fn(*xs)
        g = torch.autograd.grad(v, xs)
    return v.detach(), torch.cat([gi.reshape(-1) for gi in g])


def _vg_dev(got, ref) -> tuple[float, float]:
    """(value's relative deviation, gradient's deviation over max |g|)."""
    return abs(got[0].item() - ref[0].item()) / abs(ref[0].item()), _rel(got[1], ref[1])


def vg_check(value_tol, grad_tol):
    """check(got, ref) of two (value, gradient) pairs: raises unless the
    value is within ``value_tol`` relative and the gradient within
    ``grad_tol`` of max |g|; returns what it found."""
    def check(got, ref):
        dv, dg = _vg_dev(got, ref)
        if not (dv <= value_tol and dg <= grad_tol):
            raise AssertionError(f"value {dv:.3e} (bound {value_tol:g}), gradient {dg:.3e} "
                                 f"(bound {grad_tol:g})")
        return f"value rel {dv:.3e} (bound {value_tol:g}), gradient {dg:.3e} of max|g| " \
               f"(bound {grad_tol:g})"
    return check


def layered_check_f32(got, ref):
    """The layered f32 bars between two (value, gradient) pairs: value
    LAYERED_VALUE_RTOL_F32 relative, gradient cosine > GRAD_COS_F32, norm
    ratio in (0.5, 2)."""
    dv = abs(got[0].item() - ref[0].item()) / abs(ref[0].item())
    g, r = got[1].detach().double().cpu(), ref[1].detach().double().cpu()
    cos, ratio = (g @ r / (g.norm() * r.norm())).item(), (g.norm() / r.norm()).item()
    if not (dv <= LAYERED_VALUE_RTOL_F32 and cos > GRAD_COS_F32 and 0.5 < ratio < 2.0):
        raise AssertionError(f"layered f32: value {dv:.3e}, cosine {cos}, ratio {ratio}")
    return (f"value rel {dv:.3e} (bound {LAYERED_VALUE_RTOL_F32:g}), gradient cosine "
            f"{cos:.9f} (bound > {GRAD_COS_F32}), norm ratio {ratio:.9f} (bound (0.5, 2))")


def parallel_phase(dev, card: str) -> tuple[dict, dict]:
    """Phase 15: the parallel layer (waveform_ot_torch.parallel and the two
    sharded inversion entry points) at the full width of the problems above,
    on the mesh of the visible cards ("mesh1" on one card) and on
    PAR_SHARDS shards of ``dev`` ("mesh4"):

      a. trace-sharded loc64 (192 traces, 48 per shard on mesh4), value+grad
         through pjit_batched_misfit, f32 and f64;
      b. node-sharded scan: phase 7's 1,764 nodes (441 per shard) through
         misfit_grid_sharded, f32, with peak device memory;
      c. start-sharded study: phase 6's 64 starts (16 per shard) through
         minimize_multi_start_sharded, every start within 0.1 km, evaluations
         per shard;
      d. grid-sharded fingerprint: phase 12's 800x600 RF delayed by RF_SHIFT
         against the observed RF's marginals, 150 columns per shard, through
         grid_sharded_marg_misfit (value and gradients w.r.t. the polyline
         and the time shift) and grid_sharded_density, f64;
      e. dp x sp: the RF delayed by +RF_SHIFT and -RF_SHIFT, one per mesh row,
         300 columns per shard, on a (2, 2) mesh of ``dev`` (and (1, cards)
         over the cards), value and gradient, f64;
      f. station-sharded layered: phase 9's Fukuoka problem at PAR_NR_LAYERED
         = 12 stations, not 11, so that 4 shards divide them (3 per shard),
         f32 and f64.

    Each sharded call against the same call unsharded on the card (f64:
    value 1e-12, gradient 1e-11 of max |g|, the layered case 1e-9, JAX's
    contract; f32: the phase's card-vs-CPU bars), exactly one kernel launch
    per shard per evaluation (asserted), every launch outside the timing runs
    held bit for bit against the plain field; then a host-clock median of 3
    per call, unsharded and on each mesh. Returns the launches of each
    counted run and the launches per call."""
    from waveform_ot_torch import parallel as par
    from waveform_ot_torch.inversion import (
        InvOptions, LocCMTObjective, loc_cmt_misfit, loc_cmt_value_and_grad, misfit_grid,
        misfit_grid_sharded, minimize_multi_start, minimize_multi_start_sharded,
    )
    from waveform_ot_torch.models import make_layered_forward
    from waveform_ot_torch.ops import (
        Density1D, FingerprintSpec, cuda_distance, density_from_distance, distance_field_diff,
        grid_axes, make_density_1d, make_window, normalize_vertices,
    )
    from waveform_ot_torch.ops.marginal import marg_wasserstein_value

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    opts = InvOptions(loc=True, cmt=False, mistype="OT")
    chk = PhaseChecks("parallel", card)
    ncards = torch.cuda.device_count()
    meshes = {"mesh1": par.make_mesh(), f"mesh{PAR_SHARDS}": par.make_mesh(PAR_SHARDS, device=dev)}
    meshes_2d = {"mesh1": par.make_mesh_2d(1, ncards),
                 f"mesh{PAR_SHARDS}": par.make_mesh_2d(2, PAR_SHARDS // 2, device=dev)}
    cases = []   # (name, unsharded call, {mesh: (sharded call, shards)}, check(got, ref))

    # a. trace-sharded loc64
    for dt, tols in ((f32, (VALUE_RTOL_F32, GRAD_TOL_F32)),
                     (f64, (PAR_VALUE_RTOL_F64, PAR_GRAD_TOL_F64))):
        loc, cfg, prob = build_loc64_problem(64, dt, dev)
        m = loc + torch.tensor(DM, dtype=dt, device=dev)

        def sharded(mesh, prob=prob, cfg=cfg, m=m):
            placed = par.shard_leading_axis(prob, mesh)
            f = par.pjit_batched_misfit(lambda mm, pp: loc_cmt_misfit(mm, pp, opts, cfg), mesh)
            return lambda: _value_and_grads(lambda mm: f(mm, placed), m), mesh.size

        cases.append((f"loc64_{str(dt)[6:]}",
                      lambda prob=prob, cfg=cfg, m=m: loc_cmt_value_and_grad(m, prob, opts, cfg),
                      {k: sharded(mesh) for k, mesh in meshes.items()}, vg_check(*tols)))

    # b. node-sharded scan
    _, cfg11, prob11 = build_loc64_problem(NR_STUDY, f32, dev)
    nodes = scan_nodes(f32, dev)

    def scan_check(got, ref):
        dv = ((got - ref).abs() / ref.abs()).max().item()
        if not dv <= VALUE_RTOL_F32:
            raise AssertionError(f"scan values {dv:.3e} (bound {VALUE_RTOL_F32:g})")
        return f"{len(nodes)} nodes, value rel max {dv:.3e} (bound {VALUE_RTOL_F32:g})"

    cases.append(("scan", lambda: misfit_grid(nodes, prob11, opts, cfg11),
                  {k: (lambda mesh=mesh: misfit_grid_sharded(nodes, prob11, opts, cfg11,
                                                             mesh).gather(), mesh.size)
                   for k, mesh in meshes.items()}, scan_check))

    # d. grid-sharded fingerprint of the 800x600 RF, float64
    t0, t1, u0, u1, nu, ntg = rf_grid6()
    win = make_window(t0, t1, u0, u1, dtype=f64, device=dev)
    trf = torch.as_tensor(rf_waveform()[0], dtype=f64, device=dev)
    rf_verts = lambda shift: normalize_vertices(
        trf, torch.as_tensor(rf_waveform(shift)[1], dtype=f64, device=dev)[None], win)[0]
    tgrid, ugrid = grid_axes(trf, win, FingerprintSpec(nu=nu, ntg=ntg))
    with torch.no_grad():
        obs = density_from_distance(distance_field_diff(rf_verts(0.0)[None], tgrid[None],
                                                        ugrid[None]), RF_LAMBDA)[0]
    tgt_t, tgt_u = make_density_1d(obs.sum(0), tgrid), make_density_1d(obs.sum(1), ugrid)
    rows = lambda d, k: Density1D(*(a.expand(k, *a.shape) for a in d))
    verts = rf_verts(RF_SHIFT)
    zero = torch.zeros((), dtype=f64, device=dev)

    def plain_marg(v, ts):
        k = v.shape[0]
        u2d = density_from_distance(distance_field_diff(v, tgrid.expand(k, ntg),
                                                        ugrid.expand(k, nu)), RF_LAMBDA)
        wt, wu = marg_wasserstein_value(u2d, tgrid.expand(k, ntg), ugrid.expand(k, nu),
                                        rows(tgt_t, k), rows(tgt_u, k), p=2, tshift=ts)
        return (0.5 * wt + 0.5 * wu).sum()

    def grid_sharded(mesh):
        fn = par.grid_sharded_marg_misfit(mesh, lambdav=RF_LAMBDA, p=2)
        tg = par.shard_grid_axis(tgrid, mesh)

        def obj(v, ts):
            wt, wu = fn(v, tg, ugrid, tgt_t, tgt_u, ts)
            return 0.5 * wt + 0.5 * wu
        return lambda: _value_and_grads(obj, verts, zero), mesh.size

    cases.append(("grid_rf", lambda: _value_and_grads(lambda v, ts: plain_marg(v[None], ts),
                                                      verts, zero),
                  {k: grid_sharded(mesh) for k, mesh in meshes.items()},
                  vg_check(PAR_VALUE_RTOL_F64, PAR_GRAD_TOL_F64)))

    def density_check(got, ref):
        dv = _rel(got, ref)
        if not dv <= PAR_VALUE_RTOL_F64:
            raise AssertionError(f"sharded density {dv:.3e} (bound {PAR_VALUE_RTOL_F64:g})")
        return f"pdf {tuple(got.shape)} {dv:.3e} of its max (bound {PAR_VALUE_RTOL_F64:g})"

    cases.append(("grid_rf_density", lambda: density_from_distance(
        distance_field_diff(verts[None], tgrid[None], ugrid[None]), RF_LAMBDA)[0],
        {k: (lambda mesh=mesh, tg=par.shard_grid_axis(tgrid, mesh): par.grid_sharded_density(
            mesh, lambdav=RF_LAMBDA)(verts, tg, ugrid).gather(), mesh.size)
         for k, mesh in meshes.items()}, density_check))

    # e. dp x sp: two delayed RFs against the observed marginals
    verts_b = torch.stack([rf_verts(sh) for sh in PAR_DP_SP_SHIFTS])
    shifts = torch.zeros(len(PAR_DP_SP_SHIFTS), dtype=f64, device=dev)
    nb = len(PAR_DP_SP_SHIFTS)

    def dp_sp(mesh):
        fn = par.dp_sp_marg_misfit(mesh, lambdav=RF_LAMBDA, p=2, alpha=0.5)
        tg = par.shard_grid_axis(tgrid, mesh, axis_name="seq")
        return (lambda: _value_and_grads(lambda v: fn(v, tg, ugrid, rows(tgt_t, nb),
                                                      rows(tgt_u, nb), shifts), verts_b),
                mesh.size)

    cases.append(("dp_sp_rf", lambda: _value_and_grads(lambda v: plain_marg(v, shifts), verts_b),
                  {k: dp_sp(mesh) for k, mesh in meshes_2d.items()},
                  vg_check(PAR_VALUE_RTOL_F64, PAR_GRAD_TOL_F64)))

    # f. station-sharded layered, 12 stations
    for dt, check in ((f32, layered_check_f32),
                      (f64, vg_check(PAR_LAYERED_TOL_F64, PAR_LAYERED_TOL_F64))):
        lloc, lcfg, lprob, lfwd, _ = build_layered_problem(dt, dev, nr=PAR_NR_LAYERED)
        # model=None: the Fukuoka model built on each shard's device
        dyn = make_layered_forward(nt=NT, dt=1.0, nk=LAYERED_NK, kmax=LAYERED_KMAX)
        lm = lloc + torch.tensor(DM, dtype=dt, device=dev)

        def lsharded(mesh, lprob=lprob, lcfg=lcfg, lm=lm, dyn=dyn):
            placed = par.shard_leading_axis(lprob, mesh)
            f = par.pjit_batched_misfit(lambda mm, pp: loc_cmt_misfit(
                mm, pp, opts, lcfg, forward=lambda x, y, z, mx: dyn(x, y, z, mx, pp.stations)),
                mesh)
            return lambda: _value_and_grads(lambda mm: f(mm, placed), lm), mesh.size

        cases.append((f"layered12_{str(dt)[6:]}",
                      lambda lprob=lprob, lcfg=lcfg, lm=lm, lfwd=lfwd: loc_cmt_value_and_grad(
                          lm, lprob, opts, lcfg, forward=lfwd),
                      {k: lsharded(mesh) for k, mesh in meshes.items()}, check))

    # counted runs, every launch held
    launches, per_call, peaks = {}, {}, {}
    cuda_distance.LAUNCHES_BY_DEVICE.clear()
    with held_launches("parallel") as held:
        for name, unsharded, by_mesh, check in cases:
            torch.cuda.reset_peak_memory_stats()
            ref, n = chk.counted(unsharded, want=1, what=f"{name} unsharded")
            peaks[name, "unsharded"] = torch.cuda.max_memory_allocated() / 1e9
            launches[f"par_{name}"] = n
            for label, (fn, shards) in by_mesh.items():
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                got, n = chk.counted(fn, want=shards, what=f"{name} {label}")
                peaks[name, label] = torch.cuda.max_memory_allocated() / 1e9
                launches[f"par_{name}_{label}"] = n
                per_call[f"par_{name}_{label}"] = n
                print(f"[parallel] {name} {label} ({shards} shards) vs unsharded: "
                      f"{check(got, ref)}; kernel launches {n} (one per shard); peak device "
                      f"memory {peaks[name, label]:.3f} GB (unsharded "
                      f"{peaks[name, 'unsharded']:.3f} GB)")
            del ref, got
            torch.cuda.empty_cache()

        # c. the start-sharded study
        starts = study_starts(f32, dev)
        rep = par.replicate(LocCMTObjective(prob11, opts, cfg11), meshes["mesh1"])
        objs = dict(zip(meshes["mesh1"].devices, rep.parts))
        follow = lambda ms: objs[ms.device](ms)      # the objective on the models' device
        loc_d = torch.tensor(LOC, dtype=f64, device=dev)
        study = {"unsharded": lambda f: minimize_multi_start(f, starts, max_iter=30, tol=3e-5)}
        study.update({k: (lambda f, mesh=mesh: minimize_multi_start_sharded(
            f, starts, mesh, max_iter=30, tol=3e-5).gather()) for k, mesh in meshes.items()})
        results = {}
        for label, solve in study.items():
            fun = CountedObjective(follow)
            res, n = chk.counted(lambda: solve(fun), what=f"study {label}")
            evals = fun.values + fun.value_grads
            err = torch.linalg.vector_norm(res.x.double() - loc_d, dim=1)
            runs = {str(d): solver_runs(calls) for d, calls in fun.log.items()}
            results[label] = res
            launches[f"par_study_{label}"] = n
            per_call[f"par_study_{label}"] = n / evals
            same = (int((res.n_iter == results["unsharded"].n_iter).sum()),
                    (res.x - results["unsharded"].x).abs().max().item())
            print(f"[parallel] study {label}: {N_STARTS} starts, f32; batched evaluations "
                  f"{evals}, kernel launches {n}; [value+grad calls, trials] per shard "
                  f"{runs}; distance to the source max {err.max().item():.6f} km (bound "
                  f"{STUDY_RADIUS_KM:g}); lanes with the unsharded n_iter {same[0]} of "
                  f"{N_STARTS}, max |x - x_unsharded| {same[1]:.3e} km")
            if n != evals:
                raise AssertionError(f"study {label}: {n} launches for {evals} evaluations")
            if not bool((err < STUDY_RADIUS_KM).all()):
                raise AssertionError(f"study {label}: a start ends {err.max().item()} km "
                                     f"from the source")
    chk.check_held(held)
    print(f"[parallel] kernel launches by device outside the timing runs: "
          f"{cuda_distance.LAUNCHES_BY_DEVICE}")
    checked_s = time.perf_counter() - t_phase

    # timing runs
    ms_by = {}
    for name, unsharded, by_mesh, _ in cases:
        ms_by[name, "unsharded"] = chk.timed(f"{name} unsharded", unsharded, 1, PAR_TIMED)
        for label, (fn, shards) in by_mesh.items():
            ms_by[name, label] = chk.timed(f"{name} {label}", fn, shards, PAR_TIMED)
    for label, solve in study.items():
        fun = CountedObjective(follow)
        torch.cuda.synchronize()
        cuda_distance.LAUNCHES = 0
        ms = host_median_ms(lambda: solve(fun), n=PAR_TIMED, warm=0)
        evals = fun.values + fun.value_grads
        print(f"[timing] parallel study {label}: {ms:.4f} ms per study (host clock, "
              f"synchronized, median of {PAR_TIMED}); {evals} batched evaluations and "
              f"{cuda_distance.LAUNCHES} kernel launches over the {PAR_TIMED} studies {card}")
        if cuda_distance.LAUNCHES != evals:
            raise AssertionError(f"study {label} timing: {cuda_distance.LAUNCHES} launches "
                                 f"for {evals} evaluations")
    print(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s ({checked_s:.1f} s before "
          f"the timing runs)")
    return launches, per_call


def example(name: str):
    """The module examples/torch_<name>.py, imported without running its main."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                  REPO / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(dev, card: str, variant) -> tuple[dict, dict, list]:
    """Phase 16: the port's nine example scripts on the card, each through
    its ``run`` at the script's defaults (and ricker_inversion with
    zoom=True; multi_start_basins's joint far-field mode through its
    build_study and solve at EXAMPLE_CMT_ITERS iterations). Each
    script's own assertions hold; its kernel launches are counted and
    asserted (one per objective evaluation, scan or surface, none for the
    point masses or a least-squares moment tensor); every launch outside the
    scaling study's timing runs is held bit for bit against the plain field
    (held_launches; the study's calls are held by the same calls at its
    shapes outside its timing); where the same run on the CPU is cheap (the
    point masses, the migration self-test, the derivative walkthrough, the
    Ricker scipy inversion, the receiver function's fields) the card is held
    against it. Prints each script's host wall time, and loc1024's
    value+grad time, traces/s and the kernel's device time and share at its
    3,072 traces. Returns the launches by script, the launches per
    evaluation or per run, and loc1024's by_shape row."""
    from waveform_ot_torch.ops import DistanceField, cuda_distance, distance_field_torch

    cpu = "cpu"
    t_phase = time.perf_counter()
    launches, per_call = {}, {}
    checks = PhaseChecks("examples", card)
    counted, hold = checks.counted, checks.hold
    mods = {name: example(name) for name in (
        "point_mass_demo", "reference_migration", "ricker_inversion", "ricker_misfit_surfaces",
        "derivative_walkthrough", "receiver_function_demo", "loc_cmt_inversion",
        "multi_start_basins", "scaling_study")}

    def rel(a, b) -> float:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / np.abs(b).max())

    with held_launches("examples") as held:
        def on_card(key, name, want=None, call=None, how=None, **kw):
            """run(dev, **kw), or ``call()`` described by ``how``, counted
            and timed (host clock, the checks' time taken out): (result,
            launches)."""
            t0, c0 = time.perf_counter(), held["check_s"]
            r, n = counted(call or (lambda: mods[name].run(dev, **kw)), want, f"examples {key}")
            wall = time.perf_counter() - t0 - (held["check_s"] - c0)
            launches[f"examples_{key}"] = n
            how = how or "run(" + ", ".join(f"{k}={v!r}" for k, v in kw.items()) + ")"
            print(f"[examples] {key}: {how} on the card in {wall:.3f} s (host clock, one run, "
                  f"the launch checks' time taken out), kernel launches {n} {card}")
            return r, n

        # 1. the point masses: no distance field
        r, n = on_card("point_mass_demo", "point_mass_demo", 0)
        c = mods["point_mass_demo"].run(cpu)
        print(f"[examples] point masses: W1 {r['w1']!r} W2^2 {r['w2']!r} linprog "
              f"{r['w2_linprog']!r} numint {r['w1_numint']!r} {r['w2_numint']!r}")
        for k in ("w1", "w2", "plan", "path_pos", "path_mass"):
            hold(f"point masses {k} card vs cpu, relative", rel(r[k], c[k]), CLOSED_RTOL)
        per_call["examples_point_mass_demo"] = n

        # 2. the reference-migration self-test: one launch per calcpdf
        r, n = on_card("reference_migration", "reference_migration", 2)
        c = mods["reference_migration"].run(cpu)
        print(f"[examples] migration: W1 {r['w1']!r} W2^2 {r['w2']!r} Sinkhorn_MS "
              f"{r['w2_sinkhorn']!r} MargWasserstein {r['marg_w'].tolist()} sliced {r['sliced']!r}")
        for k in ("w1", "w2", "w2_sinkhorn", "plan", "marg_w", "sliced"):
            hold(f"migration {k} card vs cpu, relative", rel(r[k], c[k]), CLOSED_RTOL)
        per_call["examples_reference_migration"] = n

        # 3. the Ricker inversion: scipy (card vs cpu) and the zoom
        for zoom in (False, True):
            key = "ricker_inversion_zoom" if zoom else "ricker_inversion"
            r, n = on_card(key, "ricker_inversion", zoom=zoom)
            print(f"[examples] {key}: x {r['x'].tolist()} after {r['nit']} iterations, "
                  f"{r['evaluations']} evaluations, w2 {r['fun']!r}, max |x - truth| "
                  f"{r['err'].max():.3e}")
            if n != 1 + r["evaluations"]:
                raise AssertionError(f"{key}: {n} launches for the observed fingerprint and "
                                     f"{r['evaluations']} evaluations")
            per_call[f"examples_{key}"] = (n - 1) / r["evaluations"]
            if not zoom:
                c = mods["ricker_inversion"].run(cpu)
                hold("ricker_inversion card vs cpu, max |x diff|",
                     float(np.abs(r["x"] - c["x"]).max()), RICKER_X_TOL)
                if r["nit"] != c["nit"]:
                    raise AssertionError(f"ricker_inversion: {r['nit']} iterations on the card, "
                                         f"{c['nit']} on the cpu")

        # 4. the misfit surfaces: one launch per W profile and surface
        r, n = on_card("ricker_misfit_surfaces", "ricker_misfit_surfaces",
                       EXAMPLE_FIXED_LAUNCHES["ricker_misfit_surfaces"])
        print(f"[examples] surfaces: profile local minima {r['profile_minima']}, minima "
              f"{ {k: v.tolist() for k, v in r['minima'].items()} }")
        per_call["examples_ricker_misfit_surfaces"] = n

        # 5. the derivative walkthrough, float64 on the card
        r, n = on_card("derivative_walkthrough", "derivative_walkthrough",
                       EXAMPLE_FIXED_LAUNCHES["derivative_walkthrough"])
        c = mods["derivative_walkthrough"].run(cpu)
        print(f"[examples] derivative walkthrough: max FD errors {r['err1'].max():.3e} "
              f"{r['err2'].max():.3e} {r['err3'].max():.3e} (bound 1e-6), W2 {r['w2']!r}")
        for k in ("grad1", "grad2", "grad3", "w2", "dm"):
            hold(f"derivative walkthrough {k} card vs cpu, relative", rel(r[k], c[k]), CLOSED_RTOL)
        per_call["examples_derivative_walkthrough"] = n

        # 6. the receiver-function demo, 800x600
        r, n = on_card("receiver_function_demo", "receiver_function_demo",
                       EXAMPLE_FIXED_LAUNCHES["receiver_function_demo"])
        c = mods["receiver_function_demo"].run(cpu)
        print(f"[examples] RF: Dmin {r['dmin']!r} Dmax {r['dmax']!r} PDFmin {r['pdfmin']!r} "
              f"PDFmax {r['pdfmax']!r}; FMM vs exact over the band median {r['band_median']!r} "
              f"max {r['band_max']!r}")
        for k in ("d_exact", "pdf"):
            hold(f"RF {k} card vs cpu, max abs",
                 float(np.abs(r["figures"][k] - c["figures"][k]).max()), PDF_ATOL)
        hold("RF FMM vs exact, median |d| over d > 2/nu", r["band_median"], FMM_MEDIAN_BOUND)
        hold("RF FMM vs exact, max |d| over d > 2/nu", r["band_max"], FMM_MAX_BOUND)
        per_call["examples_receiver_function_demo"] = n

        # 7. the loc/CMT inversions and scan through the layered physics: the
        # observed fingerprints, one launch per OT evaluation, none for L2, and
        # one per scan call (layered_misfit_grid: every node in one evaluation)
        r, n = on_card("loc_cmt_inversion", "loc_cmt_inversion")
        inv = r["inversions"]
        print(f"[examples] loc/CMT layered: OT |err| {inv['OT']['err']:.4f} km in "
              f"{inv['OT']['nit']} iterations, {inv['OT']['nfev']} evaluations; L2 |err| "
              f"{inv['L2']['err']:.4f} km in {inv['L2']['nit']} iterations; scan of "
              f"{len(r['scan']['models'])} nodes, minimum at {r['scan']['minimum'].tolist()}")
        if n != 1 + inv["OT"]["nfev"] + 2:
            raise AssertionError(f"loc_cmt_inversion: {n} launches for 1 + {inv['OT']['nfev']} "
                                 f"OT evaluations + 2 scans")
        per_call["examples_loc_cmt_inversion"] = (n - 3) / inv["OT"]["nfev"]

        # 8. the studies: layered (default) and the joint far-field mode, cut
        # to EXAMPLE_CMT_ITERS iterations (see there); the 16 least-squares
        # tensors of the joint mode launch nothing
        msb = mods["multi_start_basins"]

        def joint_cut():
            st = msb.build_study(dev, cmt=True, physics="farfield")
            return {"starts": len(st["starts"]),
                    **{m: msb.solve(st, m, max_iter=EXAMPLE_CMT_ITERS) for m in ("OT", "L2")}}

        for key, call, how in (
                ("multi_start_basins", None, None),
                ("multi_start_basins_cmt", joint_cut, "build_study(cmt=True, physics='farfield'), "
                 f"solve(max_iter={EXAMPLE_CMT_ITERS}) per misfit")):
            r, n = on_card(key, "multi_start_basins", call=call, how=how)
            for m in ("OT", "L2"):
                o = r[m]
                print(f"[examples] {key} {m}: {r['starts']} starts, {100 * o['frac']:.0f}% within "
                      f"2 km, median |err| {np.median(o['dist']):.3f} km, {o['evaluations']} "
                      f"batched evaluations, {o['ls_failed']} failed line-search lanes"
                      + (f", median CMT rel err {np.median(o['cmt_rel_err']):.3f}"
                         if "cmt_rel_err" in o else ""))
            if n != 1 + r["OT"]["evaluations"]:
                raise AssertionError(f"{key}: {n} launches for 1 + {r['OT']['evaluations']} OT "
                                     f"evaluations")
            per_call[f"examples_{key}"] = (n - 1) / r["OT"]["evaluations"]

        # 9. the scaling study's shapes, held outside its timing runs
        sc = mods["scaling_study"]
        _, n = counted(lambda: [sc.time_value_and_grad(nr, dev, n_iter=1) for nr in SCALING_SIZES]
                       + [sc.inversions(k, dev) for k in (16, 32)])
    checks.check_held(held)

    # 9. the scaling study, timed (its launches counted, not held)
    t0 = time.perf_counter()
    r, n = counted(lambda: sc.run(dev))
    wall = time.perf_counter() - t0
    evals = sum(o["evaluations"] for o in r["inversions"])
    want = SCALING_CALLS * len(SCALING_SIZES) + len(r["inversions"]) + evals
    print(f"[examples] scaling_study: run() on the card in {wall:.3f} s (host clock, one run), "
          f"kernel launches {n} ({SCALING_CALLS} per size, 1 per inversion problem and {evals} "
          f"batched evaluations) {card}")
    if n != want:
        raise AssertionError(f"scaling_study: {n} launches, not {want}")
    launches["examples_scaling_study"] = n
    per_call["examples_scaling_study"] = 1.0
    for s in r["value_and_grad"]:
        print(f"[examples] loc{s['stations']}: value+grad {s['seconds'] * 1e3:.4f} ms/call (host "
              f"clock, synchronized, mean of 30) = {s['traces_per_s']:.1f} traces/s, "
              f"{s['traces']} traces, f32 {card}")
    for o in r["inversions"]:
        print(f"[examples] {o['k']} simultaneous inversions: {o['seconds'] * 1e3:.4f} ms "
              f"({o['ms_per_inversion']:.4f} ms/inversion), {100 * o['converged']:.0f}% within "
              f"2 km, median iterations {o['median_iters']} {card}")

    # loc1024's kernel: bit for bit the plain field, its device time and share
    loc, cfg, prob = build_loc64_problem(1024, torch.float32, dev)
    with torch.no_grad():
        args = loc_field_inputs((loc + torch.tensor(DM, dtype=torch.float32, device=dev))[None],
                                prob, cfg)
    got = DistanceField(*cuda_distance.distance_field_cuda(*args))
    ref = distance_field_torch(*args)
    rep = compare_fields(got, ref, TOL[torch.float32])
    same = all(torch.equal(x, y) for x, y in zip(got, ref))
    k = device_ms(lambda: cuda_distance.distance_field_cuda(*args), launches=BACK_TO_BACK,
                  samples=SAMPLES)
    plain = device_ms(lambda: distance_field_torch(*args), launches=PLAIN_BACK_TO_BACK)
    bound, bound_by = kernel_bound(*args)
    s_split, ptx = variant(args)
    row = {"shape": "loc1024", "dtype": "float32", "traces": args[0].shape[0], "S": s_split,
           "ms": k, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
           "share": bound / k}
    print(f"[timing] distance field loc1024 float32 B={args[0].shape[0]} S={s_split}: kernel "
          f"{k:.6f} ms (device, {BACK_TO_BACK} back-to-back launches, median of {SAMPLES}), "
          f"bound {bound:.6f} ms ({bound_by}), share {bound / k:.4f}, plain {plain:.4f} ms "
          f"({PLAIN_BACK_TO_BACK} back-to-back calls); bit-identical {same}, "
          f"{json.dumps(rep)}; ptxas: {ptx} {card}")
    if not same:
        raise AssertionError("the kernel at loc1024 differs from the plain field")
    print(f"[examples] phase {time.perf_counter() - t_phase:.1f} s")
    return launches, per_call, [row]


def entry_phase(dev, card: str) -> tuple[dict, dict]:
    """Phase 17: the system's own entry points (waveform_ot_torch.entry,
    the port's __graft_entry__) on the card:

      a. entry() at JAX's sizes (4 stations, nt 61, nk 96, f32): value+grad
         in exactly one kernel launch, against entry(device="cpu",
         dtype=float64) at the layered f32 bars (value 1e-3, gradient cosine
         > 0.97, norm ratio in (0.5, 2)); host ms, median of 20;
      b. dryrun_multichip(4) and dryrun_multichip(8) on shards of the card:
         every step finite (the function checks), each step's value and
         gradient against dryrun_multichip(n, device="cpu") (f32 both) at the
         f32 bars (far field: value 1e-4, gradient 1e-3 of max |g|; layered:
         as in a), the Adam steps' m1 within ENTRY_M1_RTOL, one kernel launch
         per shard per step (asserted);
      c. the two Adam steps at full width, unsharded, on the mesh of the
         visible cards ("mesh1") and on PAR_SHARDS shards of ``dev``: the
         trace-sharded far-field step at loc64 (64 stations, 192 traces,
         79x61, f32) and the station-sharded layered step at the bench's
         width with 12 stations (PAR_NR_LAYERED; nt 61, nk 512, f32), each
         against its unsharded step at the f32 bars, one launch per shard
         (asserted), peak device memory; host ms per step, median of 20.

    Every kernel launch outside the timing runs is held bit for bit against
    the plain field (held_launches). Returns the launches of each counted
    run and the launches per call."""
    from waveform_ot_torch import entry as E
    from waveform_ot_torch import parallel as par
    from waveform_ot_torch.models import make_layered_forward

    t_phase = time.perf_counter()
    f32 = torch.float32
    chk = PhaseChecks("entry", card)
    launches, per_call = {}, {}

    far_check = vg_check(VALUE_RTOL_F32, GRAD_TOL_F32)
    pair = lambda d, key: (torch.tensor(d["value"]), d[key])   # a dryrun step's (value, grad)

    def m1_check(got, ref):
        dm = _rel(got, ref)
        if not dm <= ENTRY_M1_RTOL:
            raise AssertionError(f"m1 {dm:.3e} (bound {ENTRY_M1_RTOL:g})")
        return f"m1 {dm:.3e} of max|m| (bound {ENTRY_M1_RTOL:g})"

    # c's cases: {label: (misfit, shards)} and the start of each
    loc, cfg, prob = E._build_problem(64, f32, dev)
    lloc, lcfg, lprob, _ = E._build_layered_problem(PAR_NR_LAYERED, nk=LAYERED_NK,
                                                    kmax=LAYERED_KMAX, dtype=f32, device=dev)
    dyn = make_layered_forward(nt=NT, dt=1.0, nk=LAYERED_NK, kmax=LAYERED_KMAX)
    meshes = {"mesh1": par.make_mesh(), f"mesh{PAR_SHARDS}": par.make_mesh(PAR_SHARDS, device=dev)}

    def variants(p, c, fwd=None):
        out = {"unsharded": (E.loc_misfit(p, c, forward=fwd), 1)}
        out.update({k: (E.loc_misfit(par.shard_leading_axis(p, mesh), c, mesh, forward=fwd),
                        mesh.size) for k, mesh in meshes.items()})
        return out

    adam_cases = {
        "adam_loc64": (loc + 3.0, variants(prob, cfg), far_check),
        "adam_layered12": (lloc + torch.tensor(E.LAYERED_START, dtype=f32, device=dev),
                           variants(lprob, lcfg, dyn), layered_check_f32)}

    with held_launches("entry") as held:
        # a. entry()
        fn, (m0, eprob) = E.entry()
        (v, g), n = chk.counted(lambda: fn(m0, eprob), want=1, what="entry()")
        launches["entry"] = per_call["entry"] = n
        cfn, (cm0, cprob) = E.entry(device="cpu", dtype=torch.float64)
        cv, cg = cfn(cm0, cprob)
        print(f"[entry] entry() f32 on the card: value {v.item()!r} grad {g.tolist()}, kernel "
              f"launches {n}; f64 on the cpu: value {cv.item()!r} grad {cg.tolist()}; "
              f"{layered_check_f32((v, g), (cv, cg))}")

        # b. dryrun_multichip on shards of the card against the CPU
        for n_dev in ENTRY_DRYRUN_SHARDS:
            print(f"[entry] dryrun_multichip({n_dev}) on {dev}:")
            got, n = chk.counted(lambda n_dev=n_dev: E.dryrun_multichip(n_dev),
                                 what=f"dryrun_multichip({n_dev})")
            print(f"[entry] dryrun_multichip({n_dev}) on the cpu (f32):")
            ref = E.dryrun_multichip(n_dev, device="cpu")
            steps = [k for k in ENTRY_STEP_KEYS if k in got]
            # the steps' evaluations and the observed fingerprints of steps a and d's problems
            if n != sum(got[k]["launches"] for k in steps) + 2 or len(steps) != 4:
                raise AssertionError(f"dryrun_multichip({n_dev}): {n} launches, steps {steps}")
            for k in steps:
                a, r, gk = got[k], ref[k], ENTRY_STEP_KEYS[k]
                check = layered_check_f32 if k == "layered" else far_check
                what = check(pair(a, gk), pair(r, gk))
                if "m1" in a:
                    what += "; " + m1_check(a["m1"], r["m1"])
                launches[f"entry_dryrun{n_dev}_{k}"] = a["launches"]
                per_call[f"entry_dryrun{n_dev}_{k}"] = a["launches"]
                print(f"[entry] dryrun_multichip({n_dev}) {k}: card vs cpu {what}; kernel "
                      f"launches {a['launches']} (one per shard)")
                if a["launches"] != n_dev:
                    raise AssertionError(f"dryrun_multichip({n_dev}) {k}: {a['launches']} "
                                         f"launches on {n_dev} shards")

        # c. the Adam steps at full width
        peaks, m1s = {}, {}
        for name, (start, by, check) in adam_cases.items():
            first = {}
            for label, (misfit, shards) in by.items():
                m = start.clone().requires_grad_(True)
                opt = E.adam(m)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                (v, g), n = chk.counted(lambda: E.adam_step(misfit, m, opt), want=shards,
                                        what=f"{name} {label}")
                peaks[name, label] = torch.cuda.max_memory_allocated() / 1e9
                first[label] = (v, g, m.detach().clone())
                launches[f"entry_{name}_{label}"] = per_call[f"entry_{name}_{label}"] = n
                if not (np.isfinite(v.item()) and bool(torch.isfinite(g).all())
                        and bool(torch.isfinite(m).all())):
                    raise AssertionError(f"{name} {label}: non-finite step")
                if label != "unsharded":
                    rv, rg, rm = first["unsharded"]
                    what = check((v, g), (rv, rg)) + "; " + m1_check(m, rm)
                    m1s[name, label] = _rel(m, rm)
                    print(f"[entry] {name} {label} ({shards} shards) vs unsharded: {what}; "
                          f"kernel launches {n}")
            print(f"[entry] {name}: m0 {start.tolist()} -> m1 {first['unsharded'][2].tolist()} "
                  f"(unsharded), value {first['unsharded'][0].item()!r}")
            del first
            torch.cuda.empty_cache()
    chk.check_held(held)
    checked_s = time.perf_counter() - t_phase

    # timing runs
    chk.timed("entry() value+grad", lambda: fn(m0, eprob), 1, N_TIMED)
    for name, (start, by, _) in adam_cases.items():
        for label, (misfit, shards) in by.items():
            m = start.clone().requires_grad_(True)
            opt = E.adam(m)
            ms = chk.timed(f"{name} {label}", lambda: E.adam_step(misfit, m, opt), shards, N_TIMED)
            print(f"[entry] {name} {label}: {ms:.4f} ms per Adam step (host clock, synchronized, "
                  f"median of {N_TIMED}), kernel launches per step {shards}, peak device memory "
                  f"{peaks[name, label]:.3f} GB, m1 vs unsharded "
                  f"{m1s.get((name, label), 0.0):.3e} of max|m| {card}")
    print(f"[entry] phase {time.perf_counter() - t_phase:.1f} s ({checked_s:.1f} s before the "
          f"timing runs)")
    return launches, per_call


def bench_phase(card: str) -> tuple[dict, dict]:
    """Phase 18: the port's benchmark program, ``python -m
    waveform_ot_torch.bench``, run as a subprocess on the card (its ten
    stages each in a process of its own, budget BENCH_BUDGET_S). Its stderr
    is echoed under ``[bench]``; its last stdout line must have all ten
    statuses "ok", every value non-null and finite, bench.py's headline and
    eleven extra metric strings (BENCH_METRICS), f32dev's deviations within
    phase 3's bars, and each stage's kernel launches (from its raw numbers on
    stderr) 1 per call, 1 per batched evaluation for the two studies. Returns
    the launches ({"bench": every stage's}) and the launches per call or
    evaluation by stage."""
    t_phase = time.perf_counter()
    env = {**os.environ, "WOT_BENCH_BUDGET_S": str(BENCH_BUDGET_S)}
    proc = subprocess.Popen([sys.executable, "-m", "waveform_ot_torch.bench"], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)   # the bench and its stage process
        out, err = proc.communicate()
    for line in err.splitlines():
        print(f"[bench] {line}")
    lines = out.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"the bench exited {proc.returncode}; its last line: "
                             f"{lines[-1] if lines else None}")
    print(f"[bench] {lines[-1]}")
    line = json.loads(lines[-1])
    status = line["stages"]
    if status != {name: "ok" for name in BENCH_STAGES}:
        raise AssertionError(f"bench stages {status}")
    if line["metric"] != BENCH_HEADLINE or [r["metric"] for r in line["extra"]] != BENCH_METRICS:
        raise AssertionError("the bench line's metric strings are not bench.py's")
    values = [line["value"]] + [r["value"] for r in line["extra"]]
    if not all(v is not None and np.isfinite(v) for v in values):
        raise AssertionError(f"bench values {values}")
    dv, dg = line["extra"][-2]["value"], line["extra"][-1]["value"]
    print(f"[bench] f32dev on the card: value rel dev {dv:.3e} (bound {VALUE_RTOL_F32:g}), "
          f"grad dev / max|g| {dg:.3e} (bound {GRAD_TOL_F32:g})")
    if not (dv <= VALUE_RTOL_F32 and dg <= GRAD_TOL_F32):
        raise AssertionError("f32dev deviates from the f64 oracle")

    raw = {}
    for entry_line in err.splitlines():
        if entry_line.startswith("[bench stage] "):
            name, numbers = entry_line[len("[bench stage] "):].split(" ", 1)
            raw[name] = json.loads(numbers)
    if sorted(raw) != sorted(BENCH_STAGES):
        raise AssertionError(f"raw numbers of stages {sorted(raw)}")
    per_call = {}
    for name in BENCH_STAGES:
        key = "launches_per_evaluation" if name in BENCH_STUDIES else "launches_per_call"
        per_call[f"bench_{name}"] = raw[name][key]
        if name in BENCH_STUDIES:
            what = (f"{raw[name]['per'] * 1e3:.4f} ms per study, "
                    f"{raw[name]['evaluations']:g} batched evaluations per study")
        elif name == "f32dev":
            what = f"value deviation {raw[name]['dv']:.3e}, gradient {raw[name]['dg']:.3e}"
        else:
            what = f"{raw[name]['per'] * 1e3:.4f} ms per call"
        print(f"[bench] {name}: {what} (host clock, synchronized, mean after a warm call), "
              f"{key} {raw[name][key]:g}, launches {raw[name]['launches']} {card}")
        if raw[name][key] != 1:
            raise AssertionError(f"bench {name}: {key} {raw[name][key]}, not 1")
    launches = {"bench": sum(r["launches"] for r in raw.values())}
    print(f"[bench] phase {time.perf_counter() - t_phase:.1f} s")
    return launches, per_call


def surface_phase(dev, card: str) -> tuple[dict, dict]:
    """Phase 19: the parts of the JAX package's public surface the port
    binds as the JAX package does (tests/test_torch_surface.py holds the
    whole surface on the CPU), on the card:

      a. ``waveform_ot_torch.ops.wasser``, the function ops/__init__ binds,
         on the time and amplitude marginals of phase 12's 800x600 RF
         fingerprint and its copy delayed RF_SHIFT s (float64, both
         fingerprints in one kernel launch): W1, W2 and W12 each within
         SURFACE_RTOL of the same call on those marginals on the CPU; host ms
         per W12 call;
      b. ``utils.top_device_ops`` on loc64 f32 value+grad with ``trace_dir``:
         its trace file is left there, non-empty and naming the kernel, and
         the kernel is in the ranking (a warm-up call and a profiled one: 2
         launches);
      c. ``utils.save_checkpoint(path, pytree=...)`` of CUDA tensors and
         ``restore_checkpoint``: every tensor back bit for bit, with its dtype
         and device, with and without a template.

    Every kernel launch is held bit for bit against the plain field
    (held_launches). Returns the path's launches and the launches per call."""
    import tempfile

    from waveform_ot_torch import ops, utils
    from waveform_ot_torch.inversion import InvOptions, loc_cmt_value_and_grad
    from waveform_ot_torch.ops import FingerprintSpec, fingerprint_density, make_window

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    chk = PhaseChecks("surface", card)
    launches, per_call = {}, {}
    cpu = torch.device("cpu")

    t0, t1, u0, u1, nu, ntg = rf_grid6()
    win = make_window(t0, t1, u0, u1, dtype=f64, device=dev)
    trf = torch.as_tensor(rf_waveform()[0], dtype=f64, device=dev)
    waves = torch.stack([torch.as_tensor(rf_waveform(s)[1], dtype=f64, device=dev)
                         for s in (RF_SHIFT, 0.0)])
    _, cfg64, prob64 = build_loc64_problem(64, f32, dev)
    m64 = torch.tensor(LOC, dtype=f32, device=dev) + torch.tensor(DM, dtype=f32, device=dev)
    opts = InvOptions(loc=True, cmt=False, mistype="OT")

    with held_launches("surface") as held:
        # a. ops.wasser on the RF marginals, card against the CPU
        with torch.no_grad():
            (pdf, (tg, ug)), n = chk.counted(
                lambda: fingerprint_density(trf, waves, win, FingerprintSpec(nu=nu, ntg=ntg),
                                            lambdav=RF_LAMBDA), want=1,
                what=f"the two {nu}x{ntg} RF fingerprints")
        launches["surface_fingerprints"] = per_call["surface_fingerprints"] = n
        margs = {"time": [ops.make_density_1d(pdf[i].sum(0), tg[i]) for i in (0, 1)],
                 "amplitude": [ops.make_density_1d(pdf[i].sum(1), ug[i]) for i in (0, 1)]}
        for axis, (src, tgt) in margs.items():
            on_cpu = [ops.Density1D(*(a.cpu() for a in d)) for d in (src, tgt)]
            for distfunc in ("W1", "W2", "W12"):
                got = [float(w) for w in ops.wasser(src, tgt, distfunc)]
                ref = [float(w) for w in ops.wasser(*on_cpu, distfunc)]
                chk.hold(f"ops.wasser {distfunc} on the {axis} marginals ({len(got)} values "
                         f"{got}), card vs cpu, relative",
                         max(abs(a - b) / abs(b) for a, b in zip(got, ref)), SURFACE_RTOL)

        # b. top_device_ops with a trace directory
        call = lambda: loc_cmt_value_and_grad(m64, prob64, opts, cfg64)
        with tempfile.TemporaryDirectory() as tmp:
            ranked, n = chk.counted(lambda: utils.top_device_ops(call, top=ALL_OPS, trace_dir=tmp),
                                    want=2, what="top_device_ops(loc64 value+grad, trace_dir)")
            files = list(Path(tmp).iterdir())
            if len(files) != 1 or not files[0].stat().st_size:
                raise AssertionError(f"top_device_ops left {[f.name for f in files]} in its "
                                     f"trace_dir, not one non-empty trace")
            size = files[0].stat().st_size
            in_trace = KERNEL_NAME in files[0].read_text()
        launches["surface_top_device_ops"] = per_call["surface_top_device_ops"] = n
        rank = [i for i, (_, name) in enumerate(ranked) if KERNEL_NAME in name]
        print(f"[surface] top_device_ops(loc64 f32 value+grad, trace_dir): trace {files[0].name} "
              f"{size} bytes, names the kernel: {in_trace}; the kernel ranks "
              f"{rank[0] + 1 if rank else None} of {len(ranked)} device ops (the held check's "
              f"plain field among them); kernel launches {n}")
        if not (rank and in_trace):
            raise AssertionError("the distance-field kernel is missing from top_device_ops' "
                                 "ranking or its trace file")

        # c. a checkpoint of CUDA tensors
        (v, g), n = chk.counted(call, want=1, what="the loc64 value+grad it saves")
        launches["surface_checkpoint"] = per_call["surface_checkpoint"] = n
        tree = {"m": m64, "value_and_grad": (v, g), "marginal": margs["time"][0].pdf,
                "support": [margs["time"][0].x], "step": 19}
        with tempfile.TemporaryDirectory() as tmp:
            utils.save_checkpoint(tmp, pytree=tree, step=19)
            back = {"plain": utils.restore_checkpoint(tmp, step=19),
                    "template": utils.restore_checkpoint(tmp, template=tree, step=19)}
        for how, out in back.items():
            leaves = lambda t: [t["m"], *t["value_and_grad"], t["marginal"], *t["support"]]
            same = [a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(leaves(out), leaves(tree))]
            print(f"[surface] save_checkpoint(pytree=...) / restore_checkpoint ({how}): "
                  f"{len(same)} CUDA tensors back bit for bit on their device: {all(same)}")
            if not all(same) or out["step"] != 19:
                raise AssertionError(f"the checkpoint round trip ({how}) changed {same}")
    chk.check_held(held)
    src, tgt = margs["time"]
    ms = host_median_ms(lambda: ops.wasser(src, tgt, "W12"), n=SURFACE_TIMED, warm=1)
    print(f"[timing] surface ops.wasser W12 on the {ntg}-point time marginals: {ms:.4f} ms/call "
          f"(host clock, synchronized, median of {SURFACE_TIMED}) {card}")
    print(f"[surface] phase {time.perf_counter() - t_phase:.1f} s")
    return launches, per_call


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from waveform_ot_torch import _build
    from waveform_ot_torch.inversion import (
        InversionTrace, InvOptions, loc_cmt_misfit, loc_cmt_value_and_grad,
        minimize_lbfgs_batched_host, minimize_multi_start, minimize_scipy,
        ricker_value_and_grad,
    )
    from waveform_ot_torch.ops import DistanceField, cuda_distance, distance_field_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    golden = json.loads((REPO / "tests_golden_ref.json").read_text())

    # 1. setup
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    lib = _build.library_path("distance_field")
    how = "reused" if lib.exists() else "built"
    t0 = time.perf_counter()
    cuda_distance._library()
    print(f"[setup] {how} {lib.relative_to(REPO)} in {time.perf_counter() - t0:.2f} s")
    ptxas = ptxas_by_variant(_build.ptxas_log("distance_field"))
    spilling = [k for k, v in ptxas.items() if re.search(r"[1-9]\d* bytes spill", v)]
    print(f"[setup] ptxas -v: {len(ptxas)} kernel variants (dtype, S), "
          f"{len(spilling)} with spills {[(str(k[0])[6:], k[1]) for k in spilling]}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def variant(args):
        bsz, nt = args[0].shape[:2]
        s = cuda_distance.plan(bsz, args[2].shape[1], args[1].shape[1], nt - 1, sms)
        return s, ptxas.get((args[0].dtype, s), "no ptxas line")

    # 2. kernel against its plain version at the main path's shapes
    shapes = {dt: main_path_shapes(dt, dev, golden)
              for dt in (torch.float32, torch.float64)}
    max_abs_err, bit_identical = 0.0, True
    for dt, by_name in shapes.items():
        for name, args in by_name.items():
            got = DistanceField(*cuda_distance.distance_field_cuda(*args))
            ref = distance_field_torch(*args)
            torch.cuda.synchronize()
            rep = compare_fields(got, ref, TOL[dt])
            rep["bit_identical"] = all(torch.equal(x, y) for x, y in zip(got, ref))
            bit_identical &= rep["bit_identical"]
            max_abs_err = max(max_abs_err, rep["max_abs_err_d"])
            b, nt = args[0].shape[:2]
            s, _ = variant(args)
            print(f"[kernel] {name} {str(dt)[6:]} B={b} nt={nt} "
                  f"grid={args[2].shape[1]}x{args[1].shape[1]} S={s}: agree at "
                  f"rtol {TOL[dt]:g}; {json.dumps(rep)}")

    # 3. loc64 value and gradient on the card, float32, through the kernel
    opts = InvOptions(loc=True, cmt=False, mistype="OT")
    loc, cfg, prob32 = build_loc64_problem(64, torch.float32, dev)
    m32 = loc + torch.tensor(DM, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    cuda_distance.LAUNCHES = 0
    v32, g32 = loc_cmt_value_and_grad(m32, prob32, opts, cfg)
    torch.cuda.synchronize()
    launches = {"loc64": cuda_distance.LAUNCHES}
    if launches["loc64"] != 1:
        raise AssertionError(f"loc64 value+grad launched the distance-field kernel "
                             f"{launches['loc64']} times, not once")
    v32, g32 = v32.item(), g32.double().cpu()
    if not (np.isfinite(v32) and torch.isfinite(g32).all()):
        raise AssertionError(f"non-finite loc64 result {v32} {g32}")
    print(f"[loc64] f32 on {torch.cuda.get_device_name(0)}: value {v32!r} grad "
          f"{g32.tolist()} kernel launches {launches['loc64']}")
    cpu = torch.device("cpu")
    loc64c, cfg64, prob64c = build_loc64_problem(64, torch.float64, cpu)
    v64, g64 = loc_cmt_value_and_grad(loc64c + torch.tensor(DM, dtype=torch.float64),
                                      prob64c, opts, cfg64)
    v64 = v64.item()
    dv = abs(v32 - v64) / abs(v64)
    dg = (g32 - g64).abs().max().item() / g64.abs().max().item()
    print(f"[loc64] f64 on cpu: value {v64!r} grad {g64.tolist()}")
    print(f"[loc64] f32-card vs f64-cpu: value rel dev {dv:.3e} (bound "
          f"{VALUE_RTOL_F32:g}), grad dev / max|g| {dg:.3e} (bound {GRAD_TOL_F32:g})")
    if dv > VALUE_RTOL_F32 or dg > GRAD_TOL_F32:
        raise AssertionError("loc64 f32 deviates from the f64 reference")

    # 4. Ricker float64 on the card against the golden reference
    rprob, rcfg = build_ricker_problem(golden, torch.float64, dev)
    m = torch.tensor([0.5, 1.2, 1.1], dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    cuda_distance.LAUNCHES = 0
    w2, dm = ricker_value_and_grad(m, rprob, rcfg)
    torch.cuda.synchronize()
    launches["ricker"] = cuda_distance.LAUNCHES
    if launches["ricker"] != 1:
        raise AssertionError(f"Ricker value+grad launched the distance-field kernel "
                             f"{launches['ricker']} times, not once")
    ref = golden["ricker_obj"]
    w2_err = abs(w2.item() - ref["w2"])
    g_err = float(np.abs(dm.cpu().numpy() - np.asarray(ref["deriv"])).max())
    print(f"[ricker] f64 on card: w2 {w2.item()!r} (|err| {w2_err:.3e}, bound "
          f"{RICKER_W2_TOL:g}), grad {dm.tolist()} (max |err| {g_err:.3e}, bound "
          f"{RICKER_GRAD_TOL:g}), kernel launches {launches['ricker']}")
    if w2_err > RICKER_W2_TOL or g_err > RICKER_GRAD_TOL:
        raise AssertionError("Ricker objective deviates from the golden values")

    # 5. timings
    card = f"[{smi}]"
    _, _, prob64 = build_loc64_problem(64, torch.float64, dev)
    m64 = m32.double()
    for name, fn in (("f32", lambda: loc_cmt_value_and_grad(m32, prob32, opts, cfg)),
                     ("f64", lambda: loc_cmt_value_and_grad(m64, prob64, opts, cfg))):
        print(f"[timing] loc64 value+grad {name}: {host_median_ms(fn, n=N_TIMED):.4f} ms/call "
              f"(host clock, synchronized, median of {N_TIMED}) {card}")
    rows = []
    for dt, by_name in shapes.items():
        for name, args in by_name.items():
            n_k = BACK_TO_BACK_BY_SHAPE.get(name, BACK_TO_BACK)
            k = device_ms(lambda: cuda_distance.distance_field_cuda(*args), launches=n_k,
                          samples=SAMPLES)
            if name in PLAIN_ONCE:
                torch.cuda.synchronize()
                plain = events_ms(lambda: distance_field_torch(*args))
                plain_how = "one call, one event pair"
            else:
                plain = device_ms(lambda: distance_field_torch(*args),
                                  launches=PLAIN_BACK_TO_BACK)
                plain_how = f"{PLAIN_BACK_TO_BACK} back-to-back calls"
            bound, bound_by = kernel_bound(*args)
            s, ptx = variant(args)
            rows.append({"shape": name, "dtype": str(dt)[6:], "traces": args[0].shape[0],
                         "S": s, "ms": k, "plain_ms": plain, "bound_ms": bound,
                         "bound_by": bound_by, "share": bound / k})
            print(f"[timing] distance field {name} {str(dt)[6:]} B={args[0].shape[0]} "
                  f"S={s}: kernel {k:.6f} ms (device, {n_k} back-to-back launches, median "
                  f"of {SAMPLES}), bound {bound:.6f} ms ({bound_by}), share "
                  f"{bound / k:.4f}, plain {plain:.4f} ms ({plain_how}); ptxas: {ptx} {card}")

    # 6. the 64-start study, on-device and host-state solvers
    _, cfg11, prob11 = build_loc64_problem(NR_STUDY, torch.float32, dev)
    misfit11 = lambda ms: loc_cmt_misfit(ms, prob11, opts, cfg11)
    loc_d = torch.tensor(LOC, dtype=torch.float64, device=dev)
    starts = study_starts(torch.float32, dev)
    per_eval, study_ms_by = {}, {}
    for name, solve in (
            ("multistart", lambda f: minimize_multi_start(f, starts, max_iter=30, tol=3e-5)),
            ("multistart_host", lambda f: minimize_lbfgs_batched_host(
                f, starts, max_iter=30, tol=3e-5))):
        fun = CountedObjective(misfit11)
        torch.cuda.synchronize()
        cuda_distance.LAUNCHES = 0
        res = solve(fun)
        torch.cuda.synchronize()
        launches[name] = cuda_distance.LAUNCHES
        evals = fun.values + fun.value_grads
        per_eval[name] = launches[name] / evals
        err = torch.linalg.vector_norm(res.x.double() - loc_d, dim=1)
        n_failed = int(res.ls_failed.sum())
        study_ms = study_ms_by[name] = host_median_ms(lambda: solve(misfit11), n=STUDY_TIMED,
                                                      warm=0)
        print(f"[{name}] {N_STARTS} starts, {NR_STUDY} stations, f32: {study_ms:.4f} ms "
              f"per study (host clock, synchronized, median of {STUDY_TIMED}); outer "
              f"iterations {fun.value_grads - 1}, line-search trials {fun.values}, batched "
              f"evaluations {evals}, kernel launches {launches[name]}; ls_failed lanes "
              f"{n_failed}; distance to the source max {err.max().item():.6f} km, median "
              f"{err.median().item():.6f} km (bound {STUDY_RADIUS_KM:g}) {card}")
        if launches[name] != evals:
            raise AssertionError(f"{name}: {launches[name]} kernel launches for {evals} "
                                 f"batched evaluations")
        if int(res.n_iter.max()) != fun.value_grads - 1:
            raise AssertionError(f"{name}: lane iterations {res.n_iter.tolist()} against "
                                 f"{fun.value_grads - 1} outer iterations")
        if not bool((err < STUDY_RADIUS_KM).all()):
            far = torch.nonzero(err >= STUDY_RADIUS_KM).flatten().tolist()
            raise AssertionError(f"{name}: starts {far} end up to {err.max().item()} km "
                                 f"from the source")

    # 7. the misfit-surface scan: value and gradient at every node in one call
    nodes = scan_nodes(torch.float32, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda_distance.LAUNCHES = 0
    sv, sg = loc_cmt_value_and_grad(nodes, prob11, opts, cfg11)
    torch.cuda.synchronize()
    launches["scan"] = cuda_distance.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches["scan"] != 1:
        raise AssertionError(f"the scan launched the kernel {launches['scan']} times, not once")
    if sv.shape != (len(nodes),) or sg.shape != nodes.shape or not (
            bool(torch.isfinite(sv).all()) and bool(torch.isfinite(sg).all())):
        raise AssertionError(f"scan result of shapes {sv.shape} {sg.shape} is not finite")
    scan_ms = host_median_ms(lambda: loc_cmt_value_and_grad(nodes, prob11, opts, cfg11),
                             n=STUDY_TIMED, warm=0)
    krow = next(r for r in rows if r["shape"] == "scan" and r["dtype"] == "float32")
    print(f"[scan] {len(nodes)} nodes x {NR_STUDY} stations x 3 = {krow['traces']} traces, "
          f"f32, value+grad in one call: {scan_ms:.4f} ms per scan (host clock, "
          f"synchronized, median of {STUDY_TIMED}); kernel launches {launches['scan']}; "
          f"peak device memory {peak_gb:.3f} GB; kernel {krow['ms']:.6f} ms (device), "
          f"bound {krow['bound_ms']:.6f} ms, share {krow['share']:.4f} {card}")
    _, cfg11c, prob11c = build_loc64_problem(NR_STUDY, torch.float64, cpu)
    pick = np.sort(np.random.default_rng(7).choice(len(nodes), SCAN_CHECKED, replace=False))
    worst_v = worst_g = 0.0
    for i in pick:
        v64, g64 = loc_cmt_value_and_grad(nodes[i].double().cpu(), prob11c, opts, cfg11c)
        worst_v = max(worst_v, abs(sv[i].item() - v64.item()) / abs(v64.item()))
        worst_g = max(worst_g, ((sg[i].double().cpu() - g64).abs().max()
                                / g64.abs().max()).item())
    print(f"[scan] nodes {pick.tolist()} f32-card vs f64-cpu alone: value rel dev max "
          f"{worst_v:.3e} (bound {VALUE_RTOL_F32:g}), grad dev / max|g| max {worst_g:.3e} "
          f"(bound {GRAD_TOL_F32:g})")
    if worst_v > VALUE_RTOL_F32 or worst_g > GRAD_TOL_F32:
        raise AssertionError("scan lanes deviate from the f64 single-node evaluations")
    del sv, sg
    torch.cuda.empty_cache()

    # 8. the Ricker scipy inversion in float64, on the card and on the CPU
    inv = {}
    for where, device in (("card", dev), ("cpu", cpu)):
        rp, rc, x0 = build_ricker_inversion(torch.float64, device)
        trace = InversionTrace()
        fn = trace.wrap_objective(lambda mm, rp=rp, rc=rc: ricker_value_and_grad(mm, rp, rc))
        torch.cuda.synchronize()
        cuda_distance.LAUNCHES = 0
        t0 = time.perf_counter()
        res = inv[where] = minimize_scipy(fn, x0, callback=trace.scipy_callback())
        wall_ms = (time.perf_counter() - t0) * 1e3
        per_it = trace.misfit_per_iterate()
        print(f"[inversion] Ricker f64 on the {where}: x {res.x.tolist()} after {res.nit} "
              f"iterations, {res.nfev} evaluations ({len(trace.models)} recorded), w2 "
              f"{res.fun!r}, misfit per iterate {float(per_it[0])!r} .. "
              f"{float(per_it[-1])!r}, kernel launches {cuda_distance.LAUNCHES}, "
              f"{wall_ms:.1f} ms (host clock, one run), "
              f"scipy: {res.message!r} {card}")
        if where == "card":
            launches["ricker_inversion"] = cuda_distance.LAUNCHES
            per_eval["ricker_inversion"] = cuda_distance.LAUNCHES / res.nfev
            if cuda_distance.LAUNCHES != res.nfev or len(trace.models) != res.nfev:
                raise AssertionError(f"{cuda_distance.LAUNCHES} launches and "
                                     f"{len(trace.models)} records for {res.nfev} evaluations")
    truth_err = float(np.abs(inv["card"].x - np.asarray(RICKER_TRUTH)).max())
    x_err = float(np.abs(inv["card"].x - inv["cpu"].x).max())
    print(f"[inversion] card vs cpu: max |x diff| {x_err:.3e} (bound {RICKER_X_TOL:g}), "
          f"iterations {inv['card'].nit} vs {inv['cpu'].nit}; card max |x - truth| "
          f"{truth_err:.3e} (bound {RICKER_TRUTH_TOL:g})")
    if truth_err > RICKER_TRUTH_TOL:
        raise AssertionError(f"the Ricker inversion ends {truth_err} from the truth")
    if x_err > RICKER_X_TOL or inv["card"].nit != inv["cpu"].nit:
        raise AssertionError("the Ricker inversion on the card parts from the CPU one")

    # 9-11. the layered f-k physics, the stage-A kernel alone first
    stage_a_rows = stage_a_phase(dev, card)
    layered, stage_a_paths, stage_a_per_call = layered_phases(dev, opts, card, per_eval)
    launches.update(layered)

    # 12. the OT and fingerprint toolbox through the compat layer
    toolbox, toolbox_per_call = toolbox_phase(dev, card)
    launches.update(toolbox)

    # 13. the reference's two inversion drivers through their compat modules
    drivers, drivers_per_call = drivers_phase(dev, card)
    launches.update(drivers)

    # 14. the native slice: fast marching, the POT bridges, the zoom L-BFGS
    native, native_per_call = native_phase(dev, card, study_ms_by["multistart"])
    launches.update(native)

    # 15. the parallel layer: meshes, trace-, node-, start-, grid- and dp x sp-sharding
    parallel, parallel_per_call = parallel_phase(dev, card)
    launches.update(parallel)

    # 16. the port's example scripts, loc1024 among them
    examples, examples_per_call, examples_rows = examples_phase(dev, card, variant)
    launches.update(examples)
    rows.extend(examples_rows)

    # 17. the system's own entry points: entry() and dryrun_multichip's steps
    entries, entries_per_call = entry_phase(dev, card)
    launches.update(entries)

    # 18. the port's bench program: bench.py's ten stages and its line
    torch.cuda.empty_cache()
    benched, bench_per_call = bench_phase(card)
    launches.update(benched)

    # 19. the JAX package's surface as the port binds it: ops.wasser,
    # top_device_ops(trace_dir), save_checkpoint(pytree)
    surface, surface_per_call = surface_phase(dev, card)
    launches.update(surface)

    head = rows[0]                        # loc64 float32, the headline
    stage_a_paths.update((f"held_{phase}", n) for phase, n in STAGE_A_HELD.items()
                         if phase not in stage_a_paths)
    calls = next(r for r in stage_a_rows if r["shape"] == "calls")
    print(json.dumps({"kernels": [{
        "name": "distance_field", "route": "cuda",
        "source": "waveform_ot_torch/csrc/distance_field.cu",
        "replaces": "waveform_ot_tpu/ops/pallas_distance.py:52",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "launches_per_call": {"loc64": launches["loc64"], "ricker": launches["ricker"],
                              "scan": launches["scan"], "layered": launches["layered"],
                              "layered_scan": launches["layered_scan"], **per_eval,
                              **toolbox_per_call, **drivers_per_call, **native_per_call,
                              **parallel_per_call, **examples_per_call, **entries_per_call,
                              **bench_per_call, **surface_per_call},
        "max_abs_err": max_abs_err,
        "bit_identical": bit_identical, "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "share": head["share"], "library_ms": None, "by_shape": rows,
    }, {
        "name": "surface_operator", "route": "cuda",
        "source": "waveform_ot_torch/csrc/surface_operator.cu", "replaces": None,
        "launches": sum(stage_a_paths.values()), "launches_by_path": stage_a_paths,
        "launches_per_call": stage_a_per_call,
        "max_ulps": max(r["ulps"] for r in stage_a_rows),
        "accuracy_ratio": max(r["accuracy_ratio"] for r in stage_a_rows),
        "bit_identical": False, "ms": calls["ms"], "plain_ms": calls["plain_ms"],
        "bound_ms": calls["bound_ms"], "bound_by": calls["bound_by"], "share": calls["share"],
        "library_ms": None, "by_shape": stage_a_rows,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
