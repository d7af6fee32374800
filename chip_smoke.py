#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``madnlp_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order, each printing one JSON line (any failure raises and the
script exits non-zero without a result):

1. ``device``  — CUDA must be available; the card's name and power limit.
2. ``build``   — nvcc builds ``madnlp_tpu_torch/csrc/banded_ldlt.cu``,
   ``madnlp_tpu_torch/csrc/banded_fused.cu`` and
   ``madnlp_tpu_torch/csrc/dense_ldlt.cu``, one process each, side by side.
3. ``kernels`` — the banded LDLᵀ kernels K1 (factorize) and K2 (solve)
   against their plain PyTorch versions on the card, float32 and float64,
   on strictly diagonally dominant indefinite band matrices made by numpy
   from a seed, at the main path's geometry and three others; inertia must
   agree exactly.  Then the batched kernels K3 (factorize) and K4 (solve)
   at B=3 lanes per geometry and dtype against their plain versions and,
   lane by lane, against K1 / K2; lane 1 carries a zero pivot, so the
   inertia must come out per lane; at the main path's geometry each lane's
   K3 factor must equal K1's bit for bit; one case per dtype runs with lane 0
   inactive, whose band, invL, pivots and right-hand side must come back
   bit for bit.
   ``fused_kernels``: the whole-band kernels K5 (factorize, one launch
   over one thread-block cluster) and K6 (solve, one launch, a cluster per
   tile of right-hand-side columns) against their witnesses (the one-CTA
   kernels they replaced) bit for bit, overhang included,
   against their plain versions and against K1 / K2 on the same bands,
   float32 and float64, at the four geometries and case118's (64, 5, 10),
   on a dominant band and one with a zero pivot, k = 1, 8 and 130
   right-hand sides; K5's factor (band, invL, d on the real columns) must
   also equal K1's bit for bit; each line names the launch plans (cluster
   size, resident or streamed); then the CUDA launches of one K5 call and
   of one K6 call counted by torch.profiler (one each) beside one K1
   call's (4·nb).
   ``solve_witness``: K2 and K4 (one thread-block cluster per system)
   against the one-CTA solve they replaced (``banded_solve_reference_cuda``,
   their witness), bit for bit, at ``SOLVE_GEOMETRIES`` in float32 and
   float64, k = 1 and 8 right-hand sides: K4 on three lanes (lane 1 with an
   exactly zero pivot), K2 on each lane, and K4 with lane 0 inactive once
   per dtype (lane 0's right-hand side must come back bit for bit); each
   line names the launch plan (cluster size, stages) and the clusters the
   card keeps resident.
   ``diag_step``: the diagonal step of K1 / K3 alone (one CTA per block) at
   b = 256 on 1 and ``DIAG_LANES`` = 16 seeded diagonal blocks (one with an
   exactly zero pivot), float32 and float64: the tiled routine against the
   scalar one, bit for bit, and against the plain version; both timed by
   CUDA events beside the one-SM bound (the FMAs of the step's loops over
   one SM's share of the card's peak).
   Also in ``kernels``: K2 on a 12-column right-hand side (the width of
   the compact L-BFGS SMW solve, 2 · max_history), at the flagship's
   geometry and the ring's (b = 256, bw = 2 and 4), float32 and float64,
   against the plain solve and against 12 one-column K2 launches, bit for
   bit, with its launch plan and its time beside one column's; and K4 on
   12 columns (the batched SMW solve) over the batch's 16 lanes at the
   flagship's geometry with lane 3 inactive, float32 and float64, against
   the plain batched solve and against 12 one-column K4 launches, bit for
   bit, the inactive lane untouched, timed beside one column's and the
   plain solve's, with its bound.
4. ``solve``   — the flagship sparse ACOPF (``opf.build_sparse(nb=600,
   seed=0)``, banded KKT, μ-scaled Richardson) solved on the card in
   float64 (which also warms the card up) and then float32, the main path,
   each against the JAX package's CPU results (``REFERENCE``: status,
   iterations and factorizations exactly, the objective within 1e-8,
   float32 backsolves within 6%, float64 backsolves within the one-ulp
   spread ``FLAGSHIP_FLOAT64_BACKSOLVES``); the kernels' launch counts
   over the float32 solve (the witness never); the float32 solve
   repeated, bit for bit; K1/K2 against the plain versions on the last
   band of that solve and timed there beside their plain versions, K2's
   witness (in turns with K2) and their bounds; ``TIMED_SOLVES``
   more float32 solves, each bit-identical to the first, whose median wall
   gives the iter/s metric (with its spread); one more float32 solve under
   torch.profiler for the device time by kernel.
5. ``batch``   — the multi-scenario path: ``solve_batch`` of
   ``opf.build_sparse(nb=600, seed=0, parametric=True)`` in float32 at the
   16 load scales ``np.linspace(0.92, 1.08, 16)`` in one bulk run, held lane
   by lane against the port's single solve of each scenario on the card
   (status, iterations and factorizations exact, objective within 1e-8,
   backsolves within 15% per lane and 6% in total) and against the JAX
   package's batch on the CPU
   (status and iterations exact, objective within 1e-8; its factorization
   and backsolve counts reported beside the port's, see
   ``BATCH_REFERENCE``), with the kernels' launch counts over that run (K3
   and K4 launched, K1 and K2 never); the bulk run repeated, bit for bit;
   the chunked run
   (``chunk_size=8, probe_iters=3``) against the bulk run;
   ``TIMED_BATCHES`` more bulk runs for the lane-iterations and instances
   per second; K3 / K4 against their plain versions on the batch's last
   band of every lane (float64), then timed against 16 sequential K1 / K2
   launches on the same bands, K4 in turns with its witness; one bulk run
   under torch.profiler.

   ``matpower_solve``: the MATPOWER front end and the JAX package's bench
   primary, ``build_acopf(tile_case(parse_case("tests/data/case118.m"), 4,
   ties="ring"), sparse=True)`` (banded KKT, μ-scaled Richardson) on the
   card in float64 and float32, each against the JAX package's CPU results
   (``MATPOWER_REFERENCE``) and the published optimum 4 × 129660.70; K1 /
   K2 launches over the float32 solve (K5 / K6 never); a repeat bit for
   bit, whose last band K2 and its witness are timed on in turns;
   ``TIMED_SOLVES`` warmed float32 solves for the median iter/s; one under
   torch.profiler.
   ``case118_band``: a float32 case118 solve (held to the JAX package) whose
   last KKT band goes through K5 / K6 (their op path: counts set to 0 just
   before, one launch each read just after), their witnesses (bit for bit,
   in float32 and float64), their plain versions and K1 / K2: agreement in
   float64 within ``REAL_BAND_RTOL``, inertia equal; K5, its witness and K1
   timed in turns, and K6, its witness, K2 and K2's witness in turns, by
   CUDA events beside their bounds, with the launch plans.
6. ``dense_kernels`` — the whole-matrix dense LDLᵀ kernel K7 against its
   plain PyTorch version on the card, float32 and float64, block 128, at
   N = 128, 300, 1024 and 2674 (the dense nb=600 system), on an indefinite
   saddle matrix and on one with an exactly zero pivot: the factor's
   relative error on the real rows within 1e-4 (float32) and 1e-10
   (float64), the inertia equal, the zero pivot counted.
   ``dense_witness``: K7 against its first version (``dense_ldlt_reference``,
   its witness) bit for bit on the strict lower triangle and the diagonal,
   at the same sizes, both dtypes, with and without the zero pivot, at
   blocks 32, 64 and 128; and at blocks 48 and 100, which the witness does
   not take, against the plain version within ``KERNEL_RTOL``.
7. ``dense_solve`` — the dense-callback path: ``madnlp(opf.build(nb=600,
   seed=0))`` with default options (condensed dense KKT, blocked LDLᵀ,
   block 128, which is K7 on the card) in float64 and float32, each against
   the JAX package's CPU results (``DENSE_REFERENCE``; float32 counts
   against the spread that rounding alone produces,
   ``DENSE_FLOAT32_SPREAD``), with every kernel's launch count over each
   solve (K7 once per factorization and once for the least-squares start,
   its witness and K1-K6 never); the float32 solve repeated, bit for bit;
   ``TIMED_DENSE_SOLVES`` more float32 solves for the median iter/s; one
   more, whole, under torch.profiler.
8. ``dense_main_matrix`` — the last Ruiz-scaled condensed matrix of the
   float32 solve through K7 and its witness (their op paths: counts set to
   0 just before, one launch each read just after; equal bit for bit),
   through the plain version and through the port's ``ldlt_factorize`` on
   the card: their agreement and inertia; ``dense_timing``: K7 and the
   witness timed in turns by CUDA events in float32 and float64 beside the
   bound, the plain version's and ``ldlt_factorize``'s times, the device
   launches of one K7 call and of one ``ldlt_factorize`` (torch.profiler),
   and ``torch.linalg.cholesky`` of an SPD matrix of the same size as
   context (a different function: no PyTorch call computes an unpivoted
   LDLᵀ).
9. ``restoration`` — the parametric flagship model
   (``opf.build_sparse(nb=600, seed=0, parametric=True)``) at load scale
   2.0, which is infeasible, with the flagship's options: the solve passes
   through soft and robust feasibility restoration, whose factorizations
   and solves are K1 / K2 as in the regular phase.  In float64 and float32
   on the card, each held to the JAX package's status and ``inf_pr`` at
   exit and to the one-ulp spread of its counters (iterations,
   factorizations, backsolves, soft and robust steps;
   ``RESTORATION_REFERENCE``, ``RESTORATION_SPREAD``), with every kernel's
   launch count over the solve (K1 once per factorization and per
   least-squares multiplier solve, K2 at least once per backsolve, K5-K7
   and every witness never); the float32 solve repeated under
   torch.profiler, bit for bit, for the card's busy share.  Then the dense
   path through restoration: ``suite.infeasible()`` and ``suite.eigmina()``
   (eigmina's condensed system has equality rows, so LDLᵀ, which is K7)
   against the JAX package's status, eigmina's objective against its
   optimum 1.
    ``batch_restoration``: ``solve_batch`` of the same model at load
    scales (1.0, 1.04, 2.0) in one bulk run, float64 and float32: the
    overloaded lane restores inside the batch (its soft and robust
    systems factored by K3 and solved by K4) while the others solve.  In
    float64 the solving lanes are held to the JAX package's cold solves
    (``WARM_REFERENCE``: status, iterations, factorizations, objective
    within 1e-8), in float32 to the port's single solves on the card (and
    backsolves within 15%); the 2.0 lane to the single restoration solve
    above (equal, or else inside ``BATCH_RESTORATION_SPREAD``; status and
    ``inf_pr`` against the JAX package's), steps by phase per lane; K3 and
    K4 launched, K1/K2, K5-K7 and every witness never; the float32 batch
    repeated under torch.profiler, bit for bit, for the busy share.
10. ``warm_start`` — the parametric flagship model in float64 solved at
    load scale 1.0 and re-solved on the same solver at 1.0 (held to the
    JAX package's warm re-solve: status, iterations, factorizations) and at
    1.04 (the optimum of the new instance, held to the JAX package's cold
    solve at 1.04; the state carries the new parameters), K1 / K2 launched
    and no witness.
11. ``checkpoint`` — the flagship float64 solve driven by hand through the
    three-phase loop for ``CHECKPOINT_AFTER`` steps, saved
    (``utils.checkpoint.save_state``), loaded back onto the card into a
    fresh solver (``resume``) and finished there by the same loop: equal
    to an uninterrupted solve, counters and solution bit for bit.
12. ``step_options`` — the IPM's step options on the banded flagship
    (K1/K2), in float64 and float32: the quality-function and LOQO
    barriers, the inertia-free correction and compact L-BFGS (its
    σ-diagonal assembled, the low-rank part by SMW: one 12-column K2
    solve per factorization); then float32 under ``kkt_scaling="k25"``
    and under ``kkt_system="scaled_sparse"`` (the same run, bit for bit).
    Each run against the JAX package's CPU numbers (``STEP_REFERENCE``:
    status, iterations and factorizations exactly, the objective within
    1e-8, backsolves exactly or within their one-ulp spread,
    ``STEP_SPREAD``), with its launches (K1 once per factorization and
    least-squares start, K2 at least once per backsolve, every witness
    and other kernel never), wall and iter/s; the quasi-Newton runs, whose
    counts at nb=600 rounding decides, timed and held to SOLVE_SUCCEEDED
    at the JAX package's objective; the float32 quality-function and
    L-BFGS runs repeated under torch.profiler (bit for bit) for the busy
    share.  ``step_options_dense``: the dense nb=600 path in float64
    under damped BFGS (the formed operator, K7; timed), GMRES refinement
    (K7) and ``linear_solver=LU`` (no inertia, so the inertia-free
    correction; a library factorization, no kernel), against the JAX
    package.  ``step_options_exact``: banded compact L-BFGS (f64, f32)
    and dense compact L-BFGS and damped BFGS (f64) held exactly to the
    JAX package at the largest flagship size at which both packages'
    judged runs agree (``STEP_EXACT``: nb=30, and nb=14 for damped BFGS).
13. ``batch_step_options`` — the step options inside ``solve_batch``: the
    parametric flagship at the 16 ``BATCH_SCALES`` in one bulk run (K3 /
    K4) under the quality function, LOQO and the inertia-free correction
    in float64 and float32, and under ``kkt_scaling="k25"`` in float32.
    Every lane against the port's single solve of its scale on the card
    (status, iterations and factorizations exactly, the objective within
    1e-8, backsolves within ``BACKSOLVE_LANE_RTOL``), lanes 0, 5, 10 and
    15 in float64 against the JAX package's single solves
    (``BATCH_STEP_JAX``); K3 and K4 launched, K1/K2 and every witness
    never, K4's launches per batched step; the run repeated bit for bit
    with a window of its batched steps under torch.profiler (the busy
    share), and ``TIMED_OPTION_BATCHES`` more, bit for bit, for the
    median lane-iterations per second.
14. ``batch_step_options_exact`` — compact L-BFGS inside ``solve_batch``
    on the parametric nb=30 flagship at ``BATCH_SCALES``, float64 and
    float32: every lane the port's single solve on the card, the lanes of
    ``BATCH_EXACT_JAX`` the JAX package's, and one K4 launch of 12
    columns (the SMW payload) per batched factorization.
15. ``nl_sparse`` — the front end of AMPL users: ``minsurf_nl(100)``
    (the COPS minimal surface with obstacle on a 100 × 100 grid, n =
    10,201, its boundary fixed by equal bounds) written as a text ``.nl``
    file and solved through ``solve_nl`` on the card (``sparse="auto"``:
    the template compiler, then the banded KKT with b = 256, bw = 1, nb =
    40, every factorization K1 and every backsolve K2) in float64 and
    float32, each against the JAX package's CPU results (``NL_REFERENCE``:
    status, iterations and factorizations exactly, the objective within
    1e-8, float64 backsolves exactly and float32 ones inside their
    one-ulp spread ``NL_BACKSOLVE_SPREAD``), K1 launched once per
    factorization and K2 once per backsolve, nothing else; a repeat, the
    binary encoding of the file (``convert_nl``) and the ``.sol`` file
    read back (``read_sol``) bit for bit, and the solver executable
    (``python -m madnlp_tpu_torch.models.nl stub -AMPL`` in a subprocess
    on the card, after the checked solves) writing the same ``.sol``;
    K1/K2 against their plain
    versions on the solve's last band and timed there beside their
    bounds; ``TIMED_NL_SOLVES`` warmed re-solves per dtype, each bit for
    bit the first, for the median iter/s, one more under torch.profiler
    for the busy share, and the model's
    ``obj``, ``grad`` and ``hess_coords`` timed apart by CUDA events at
    the solution (milliseconds per iteration, share of the wall).
16. ``frontends`` — ``from_scipy`` (HS15 with a NonlinearConstraint; the
    dict and LinearConstraint model) and ``host_model`` (with
    ``lag_hess``; without it under compact L-BFGS) on the card against the
    JAX package's numbers (``FRONTEND_REFERENCE``), K7 once per
    factorization and least-squares start where the condensed system
    takes LDLᵀ, never under Cholesky; the host models' round trips.
17. ``harness`` — ``testing.test_linear_solver`` for LDL (K7), CHOLESKY,
    LU, QR, EVD, BLOCK_CHOLESKY and HYKKT (its K_γ through K7),
    ``testing.test_kkt_system`` on every KKT system the port has (dense LDL
    and EVD, condensed Cholesky and LDL, sparse on dense storage, banded
    SPARSE in both dtypes, SCALED_SPARSE, SPARSE_UNREDUCED and
    SPARSE_CONDENSED on K1/K2, the unreduced system of a dense model and
    DENSE under HYKKT on K7, DENSE under BLOCK_CHOLESKY), each with its
    launches; the whole behavior suite on the card; ``solve_jitted`` bit
    for bit ``solve()`` on hs15.
18. ``sparse_unreduced`` — the flagship ``opf.build_sparse(nb=600,
    seed=0)`` under ``kkt_system=SPARSE_UNREDUCED, linear_solver=BANDED``
    (the √z-symmetrized 4-block system, N = 3·nw + m, on K1/K2) in float64
    and float32, each against the JAX package's CPU results
    (``UNREDUCED_REFERENCE``: status, iterations and factorizations
    exactly, the objective within 1e-8, backsolves exactly in float64 and
    within 6% in float32, or their one-ulp spread ``UNREDUCED_SPREAD``
    where rounding moves them), K1 once per factorization and K2 at least
    once per backsolve (and once each for the least-squares start); the float32
    solve repeated bit for bit; K1/K2 against their plain versions on the
    float64 solve's last band (the factor entrywise, and K1 then K2
    by the backward error of one solve beside the plain factorization's
    and solve's: the band is ill-conditioned at the solution) and timed
    on both dtypes' last bands beside their bounds; ``TIMED_A4_SOLVES`` float32 solves, each bit for
    bit the first, for the median iter/s and one under torch.profiler for
    the busy share.
19. ``sparse_condensed`` — the same model under
    ``kkt_system=SPARSE_CONDENSED, linear_solver=BANDED`` at
    ``tol=CONDENSED_TOL`` (the n×n SPD band K = W + Σx + JᵀDJ on K1/K2)
    in float64: the same checks (the float64 solve timed and repeated;
    the factor by the backward error alone, its entries part from plain's
    by 1e-4 with the summation order), the counts held to the JAX
    package's one-ulp spread ``CONDENSED_SPREAD`` (ROADMAP §C, R3), status
    and objective to the JAX package's condensed solve.
    Not in float32: the JAX package's float32 condensed solve reaches no
    solution (500 iterations at nb=14 and 30, either band backend).
20. ``range_space`` — the dense ``opf.build(nb=600, seed=0)`` under
    ``kkt_system=DENSE`` with ``linear_solver=HYKKT`` (the card's default
    backend: K_γ through K7; float64 and float32) and ``BLOCK_CHOLESKY``
    (float64, at ``BCHOL_NB``: the largest flagship size tried at which
    the JAX package's BLOCK_CHOLESKY solve succeeds; at the other sizes
    tried from 80 to 600 it reaches no solution), and the one-variable
    infeasible model under DENSE + HYKKT
    (INFEASIBLE_PROBLEM_DETECTED, its robust steps in HYKKT's ``rr`` mode),
    each against the JAX package (``RANGE_SPACE_REFERENCE``, HYKKT with
    ``hykkt_backend="ldl"``); K7 once per factorization and once for the
    least-squares start, no Cholesky under HYKKT, the CG's iterations per
    backsolve and host reads per iteration; K7 against its plain version
    on its last K_γ and timed there beside its bound; the timed float32
    HYKKT solves, each bit for bit the first.

Then the ``{"kernels": [...]}`` line (K1 and K2 also on the minimal
surface's band and on the unreduced and condensed bands, K7 also on
HYKKT's K_γ) and, last, the ``{"ok": true, ...}`` line.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): float32 and
# float64 outside the tensor cores (TF32 is ruled out for the factor), HBM3.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
SMS = 132     # the diagonal step runs on one SM: its peak is PEAK_FLOPS / SMS

# The JAX package's results for the flagship solve on the CPU, (status,
# iterations, factorization_cnt, backsolve_cnt, objective), from
#   JAX_PLATFORMS=cpu python -c 'import madnlp_tpu as M; from madnlp_tpu.models.instances import opf;
#   from madnlp_tpu.utils.options import RichardsonOptions as R;
#   s = M.madnlp(opf.build_sparse(nb=600, seed=0), linear_solver=M.LinearSolver.BANDED,
#                dtype=DT, richardson=R(mu_scaled=True), banded_backend=BACKEND);
#   print(s.status.name, s.iter, s.counters["factorization_cnt"],
#         s.counters["backsolve_cnt"], repr(s.objective))'
# with BACKEND="pallas_interpret" in float32 (the TPU kernel's factorization
# order, which the port follows; the XLA band loop's counts,
# FLAGSHIP_XLA_FLOAT32, are reported beside) and "auto" in float64 (both
# backends take 25, 25, 29).  Status, iterations and factorizations are
# held exactly, the objective within OBJ_RTOL; float32 backsolves within
# BACKSOLVE_RTOL, float64 backsolves within FLAGSHIP_FLOAT64_BACKSOLVES.
REFERENCE = {
    "float32": ("SOLVE_SUCCEEDED", 25, 25, 64, 583.7230018594354),
    "float64": ("SOLVE_SUCCEEDED", 25, 25, 29, 583.7230018594349),
}
FLAGSHIP_XLA_FLOAT32 = ("SOLVE_SUCCEEDED", 25, 25, 63, 583.7230018594349)
# The float64 backsolve count is a property of the rounding, not of the
# algorithm (ROADMAP C1).  At iteration 24 (μ = 2.5e-9) the refinement's
# residual is the difference of opposite terms of the Σ-shifted operator
# band, as large as the residual itself, so the sum order of the operator's
# mat-vec decides whether 2 or 3 Richardson sweeps reach the tolerance:
# the JAX package takes 3 and the port 2 on the same KKT inputs, and the
# JAX package takes 2 on 6 of 11 one-ulp perturbations of those inputs;
# whole solves from an initial point perturbed by one ulp take 27-29
# backsolves in both packages (6 seeds each), with 25 iterations and 25
# factorizations (tests/test_torch_refine_f64.py).
FLAGSHIP_FLOAT64_BACKSOLVES = (27, 29)
OBJ_RTOL = 1e-8

# (b, bw, nb): the main path (nb=600: N=2674 -> b=256, bw=2, 11 block
# columns), the case118x4 default geometry, a wide band, a narrow one
GEOMETRIES = [(256, 2, 11), (256, 4, 8), (128, 7, 12), (64, 1, 12)]
# normwise relative tolerances kernel vs plain on diagonally dominant
# systems: only summation order differs, and dominance bounds the growth
KERNEL_RTOL = {"float32": 1e-4, "float64": 1e-10}
# kernel vs plain on the main path's own (Ruiz-scaled, ill-conditioned)
# KKT band, in float64: rounding is amplified by the condition number
REAL_BAND_RTOL = 1e-6
# warmed float32 solves timed for the end-to-end iter/s (median and spread)
TIMED_SOLVES = 7
# K5 / K6 at the kernel phase's geometries and case118's own (N = 580:
# b = 64, bw = 5, nb = 10), right-hand sides of 1, 8 and 130 columns
FUSED_GEOMETRIES = GEOMETRIES + [(64, 5, 10)]
FUSED_WIDTHS = (1, 8, 130)
# K2 / K4 against their witness: the kernel phase's geometries, case118's
# and the case118×4 ring's (N = 2320: b = 256, bw = 4, nb = 10)
SOLVE_GEOMETRIES = GEOMETRIES + [(64, 5, 10), (256, 4, 10)]
SOLVE_WIDTHS = (1, 8)
# the diagonal step alone: lanes of one launch (as the batch's K3) and
# timed launches per configuration
DIAG_LANES = 16
DIAG_REPS = 20

# The MATPOWER path: the JAX package's results on the CPU, (status,
# iterations, factorization_cnt, backsolve_cnt, objective), from
#   JAX_PLATFORMS=cpu python -c 'import madnlp_tpu as M; from madnlp_tpu.models import matpower as mp;
#   from madnlp_tpu.utils.options import RichardsonOptions as R;
#   c = mp.parse_case("tests/data/case118.m"); c = mp.tile_case(c, 4, ties="ring") if RING else c;
#   s = M.madnlp(mp.build_acopf(c, sparse=True), linear_solver=M.LinearSolver.BANDED,
#                dtype=DT, richardson=R(mu_scaled=True), banded_backend=BACKEND);
#   print(s.status.name, s.iter, s.counters["factorization_cnt"],
#         s.counters["backsolve_cnt"], repr(s.objective))'
# with BACKEND="pallas_interpret" in float32: the TPU kernel's panel-blocked
# factorization order, which the port follows (the default "auto" runs the
# XLA band loop on the CPU, another order: MATPOWER_XLA_FLOAT32, reported
# beside).  float64 is held exactly (objective within OBJ_RTOL; both
# backends give the same counts); float32 status, iterations and
# factorizations exactly, backsolves within BACKSOLVE_RTOL.
MATPOWER_REFERENCE = {
    ("case118x4_ring", "float64"): ("SOLVE_SUCCEEDED", 15, 15, 16,
                                    518642.7397434097),
    ("case118x4_ring", "float32"): ("SOLVE_SUCCEEDED", 15, 15, 35,
                                    518642.7397434094),
    ("case118", "float32"): ("SOLVE_SUCCEEDED", 15, 15, 34,
                             129660.68493585243),
}
MATPOWER_XLA_FLOAT32 = {
    "case118x4_ring": ("SOLVE_SUCCEEDED", 15, 15, 34, 518642.73974340927),
    "case118": ("SOLVE_SUCCEEDED", 15, 15, 37, 129660.68493585243),
}
# MATPOWER's published case118 optimum ($/hr, tests/test_realcases.py): the
# ring of four copies has exactly four times it by symmetry
PUBLISHED_OPTIMUM = {"case118x4_ring": 4 * 129660.70, "case118": 129660.70}
PUBLISHED_RTOL = 1e-6

# The batched path: 16 load scales of the parametric flagship model, and
# the JAX package's batch of them on the CPU, from
#   JAX_PLATFORMS=cpu python -c 'import jax.numpy as jnp, madnlp_tpu as M;
#   from madnlp_tpu.models.instances import opf;
#   from madnlp_tpu.utils.options import RichardsonOptions as R;
#   s = M.MadNLPSolver(opf.build_sparse(nb=600, seed=0, parametric=True),
#       linear_solver=M.LinearSolver.BANDED, dtype="float32",
#       richardson=R(mu_scaled=True));
#   st = s.solve_batch(jnp.linspace(0.92, 1.08, 16));
#   print(st.k, st.factorization_cnt, st.backsolve_cnt,
#         M.batch_summary(s.prob, st)["objective"].tolist())'
# (every lane SOLVE_SUCCEEDED, factorization_cnt == iter on every lane).
# Float32 factorization and backsolve counts are not held against these:
# where float32 Richardson refinement stalls at its sweep cap, the δ ladder
# adds a factorization, and whether it stalls depends on the factor's
# rounding (on the card, the port's single solves of scales 1 and 13 stall
# once and twice where the JAX package's CPU loop does not).  The port's
# own single solves on the card are the exact reference for them.
BATCH_SCALES = np.linspace(0.92, 1.08, 16)
BATCH_REFERENCE = {
    "iter": [24, 23, 25, 24, 23, 23, 27, 25, 27, 26, 26, 28, 26, 27, 28, 27],
    "backsolve_cnt": [61, 69, 61, 59, 59, 53, 60, 63, 67, 66, 59, 65, 66, 74,
                      65, 64],
    "objective": [
        482.97713389105974, 495.5904554411171, 508.4357216103771,
        521.5263349828456, 534.881472736899, 548.4943838946886,
        562.3682522971778, 576.5276008714972, 590.996771633352,
        605.8048071850728, 620.9386671040421, 636.3977767668068,
        652.2649664902088, 668.507253405474, 685.1492939791464,
        702.2010771923605],
}
# float32 refinement stops a sweep earlier or later with the rounding of
# the factor and of the f64 reductions: a batch lane's backsolve count is
# held within 15% of the single solve of its scenario (the spread measured
# on the card: up to 10% per lane), and the batch's total within 6% of
# the single solves' total (measured: 0.1%), which shows that no lane
# counts another lane's sweeps
BACKSOLVE_RTOL = 0.06
BACKSOLVE_LANE_RTOL = 0.15
BATCH_LANES = 3          # lanes of the batched kernel checks
TIMED_BATCHES = 3
# the step options' batches (eight runs): two timed runs each keep the
# script inside its time limit beside the A4 phases
TIMED_OPTION_BATCHES = 2

# The dense-callback path: the JAX package's default solve of the dense
# nb=600 ACOPF on the CPU, (status, iterations, factorization_cnt,
# backsolve_cnt, objective), from
#   JAX_PLATFORMS=cpu python -c 'import madnlp_tpu as M; from madnlp_tpu.models.instances import opf;
#   s = M.madnlp(opf.build(nb=600, seed=0), dtype=DT); print(s.status.name, s.iter,
#   s.counters["factorization_cnt"], s.counters["backsolve_cnt"], repr(s.objective))'
# float64 is held to them exactly (backsolves within BACKSOLVE_RTOL).
DENSE_REFERENCE = {
    "float64": ("SOLVE_SUCCEEDED", 25, 25, 27, 583.7230018594353),
    "float32": ("SOLVE_SUCCEEDED", 25, 28, 137, 583.7230018594353),
}
# float32 counts are a property of the rounding, not of the algorithm: the
# solve on the card, which factors with K7, with every factorized matrix
# perturbed by one float32 ulp of seeded noise takes 25-27 iterations,
# 27-34 factorizations and 133-186 backsolves (12 runs,
# tools/spread.py dense32; the CPU study of the same kind,
# tests/test_torch_refine_stall.py:dense_float32_spread, 6 runs), where
# refinement stalls on near-singular pivots send the δ ladder up a step or
# not.  The float32 solve on the card is held to that spread and to the JAX
# package's status and objective; its counts stand beside JAX's.
DENSE_FLOAT32_SPREAD = {"iter": (25, 27), "factorization_cnt": (27, 34),
                        "backsolve_cnt": (133, 186)}
DENSE_BLOCK = 128
# K7 against its plain version: N = one block, a padded tail, the TPU
# kernel's VMEM limit, and the dense nb=600 system (2674 -> 2688 padded)
DENSE_SIZES = (128, 300, 1024, 2674)
# K7 vs plain vs ldlt_factorize on the solve's own (Ruiz-scaled,
# ill-conditioned) matrix, in float64: rounding is amplified by the
# condition number, as on the banded path's main band
DENSE_MAIN_RTOL = 1e-6
TIMED_DENSE_SOLVES = 3
# K7 against its witness (bit for bit) and, at blocks the witness does not
# take, against the plain version
WITNESS_BLOCKS = (32, 64, 128)
ODD_BLOCKS = (48, 100)
DENSE_TURN_ROUNDS = 4      # rounds of K7 and its witness in turns

# The restoration path: the parametric flagship model at load scale 2.0,
# which is infeasible (the loads exceed what the network can carry), with
# the flagship's options.  The JAX package's results on the CPU, from the
# hosted three-phase loop of tools/spread.py restoration (its unperturbed
# solve):
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tools/spread.py restoration \
#       --pkg jax --dtype DT --backend BACKEND --seeds 0
# with BACKEND "auto" in float64 and "pallas_interpret" in float32 (the
# TPU kernel's factorization order; the XLA band loop's counts,
# RESTORATION_XLA_FLOAT32, are reported beside).  "restore" and "robust"
# count the soft and robust restoration steps, "steps" every step of the
# loop; ``iter`` counts the steps that move the iterate.
RESTORATION_THETA = 2.0
RESTORATION_REFERENCE = {
    "float64": {"status": "INFEASIBLE_PROBLEM_DETECTED", "iter": 194,
                "factorization_cnt": 213, "backsolve_cnt": 218,
                "restore": 15, "robust": 72, "steps": 208,
                "inf_pr": 5.281744150808372},
    "float32": {"status": "INFEASIBLE_PROBLEM_DETECTED", "iter": 211,
                "factorization_cnt": 282, "backsolve_cnt": 997,
                "restore": 15, "robust": 83, "steps": 226,
                "inf_pr": 5.2817441483281655},
}
RESTORATION_XLA_FLOAT32 = {"iter": 220, "factorization_cnt": 266,
                           "backsolve_cnt": 929, "restore": 15, "robust": 86,
                           "steps": 235}
# The counts of a solve this long are a property of the rounding, not of
# the algorithm.  The port's phases agree step for step with the JAX
# package's until one line search's decision flips (step 165 of 208 in
# float64 on the CPU), and solves from the initial point moved by one
# float64 ulp (tools/spread.py restoration, the unperturbed start and
# seeds 1..N) spread as below, with every solve INFEASIBLE_PROBLEM_DETECTED
# at the same point (inf_pr 5.2817441 in every solve):
#   float64, JAX on the CPU (seeds 1-18): iter 190-196, factorizations
#     209-215, backsolves 212-221, soft steps 13-15, robust 70-73, steps
#     204-210;
#   float64, the port on the card (seeds 1-6): 190-196, 209-215, 213-219,
#     13-16, 70-71, 204-210 (its unperturbed solve 196/215/219/16/71/210;
#     JAX's seed 16 takes 196/215/221/15/73/210: the same iterations,
#     factorizations and steps, split otherwise between the phases);
#   float32, JAX in the TPU kernel's order (pallas_interpret, seeds 1-6):
#     iter 198-256, factorizations 245-334, backsolves 839-1310, soft
#     steps 12-15, robust 73-120, steps 211-272;
#   float32, the port on the card (seeds 1-6): 195-216, 218-273, 730-1024,
#     13-14, 70-79, 209-231 (its unperturbed solve 216/273/1024/14/79/231,
#     inside JAX's range on every counter).
# Each counter of the card's solve is held to the union of both packages'
# ranges in its dtype, the status exactly and inf_pr at exit within
# RESTORATION_INF_PR_RTOL of the JAX package's (ROADMAP §C).
RESTORATION_SPREAD = {
    "float64": {"iter": (190, 196), "factorization_cnt": (209, 215),
                "backsolve_cnt": (212, 221), "restore": (13, 16),
                "robust": (70, 73), "steps": (204, 210)},
    "float32": {"iter": (195, 256), "factorization_cnt": (218, 334),
                "backsolve_cnt": (730, 1310), "restore": (12, 15),
                "robust": (70, 120), "steps": (209, 272)},
}
RESTORATION_INF_PR_RTOL = 1e-8
# The dense path through restoration: the behaviour suite's infeasible
# model and eigmina, whose solve passes through robust restoration, with
# the JAX package's status (tests/test_behavior_suite.py) and eigmina's
# optimum 1 within 1e-6
DENSE_RESTORATION = {"infeasible": "INFEASIBLE_PROBLEM_DETECTED",
                     "eigmina": "SOLVE_SUCCEEDED"}
EIGMINA_OPTIMUM = 1.0
# The warm start: the parametric flagship model in float64 solved at load
# scale 1.0, re-solved on the same solver at 1.0 and then at 1.04.  The
# JAX package's results on the CPU (status, iterations, factorization_cnt
# — cumulative over the solver's solves, as both packages count it — and
# objective): its cold solve at 1.0, its warm re-solve at 1.0, and its
# cold solve at 1.04 (its warm re-solve at 1.04 keeps the old parameters
# and returns the optimum at 1.0, a fault of the reference the port does
# not copy; tests/test_torch_restoration.py).  From
#   JAX_PLATFORMS=cpu python -c 'import numpy as np, madnlp_tpu as M
#   from madnlp_tpu.models.instances import opf
#   from madnlp_tpu.utils.options import RichardsonOptions as R
#   s = M.MadNLPSolver(opf.build_sparse(nb=600, seed=0, parametric=True),
#       linear_solver=M.LinearSolver.BANDED, richardson=R(mu_scaled=True),
#       print_level=M.PrintLevel.ERROR)
#   for p, cold in ((1.0, True), (1.0, False), (1.04, True)):
#       s.state = None if cold else s.state
#       r = s.solve(params=np.asarray(p))
#       print(r.status.name, r.iter, r.counters["factorization_cnt"],
#             repr(r.objective))'
WARM_REFERENCE = {
    "cold_1.0": ("SOLVE_SUCCEEDED", 25, 25, 583.7230018594349),
    "warm_1.0": ("SOLVE_SUCCEEDED", 27, 55, 583.7230018594357),
    "cold_1.04": ("SOLVE_SUCCEEDED", 25, 25, 640.3292897555045),
}
WARM_OBJ_RTOL = 1e-6
CHECKPOINT_AFTER = 4     # hand-driven steps before the checkpoint
# Restoration inside solve_batch: three lanes of the parametric flagship,
# two that solve (held in float64 to WARM_REFERENCE's JAX cold solves at
# 1.0 and 1.04, in float32 to the port's single solves on the card) and
# one overloaded (held to the port's single restoration solve of the
# ``restoration`` phase on the card: equal, or else inside
# BATCH_RESTORATION_SPREAD; status and inf_pr as there)
BATCH_RESTORATION_SCALES = (1.0, 1.04, 2.0)
# the batched steps of the float32 repeat read by torch.profiler for the
# card's busy share: (first, count), past the solving lanes' last steps,
# where only the overloaded lane restores (reading every event of the
# whole batch back takes the profiler about a minute)
PROFILE_STEPS = (30, 40)
# The 2.0 lane runs the single solve's kernels bit for bit (K3 = K1 and
# K4 = K2 on the same band); the batched torch reductions around them (the
# refinement operator, the objective) sum in another order on the card, so
# in float32 the lane parts from the single solve from its first step
# (tools/restoration_parting.py --pair batch) and is a rounding twin of it,
# as a one-ulp start is.  Its counts are held to the one-ulp twins of both
# solves, the judged run (seed 0) left out of the range: RESTORATION_SPREAD
# (seeds 1-6 of both packages), the port's single solve on the card (seeds
# 7-40: 12-19 soft steps) and the batched lane on the card (seeds 1-40:
# 12-16 soft steps), from tools/spread.py restoration --pkg port|batch.
BATCH_RESTORATION_SPREAD = {
    "float64": RESTORATION_SPREAD["float64"],
    "float32": {"iter": (189, 256), "factorization_cnt": (217, 334),
                "backsolve_cnt": (725, 1310), "restore": (12, 19),
                "robust": (69, 120), "steps": (203, 272)},
}

# The step options (phases step_options, step_options_dense and
# step_options_exact): the runs, by name, with their options (enum members
# by name).
STEP_QN_HISTORY = 6       # QuasiNewtonOptions.max_history: SMW solves of 12
# The quasi-Newton runs at nb=600 stop at this many iterations: the JAX
# package's end within 123, and a run that stalls in robust restoration
# fails at 300 instead of at 3000.
STEP_QN_MAX_ITER = 300
STEP_BANDED = {
    "quality_function": {"barrier": "BarrierUpdate.QUALITY_FUNCTION"},
    "loqo": {"barrier": "BarrierUpdate.LOQO"},
    "inertia_free": {"inertia_correction_method": "InertiaCorrection.FREE"},
    "compact_lbfgs": {"hessian_approximation":
                      "HessianApproximation.COMPACT_LBFGS"},
}
STEP_DENSE = {
    "damped_bfgs": {"hessian_approximation": "HessianApproximation.DAMPED_BFGS"},
    "compact_lbfgs": {"hessian_approximation":
                      "HessianApproximation.COMPACT_LBFGS"},
    "gmres": {"iterator": "gmres"},
    "lu": {"linear_solver": "LinearSolver.LU"},
}
STEP_QUASI_NEWTON = ("damped_bfgs", "compact_lbfgs")
STEP_DENSE_AT_NB = ("damped_bfgs", "gmres", "lu")    # the dense runs at STEP_NB
STEP_NB = 600
STEP_PROFILED = ("quality_function", "compact_lbfgs")
# The JAX package's results on the CPU, (status, iterations,
# factorization_cnt, backsolve_cnt, objective), from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tools/spread.py flagship \
#       --pkg jax --option OPT --dtype DT --nb NB --first 0 --seeds 0
# (OPT: qf, loqo, free, lbfgs, k25 on the banded flagship, its options as
# _banded_solver's, float32 through the Pallas kernels in interpret mode;
# dbfgs, dlbfgs, gmres, lu on the dense opf.build(nb=NB, seed=0)); NB is
# STEP_NB here and STEP_EXACT's size in STEP_EXACT_REFERENCE.
STEP_REFERENCE = {
    ("banded", "float64", "quality_function"):
        ("SOLVE_SUCCEEDED", 35, 39, 43, 583.7230018594366),
    ("banded", "float64", "loqo"):
        ("SOLVE_SUCCEEDED", 26, 26, 28, 583.7230021565184),
    ("banded", "float64", "inertia_free"):
        ("SOLVE_SUCCEEDED", 25, 25, 54, 583.7230018594349),
    ("banded", "float64", "compact_lbfgs"):
        ("SOLVE_SUCCEEDED", 106, 106, 123, 583.7230021724106),
    ("banded", "float32", "quality_function"):
        ("SOLVE_SUCCEEDED", 35, 39, 112, 583.7230018594366),
    ("banded", "float32", "loqo"):
        ("SOLVE_SUCCEEDED", 26, 26, 67, 583.7230021589736),
    ("banded", "float32", "inertia_free"):
        ("SOLVE_SUCCEEDED", 25, 25, 131, 583.7230018594354),
    ("banded", "float32", "compact_lbfgs"):
        ("RESTORATION_FAILED", 103, 117, 351, 583.7230086318154),
    ("banded", "float32", "k25"):
        ("SOLVE_SUCCEEDED", 25, 25, 64, 583.7230018594353),
    ("dense", "float64", "damped_bfgs"):
        ("RESTORATION_FAILED", 103, 117, 123, 583.7230021724109),
    ("dense", "float64", "compact_lbfgs"):
        ("SOLVE_SUCCEEDED", 123, 123, 144, 583.7230018594353),
    ("dense", "float64", "gmres"):
        ("SOLVE_SUCCEEDED", 25, 25, 250, 583.723001859435),
    ("dense", "float64", "lu"):
        ("SOLVE_SUCCEEDED", 25, 25, 52, 583.7230018594353),
}
# Float64 backsolves that the refinement's rounding moves (ROADMAP C1):
# iterations and factorizations are exact, and the port's solve on the
# CPU replayed refinement by refinement in the JAX package's KKT system
# parts only at the last factorizations, where the refinement ratio's
# rounding floor lies above its tolerance (tests/test_torch_refine_f64.py
# ::test_step_option_sweeps_part_below_rounding).  Held to the range of
# both packages' one-ulp twins (tools/spread.py flagship: the JAX package
# on the CPU, seeds 0-6, and the port on the card, seeds 1-6).
STEP_SPREAD = {
    ("banded", "float64", "quality_function"): {"backsolve_cnt": (41, 43)},
    ("banded", "float64", "loqo"): {"backsolve_cnt": (27, 28)},
    ("banded", "float64", "inertia_free"): {"backsolve_cnt": (52, 54)},
}
# The quasi-Newton runs' 100-odd iterations at nb=600 carry the last bits
# of the first step into their counts and their exit: from the same start
# the port's step equals the JAX package's within rounding at every
# iteration (tools/spread.py lockstep), yet one-ulp twins of either
# package end SOLVE_SUCCEEDED, SOLVED_TO_ACCEPTABLE_LEVEL,
# RESTORATION_FAILED or stalled in robust restoration (ROADMAP C4).  So
# at nb=600 they are timed and must end SOLVE_SUCCEEDED at the JAX
# package's objective (within OBJ_RTOL), and the runs are held exactly at
# the largest flagship size at which both packages' judged runs agree
# (from nb=14, 30, 60 and 118 on the CPU): there status, iterations and
# factorizations exactly, backsolves exactly in float64 and within
# BACKSOLVE_RTOL in float32, the objective within OBJ_RTOL.  The dense
# compact L-BFGS run at nb=600 is left out: on the card its judged run
# stalls in robust restoration (as 1 in 5 of the JAX package's twins do).
STEP_EXACT = {
    ("banded", "float64", "compact_lbfgs"): 30,
    ("banded", "float32", "compact_lbfgs"): 30,
    ("dense", "float64", "compact_lbfgs"): 30,
    ("dense", "float64", "damped_bfgs"): 14,
}
STEP_EXACT_REFERENCE = {
    ("banded", "float64", "compact_lbfgs"):
        ("SOLVE_SUCCEEDED", 22, 22, 22, 27.27397025861216),
    ("banded", "float32", "compact_lbfgs"):
        ("SOLVE_SUCCEEDED", 22, 22, 52, 27.273970258612135),
    ("dense", "float64", "compact_lbfgs"):
        ("SOLVE_SUCCEEDED", 22, 22, 22, 27.27397025861218),
    ("dense", "float64", "damped_bfgs"):
        ("SOLVE_SUCCEEDED", 17, 17, 17, 29.302171747052675),
}
# Float32 backsolves there: 22 iterations and factorizations in every
# one-ulp twin of both packages, backsolves 50-54 in the JAX package (the
# CPU, seeds 0-6) and 53-56 in the port on the card (seeds 0-6; 52-54 on
# the CPU), from tools/spread.py flagship --option lbfgs --dtype float32
# --nb 30.  (At nb=14 the card's float32 twins take 19 or 20 iterations.)
STEP_EXACT_SPREAD = {
    ("banded", "float32", "compact_lbfgs"): {"backsolve_cnt": (50, 56)},
}

# The step options inside solve_batch (phases batch_step_options and
# batch_step_options_exact): the parametric flagship at BATCH_SCALES, one
# bulk run per option and dtype, every lane held to the port's single solve
# of its scale on the card (status, iterations and factorizations exactly,
# the objective within OBJ_RTOL, backsolves within BACKSOLVE_LANE_RTOL).
BATCH_STEP_OPTIONS = {
    "quality_function": STEP_BANDED["quality_function"],
    "loqo": STEP_BANDED["loqo"],
    "inertia_free": STEP_BANDED["inertia_free"],
    "k25": {"kkt_scaling": "k25"},
}
BATCH_STEP_RUNS = [(name, dtype) for dtype in ("float64", "float32")
                   for name in ("quality_function", "loqo", "inertia_free")
                   ] + [("k25", "float32")]
# the batched steps of the bit-for-bit repeat read by torch.profiler for
# the card's busy share: (first, count)
BATCH_STEP_PROFILED = (5, 10)
# The JAX package's float64 single solves of lanes 0, 5, 10 and 15 on the
# CPU, (status, iterations, factorization_cnt, objective), from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tools/spread.py lanes --pkg jax \
#       --option OPT --dtype float64 --indices 0,5,10,15
# (OPT: qf, loqo, free): status, iterations and factorizations exactly,
# the objective within OBJ_RTOL.
BATCH_STEP_JAX = {
    "quality_function": {
        0: ("SOLVE_SUCCEEDED", 35, 39, 482.97713399952283),
        5: ("SOLVE_SUCCEEDED", 39, 47, 548.4943842809328),
        10: ("SOLVE_SUCCEEDED", 31, 38, 620.9386667886148),
        15: ("SOLVE_SUCCEEDED", 32, 36, 702.2010769340687),
    },
    "loqo": {
        0: ("SOLVE_SUCCEEDED", 25, 25, 482.9771342732463),
        5: ("SOLVE_SUCCEEDED", 25, 25, 548.4943835864325),
        10: ("SOLVE_SUCCEEDED", 27, 27, 620.9386667887952),
        15: ("SOLVE_SUCCEEDED", 31, 31, 702.2010768665211),
    },
    "inertia_free": {
        0: ("SOLVE_SUCCEEDED", 24, 24, 482.97713389105974),
        5: ("SOLVE_SUCCEEDED", 23, 23, 548.4943838946883),
        10: ("SOLVE_SUCCEEDED", 26, 26, 620.9386671040447),
        15: ("SOLVE_SUCCEEDED", 27, 27, 702.2010771923601),
    },
}
# Compact L-BFGS inside the batch on the parametric flagship at
# BATCH_EXACT_NB (at nb=600 a quasi-Newton lane stalls in about one
# one-ulp twin in five, ROADMAP C4, so sixteen lanes all end in about 2%
# of runs): every lane exactly the port's single solve on the card
# (status, iterations, factorizations; backsolves within
# BACKSOLVE_LANE_RTOL), and held to the JAX package's single solves
# (BATCH_EXACT_JAX, from tools/spread.py lanes --pkg jax --option lbfgs
# --dtype DT --nb 30 --indices 0,...,15) on the lanes where the two
# packages' judged runs agree on the CPU (tools/spread.py lanes --pkg
# port, the same arguments): status, iterations and factorizations
# exactly, the objective within OBJ_RTOL.  Left out: float64 lanes 4 (JAX
# 27 iterations, the port 28) and 13 (28 and 25), float32 lane 12 (26 and
# 23), and the lanes that part from their single solve on the card
# (BATCH_SPREAD: float64 lane 9, float32 lane 4).  Every batched factorization launches K4
# once with 2·max_history columns (the SMW payload).
BATCH_EXACT_NB = 30
# The one-ulp spreads of the lanes that rounding parts from their single
# solve on the card (every float64 lane at nb600 and every K2.5 lane equal
# their single solves): {(run, dtype, nb): {lane: {counter: (lo, hi)}}},
# the range of the port's single solves and of the batch's lane over x0
# moved by at most one ulp, the judged run (seed 0) left out, on the card,
# from
#   python3 tools/spread.py lanes --pkg port|batch --device cuda \
#       --option OPT --dtype DT --nb NB --indices 0,...,15 --first 0 \
#       --seeds S
# with S = 20 for the quality function and 12 for the others; the lanes
# whose judged counts lay outside that first range (quality function 3, 7
# and 15, float32 L-BFGS 4) ran seeds up to 60 (--first 21|13 --seeds 60).
# A lane that parts is held to its spread: its counts and its single
# solve's both inside it.
BATCH_SPREAD = {
    ('quality_function', 'float32', 600): {
        2: {"iter": (29, 36), "factorization_cnt": (35, 46),
             "backsolve_cnt": (104, 192)},   # seeds 1-20
        3: {"iter": (29, 40), "factorization_cnt": (34, 52),
             "backsolve_cnt": (99, 218)},   # seeds 1-60
        4: {"iter": (28, 34), "factorization_cnt": (34, 43),
             "backsolve_cnt": (100, 149)},   # seeds 1-20
        5: {"iter": (30, 43), "factorization_cnt": (35, 58),
             "backsolve_cnt": (127, 279)},   # seeds 1-20
        6: {"iter": (31, 34), "factorization_cnt": (31, 35),
             "backsolve_cnt": (79, 106)},   # seeds 1-20
        7: {"iter": (28, 34), "factorization_cnt": (32, 41),
             "backsolve_cnt": (97, 144)},   # seeds 1-60
        8: {"iter": (34, 41), "factorization_cnt": (41, 50),
             "backsolve_cnt": (125, 190)},   # seeds 1-20
        9: {"iter": (32, 38), "factorization_cnt": (39, 48),
             "backsolve_cnt": (121, 174)},   # seeds 1-20
        12: {"iter": (30, 32), "factorization_cnt": (36, 39),
             "backsolve_cnt": (99, 132)},   # seeds 1-20
        13: {"iter": (35, 40), "factorization_cnt": (40, 46),
             "backsolve_cnt": (112, 148)},   # seeds 1-20
        15: {"iter": (32, 34), "factorization_cnt": (36, 42),
             "backsolve_cnt": (95, 132)},   # seeds 1-60
    },
    ('loqo', 'float32', 600): {
        4: {"iter": (26, 26), "factorization_cnt": (26, 27),
             "backsolve_cnt": (62, 74)},   # seeds 1-12
        7: {"iter": (26, 26), "factorization_cnt": (26, 29),
             "backsolve_cnt": (70, 99)},   # seeds 1-12
    },
    ('inertia_free', 'float32', 600): {
        1: {"iter": (23, 24), "factorization_cnt": (25, 27),
             "backsolve_cnt": (169, 203)},   # seeds 1-12
    },
    ('compact_lbfgs', 'float64', 30): {
        4: {"iter": (27, 28), "factorization_cnt": (27, 28),
             "backsolve_cnt": (27, 29)},   # seeds 1-12
        9: {"iter": (23, 31), "factorization_cnt": (23, 31),
             "backsolve_cnt": (23, 37)},   # seeds 1-12
    },
    ('compact_lbfgs', 'float32', 30): {
        4: {"iter": (27, 31), "factorization_cnt": (27, 31),
             "backsolve_cnt": (60, 83)},   # seeds 1-60
    },
}
BATCH_EXACT_JAX = {
    "float64": {
        0: ("SOLVE_SUCCEEDED", 36, 36, 22.458522982516776),
        1: ("SOLVE_SUCCEEDED", 29, 29, 23.035545711781925),
        2: ("SOLVE_SUCCEEDED", 28, 28, 23.629188613594827),
        3: ("SOLVE_SUCCEEDED", 29, 29, 24.24031694313484),
        5: ("SOLVE_SUCCEEDED", 29, 29, 25.51787024840906),
        6: ("SOLVE_SUCCEEDED", 24, 24, 26.191165564665578),
        7: ("SOLVE_SUCCEEDED", 22, 22, 26.904331160812948),
        8: ("SOLVE_SUCCEEDED", 24, 24, 27.65261614245675),
        10: ("SOLVE_SUCCEEDED", 24, 24, 29.22514777727186),
        11: ("SOLVE_SUCCEEDED", 24, 24, 30.038862842692442),
        12: ("SOLVE_SUCCEEDED", 23, 23, 30.871655249984638),
        14: ("SOLVE_SUCCEEDED", 23, 23, 32.60424404412829),
        15: ("SOLVE_SUCCEEDED", 24, 24, 33.50910614382818),
    },
    "float32": {
        0: ("SOLVE_SUCCEEDED", 36, 36, 22.458522982516726),
        1: ("SOLVE_SUCCEEDED", 29, 29, 23.035545711781893),
        2: ("SOLVE_SUCCEEDED", 28, 28, 23.629188613594835),
        3: ("SOLVE_SUCCEEDED", 29, 29, 24.240316943134886),
        5: ("SOLVE_SUCCEEDED", 29, 29, 25.517870248409206),
        6: ("SOLVE_SUCCEEDED", 24, 24, 26.191165564665546),
        7: ("SOLVE_SUCCEEDED", 22, 22, 26.90433116081304),
        8: ("SOLVE_SUCCEEDED", 24, 24, 27.652616142456726),
        9: ("SOLVE_SUCCEEDED", 23, 23, 28.429888065674803),
        10: ("SOLVE_SUCCEEDED", 24, 24, 29.225147777271843),
        11: ("SOLVE_SUCCEEDED", 24, 24, 30.038862842692463),
        13: ("SOLVE_SUCCEEDED", 25, 25, 31.724182046806998),
        14: ("SOLVE_SUCCEEDED", 23, 23, 32.6042440441283),
        15: ("SOLVE_SUCCEEDED", 24, 24, 33.50910614382807),
    },
}


# The front ends (slice A3).  ``nl_sparse``: the COPS minimal surface with
# obstacle on a 100 × 100 grid (Dolan, Moré and Munson, COPS 3.0,
# ANL/MCS-TM-273), n = 10,201, written as an AMPL text file by
# ``madnlp_tpu_torch.testing.minsurf_nl`` and solved through ``solve_nl``
# (``sparse="auto"``: the template compiler, then the banded KKT on K1/K2,
# N = 10,201: b = 256, bw = 1, nb = 40).  The JAX package's results on the
# CPU, (status, iterations, factorization_cnt, backsolve_cnt, objective),
# from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tools/a3_pins.py nl
# float64 with the default band backend, float32 through the Pallas
# kernels in interpret mode (the TPU kernel's order, which the port
# follows).  Both are held exactly, the objective within OBJ_RTOL.
NL_NX = 100
NL_REFERENCE = {
    "float64": ("SOLVE_SUCCEEDED", 32, 32, 100, 2.7495232903700737),
    "float32": ("SOLVE_SUCCEEDED", 31, 31, 219, 2.7495232903726623),
}
# float32 backsolves are a property of the rounding: one-ulp twins of the
# solve (x0 moved by at most one float64 ulp) take 214-219 in the JAX
# package on the CPU (seeds 0-6) and 210-215 in the port on the card
# (seeds 0-8; NVIDIA H100 80GB HBM3, 700.00 W), every twin at 31
# iterations and 31 factorizations (tools/spread.py minsurf --pkg jax|port
# --dtype float32; ROADMAP "Settled"), so the float32 solve's backsolves
# are held to the union; status, iterations and factorizations exactly
NL_BACKSOLVE_SPREAD = {"float32": (210, 219)}
TIMED_NL_SOLVES = 3
NL_CALLBACK_REPS = 20
# ``frontends``: the models of tests/test_frontends.py (HS15 through
# ``from_scipy`` with a NonlinearConstraint, the dict and
# LinearConstraint model, ``host_model`` with ``lag_hess`` and without it
# under compact L-BFGS), the JAX package's results on the CPU from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tools/a3_pins.py frontends
# status, iterations and factorizations held exactly (float64), the
# objective within OBJ_RTOL; backsolves reported beside the JAX package's
# (the CPU tests hold them exactly): the card's Cholesky (cuSOLVER) rounds
# otherwise than the CPU's, and HS15 takes one refinement sweep more.
FRONTEND_REFERENCE = {
    "scipy_hs15": ("SOLVE_SUCCEEDED", 23, 29, 39, 360.37976240508465),
    "scipy_dict_linear": ("SOLVE_SUCCEEDED", 4, 4, 4, 1.3333333333333337),
    "host_qp": ("SOLVE_SUCCEEDED", 1, 1, 1, -0.7272727272727275),
    "host_lbfgs": ("SOLVE_SUCCEEDED", 6, 6, 6, 0.9999999500540218),
}
# ``harness``: ``testing.test_kkt_system`` on every KKT system the port
# has; the banded cases on ``sparse_qp.build(n=1000)`` (N = 1500: b = 128)
HARNESS_QP_N = 1000

# Slice A4: the flagship model under the unreduced and the condensed
# systems (K1/K2 on their bands), the dense flagship under HYKKT (K_γ on
# K7) and BLOCK_CHOLESKY.  The JAX package's results on the CPU, (status,
# iterations, factorization_cnt, backsolve_cnt, objective), from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tools/a4_pins.py CASE --nb NB \
#       --dtype DT
# (float32 banded runs through the Pallas kernels in interpret mode, the
# TPU kernel's order, which the port follows; HYKKT with
# hykkt_backend="ldl", the algorithm of K7), and their one-ulp spreads
# (x0 moved by at most one ulp, seeds 0-6) from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tools/spread.py CASE --pkg jax \
#       --nb 600 --seeds 6
A4_NB = 600
# float64 is moved by rounding (ROADMAP §C, R3): held to the JAX
# package's one-ulp spread (which holds the port's twins on the card,
# 25/51-52/332-348); float32 to the pin (iterations and factorizations
# exactly, backsolves within BACKSOLVE_RTOL; the card's twins 25/59-60/
# 481-496)
UNREDUCED_REFERENCE = {
    "float64": ("SOLVE_SUCCEEDED", 26, 54, 366, 583.723002172411),
    "float32": ("SOLVE_SUCCEEDED", 25, 60, 497, 583.7230018594356),
}
UNREDUCED_SPREAD = {"float64": {"iter": (25, 26),
                                "factorization_cnt": (51, 54),
                                "backsolve_cnt": (331, 366)}}
CONDENSED_TOL = 1e-6
# every count moved by rounding (R3): held to the JAX package's twins
# (the port's on the card, 82-97/187-223/1434-1732, are reported in
# PERF.md, not used here); the objective of a twin lands up to 2e-8
# relative from another's, so it is held to the JAX package's unperturbed
# solve only for the run as it is
CONDENSED_REFERENCE = {
    "float64": ("SOLVE_SUCCEEDED", 83, 184, 1403, 583.722899518331),
}
CONDENSED_SPREAD = {"float64": {"iter": (83, 99),
                                "factorization_cnt": (184, 233),
                                "backsolve_cnt": (1373, 1767)}}
# BLOCK_CHOLESKY at the largest flagship size tried at which the JAX
# package's solve succeeds: of nb = 80, 90, 95-118, 150, 200, 250, 300
# and 450 it succeeds at 90, 95, 102 and 107 only in 400 iterations, at
# 600 not in 100 (ROADMAP §C, R3); its one-ulp twins at 107 (tools/
# spread.py range_space --option bchol --nb 107) all take 48/93/94
BCHOL_NB = 107
# HYKKT float32: iterations and factorizations exactly, backsolves within
# BACKSOLVE_RTOL (the card's twins 25/25/110-111)
RANGE_SPACE_REFERENCE = {
    ("hykkt", "float64"): ("SOLVE_SUCCEEDED", 25, 25, 49, 583.723001859435),
    ("hykkt", "float32"): ("SOLVE_SUCCEEDED", 25, 25, 108, 583.723001859435),
    ("block_cholesky", "float64"): ("SOLVE_SUCCEEDED", 48, 93, 94,
                                    79.50522163521751),
    ("infeasible", "float64"): ("INFEASIBLE_PROBLEM_DETECTED", 8, 8, 8,
                                0.9999999900025058),
}
TIMED_A4_SOLVES = 2
# K1 then K2's backward error on an A4 band: at most 10× that of the plain
# factorization and solve, or this
BACKWARD_TOL = 1e-12

def emit(obj):
    print(json.dumps(obj, default=_plain), flush=True)


def _plain(v):
    """numpy scalars and arrays in a JSON line."""
    return v.tolist() if hasattr(v, "tolist") else str(v)


def _import_port():
    sys.path.insert(0, HERE)
    import madnlp_tpu_torch

    pkg = os.path.dirname(os.path.abspath(madnlp_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"madnlp_tpu_torch imported from {pkg}, not from "
                           f"this checkout ({HERE})")
    return madnlp_tpu_torch


# -- 1. device -----------------------------------------------------------------


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke test needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi.splitlines()[0]


# -- 2. build ------------------------------------------------------------------


def phase_build():
    from madnlp_tpu_torch.ops import banded_fused_kernels as bf
    from madnlp_tpu_torch.ops import banded_kernels as bk
    from madnlp_tpu_torch.ops import dense_kernels as dk

    t = time.perf_counter()
    # one nvcc per source, started together
    modules = (bk, bf, dk)
    with ThreadPoolExecutor(max_workers=len(modules)) as pool:
        futures = [pool.submit(m.build, force=True, ptxas_info=True)
                   for m in modules]
        paths = [f.result() for f in futures]
    for m in modules:
        m.load()
    emit({"phase": "build",
          "libraries": [os.path.relpath(p, HERE) for p in paths],
          "seconds": time.perf_counter() - t})


# -- 3. kernels vs plain on seeded systems -------------------------------------


def _rel(a, ref):
    a, ref = a.double(), ref.double()
    return float((a - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def _abs(a, ref):
    return float((a.double() - ref.double()).abs().max())


def compare_kernels(torch, struct, band):
    """K1 and K2 against the plain versions on one band (on the card).
    Returns the errors over the real block columns."""
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.ops import banded_kernels as bk

    b, bw, nb = struct.b, struct.bw, struct.nb
    kf = bk.factorize(struct, band.clone())
    pf = plain.banded_factorize(struct, band)
    rhs = torch.as_tensor(np.random.default_rng(nb * b + bw).standard_normal(
        struct.N), dtype=band.dtype, device=band.device)
    kx = bk.solve(struct, kf, rhs)
    px = plain.banded_solve(struct, kf, rhs)
    torch.cuda.synchronize()
    pairs = {"band": (kf.band[:nb], pf.band[:nb]),
             "invL": (kf.invL[:nb], pf.invL[:nb]),
             "d": (kf.d, pf.d), "solve": (kx, px)}
    return {
        "rel": {k: _rel(*v) for k, v in pairs.items()},
        "abs": {k: _abs(*v) for k, v in pairs.items()},
        "inertia": (plain.banded_inertia(struct, kf),
                    plain.banded_inertia(struct, pf)),
        "finite": bool(torch.isfinite(kf.band[:nb]).all()
                       and torch.isfinite(kx).all()),
    }


def compare_batched(torch, struct, bands):
    """K3 and K4 against their plain batched versions on ``bands (B, ...)``
    (on the card), and lane by lane against K1 and K2.  Returns the errors
    over the real block columns and the per-lane inertia."""
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.ops import banded_kernels as bk

    B, b, nb = bands.shape[0], struct.b, struct.nb
    every = np.ones(B, dtype=bool)
    kf = bk.factorize_batched(
        struct, bands.clone(), bands.new_zeros((B, struct.nbp, b, b)),
        bands.new_ones((B, nb * b)), every)
    pf = plain.banded_factorize_batched(struct, bands)
    rhs = torch.as_tensor(np.random.default_rng(B * nb * b + 1).standard_normal(
        (B, struct.N)), dtype=bands.dtype, device=bands.device)
    kx = bk.solve_batched(struct, kf, rhs, every)
    px = plain.banded_solve_batched(struct, kf, rhs)
    single = [bk.factorize(struct, bands[i].clone()) for i in range(B)]
    sx = torch.stack([bk.solve(struct, f, rhs[i])
                      for i, f in enumerate(single)])
    torch.cuda.synchronize()
    pairs = {"band": (kf.band[:, :nb], pf.band[:, :nb]),
             "invL": (kf.invL[:, :nb], pf.invL[:, :nb]),
             "d": (kf.d, pf.d), "solve": (kx, px)}
    vs_single = {"band": (kf.band[:, :nb], torch.stack([f.band[:nb]
                                                        for f in single])),
                 "d": (kf.d, torch.stack([f.d for f in single])),
                 "solve": (kx, sx)}
    inertia = plain.banded_inertia(struct, kf)
    return {
        "rel": {k: _rel(*v) for k, v in pairs.items()},
        "abs": {k: _abs(*v) for k, v in pairs.items()},
        "rel_vs_single": {k: _rel(*v) for k, v in vs_single.items()},
        # every lane is active: K3's factor of each lane is K1's, bit for bit
        "equal_to_single": all(
            torch.equal(kf.band[i, :nb], f.band[:nb])
            and torch.equal(kf.invL[i, :nb], f.invL[:nb])
            and torch.equal(kf.d[i], f.d) for i, f in enumerate(single)),
        "inertia": inertia.tolist(),
        "inertia_equal": bool(
            (inertia == plain.banded_inertia(struct, pf)).all()
            and all(tuple(inertia[i]) == plain.banded_inertia(struct, f)
                    for i, f in enumerate(single))),
        "finite": bool(torch.isfinite(kf.band[:, :nb]).all()
                       and torch.isfinite(kx).all()),
    }


def check_inactive_lane(torch, struct, bands):
    """K3 and K4 with lane 0 switched off: lane 0's band, invL, pivots and
    right-hand side must come back bit for bit.  Returns True if they do."""
    from madnlp_tpu_torch.ops import banded_kernels as bk

    B, b, nb = bands.shape[0], struct.b, struct.nb
    active = np.ones(B, dtype=bool)
    active[0] = False
    work = bands.clone()
    invL = torch.full((B, struct.nbp, b, b), 7.0, dtype=bands.dtype,
                      device=bands.device)
    d = torch.full((B, nb * b), 3.0, dtype=bands.dtype, device=bands.device)
    bk.banded_factorize_batched_cuda(work, invL, d, active, nb, b, struct.bw)
    rhs = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (B, struct.nbp * b, 1)), dtype=bands.dtype, device=bands.device)
    r = rhs.clone()
    bk.banded_solve_batched_cuda(work, invL, d, r, active)
    torch.cuda.synchronize()
    return bool(torch.equal(work[0], bands[0]) and (invL[0] == 7.0).all()
                and (d[0] == 3.0).all() and torch.equal(r[0], rhs[0]))


def _lane_bands(torch, b, bw, nb, dtype_name, lanes, zero_lane=None):
    """``lanes`` seeded band systems of one geometry (identity ordering),
    stacked on the card; ``zero_lane`` carries an exactly zero pivot."""
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.testing import band_system

    # N = nb·b − b/2 leaves a padded tail block
    N = nb * b - b // 2
    bands = []
    for i in range(lanes):
        rows, cols, vals = band_system(
            b + 7 * bw + nb + 100 * i, N, b, bw,
            zero_row=nb * b // 2 if i == zero_lane else None)
        st = plain.BandStructure(rows, cols, N, block=b, perm=np.arange(N))
        if (st.b, st.bw, st.nb) != (b, bw, nb):
            raise AssertionError(f"geometry {(st.b, st.bw, st.nb)} "
                                 f"!= {(b, bw, nb)}")
        bands.append(st.assembly(st.map(rows, cols), "cpu")(
            torch.as_tensor(vals)))
    return st, torch.stack(bands).to(getattr(torch, dtype_name)).cuda()


def phase_kernels(torch):
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.testing import band_system

    dev = torch.device("cuda")
    worst = {}
    for (b, bw, nb) in GEOMETRIES:
        for dtype_name in ("float32", "float64"):
            tol = KERNEL_RTOL[dtype_name]
            st, bands = _lane_bands(torch, b, bw, nb, dtype_name, BATCH_LANES,
                                    zero_lane=1)
            res = compare_batched(torch, st, bands)
            untouched = (check_inactive_lane(torch, st, bands)
                         if (b, bw, nb) == GEOMETRIES[0] else None)
            emit({"phase": "kernels", "batched": True, "lanes": BATCH_LANES,
                  "b": b, "bw": bw, "nb": nb, "N": st.N, "dtype": dtype_name,
                  "max_rel_err": res["rel"],
                  "max_rel_err_vs_K1_K2": res["rel_vs_single"], "tol": tol,
                  "factor_equal_to_K1": res["equal_to_single"],
                  "inertia_per_lane": res["inertia"],
                  "inactive_lane_untouched": untouched})
            if not res["finite"]:
                raise AssertionError("non-finite batched kernel output")
            if max(res["rel"].values()) > tol:
                raise AssertionError(f"K3/K4 disagree with plain at "
                                     f"{(b, bw, nb, dtype_name)}")
            if max(res["rel_vs_single"].values()) > tol:
                raise AssertionError(f"K3/K4 disagree with K1/K2 at "
                                     f"{(b, bw, nb, dtype_name)}")
            if (b, bw, nb) == GEOMETRIES[0] and not res["equal_to_single"]:
                raise AssertionError(f"K3's factor differs from K1's at "
                                     f"{(b, bw, nb, dtype_name)}")
            if not res["inertia_equal"]:
                raise AssertionError("batched inertia differs")
            if res["inertia"][1][1] != 1:
                raise AssertionError("lane 1's zero pivot was not counted")
            if untouched is False:
                raise AssertionError("an inactive lane was modified")
            if (b, bw, nb) == GEOMETRIES[0] and dtype_name == "float32":
                worst["K3"] = max(res["abs"][k] for k in ("band", "invL", "d"))
                worst["K4"] = res["abs"]["solve"]
            variants = [None] + ([nb * b // 2] if (b, bw, nb) == GEOMETRIES[0]
                                 else [])
            for zero_row in variants:
                # N = nb·b − b/2 leaves a padded tail block
                N = nb * b - b // 2
                rows, cols, vals = band_system(b + 7 * bw + nb, N, b, bw,
                                               zero_row=zero_row)
                st = plain.BandStructure(rows, cols, N, block=b,
                                         perm=np.arange(N))
                if (st.b, st.bw, st.nb) != (b, bw, nb):
                    raise AssertionError(f"geometry {(st.b, st.bw, st.nb)} "
                                         f"!= {(b, bw, nb)}")
                band = st.assembly(st.map(rows, cols), "cpu")(
                    torch.as_tensor(vals)).to(getattr(torch, dtype_name))
                res = compare_kernels(torch, st, band.to(dev))
                tol = KERNEL_RTOL[dtype_name]
                emit({"phase": "kernels", "b": b, "bw": bw, "nb": nb, "N": N,
                      "dtype": dtype_name, "zero_row": zero_row,
                      "max_rel_err": res["rel"], "tol": tol,
                      "inertia_kernel": res["inertia"][0],
                      "inertia_plain": res["inertia"][1]})
                if not res["finite"]:
                    raise AssertionError("non-finite kernel output")
                if max(res["rel"].values()) > tol:
                    raise AssertionError(f"kernel disagrees with plain at "
                                         f"{(b, bw, nb, dtype_name)}")
                if res["inertia"][0] != res["inertia"][1]:
                    raise AssertionError("inertia differs")
                if zero_row is not None and res["inertia"][0][1] != 1:
                    raise AssertionError("the zero pivot was not counted")
                if (b, bw, nb) == GEOMETRIES[0] and dtype_name == "float32":
                    for k, v in res["abs"].items():
                        worst[k] = max(worst.get(k, 0.0), v)
    check_k2_wide(torch)
    worst["K4_wide"] = check_k4_wide(torch)
    return worst


# K2 at the width of the compact L-BFGS SMW solve (2 · max_history = 12
# right-hand sides): the flagship's geometry and the ring's, both dtypes
WIDE_K = 12
WIDE_GEOMETRIES = [(256, 2, 11), (256, 4, 10)]
WIDE_REPS = 20


def check_k2_wide(torch):
    """K2 on a ``WIDE_K``-column right-hand side: against the plain solve
    (within ``KERNEL_RTOL``) and against ``WIDE_K`` one-column K2 launches,
    bit for bit (each column of the cluster solve is independent); its
    launch plan, and its time beside one one-column launch (CUDA events,
    float32 and float64)."""
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.ops import banded_kernels as bk

    out = {}
    for (b, bw, nb) in WIDE_GEOMETRIES:
        for dtype_name in ("float32", "float64"):
            st, bands = _lane_bands(torch, b, bw, nb, dtype_name, 1)
            f = bk.factorize(st, bands[0].clone())
            rng = np.random.default_rng(b + bw + nb + WIDE_K)
            rhs = torch.as_tensor(rng.standard_normal((st.N, WIDE_K)),
                                  dtype=bands.dtype, device=bands.device)
            wide = plain.pad_rhs(st, rhs)
            x = wide.clone()
            bk.banded_solve_cuda(f.band, f.invL, f.d, x)
            cols = []
            for j in range(WIDE_K):
                xj = wide[:, j:j + 1].clone()
                bk.banded_solve_cuda(f.band, f.invL, f.d, xj)
                cols.append(xj)
            torch.cuda.synchronize()
            split = all(_same_bits(torch, x[:, j:j + 1], cols[j])
                        for j in range(WIDE_K))
            rel = _rel(x[: st.N], plain.banded_solve(st, f, rhs))
            one = wide[:, :1].clone()
            times = {
                f"k{WIDE_K}": _time_events(
                    torch, lambda: bk.banded_solve_cuda(f.band, f.invL, f.d, x),
                    lambda: x.copy_(wide), WIDE_REPS),
                "k1": _time_events(
                    torch, lambda: bk.banded_solve_cuda(f.band, f.invL, f.d,
                                                        one),
                    lambda: one.copy_(wide[:, :1]), WIDE_REPS)}
            tol = KERNEL_RTOL[dtype_name]
            emit({"phase": "kernels", "K2_columns": WIDE_K, "b": b, "bw": bw,
                  "nb": nb, "N": st.N, "dtype": dtype_name,
                  "max_rel_err_vs_plain": rel, "tol": tol,
                  "equal_to_one_column_launches": split, "ms": times,
                  "plan": _plan_line(torch, f.band, x)})
            if not torch.isfinite(x).all() or rel > tol:
                raise AssertionError(f"K2 at k={WIDE_K} disagrees with plain "
                                     f"at {(b, bw, nb, dtype_name)}: {rel}")
            if not split:
                raise AssertionError(f"K2 at k={WIDE_K} differs from "
                                     f"{WIDE_K} one-column launches at "
                                     f"{(b, bw, nb, dtype_name)}")
            out[(b, bw, dtype_name)] = times
    return out


WIDE_LANES = 16      # the batch's lanes
WIDE_INACTIVE = 3    # a lane left out of the launch


def check_k4_wide(torch):
    """K4 on ``WIDE_K`` columns (the batched SMW solve of compact L-BFGS)
    at the batch's geometry (b = 256, bw = 2, nb = 11) over
    ``WIDE_LANES`` lanes, lane ``WIDE_INACTIVE`` inactive: against the
    plain batched solve (within ``KERNEL_RTOL``), bit for bit against
    ``WIDE_K`` one-column K4 launches, the inactive lane's right-hand
    side back bit for bit; its launch plan, and its time by CUDA events
    beside one column's and beside the plain solve's, with its bound
    (bytes, :func:`_bounds` at k columns over the active lanes).  Returns
    {dtype: its numbers}."""
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.ops import banded_kernels as bk

    b, bw, nb = WIDE_GEOMETRIES[0]
    active = np.ones(WIDE_LANES, dtype=bool)
    active[WIDE_INACTIVE] = False
    out = {}
    for dtype_name in ("float32", "float64"):
        st, bands = _lane_bands(torch, b, bw, nb, dtype_name, WIDE_LANES)
        every = np.ones(WIDE_LANES, dtype=bool)
        f = bk.factorize_batched(
            st, bands.clone(), bands.new_zeros((WIDE_LANES, st.nbp, b, b)),
            bands.new_ones((WIDE_LANES, nb * b)), every)
        rng = np.random.default_rng(b + bw + nb + WIDE_K + WIDE_LANES)
        rhs = torch.as_tensor(rng.standard_normal((WIDE_LANES, st.N, WIDE_K)),
                              dtype=bands.dtype, device=bands.device)
        wide = plain.pad_rhs_batched(st, rhs)
        x = wide.clone()
        bk.banded_solve_batched_cuda(f.band, f.invL, f.d, x, active)
        cols = []
        for j in range(WIDE_K):
            xj = wide[:, :, j:j + 1].clone()
            bk.banded_solve_batched_cuda(f.band, f.invL, f.d, xj, active)
            cols.append(xj)
        torch.cuda.synchronize()
        split = all(_same_bits(torch, x[:, :, j:j + 1], cols[j])
                    for j in range(WIDE_K))
        untouched = _same_bits(torch, x[WIDE_INACTIVE], wide[WIDE_INACTIVE])
        ref = plain.banded_solve_batched(st, f, rhs, active)
        rel = max(_rel(x[i, : st.N], ref[i]) for i in np.flatnonzero(active))
        err = max(_abs(x[i, : st.N], ref[i]) for i in np.flatnonzero(active))
        one = wide[:, :, :1].clone()
        work = wide.clone()
        times = {
            f"k{WIDE_K}": _time_events(
                torch, lambda: bk.banded_solve_batched_cuda(
                    f.band, f.invL, f.d, x, active),
                lambda: x.copy_(wide), WIDE_REPS),
            "k1": _time_events(
                torch, lambda: bk.banded_solve_batched_cuda(
                    f.band, f.invL, f.d, one, active),
                lambda: one.copy_(wide[:, :, :1]), WIDE_REPS),
            f"k{WIDE_K}_plain": _time_events(
                torch, lambda: plain.solve_padded_batched(
                    f.band, f.invL, f.d, work, active),
                lambda: work.copy_(wide), 3)}
        bound = _bounds(nb, b, bw, bands.element_size(), dtype_name,
                        lanes=int(active.sum()), k=WIDE_K)["K4"]
        tol = KERNEL_RTOL[dtype_name]
        emit({"phase": "kernels", "K4_columns": WIDE_K, "lanes": WIDE_LANES,
              "inactive_lane": WIDE_INACTIVE, "b": b, "bw": bw, "nb": nb,
              "N": st.N, "dtype": dtype_name, "max_rel_err_vs_plain": rel,
              "max_abs_err_vs_plain": err, "tol": tol,
              "equal_to_one_column_launches": split,
              "inactive_lane_untouched": untouched, "ms": times,
              "bound": bound,
              "share_of_bound": bound["bound_ms"] / times[f"k{WIDE_K}"],
              "plan": _plan_line(torch, f.band, x)})
        if not torch.isfinite(x).all() or rel > tol:
            raise AssertionError(f"K4 at k={WIDE_K} disagrees with plain "
                                 f"({dtype_name}): {rel}")
        if not split:
            raise AssertionError(f"K4 at k={WIDE_K} differs from {WIDE_K} "
                                 f"one-column launches ({dtype_name})")
        if not untouched:
            raise AssertionError(f"K4 at k={WIDE_K} wrote an inactive lane")
        out[dtype_name] = {"ms": times, "bound": bound, "abs": err}
    return out


# -- 3b. the whole-band kernels K5 / K6 on seeded systems ----------------------


def compare_fused(torch, struct, band, widths=FUSED_WIDTHS):
    """K5 and K6 against their witnesses (the kernels they replaced, bit
    for bit, overhang included), against their plain versions, and against
    K1 and K2 (the same function), on one band on the card; K6, its witness and
    K2 at each right-hand side width in ``widths``.  Returns the errors
    over the real block columns, the bit-for-bit verdicts and the three
    inertias."""
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.ops import banded_fused_kernels as bf
    from madnlp_tpu_torch.ops import banded_kernels as bk

    nb, b, bw = struct.nb, struct.b, struct.bw
    ff = bf.banded_fused_factorize(struct, band.clone())
    pf = bf.banded_fused_factorize_plain(struct, band)
    kf = bk.factorize(struct, band.clone())
    wb = band.clone()
    winvL = torch.zeros_like(ff.invL)
    wd = torch.ones((struct.nbp * b,), dtype=band.dtype, device=band.device)
    bf.banded_fused_factorize_reference_cuda(wb, winvL, wd, nb, b, bw)
    witness = {"K5": all(_same_bits(torch, x, y) for x, y in (
        (ff.band, wb), (ff.invL, winvL), (ff.d, wd[: nb * b])))}
    pairs = {"band": (ff.band[:nb], pf.band[:nb]),
             "invL": (ff.invL[:nb], pf.invL[:nb]), "d": (ff.d, pf.d)}
    witness_abs = {"band": _abs(wb[:nb], pf.band[:nb]),
                   "invL": _abs(winvL[:nb], pf.invL[:nb]),
                   "d": _abs(wd[: nb * b], pf.d)}
    vs_k1_k2 = {"band": (ff.band[:nb], kf.band[:nb]),
                "invL": (ff.invL[:nb], kf.invL[:nb]), "d": (ff.d, kf.d)}
    rng = np.random.default_rng(nb * struct.b + struct.bw)
    for k in widths:
        rhs = torch.as_tensor(
            rng.standard_normal(struct.N if k == 1 else (struct.N, k)),
            dtype=band.dtype, device=band.device)
        fx = bf.banded_fused_solve(struct, ff, rhs)
        px = bf.banded_fused_solve_plain(struct, ff, rhs)
        pairs[f"solve_k{k}"] = (fx, px)
        # K6 (on the k columns, as the solve above, and on every padded
        # column) and its witness on the same padded operands, every row
        # and column of the result
        x, dpad = bf._padded(struct, ff, rhs)
        y, z = x.clone(), x.clone()
        bf.banded_fused_solve_cuda(ff.band, ff.invL, dpad, x, k)
        bf.banded_fused_solve_cuda(ff.band, ff.invL, dpad, z)
        bf.banded_fused_solve_reference_cuda(ff.band, ff.invL, dpad, y)
        witness[f"K6_k{k}"] = _same_bits(torch, x, y)
        witness[f"K6_k{k}_all_columns"] = _same_bits(torch, z, y)
        witness_abs[f"solve_k{k}"] = _abs(bf._unpadded(struct, y, rhs), px)
        # K2 holds (bw+2)·b·k values of the right-hand side in each CTA's
        # shared memory: eight columns at a time
        kx = (bk.solve(struct, kf, rhs) if k == 1 else torch.cat(
            [bk.solve(struct, kf, rhs[:, i:i + 8]) for i in range(0, k, 8)], 1))
        vs_k1_k2[f"solve_k{k}"] = (fx, kx)
    torch.cuda.synchronize()
    return {
        "rel": {k: _rel(*v) for k, v in pairs.items()},
        "abs": {k: _abs(*v) for k, v in pairs.items()},
        "equal_to_witness": witness,
        "witness_abs": witness_abs,
        "rel_vs_K1_K2": {k: _rel(*v) for k, v in vs_k1_k2.items()},
        # K5 runs the tiled diagonal step and its witness the scalar one,
        # K1 the tiled one: their factors on the real columns must be
        # equal, bit for bit
        "factor_equal_to_K1": {k: bool(torch.equal(*vs_k1_k2[k]))
                               for k in ("band", "invL", "d")},
        "inertia": [plain.banded_inertia(struct, f) for f in (ff, pf, kf)],
        "finite": bool(torch.isfinite(ff.band[:nb]).all()
                       and all(torch.isfinite(v[0]).all()
                               for k, v in pairs.items()
                               if k.startswith("solve"))),
    }


def _check_fused(res, tol, where):
    if not res["finite"]:
        raise AssertionError(f"non-finite K5/K6 output at {where}")
    if not all(res["equal_to_witness"].values()):
        raise AssertionError(f"K5/K6 differ from their witnesses at {where}: "
                             f"{res['equal_to_witness']}")
    if max(res["rel"].values()) > tol:
        raise AssertionError(f"K5/K6 disagree with plain at {where}")
    if not all(res["factor_equal_to_K1"].values()):
        raise AssertionError(f"K5's factor differs from K1's at {where}: "
                             f"{res['factor_equal_to_K1']}")
    if max(v for k, v in res["rel_vs_K1_K2"].items()
           if k.startswith("solve")) > tol:
        raise AssertionError(f"K6 disagrees with K2 at {where}")
    if len(set(res["inertia"])) != 1:
        raise AssertionError(f"K5 inertia differs at {where}: {res['inertia']}")


def phase_fused_kernels(torch):
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.ops import banded_fused_kernels as bf
    from madnlp_tpu_torch.ops import banded_kernels as bk
    from madnlp_tpu_torch.testing import band_system

    worst = {}
    for (b, bw, nb) in FUSED_GEOMETRIES:
        for dtype_name in ("float32", "float64"):
            tol = KERNEL_RTOL[dtype_name]
            # N = nb·b − b/2 leaves a padded tail block
            N = nb * b - b // 2
            for zero_row in (None, N // 2):
                rows, cols, vals = band_system(b + 7 * bw + nb + 1, N, b, bw,
                                               zero_row=zero_row)
                st = plain.BandStructure(rows, cols, N, block=b,
                                         perm=np.arange(N))
                if (st.b, st.bw, st.nb) != (b, bw, nb):
                    raise AssertionError(f"geometry {(st.b, st.bw, st.nb)} "
                                         f"!= {(b, bw, nb)}")
                band = st.assembly(st.map(rows, cols), "cpu")(
                    torch.as_tensor(vals)).to(getattr(torch, dtype_name)).cuda()
                res = compare_fused(torch, st, band)
                where = (b, bw, nb, dtype_name, zero_row)
                emit({"phase": "fused_kernels", "b": b, "bw": bw, "nb": nb,
                      "N": N, "dtype": dtype_name, "zero_row": zero_row,
                      "plans": _fused_plans(torch, st, band),
                      "equal_to_witness": res["equal_to_witness"],
                      "max_rel_err": res["rel"],
                      "max_rel_err_vs_K1_K2": res["rel_vs_K1_K2"], "tol": tol,
                      "factor_equal_to_K1": res["factor_equal_to_K1"],
                      "inertia (K5, plain, K1)": res["inertia"]})
                _check_fused(res, tol, where)
                if zero_row is not None and res["inertia"][0][1] != 1:
                    raise AssertionError(f"the zero pivot was not counted at "
                                         f"{where}")
                if (b, bw, nb) == FUSED_GEOMETRIES[-1] and \
                        dtype_name == "float32":
                    a = res["abs"]
                    worst["K5"] = max(worst.get("K5", 0.0),
                                      *(a[k] for k in ("band", "invL", "d")))
                    worst["K6"] = max(worst.get("K6", 0.0),
                                      *(v for k, v in a.items()
                                        if k.startswith("solve")))
                    w = res["witness_abs"]
                    worst["K5_witness"] = max(
                        worst.get("K5_witness", 0.0),
                        *(w[k] for k in ("band", "invL", "d")))
                    worst["K6_witness"] = max(
                        worst.get("K6_witness", 0.0),
                        *(v for k, v in w.items() if k.startswith("solve")))

    # one K5 call and one K6 call are one CUDA kernel launch each; one K1
    # call is 4·nb (on the loop's last band, case118's geometry)
    b, bw, nb = FUSED_GEOMETRIES[-1]
    work = band.float().contiguous()
    invL = torch.zeros((st.nbp, b, b), dtype=work.dtype, device=work.device)
    d = torch.ones((st.nbp * b,), dtype=work.dtype, device=work.device)
    x = torch.zeros((st.nbp * b, 8), dtype=work.dtype, device=work.device)
    launches = {
        "K5": _count_launches(torch, lambda: bf.banded_fused_factorize_cuda(
            work, invL, d, nb, b, bw)),
        "K6": _count_launches(torch, lambda: bf.banded_fused_solve_cuda(
            work, invL, d, x)),
        "K1": _count_launches(torch, lambda: bk.banded_factorize_cuda(
            work, invL, d, nb, b, bw)),
    }
    emit({"phase": "fused_kernels", "b": b, "bw": bw, "nb": nb,
          "device_launches_per_call": launches})
    if launches["K5"] != 1 or launches["K6"] != 1:
        raise AssertionError(f"one K5 / K6 call made {launches} launches")
    return worst


def _fused_plans(torch, struct, band, widths=FUSED_WIDTHS):
    """The launch plans of K5 and of K6 at each width, for this band."""
    from madnlp_tpu_torch.ops import banded_fused_kernels as bf

    b, bw, nb = struct.b, struct.bw, struct.nb
    plans = {"K5": bf.factorize_plan_for(band, nb, b, bw)._asdict()}
    for k in widths:
        plans[f"K6_k{k}"] = bf.solve_plan_for(band, k)._asdict()
    return plans


# -- 3b'. K2 / K4 against their witness ---------------------------------------

def _same_bits(torch, a, b):
    """Equal bit for bit (NaN and signed zeros included)."""
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


def _plan_line(torch, band, rhs):
    """The cluster solve's launch plan for these operands, and the clusters
    of each size the card keeps resident."""
    from madnlp_tpu_torch.ops import banded_kernels as bk

    plan = bk.plan_for(band, rhs)
    return {"clusters": plan.clusters, "rows_per_stage": plan.rows,
            "stages": plan.stages, "smem_bytes": plan.smem,
            "max_active_clusters": bk.max_clusters(band.dtype, band.device)}


def phase_solve_witness(torch):
    """K2 and K4 against the one-CTA reference solve, bit for bit, at
    ``SOLVE_GEOMETRIES`` × both dtypes × ``SOLVE_WIDTHS``, three lanes of
    which lane 1 carries an exactly zero pivot; K4 with lane 0 inactive
    once per dtype.  Returns the witness's worst absolute error against
    the plain solve at the main path's geometry in float32."""
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.ops import banded_kernels as bk

    worst = {}
    for (b, bw, nb) in SOLVE_GEOMETRIES:
        for dtype_name in ("float32", "float64"):
            st, bands = _lane_bands(torch, b, bw, nb, dtype_name, BATCH_LANES,
                                    zero_lane=1)
            B = bands.shape[0]
            every = np.ones(B, dtype=bool)
            f = bk.factorize_batched(
                st, bands.clone(), bands.new_zeros((B, st.nbp, b, b)),
                bands.new_ones((B, nb * b)), every)
            rng = np.random.default_rng(b * bw + nb)
            equal, plans = {}, {}
            for k in SOLVE_WIDTHS:
                rhs = plain.pad_rhs_batched(st, torch.as_tensor(
                    rng.standard_normal((B, st.N, k)), dtype=bands.dtype,
                    device=bands.device))
                new, ref = rhs.clone(), rhs.clone()
                bk.banded_solve_batched_cuda(f.band, f.invL, f.d, new, every)
                bk.banded_solve_reference_cuda(f.band, f.invL, f.d, ref, every)
                ok = _same_bits(torch, new, ref)
                for i in range(B):
                    x, y = rhs[i].clone(), rhs[i].clone()
                    bk.banded_solve_cuda(f.band[i], f.invL[i], f.d[i], x)
                    bk.banded_solve_reference_cuda(f.band[i], f.invL[i],
                                                   f.d[i], y)
                    ok = ok and _same_bits(torch, x, y) \
                        and _same_bits(torch, x, new[i])
                equal[f"k{k}"] = ok
                plans[f"K2_k{k}"] = _plan_line(torch, f.band[0], rhs[0])
                plans[f"K4_k{k}"] = _plan_line(torch, f.band, rhs)
                if (b, bw, nb) == GEOMETRIES[0] and dtype_name == "float32" \
                        and k == 1:
                    p = plain.solve_padded_batched(f.band, f.invL, f.d,
                                                   rhs.clone(), every)
                    y = rhs[0].clone()
                    bk.banded_solve_reference_cuda(f.band[0], f.invL[0],
                                                   f.d[0], y)
                    worst["K2_witness"] = _abs(y, p[0])
                    worst["K4_witness"] = _abs(ref, p)
            untouched = None
            if (b, bw, nb) == GEOMETRIES[0]:
                active = every.copy()
                active[0] = False
                new, ref = rhs.clone(), rhs.clone()
                bk.banded_solve_batched_cuda(f.band, f.invL, f.d, new, active)
                bk.banded_solve_reference_cuda(f.band, f.invL, f.d, ref,
                                               active)
                untouched = (_same_bits(torch, new, ref)
                             and _same_bits(torch, new[0], rhs[0]))
            torch.cuda.synchronize()
            emit({"phase": "solve_witness", "b": b, "bw": bw, "nb": nb,
                  "N": st.N, "dtype": dtype_name, "lanes": B, "zero_lane": 1,
                  "equal_to_witness": equal,
                  "inactive_lane_equal_and_untouched": untouched,
                  "plans": plans})
            if not all(equal.values()):
                raise AssertionError(f"K2/K4 differ from their witness at "
                                     f"{(b, bw, nb, dtype_name)}: {equal}")
            if untouched is False:
                raise AssertionError(f"K4 with lane 0 inactive differs at "
                                     f"{(b, bw, nb, dtype_name)}")
    return worst


QUEUED = 10            # launches per round of _time_turns
SPIN_CYCLES = 20_000_000   # the spin kernel that queues them (about 10 ms)


def _time_turns(torch, fns, setup, rounds):
    """Milliseconds per launch of each of ``fns`` ({name: fn}) on the card,
    timed in turns by CUDA events: each round queues ``QUEUED`` launches,
    ``setup`` before each, behind a spin kernel, so that they run back to
    back and the host's launch overhead (the wrapper's checks and the
    launch, tens of microseconds) stays off the card's clock; the
    functions take turns, in order and then reversed, for ``rounds`` rounds.
    The median round, less the setup's own time measured the same way."""
    def queued(fn):
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(QUEUED):
            setup()
            if fn is not None:
                fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / QUEUED

    times = {name: [] for name in fns}
    base = []
    for r in range(rounds):
        base.append(queued(None))
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(queued(fns[name]))
    setup_ms = statistics.median(base)
    return {name: statistics.median(v) - setup_ms for name, v in times.items()}


def _witness_launches(torch, fn):
    """Launches of the witness on its own op path: counts set to 0 just
    before one call, read just after."""
    from madnlp_tpu_torch.ops import banded_kernels as bk

    bk.reset_counts()
    fn()
    torch.cuda.synchronize()
    return bk.banded_solve_reference_cuda.launches


# -- 3c. the diagonal step of K1 / K3 alone ------------------------------------


def _diag_fmas(b, p=32):
    """FMAs of one diagonal step at block size ``b``, counted from the loops
    of ``csrc/banded_diag.cuh`` (panel p): per panel, the corner recursion
    Σ_j (p−1−j)(2p−1−j), the panel product nr·p², the trailing update of the
    lower triangle nr(nr+1)/2·p, the L⁻¹ accumulation p²·hi and the R
    update nr·hi·p, with hi the panel's end and nr = b − hi."""
    corner = sum((p - 1 - j) * (2 * p - 1 - j) for j in range(p - 1))
    total = 0
    for lo in range(0, b, p):
        hi = lo + p
        nr = b - hi
        total += (corner + nr * p * p + nr * (nr + 1) // 2 * p + p * p * hi
                  + nr * hi * p)
    return total


def phase_diag_step(torch):
    """One launch of the diagonal-step kernel (the tiled routine K1, K3
    and K5 run) at the flagship's b = 256 on ``DIAG_LANES`` diagonal blocks of
    seeded bands (lane 1's holds an exactly zero pivot), for one lane and for
    all of them, float32 and float64: held bit for bit against the scalar
    routine that K5's witness keeps and against the plain version, then both routines
    timed by CUDA events beside the one-SM bound."""
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.ops import banded_kernels as bk

    b, bw, nb = GEOMETRIES[0]
    out = {}
    for dtype_name in ("float32", "float64"):
        _, bands = _lane_bands(torch, b, bw, nb, dtype_name, DIAG_LANES,
                               zero_lane=1)
        # block column nb // 2 holds lane 1's zero pivot
        blocks = bands[:, nb // 2, 0].contiguous()
        for lanes in (1, DIAG_LANES):
            A0 = blocks[:lanes].clone()
            work = {}
            for tiled in (True, False):
                A, R = A0.clone(), torch.empty_like(A0)
                d = A0.new_empty((lanes, b))
                bk.banded_diag_step_cuda(A, R, d, tiled=tiled)
                work[tiled] = (A, R, d)
            torch.cuda.synchronize()
            equal = all(torch.equal(x, y)
                        for x, y in zip(work[True], work[False]))
            LD, invL = plain.ldlt_with_inverse(A0[0].cpu())
            ref = (LD, invL, torch.diagonal(LD))
            rel = max(_rel(x[0].cpu(), r) for x, r in zip(work[True], ref))
            finite = all(bool(torch.isfinite(x).all()) for x in work[True])
            zeros = [int((work[True][2][i] == 0).sum()) for i in range(lanes)]
            ms = {}
            for tiled in (True, False):
                A, R, d = work[tiled]
                ms["tiled" if tiled else "scalar"] = _time_events(
                    torch,
                    lambda A=A, R=R, d=d, t=tiled: bk.banded_diag_step_cuda(
                        A, R, d, tiled=t),
                    lambda A=A: A.copy_(A0), DIAG_REPS)
            bound = _bounds(nb, b, bw, A0.element_size(), dtype_name,
                            lanes)["diag"]
            emit({"phase": "diag_step", "dtype": dtype_name, "b": b,
                  "lanes": lanes, "ms": ms, "bound": bound,
                  "bound_share": bound["bound_ms"] / ms["tiled"],
                  "tiled_equals_scalar": equal, "max_rel_err_vs_plain": rel,
                  "tol": KERNEL_RTOL[dtype_name], "zero_pivots": zeros})
            if not equal:
                raise AssertionError(f"the tiled diagonal step differs from "
                                     f"the scalar one ({dtype_name}, {lanes})")
            if not finite or rel > KERNEL_RTOL[dtype_name]:
                raise AssertionError(f"the diagonal step disagrees with plain "
                                     f"({dtype_name}, {lanes}): {rel}")
            if zeros[0] != 0 or (lanes > 1 and zeros[1] != 1):
                raise AssertionError(f"zero pivots {zeros}: lane 1's was not "
                                     f"kept")
            out[dtype_name, lanes] = {"ms": ms, "bound": bound}
    return out


# -- 4. the flagship solve -----------------------------------------------------


def _solve(torch, port, dtype, keep_band=None, model=None):
    """One banded solve of ``model`` (the flagship nb=600 ACOPF by default)
    on the card, model and symbolic set-up excluded from the wall, the
    kernels' counts set to 0 just before it.  Returns (stats, wall, (K1,
    K2) launches); ``keep_band`` collects the last band factorized."""
    from madnlp_tpu_torch.models.instances import opf
    from madnlp_tpu_torch.ops import banded_fused_kernels as bf
    from madnlp_tpu_torch.ops import banded_kernels as bk

    solver = port.MadNLPSolver(
        opf.build_sparse(nb=600, seed=0) if model is None else model,
        device="cuda",
        linear_solver=port.LinearSolver.BANDED, dtype=dtype,
        richardson=port.RichardsonOptions(mu_scaled=True),
        print_level=port.PrintLevel.ERROR)
    factorize = bk.factorize
    if keep_band is not None:
        def keeping(struct, band):
            keep_band["struct"], keep_band["band"] = struct, band.clone()
            return factorize(struct, band)
        bk.factorize = keeping
    torch.cuda.synchronize()
    bk.reset_counts()
    bf.reset_counts()
    t = time.perf_counter()
    try:
        stats = solver.solve()
        torch.cuda.synchronize()
    finally:
        bk.factorize = factorize
    wall = time.perf_counter() - t
    launches = (bk.banded_factorize_cuda.launches, bk.banded_solve_cuda.launches)
    _no_witness({**bk.counts(), **bf.witness_counts()})
    return stats, wall, launches


def _no_witness(counts):
    """No solve path reaches a witness (of K2 / K4, K5 or K6)."""
    if any(v for k, v in counts.items() if "reference" in k):
        raise AssertionError(f"a witness ran on a solve path: {counts}")


def _check_solve(stats, dtype, launches):
    status, iters, facts, backs, obj = REFERENCE[dtype]
    c = stats.counters
    if stats.status.name != status:
        raise AssertionError(f"{dtype}: status {stats.status.name}, JAX {status}")
    if stats.iter != iters:
        raise AssertionError(f"{dtype}: {stats.iter} iterations, JAX {iters}")
    if c["factorization_cnt"] != facts:
        raise AssertionError(f"{dtype}: {c['factorization_cnt']} "
                             f"factorizations, JAX {facts}")
    if dtype == "float64":
        lo, hi = FLAGSHIP_FLOAT64_BACKSOLVES
        if not lo <= c["backsolve_cnt"] <= hi:
            raise AssertionError(f"float64: {c['backsolve_cnt']} backsolves, "
                                 f"outside the one-ulp spread {lo}-{hi}")
    elif abs(c["backsolve_cnt"] - backs) > BACKSOLVE_RTOL * backs:
        raise AssertionError(f"{dtype}: {c['backsolve_cnt']} backsolves, "
                             f"JAX {backs}")
    if abs(stats.objective - obj) > OBJ_RTOL * abs(obj):
        raise AssertionError(f"{dtype}: objective {stats.objective!r}, JAX {obj!r}")
    if not np.isfinite(stats.solution).all():
        raise AssertionError(f"{dtype}: non-finite solution")
    # one factorization more than the counter: the least-squares dual
    # initialization factorizes once and is not counted (as in the JAX
    # package); its refinement solves are not counted either
    if launches[0] != c["factorization_cnt"] + 1:
        raise AssertionError(f"{dtype}: K1 launched {launches[0]} times, "
                             f"factorization_cnt {c['factorization_cnt']}")
    if launches[1] < c["backsolve_cnt"]:
        raise AssertionError(f"{dtype}: K2 launched {launches[1]} times, "
                             f"backsolve_cnt {c['backsolve_cnt']}")


def _time_events(torch, fn, setup, reps):
    """Median milliseconds of ``fn`` over ``reps`` launches, each bracketed
    by CUDA events; ``setup`` (not timed) runs before each."""
    times = []
    for _ in range(reps):
        setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bounds(nb, b, bw, itemsize, dtype, lanes=1, k=1):
    """Least times (ms) for K1 and K2 at this geometry, and for K3 and K4
    over ``lanes`` systems (each lane's K1 / K2 work, all lanes active),
    K2 and K4 on ``k`` right-hand-side columns:
    each input read once, each output written once; operations the
    algorithm needs on the real columns.  K1: LDLᵀ b³/3, unit-lower inverse
    b³/3, panel 2·bw·b³, trailing bw(bw+1)·b³ per column.  K2 reads only
    P_j = band[j, 1..bw], invL_j and d (never the diagonal block band[j, 0])
    and the right-hand side, and writes the solution; its two sweeps do
    4·(bw+1)·b² per column (invL_j and P_j mat-vecs each way) plus the D⁻¹
    divisions."""
    flops1 = nb * b**3 * (2.0 / 3.0 + 2.0 * bw + bw * (bw + 1))
    bytes1 = ((2 * (nb + bw) * (bw + 1) * b * b) + nb * b * b + nb * b) * itemsize
    flops2 = k * (4.0 * nb * (bw + 1) * b * b + nb * b)
    bytes2 = (nb * bw * b * b + nb * b * b + nb * b
              + 2 * (nb + bw) * b * k) * itemsize
    out = {}
    # the diagonal step alone: one CTA, so one SM, per lane (lanes side by
    # side on separate SMs); it reads the block and writes the factor, the
    # inverse and the pivots
    fmas = _diag_fmas(b)
    waves = -(-lanes // SMS)
    t_ops = waves * 2.0 * fmas / (PEAK_FLOPS[dtype] / SMS)
    t_bytes = lanes * (3 * b * b + b) * itemsize / PEAK_BYTES
    out["diag"] = {"fmas_per_lane": fmas, "flops": 2.0 * fmas * lanes,
                   "bytes": lanes * (3 * b * b + b) * itemsize,
                   "bound_ms": 1e3 * max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    for name, fl, by in (("K1", flops1, bytes1), ("K2", flops2, bytes2),
                         ("K3", lanes * flops1, lanes * bytes1),
                         ("K4", lanes * flops2, lanes * bytes2)):
        t_ops, t_bytes = fl / PEAK_FLOPS[dtype], by / PEAK_BYTES
        out[name] = {"flops": fl, "bytes": by,
                     "bound_ms": 1e3 * max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    return out


def phase_solve(torch, port):
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.ops import banded_kernels as bk

    results = {}
    # float64 first: the first solve on the card also pays one-time set-up
    # (allocator, library handles), which the timed float32 run should not
    stats, wall, l64 = _solve(torch, port, "float64")
    _check_solve(stats, "float64", l64)
    emit({"phase": "solve", "dtype": "float64", "status": stats.status.name,
          "iter": stats.iter, "objective": stats.objective,
          "reference": REFERENCE["float64"], "counters": stats.counters,
          "K1_launches": l64[0], "K2_launches": l64[1],
          "wall_s": wall, "iter_per_s": stats.iter / wall})

    # the main path: the configuration bench.py runs
    stats, wall, launches = _solve(torch, port, "float32")
    _check_solve(stats, "float32", launches)
    results["launches"] = launches
    emit({"phase": "solve", "dtype": "float32", "status": stats.status.name,
          "iter": stats.iter, "objective": stats.objective,
          "reference": REFERENCE["float32"],
          "reference_xla_loop": FLAGSHIP_XLA_FLOAT32, "counters": stats.counters,
          "K1_launches": launches[0], "K2_launches": launches[1],
          "wall_s": wall, "iter_per_s": stats.iter / wall})
    first = stats

    kept = {}
    again, wall2, _ = _solve(torch, port, "float32", keep_band=kept)
    same = (again.objective == first.objective
            and np.array_equal(again.solution, first.solution)
            and np.array_equal(again.multipliers, first.multipliers)
            and again.counters == first.counters)
    emit({"phase": "solve", "dtype": "float32", "repeat": True,
          "bit_identical": same, "wall_s": wall2})
    if not same:
        raise AssertionError("the repeated float32 solve differs")

    # the end-to-end metric: median iter/s over warmed float32 solves, each
    # of which must reproduce the first bit for bit
    walls = []
    for _ in range(TIMED_SOLVES):
        again, w, _ = _solve(torch, port, "float32")
        if not (again.objective == first.objective
                and np.array_equal(again.solution, first.solution)
                and again.counters == first.counters):
            raise AssertionError("a timed float32 solve differs from the first")
        walls.append(w)
    med = statistics.median(walls)
    results["iter_per_s_median"] = first.iter / med
    emit({"phase": "solve", "dtype": "float32", "timed_solves": TIMED_SOLVES,
          "wall_s": walls, "median_wall_s": med,
          "iter_per_s_median": first.iter / med,
          "iter_per_s_min": first.iter / max(walls),
          "iter_per_s_max": first.iter / min(walls)})

    # K1 / K2 on the main path's last band: agreement in float64 (the
    # float32 factor of an ill-conditioned KKT differs from the plain one
    # by amplified rounding, so it is reported, not held), then timings
    st, band32 = kept["struct"], kept["band"]
    real64 = compare_kernels(torch, st, band32.double())
    real32 = compare_kernels(torch, st, band32)
    emit({"phase": "main_band", "b": st.b, "bw": st.bw, "nb": st.nb,
          "N": st.N, "float64_max_rel_err": real64["rel"],
          "float64_tol": REAL_BAND_RTOL,
          "float32_max_rel_err (reported)": real32["rel"],
          "inertia_float32": real32["inertia"]})
    if max(real64["rel"].values()) > REAL_BAND_RTOL:
        raise AssertionError("kernel disagrees with plain on the main band")
    if real64["inertia"][0] != real64["inertia"][1]:
        raise AssertionError("inertia differs on the main band")

    work = torch.empty_like(band32)
    f = bk.factorize(st, band32.clone())
    rhs = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (st.nbp * st.b, 1)), dtype=band32.dtype, device=band32.device)
    rwork = torch.empty_like(rhs)
    invL = torch.empty_like(f.invL)
    d = torch.ones((st.nbp * st.b,), dtype=band32.dtype, device=band32.device)
    pinv = torch.empty_like(f.invL)
    pd = torch.ones_like(d)
    times = {
        "K1": _time_events(
            torch, lambda: bk.banded_factorize_cuda(work, invL, d, st.nb, st.b, st.bw),
            lambda: work.copy_(band32), 30),
        "K1_plain": _time_events(
            torch, lambda: plain.factorize_columns(work, pinv, pd, st.nb, st.b, st.bw),
            lambda: work.copy_(band32), 5),
        **_time_turns(torch, {
            "K2": lambda: bk.banded_solve_cuda(f.band, f.invL, f.d, rwork),
            "K2_witness": lambda: bk.banded_solve_reference_cuda(
                f.band, f.invL, f.d, rwork)},
            lambda: rwork.copy_(rhs), 10),
        "K2_plain": _time_events(
            torch, lambda: plain.solve_padded(f.band, f.invL, f.d, rwork),
            lambda: rwork.copy_(rhs), 20),
    }
    witness = _witness_launches(torch, lambda: bk.banded_solve_reference_cuda(
        f.band, f.invL, f.d, rwork))
    bounds = _bounds(st.nb, st.b, st.bw, band32.element_size(), "float32")
    emit({"phase": "timing", "dtype": "float32", "b": st.b, "bw": st.bw,
          "nb": st.nb, "ms": times, "bounds": bounds,
          "K2_share_of_bound": bounds["K2"]["bound_ms"] / times["K2"],
          "K2_witness_over_K2": times["K2_witness"] / times["K2"],
          "K2_plan": _plan_line(torch, f.band, rwork),
          "witness_op_launches": witness})
    results.update(times=times, bounds=bounds, witness_launches=witness)
    emit(dict(phase="profile", dtype="float32", **_profile(torch, port)))
    return results


def _profile(torch, port, run=None, host=True):
    """One more float32 solve (or ``run()``, which returns its iteration
    count and wall) under torch.profiler: the device time by kernel name
    and the share of the wall during which the card was busy.  ``host``:
    record the host's operators too (off for a long solve, whose millions
    of host events take minutes to read back)."""
    from torch.profiler import ProfilerActivity, profile

    if run is None:
        def run():
            stats, wall, _ = _solve(torch, port, "float32")
            return stats.iter, wall
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        iters, wall = run()
    return dict(iter=iters, **_device_time(torch, prof, wall))


def _device_time(torch, prof, wall):
    """A finished profiler's device time by kernel name over ``wall``
    seconds, and the share of them during which the card was busy."""
    by_name, launches = {}, 0
    for ev in prof.events():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "device_time", None)
        if us is None:
            us = getattr(ev, "cuda_time", 0.0)
        launches += 1
        name = ev.name if len(ev.name) < 60 else ev.name[:57] + "..."
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": 1e3 * wall,
            "device_busy_ms": busy, "device_busy_share": busy / (1e3 * wall),
            "device_launches": launches, "top_ms": dict(top)}


# -- 5. the multi-scenario batch ----------------------------------------------


def _solve_batch(torch, port, keep=None, **kwargs):
    """One ``solve_batch`` of the 16 scenarios on the card (model and
    symbolic set-up excluded from the wall).  ``keep`` collects the last
    band each lane factored.  Returns (summary, wall, kernel launches)."""
    from madnlp_tpu_torch.models.instances import opf
    from madnlp_tpu_torch.ops import banded_fused_kernels as bf
    from madnlp_tpu_torch.ops import banded_kernels as bk

    solver = port.MadNLPSolver(
        opf.build_sparse(nb=600, seed=0, parametric=True), device="cuda",
        linear_solver=port.LinearSolver.BANDED, dtype="float32",
        richardson=port.RichardsonOptions(mu_scaled=True),
        print_level=port.PrintLevel.ERROR)
    factorize_batched = bk.factorize_batched
    if keep is not None:
        def keeping(struct, band, invL, d, active):
            on = torch.as_tensor(active, device=band.device)
            on = on.reshape((-1,) + (1,) * (band.ndim - 1))
            keep["struct"] = struct
            keep["bands"] = (band.clone() if "bands" not in keep
                             else torch.where(on, band, keep["bands"]))
            return factorize_batched(struct, band, invL, d, active)
        bk.factorize_batched = keeping
    torch.cuda.synchronize()
    bk.reset_counts()
    bf.reset_counts()
    t = time.perf_counter()
    try:
        st = solver.solve_batch(BATCH_SCALES, **kwargs)
        torch.cuda.synchronize()
    finally:
        bk.factorize_batched = factorize_batched
    wall = time.perf_counter() - t
    _no_witness({**bk.counts(), **bf.witness_counts()})
    return port.batch_summary(solver.prob, st), wall, bk.counts()


def _same_batch(a, b):
    return (np.array_equal(a["x"], b["x"])
            and np.array_equal(a["objective"], b["objective"])
            and all(np.array_equal(a["counters"][k], b["counters"][k])
                    for k in a["counters"]))


def _single_lanes(torch, port):
    """The port's single float32 solve of each scenario on the card (K1 and
    K2): the exact reference for the batch's per-lane counters."""
    from madnlp_tpu_torch.models.instances import opf
    from madnlp_tpu_torch.ops import banded_fused_kernels as bf
    from madnlp_tpu_torch.ops import banded_kernels as bk

    model = opf.build_sparse(nb=600, seed=0, parametric=True)
    out = []
    bk.reset_counts()
    bf.reset_counts()
    for scale in BATCH_SCALES:
        s = port.madnlp(model, params=scale, device="cuda",
                        linear_solver=port.LinearSolver.BANDED,
                        dtype="float32",
                        richardson=port.RichardsonOptions(mu_scaled=True),
                        print_level=port.PrintLevel.ERROR)
        out.append((int(s.status), s.iter, s.counters["factorization_cnt"],
                    s.counters["backsolve_cnt"], s.objective))
    torch.cuda.synchronize()
    _no_witness({**bk.counts(), **bf.witness_counts()})
    return [np.array(v) for v in zip(*out)]


def _check_batch(port, summ, counts, single):
    ref = BATCH_REFERENCE
    c = summ["counters"]
    status, iters, facts, backs, objs = single
    ok = int(port.Status.SOLVE_SUCCEEDED)
    if not (summ["status"] == ok).all() or not (status == ok).all():
        raise AssertionError(f"batch: statuses {summ['status'].tolist()}, "
                             f"single {status.tolist()}")
    if summ["iter"].tolist() != ref["iter"] or summ["iter"].tolist() != \
            iters.tolist():
        raise AssertionError(f"batch: iterations {summ['iter'].tolist()}, "
                             f"single {iters.tolist()}, JAX {ref['iter']}")
    if c["factorization_cnt"].tolist() != facts.tolist():
        raise AssertionError("batch: factorizations "
                             f"{c['factorization_cnt'].tolist()}, single "
                             f"{facts.tolist()}")
    rel = np.abs(summ["objective"] - ref["objective"]) / np.abs(ref["objective"])
    rel_single = np.abs(summ["objective"] - objs) / np.abs(objs)
    if max(rel.max(), rel_single.max()) > OBJ_RTOL:
        raise AssertionError(f"batch: objective off by {rel.max()!r} (JAX), "
                             f"{rel_single.max()!r} (single)")
    bad_lane = (np.abs(c["backsolve_cnt"] - backs)
                > BACKSOLVE_LANE_RTOL * backs).any()
    bad_total = (abs(int(c["backsolve_cnt"].sum()) - int(backs.sum()))
                 > BACKSOLVE_RTOL * backs.sum())
    if bad_lane or bad_total:
        raise AssertionError(f"batch: backsolves {c['backsolve_cnt'].tolist()}"
                             f", single {backs.tolist()}")
    if not np.isfinite(summ["x"]).all():
        raise AssertionError("batch: non-finite solution")
    if (counts["banded_factorize_batched_cuda"] == 0
            or counts["banded_solve_batched_cuda"] == 0):
        raise AssertionError(f"batch: K3/K4 not launched: {counts}")
    if counts["banded_factorize_cuda"] or counts["banded_solve_cuda"]:
        raise AssertionError(f"batch: the single kernels ran: {counts}")
    return float(rel.max()), float(rel_single.max())


def phase_batch(torch, port, single_iter_per_s):
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.ops import banded_kernels as bk

    single = _single_lanes(torch, port)
    # the batched main path, counts from 0 just before it
    summ, wall, counts = _solve_batch(torch, port)
    rel, rel_single = _check_batch(port, summ, counts, single)
    c = summ["counters"]
    emit({"phase": "batch", "lanes": len(BATCH_SCALES), "dtype": "float32",
          "status": summ["status"].tolist(), "iter": summ["iter"].tolist(),
          "factorization_cnt": c["factorization_cnt"].tolist(),
          "factorization_cnt_single": single[2].tolist(),
          "factorization_cnt_jax": BATCH_REFERENCE["iter"],
          "backsolve_cnt": c["backsolve_cnt"].tolist(),
          "backsolve_cnt_single": single[3].tolist(),
          "backsolve_cnt_jax": BATCH_REFERENCE["backsolve_cnt"],
          "objective": summ["objective"].tolist(),
          "objective_max_rel_err_jax": rel,
          "objective_max_rel_err_single": rel_single,
          "launches": counts, "wall_s": wall})
    first = summ

    kept = {}
    again, wall2, _ = _solve_batch(torch, port, keep=kept)
    same = _same_batch(again, first)
    emit({"phase": "batch", "repeat": True, "bit_identical": same,
          "wall_s": wall2})
    if not same:
        raise AssertionError("the repeated batch differs")

    chunked, wall3, _ = _solve_batch(torch, port, chunk_size=8, probe_iters=3)
    crel = (np.abs(chunked["objective"] - first["objective"])
            / np.abs(first["objective"]))
    match = bool(np.array_equal(chunked["status"], first["status"])
                 and np.array_equal(chunked["iter"], first["iter"])
                 and np.array_equal(chunked["counters"]["factorization_cnt"],
                                    c["factorization_cnt"])
                 and crel.max() <= OBJ_RTOL)
    emit({"phase": "batch", "chunk_size": 8, "probe_iters": 3,
          "matches_bulk": match, "iter": chunked["iter"].tolist(),
          "objective_max_rel_err_vs_bulk": float(crel.max()),
          "wall_s": wall3})
    if not match:
        raise AssertionError("the chunked batch differs from the bulk run")

    walls = []
    for _ in range(TIMED_BATCHES):
        again, w, _ = _solve_batch(torch, port)
        if not _same_batch(again, first):
            raise AssertionError("a timed batch differs from the first")
        walls.append(w)
    med = statistics.median(walls)
    lane_iters = int(first["iter"].sum())
    emit({"phase": "batch", "timed_batches": TIMED_BATCHES, "wall_s": walls,
          "median_wall_s": med, "lane_iterations": lane_iters,
          "lane_iter_per_s": lane_iters / med,
          "instances_per_s": len(BATCH_SCALES) / med,
          "single_iter_per_s_median": single_iter_per_s,
          "lane_iter_per_s_over_single": lane_iters / med / single_iter_per_s})

    # K3 / K4 on the last band of every lane: agreement in float64, then
    # timed in float32 against 16 sequential K1 / K2 launches
    st, bands = kept["struct"], kept["bands"]
    B, b, nb, bw = bands.shape[0], st.b, st.nb, st.bw
    real64 = compare_batched(torch, st, bands.double())
    emit({"phase": "batch_bands", "lanes": B, "b": b, "bw": bw, "nb": nb,
          "N": st.N, "float64_max_rel_err": real64["rel"],
          "float64_max_rel_err_vs_K1_K2": real64["rel_vs_single"],
          "float64_tol": REAL_BAND_RTOL,
          "inertia_equal": real64["inertia_equal"]})
    if max(max(real64["rel"].values()),
           max(real64["rel_vs_single"].values())) > REAL_BAND_RTOL:
        raise AssertionError("K3/K4 disagree on the batch's bands")
    if not real64["inertia_equal"]:
        raise AssertionError("batched inertia differs on the batch's bands")

    every = np.ones(B, dtype=bool)
    work = torch.empty_like(bands)
    invL = bands.new_zeros((B, st.nbp, b, b))
    d = bands.new_ones((B, nb * b))
    f = bk.factorize_batched(st, bands.clone(), bands.new_zeros(invL.shape),
                             bands.new_ones(d.shape), every)
    rhs = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (B, st.nbp * b, 1)), dtype=bands.dtype, device=bands.device)
    rwork = torch.empty_like(rhs)

    # the lane mask on the card, as the solver's own calls upload it
    mask = torch.ones(B, dtype=torch.int32, device=bands.device)

    def k1_each():
        for i in range(B):
            bk.banded_factorize_cuda(work[i], invL[i], d[i], nb, b, bw)

    def k2_each():
        for i in range(B):
            bk.banded_solve_cuda(f.band[i], f.invL[i], f.d[i], rwork[i])

    times = {
        "K3": _time_events(
            torch, lambda: bk.banded_factorize_batched_cuda(
                work, invL, d, every, nb, b, bw),
            lambda: work.copy_(bands), 10),
        "K1_x16": _time_events(torch, k1_each, lambda: work.copy_(bands), 5),
        "K3_plain": _time_events(
            torch, lambda: plain.factorize_columns_batched(
                work, invL, d, every, nb, b, bw),
            lambda: work.copy_(bands), 1),
        **_time_turns(torch, {
            "K4": lambda: bk.banded_solve_batched_cuda(
                f.band, f.invL, f.d, rwork, mask),
            "K4_witness": lambda: bk.banded_solve_reference_cuda(
                f.band, f.invL, f.d, rwork, mask)},
            lambda: rwork.copy_(rhs), 8),
        "K2_x16": _time_events(torch, k2_each, lambda: rwork.copy_(rhs), 20),
        "K4_plain": _time_events(
            torch, lambda: plain.solve_padded_batched(
                f.band, f.invL, f.d, rwork, every),
            lambda: rwork.copy_(rhs), 3),
    }
    witness = _witness_launches(torch, lambda: bk.banded_solve_reference_cuda(
        f.band, f.invL, f.d, rwork, every))
    bounds = _bounds(nb, b, bw, bands.element_size(), "float32", lanes=B)
    emit({"phase": "batch_timing", "dtype": "float32", "lanes": B, "b": b,
          "bw": bw, "nb": nb, "ms": times,
          "K3_over_K1": times["K3"] / (times["K1_x16"] / B),
          "K4_over_K2": times["K4"] / (times["K2_x16"] / B),
          "K4_share_of_bound": bounds["K4"]["bound_ms"] / times["K4"],
          "K4_witness_over_K4": times["K4_witness"] / times["K4"],
          "K4_plan": _plan_line(torch, f.band, rwork),
          "witness_op_launches": witness,
          "bounds": {k: bounds[k] for k in ("K3", "K4")}})

    def profiled():
        s, w, _ = _solve_batch(torch, port)
        return int(s["iter"].max()), w
    emit(dict(phase="batch_profile", dtype="float32", lanes=B,
              **_profile(torch, port, profiled)))
    return {"launches": (counts["banded_factorize_batched_cuda"],
                         counts["banded_solve_batched_cuda"]),
            "times": times, "bounds": bounds, "witness_launches": witness}


# -- 5b. the MATPOWER front end: the case118×4 ring and case118 ----------------


def _matpower_model(name):
    from madnlp_tpu_torch.models import matpower

    case = matpower.parse_case(os.path.join(HERE, "tests", "data", "case118.m"))
    if name == "case118x4_ring":
        case = matpower.tile_case(case, 4, ties="ring")
    return matpower.build_acopf(case, sparse=True)


def _check_matpower(name, dtype, stats, launches, fused):
    status, iters, facts, backs, obj = MATPOWER_REFERENCE[name, dtype]
    c = stats.counters
    got = (stats.status.name, stats.iter, c["factorization_cnt"])
    if got != (status, iters, facts):
        raise AssertionError(f"{name} {dtype}: {got}, JAX {(status, iters, facts)}")
    tol = BACKSOLVE_RTOL if dtype == "float32" else 0.0
    if abs(c["backsolve_cnt"] - backs) > tol * backs:
        raise AssertionError(f"{name} {dtype}: {c['backsolve_cnt']} backsolves, "
                             f"JAX {backs}")
    if abs(stats.objective - obj) > OBJ_RTOL * abs(obj):
        raise AssertionError(f"{name} {dtype}: objective {stats.objective!r}, "
                             f"JAX {obj!r}")
    pub = PUBLISHED_OPTIMUM[name]
    if abs(stats.objective - pub) > PUBLISHED_RTOL * pub:
        raise AssertionError(f"{name} {dtype}: objective {stats.objective!r}, "
                             f"published {pub!r}")
    if not np.isfinite(stats.solution).all():
        raise AssertionError(f"{name} {dtype}: non-finite solution")
    # +1: the least-squares dual initialization factorizes once, uncounted
    if launches[0] != facts + 1 or launches[1] < c["backsolve_cnt"]:
        raise AssertionError(f"{name} {dtype}: K1/K2 launched {launches}")
    if any(fused.values()):
        raise AssertionError(f"{name} {dtype}: K5/K6 ran on a solve: {fused}")


def phase_matpower_solve(torch, port):
    from madnlp_tpu_torch.ops import banded_fused_kernels as bf

    name = "case118x4_ring"
    model = _matpower_model(name)
    out = {}
    for dtype in ("float64", "float32"):
        # the kernels' counts are set to 0 inside _solve, just before
        stats, wall, launches = _solve(torch, port, dtype, model=model)
        fused = {**bf.counts(), **bf.witness_counts()}
        _check_matpower(name, dtype, stats, launches, fused)
        emit({"phase": "matpower_solve", "case": name, "n": model.n,
              "m": model.m, "dtype": dtype, "status": stats.status.name,
              "iter": stats.iter, "objective": stats.objective,
              "reference": MATPOWER_REFERENCE[name, dtype],
              "reference_xla": (MATPOWER_XLA_FLOAT32[name]
                                if dtype == "float32" else None),
              "published": PUBLISHED_OPTIMUM[name], "counters": stats.counters,
              "K1_launches": launches[0], "K2_launches": launches[1],
              "K5_K6_launches": fused, "wall_s": wall,
              "iter_per_s": stats.iter / wall})
        out[dtype] = (stats, launches)
        kept = {}
        again, wall2, _ = _solve(torch, port, dtype, model=model,
                                 keep_band=kept)
        same = (again.objective == stats.objective
                and np.array_equal(again.solution, stats.solution)
                and np.array_equal(again.multipliers, stats.multipliers)
                and again.counters == stats.counters)
        emit({"phase": "matpower_solve", "case": name, "dtype": dtype,
              "repeat": True, "bit_identical": same, "wall_s": wall2})
        if not same:
            raise AssertionError(f"the repeated {name} {dtype} solve differs")
    first = out["float32"][0]
    ring_times = _time_ring_band(torch, kept)

    walls = []
    for _ in range(TIMED_SOLVES):
        again, w, _ = _solve(torch, port, "float32", model=model)
        if not (again.objective == first.objective
                and np.array_equal(again.solution, first.solution)
                and again.counters == first.counters):
            raise AssertionError(f"a timed {name} float32 solve differs")
        walls.append(w)
    med = statistics.median(walls)
    emit({"phase": "matpower_solve", "case": name, "dtype": "float32",
          "timed_solves": TIMED_SOLVES, "wall_s": walls, "median_wall_s": med,
          "iter_per_s_median": first.iter / med,
          "iter_per_s_min": first.iter / max(walls),
          "iter_per_s_max": first.iter / min(walls)})

    def run():
        stats, wall, _ = _solve(torch, port, "float32", model=model)
        return stats.iter, wall
    emit(dict(phase="matpower_profile", case=name, dtype="float32",
              **_profile(torch, port, run)))
    return {"launches": out["float32"][1], "iter_per_s_median": first.iter / med,
            "times": ring_times}


def _time_ring_band(torch, kept):
    """K2 and its witness, in turns, on the last band the ring's float32
    solve factorized (one right-hand side), beside K2's bound."""
    from madnlp_tpu_torch.ops import banded_kernels as bk

    st, band32 = kept["struct"], kept["band"]
    f = bk.factorize(st, band32.clone())
    rhs = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (st.nbp * st.b, 1)), dtype=band32.dtype, device=band32.device)
    rw = torch.empty_like(rhs)
    times = _time_turns(torch, {
        "K2": lambda: bk.banded_solve_cuda(f.band, f.invL, f.d, rw),
        "K2_witness": lambda: bk.banded_solve_reference_cuda(
            f.band, f.invL, f.d, rw)},
        lambda: rw.copy_(rhs), 10)
    bound = _bounds(st.nb, st.b, st.bw, band32.element_size(),
                    "float32")["K2"]
    emit({"phase": "matpower_timing", "case": "case118x4_ring",
          "dtype": "float32", "b": st.b, "bw": st.bw, "nb": st.nb,
          "ms": times, "bound": bound,
          "K2_share_of_bound": bound["bound_ms"] / times["K2"],
          "K2_witness_over_K2": times["K2_witness"] / times["K2"],
          "K2_plan": _plan_line(torch, f.band, rw)})
    return times


def phase_case118_band(torch, port):
    from madnlp_tpu_torch.ops import banded_fused_kernels as bf
    from madnlp_tpu_torch.ops import banded_kernels as bk

    name = "case118"
    kept = {}
    stats, wall, launches = _solve(torch, port, "float32", keep_band=kept,
                                   model=_matpower_model(name))
    _check_matpower(name, "float32", stats, launches,
                    {**bf.counts(), **bf.witness_counts()})
    emit({"phase": "case118_band", "dtype": "float32",
          "status": stats.status.name, "iter": stats.iter,
          "objective": stats.objective,
          "reference": MATPOWER_REFERENCE[name, "float32"],
          "reference_xla": MATPOWER_XLA_FLOAT32[name],
          "counters": stats.counters, "wall_s": wall})
    st, band32 = kept["struct"], kept["band"]
    b, bw, nb = st.b, st.bw, st.nb

    # K5 / K6 on their op path: counts from 0 just before, read just after
    rhs = torch.as_tensor(np.random.default_rng(11).standard_normal(st.N),
                          dtype=band32.dtype, device=band32.device)
    bf.reset_counts()
    f = bf.banded_fused_factorize(st, band32.clone())
    bf.banded_fused_solve(st, f, rhs)
    torch.cuda.synchronize()
    op_launches = (bf.banded_fused_factorize_cuda.launches,
                   bf.banded_fused_solve_cuda.launches)
    if op_launches != (1, 1):
        raise AssertionError(f"K5/K6 op path launched {op_launches}")

    real64 = compare_fused(torch, st, band32.double(), widths=(1, 8))
    real32 = compare_fused(torch, st, band32, widths=(1, 8))
    emit({"phase": "case118_band", "b": b, "bw": bw, "nb": nb, "N": st.N,
          "plans": _fused_plans(torch, st, band32, widths=(1, 8)),
          "equal_to_witness_float64": real64["equal_to_witness"],
          "equal_to_witness_float32": real32["equal_to_witness"],
          "float64_max_rel_err": real64["rel"],
          "float64_max_rel_err_vs_K1_K2": real64["rel_vs_K1_K2"],
          "float64_tol": REAL_BAND_RTOL,
          "float32_max_rel_err (reported)": real32["rel"],
          "float32_max_rel_err_vs_K1_K2 (reported)": real32["rel_vs_K1_K2"],
          "inertia_float64 (K5, plain, K1)": real64["inertia"],
          "inertia_float32 (K5, plain, K1)": real32["inertia"]})
    _check_fused(real64, REAL_BAND_RTOL, "the case118 band")
    if not all(real32["equal_to_witness"].values()):
        raise AssertionError(f"K5/K6 differ from their witnesses on the "
                             f"case118 band in float32: "
                             f"{real32['equal_to_witness']}")

    work = torch.empty_like(band32)
    invL = torch.zeros((st.nbp, b, b), dtype=band32.dtype, device=band32.device)
    d = torch.ones((st.nbp * b,), dtype=band32.dtype, device=band32.device)
    xw, dpad = bf._padded(st, f, rhs)
    xrhs = xw.clone()
    r1 = xrhs[:, :1].contiguous()
    rw = torch.empty_like(r1)

    def solve_setup():
        xw.copy_(xrhs)
        rw.copy_(r1)

    times = {
        "K5_plain": _time_events(
            torch, lambda: bf.banded_fused_factorize_plain(st, band32),
            lambda: None, 5),
        "K6_plain": _time_events(
            torch, lambda: bf.banded_fused_solve_plain(st, f, rhs),
            lambda: None, 20),
        # K5, its witness and K1 in turns, each on a fresh copy of the band
        **_time_turns(torch, {
            "K5": lambda: bf.banded_fused_factorize_cuda(work, invL, d, nb, b, bw),
            "K5_witness": lambda: bf.banded_fused_factorize_reference_cuda(
                work, invL, d, nb, b, bw),
            "K1": lambda: bk.banded_factorize_cuda(work, invL, d, nb, b, bw)},
            lambda: work.copy_(band32), 6),
        # K6 (one right-hand side: its column of the 8 padded ones, as
        # banded_fused_solve runs it), its witness (all 8), K2 (one column)
        # and K2's witness in turns
        **_time_turns(torch, {
            "K6": lambda: bf.banded_fused_solve_cuda(f.band, f.invL, dpad, xw,
                                                     1),
            "K6_witness": lambda: bf.banded_fused_solve_reference_cuda(
                f.band, f.invL, dpad, xw),
            "K2": lambda: bk.banded_solve_cuda(f.band, f.invL, f.d, rw),
            "K2_witness": lambda: bk.banded_solve_reference_cuda(
                f.band, f.invL, f.d, rw)},
            solve_setup, 10),
    }
    # the witnesses' launches on their op path: one per call
    bf.reset_counts()
    bf.banded_fused_factorize_reference_cuda(work, invL, d, nb, b, bw)
    bf.banded_fused_solve_reference_cuda(f.band, f.invL, dpad, xw)
    torch.cuda.synchronize()
    witness_launches = (bf.banded_fused_factorize_reference_cuda.launches,
                        bf.banded_fused_solve_reference_cuda.launches)
    # K5 computes K1's function and K6 K2's (one right-hand side)
    bounds = _bounds(nb, b, bw, band32.element_size(), "float32")
    bounds = {"K5": bounds["K1"], "K6": bounds["K2"], "K2": bounds["K2"]}
    plans = _fused_plans(torch, st, band32, widths=(1,))
    emit({"phase": "case118_timing", "dtype": "float32", "b": b, "bw": bw,
          "nb": nb, "ms": times, "bounds": bounds,
          "K5_plan": plans["K5"], "K6_plan": plans["K6_k1"],
          "K5_over_K1": times["K5"] / times["K1"],
          "K5_witness_over_K5": times["K5_witness"] / times["K5"],
          "K6_over_K2": times["K6"] / times["K2"],
          "K6_witness_over_K6": times["K6_witness"] / times["K6"],
          "K2_witness_over_K2": times["K2_witness"] / times["K2"],
          "K2_plan": _plan_line(torch, f.band, rw)})
    return {"launches": op_launches, "witness_launches": witness_launches,
            "times": times, "bounds": bounds}


# -- 6. the dense LDLᵀ kernel K7 on seeded matrices ----------------------------


def _saddle(torch, N, seed, zero_row=None):
    """A seeded indefinite saddle matrix [[H, Jᵀ], [J, -1e-3·I]] (H SPD,
    m = N/4 rows) in float64 on the card; ``zero_row`` zeroes one row and
    column, which makes that pivot exactly zero."""
    rng = np.random.default_rng(seed)
    m = N // 4
    R = torch.as_tensor(rng.standard_normal((N - m, N - m)), device="cuda")
    J = torch.as_tensor(rng.standard_normal((m, N - m)), device="cuda")
    H = R @ R.T + N * torch.eye(N - m, dtype=torch.float64, device="cuda")
    K = torch.cat([torch.cat([H, J.T], 1),
                   torch.cat([J, -1e-3 * torch.eye(m, dtype=torch.float64,
                                                   device="cuda")], 1)])
    if zero_row is not None:
        K[zero_row, :] = 0.0
        K[:, zero_row] = 0.0
    return K


def _factor_errors(torch, f, ref):
    """Relative and absolute differences of two LDL factors on the real
    rows (strict lower L and D)."""
    n = ref.n
    pairs = {"L": (torch.tril(f.L[:n, :n], -1), torch.tril(ref.L[:n, :n], -1)),
             "d": (f.d[:n], ref.d[:n])}
    return ({k: _rel(*v) for k, v in pairs.items()},
            {k: _abs(*v) for k, v in pairs.items()})


def phase_dense_kernels(torch):
    from madnlp_tpu_torch.ops import dense_kernels as dk
    from madnlp_tpu_torch.ops.ldlt import ldlt_inertia

    worst = 0.0
    for N in DENSE_SIZES:
        for dtype_name in ("float32", "float64"):
            tol = KERNEL_RTOL[dtype_name]
            for zero_row in (None, N // 3):
                K = _saddle(torch, N, N + 1, zero_row).to(getattr(torch, dtype_name))
                kf = dk.dense_ldlt(K, DENSE_BLOCK)
                pf = dk.dense_ldlt_plain(K, DENSE_BLOCK)
                torch.cuda.synchronize()
                rel, ab = _factor_errors(torch, kf, pf)
                inertia = (ldlt_inertia(kf), ldlt_inertia(pf))
                m = N // 4
                expect = ((N - m, 0, m) if zero_row is None
                          else (N - m - 1, 1, m))
                emit({"phase": "dense_kernels", "N": N, "block": DENSE_BLOCK,
                      "dtype": dtype_name, "zero_row": zero_row,
                      "max_rel_err": rel, "tol": tol,
                      "inertia_kernel": inertia[0], "inertia_plain": inertia[1]})
                if not (torch.isfinite(kf.L).all() and torch.isfinite(kf.d).all()):
                    raise AssertionError("non-finite K7 output")
                if max(rel.values()) > tol:
                    raise AssertionError(f"K7 disagrees with plain at "
                                         f"{(N, dtype_name, zero_row)}")
                if inertia[0] != inertia[1] or inertia[0] != expect:
                    raise AssertionError(f"K7 inertia {inertia}, expected {expect}")
                if N == DENSE_SIZES[-1] and dtype_name == "float32":
                    worst = max(worst, max(ab.values()))
    return worst


def phase_dense_witness(torch):
    """K7 against its witness, bit for bit, at ``DENSE_SIZES`` × both
    dtypes × (no zero pivot, one) × ``WITNESS_BLOCKS``; at ``ODD_BLOCKS``
    against the plain version.  Returns the witness's worst absolute error
    against the plain version at the dense system's size in float32."""
    from madnlp_tpu_torch.ops import dense_kernels as dk
    from madnlp_tpu_torch.ops.ldlt import ldlt_inertia

    worst = 0.0
    for N in DENSE_SIZES:
        for dtype_name in ("float32", "float64"):
            equal, rel = {}, {}
            for zero_row in (None, N // 3):
                K = _saddle(torch, N, 7 * N + 3, zero_row).to(
                    getattr(torch, dtype_name))
                for block in WITNESS_BLOCKS:
                    kf = dk.dense_ldlt(K, block)
                    rf = dk.dense_ldlt_reference(K, block)
                    equal[f"b{block}_zero{zero_row is not None:d}"] = (
                        _same_bits(torch, kf.L, rf.L)
                        and _same_bits(torch, kf.d, rf.d))
                    if (N, dtype_name, block, zero_row) == (
                            DENSE_SIZES[-1], "float32", DENSE_BLOCK, None):
                        pf = dk.dense_ldlt_plain(K, block)
                        worst = max(_factor_errors(torch, rf, pf)[1].values())
                for block in ODD_BLOCKS:
                    kf = dk.dense_ldlt(K, block)
                    pf = dk.dense_ldlt_plain(K, block)
                    rel[f"b{block}_zero{zero_row is not None:d}"] = max(
                        _factor_errors(torch, kf, pf)[0].values())
                    if ldlt_inertia(kf) != ldlt_inertia(pf):
                        raise AssertionError(
                            f"K7 inertia differs from plain at "
                            f"{(N, dtype_name, block, zero_row)}")
            torch.cuda.synchronize()
            tol = KERNEL_RTOL[dtype_name]
            emit({"phase": "dense_witness", "N": N, "dtype": dtype_name,
                  "equal_to_witness": equal, "odd_block_max_rel_err": rel,
                  "tol": tol})
            if not all(equal.values()):
                raise AssertionError(f"K7 differs from its witness at "
                                     f"{(N, dtype_name)}: {equal}")
            if max(rel.values()) > tol:
                raise AssertionError(f"K7 disagrees with plain at odd blocks "
                                     f"{(N, dtype_name)}: {rel}")
    return worst


# -- 7. the dense-callback solve -----------------------------------------------


def _dense_solve(torch, port, dtype, keep=None):
    """``madnlp``'s path with default options on the dense nb=600 ACOPF
    (model and set-up excluded from the wall), every kernel's count set to
    0 just before it.  ``keep`` collects the last matrix the solve
    factorized.  Returns (stats, wall, kernel counts, resolved options)."""
    from madnlp_tpu_torch.models.instances import opf
    from madnlp_tpu_torch.ops import banded_fused_kernels as bf
    from madnlp_tpu_torch.ops import banded_kernels as bk
    from madnlp_tpu_torch.ops import dense_kernels as dk
    from madnlp_tpu_torch.ops import dense_solvers as ds

    solver = port.MadNLPSolver(opf.build(nb=600, seed=0), device="cuda",
                               dtype=dtype, print_level=port.PrintLevel.ERROR)
    factorize = ds.factorize
    if keep is not None:
        def keeping(K, *args, **kwargs):
            keep["K"] = K.clone()
            return factorize(K, *args, **kwargs)
        ds.factorize = keeping
    torch.cuda.synchronize()
    bk.reset_counts()
    bf.reset_counts()
    dk.reset_counts()
    t = time.perf_counter()
    try:
        stats = solver.solve()
        torch.cuda.synchronize()
    finally:
        ds.factorize = factorize
    wall = time.perf_counter() - t
    return stats, wall, {**bk.counts(), **bf.counts(), **bf.witness_counts(),
                         **dk.counts()}, \
        solver.opts


def _check_dense(stats, dtype, counts, opts):
    status, iters, facts, backs, obj = DENSE_REFERENCE[dtype]
    c = stats.counters
    if stats.status.name != status:
        raise AssertionError(f"dense {dtype}: status {stats.status.name}")
    if abs(stats.objective - obj) > OBJ_RTOL * abs(obj):
        raise AssertionError(f"dense {dtype}: objective {stats.objective!r}, "
                             f"JAX {obj!r}")
    got = {"iter": stats.iter, "factorization_cnt": c["factorization_cnt"],
           "backsolve_cnt": c["backsolve_cnt"]}
    if dtype == "float32":
        bad = {k: v for k, v in got.items()
               if not DENSE_FLOAT32_SPREAD[k][0] <= v <= DENSE_FLOAT32_SPREAD[k][1]}
    else:
        bad = {k: v for k, v in got.items() if k != "backsolve_cnt"
               and v != {"iter": iters, "factorization_cnt": facts}[k]}
        if abs(got["backsolve_cnt"] - backs) > BACKSOLVE_RTOL * backs:
            bad["backsolve_cnt"] = got["backsolve_cnt"]
    if bad:
        raise AssertionError(f"dense {dtype}: {bad}; JAX {DENSE_REFERENCE[dtype]}")
    if not np.isfinite(stats.solution).all():
        raise AssertionError(f"dense {dtype}: non-finite solution")
    if (opts.kkt_system.name, opts.linear_solver.name, opts.ldl_block_size) \
            != ("DENSE_CONDENSED", "LDL", DENSE_BLOCK):
        raise AssertionError(f"dense {dtype}: preset {opts.kkt_system}, "
                             f"{opts.linear_solver}, {opts.ldl_block_size}")
    # the path factors with K7: once per counted factorization and once for
    # the least-squares dual initialization (not counted, as in the JAX
    # package); K7's witness and K1-K6 never
    others = {k: v for k, v in counts.items() if k != "dense_ldlt_cuda"}
    if counts["dense_ldlt_cuda"] != c["factorization_cnt"] + 1 \
            or any(others.values()):
        raise AssertionError(f"dense {dtype}: kernels launched: {counts}, "
                             f"{c['factorization_cnt']} factorizations")


def phase_dense_solve(torch, port):
    out, out_counts = {}, {}
    for dtype in ("float64", "float32"):
        stats, wall, counts, opts = _dense_solve(torch, port, dtype)
        _check_dense(stats, dtype, counts, opts)
        out_counts[dtype] = counts
        emit({"phase": "dense_solve", "dtype": dtype,
              "status": stats.status.name, "iter": stats.iter,
              "objective": stats.objective,
              "reference": DENSE_REFERENCE[dtype], "counters": stats.counters,
              "launches": counts, "wall_s": wall,
              "iter_per_s": stats.iter / wall})
        out[dtype] = stats
    first = out["float32"]

    kept = {}
    again, wall2, _, _ = _dense_solve(torch, port, "float32", keep=kept)
    same = (again.objective == first.objective
            and np.array_equal(again.solution, first.solution)
            and np.array_equal(again.multipliers, first.multipliers)
            and again.counters == first.counters)
    emit({"phase": "dense_solve", "dtype": "float32", "repeat": True,
          "bit_identical": same, "wall_s": wall2})
    if not same:
        raise AssertionError("the repeated dense float32 solve differs")

    walls = []
    for _ in range(TIMED_DENSE_SOLVES):
        again, w, _, _ = _dense_solve(torch, port, "float32")
        if not (again.objective == first.objective
                and np.array_equal(again.solution, first.solution)
                and again.counters == first.counters):
            raise AssertionError("a timed dense float32 solve differs")
        walls.append(w)
    med = statistics.median(walls)
    emit({"phase": "dense_solve", "dtype": "float32",
          "timed_solves": TIMED_DENSE_SOLVES, "wall_s": walls,
          "median_wall_s": med, "iter_per_s_median": first.iter / med,
          "iter_per_s_min": first.iter / max(walls),
          "iter_per_s_max": first.iter / min(walls)})

    # the whole solve: with K7 a factorization is some 90 launches
    window = {}

    def profiled():
        stats, wall, _, _ = _dense_solve(torch, port, "float32")
        window["factorizations"] = stats.counters["factorization_cnt"]
        return stats.iter, wall
    prof = _profile(torch, port, profiled)
    # +1: the least-squares dual initialization factorizes once, uncounted
    prof["device_launches_per_factorization"] = (
        prof["device_launches"] / (window["factorizations"] + 1))
    emit(dict(phase="dense_profile", dtype="float32",
              factorizations=window["factorizations"], **prof))
    return {"iter_per_s_median": first.iter / med, "K": kept["K"],
            "launches": out_counts["float32"]["dense_ldlt_cuda"]}


# -- 8. K7 on the dense solve's own matrix --------------------------------------


def _dense_bound(np_, itemsize, dtype):
    """Least time (ms) of a whole-matrix LDLᵀ of the padded Np×Np matrix:
    Np³/3 flops at the card's peak outside the tensor cores, the matrix
    read once and the factor written once."""
    flops = np_ ** 3 / 3.0
    nbytes = 2.0 * np_ * np_ * itemsize
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _count_launches(torch, fn):
    """CUDA kernels that one call of ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events()
               if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA)


def phase_dense_main_matrix(torch, K32):
    from madnlp_tpu_torch.ops import dense_kernels as dk
    from madnlp_tpu_torch.ops.ldlt import (
        ldlt_factorize,
        ldlt_inertia,
        pad_identity,
    )

    n = K32.shape[0]
    # K7's and its witness's op paths: counts from 0 just before, read just
    # after
    dk.reset_counts()
    kf32 = dk.dense_ldlt(K32, DENSE_BLOCK)
    torch.cuda.synchronize()
    launches = dk.counts()
    rf32 = dk.dense_ldlt_reference(K32, DENSE_BLOCK)
    torch.cuda.synchronize()
    witness_launches = dk.dense_ldlt_reference_cuda.launches
    if launches != {"dense_ldlt_cuda": 1, "dense_ldlt_reference_cuda": 0} \
            or witness_launches != 1:
        raise AssertionError(f"K7 / witness launches on their op paths: "
                             f"{launches}, {witness_launches}")
    pf32 = dk.dense_ldlt_plain(K32, DENSE_BLOCK)
    lf32 = ldlt_factorize(K32, DENSE_BLOCK)
    K64 = K32.double()
    kf, rf, pf, lf = (dk.dense_ldlt(K64, DENSE_BLOCK),
                      dk.dense_ldlt_reference(K64, DENSE_BLOCK),
                      dk.dense_ldlt_plain(K64, DENSE_BLOCK),
                      ldlt_factorize(K64, DENSE_BLOCK))
    torch.cuda.synchronize()
    same = {dt: _same_bits(torch, a.L, b.L) and _same_bits(torch, a.d, b.d)
            for dt, (a, b) in (("float32", (kf32, rf32)),
                               ("float64", (kf, rf)))}
    rel64 = {"K7_vs_plain": _factor_errors(torch, kf, pf)[0],
             "ldlt_factorize_vs_plain": _factor_errors(torch, lf, pf)[0]}
    rel32 = {"K7_vs_plain": _factor_errors(torch, kf32, pf32)[0],
             "ldlt_factorize_vs_plain": _factor_errors(torch, lf32, pf32)[0]}
    inertia = {"float32": [ldlt_inertia(f) for f in (kf32, pf32, lf32)],
               "float64": [ldlt_inertia(f) for f in (kf, pf, lf)]}
    emit({"phase": "dense_main_matrix", "N": n, "block": DENSE_BLOCK,
          "K7_equal_to_witness": same,
          "float64_max_rel_err": rel64, "float64_tol": DENSE_MAIN_RTOL,
          "float32_max_rel_err (reported)": rel32,
          "inertia (K7, plain, ldlt_factorize)": inertia})
    if not all(same.values()):
        raise AssertionError(f"K7 differs from its witness on the dense main "
                             f"matrix: {same}")
    if max(max(v.values()) for v in rel64.values()) > DENSE_MAIN_RTOL:
        raise AssertionError("K7, plain and ldlt_factorize disagree on the "
                             "dense main matrix")
    if len(set(inertia["float64"])) != 1 or len(set(inertia["float32"])) != 1:
        raise AssertionError(f"inertia differs on the dense main matrix: {inertia}")

    rng = np.random.default_rng(5)
    R = torch.as_tensor(rng.standard_normal((n, n)), device="cuda")
    spd = (R @ R.T + n * torch.eye(n, dtype=torch.float64, device="cuda")).float()
    times, bounds = {}, {}
    for dtype_name, K in (("float32", K32), ("float64", K64)):
        padded = pad_identity(K, DENSE_BLOCK).contiguous()
        work = torch.empty_like(padded)
        # K7 and its witness in turns, launches queued behind a spin kernel
        turns = _time_turns(
            torch, {"K7": lambda: dk.dense_ldlt_cuda(work, DENSE_BLOCK),
                    "K7_witness": lambda: dk.dense_ldlt_reference_cuda(
                        work, DENSE_BLOCK)},
            lambda: work.copy_(padded), DENSE_TURN_ROUNDS)
        t = {k: v for k, v in turns.items()}
        t["K7_plain"] = _time_events(
            torch, lambda: dk.dense_ldlt_plain(K, DENSE_BLOCK), lambda: None, 3)
        t["ldlt_factorize"] = _time_events(
            torch, lambda: ldlt_factorize(K, DENSE_BLOCK), lambda: None, 3)
        if dtype_name == "float32":
            t["cholesky_spd_context"] = _time_events(
                torch, lambda: torch.linalg.cholesky(spd), lambda: None, 10)
        times[dtype_name] = t
        bounds[dtype_name] = _dense_bound(padded.shape[0], K.element_size(),
                                          dtype_name)
    device_launches = {
        "dense_ldlt": _count_launches(torch, lambda: dk.dense_ldlt(K32, DENSE_BLOCK)),
        "ldlt_factorize": _count_launches(
            torch, lambda: ldlt_factorize(K32, DENSE_BLOCK))}
    emit({"phase": "dense_timing", "N": n, "Np": pad_identity(
        K32, DENSE_BLOCK).shape[0], "block": DENSE_BLOCK, "ms": times,
          "bound": bounds, "device_launches_per_call": device_launches,
          "K7_witness_over_K7": {dt: times[dt]["K7_witness"] / times[dt]["K7"]
                                 for dt in times}})
    return {"launches": launches["dense_ldlt_cuda"],
            "witness_launches": witness_launches, "times": times,
            "bounds": bounds}


# -- 9. restoration, warm start and checkpoint -----------------------------------


def _all_counts():
    from madnlp_tpu_torch.ops import banded_fused_kernels as bf
    from madnlp_tpu_torch.ops import banded_kernels as bk
    from madnlp_tpu_torch.ops import dense_kernels as dk

    return {**bk.counts(), **bf.counts(), **bf.witness_counts(), **dk.counts()}


def _reset_all_counts():
    from madnlp_tpu_torch.ops import banded_fused_kernels as bf
    from madnlp_tpu_torch.ops import banded_kernels as bk
    from madnlp_tpu_torch.ops import dense_kernels as dk

    bk.reset_counts()
    bf.reset_counts()
    dk.reset_counts()


def _count_steps(solver):
    """Count the solver's steps by phase and its least-squares multiplier
    solves (one uncounted factorization each: the start, and every return
    from robust restoration to the regular phase)."""
    seen = {"regular": 0, "restore": 0, "robust": 0, "least_squares": 0}
    k = solver.kernel
    for key, name in (("regular", "regular_step"), ("restore", "restore_step"),
                      ("robust", "robust_step"),
                      ("least_squares", "_least_squares_duals")):
        inner = getattr(k, name)

        def counted(st, inner=inner, key=key):
            seen[key] += 1
            return inner(st)
        setattr(k, name, counted)
    return seen


def _banded_solver(port, model, dtype, **opts):
    return port.MadNLPSolver(
        model, device="cuda", linear_solver=port.LinearSolver.BANDED,
        dtype=dtype, richardson=port.RichardsonOptions(mu_scaled=True),
        print_level=port.PrintLevel.ERROR, **opts)


def _restoration_solve(torch, port, dtype):
    """The parametric flagship at load scale 2.0 on the card (model and
    set-up excluded from the wall), every kernel's count set to 0 just
    before.  Returns (stats, wall, kernel counts, step counts)."""
    from madnlp_tpu_torch.models.instances import opf

    solver = _banded_solver(
        port, opf.build_sparse(nb=600, seed=0, parametric=True), dtype)
    seen = _count_steps(solver)
    torch.cuda.synchronize()
    _reset_all_counts()
    t = time.perf_counter()
    stats = solver.solve(params=RESTORATION_THETA)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return stats, wall, _all_counts(), seen


def _restoration_counters(stats, seen):
    c = stats.counters
    return {"iter": stats.iter, "factorization_cnt": c["factorization_cnt"],
            "backsolve_cnt": c["backsolve_cnt"], "restore": seen["restore"],
            "robust": seen["robust"],
            "steps": seen["regular"] + seen["restore"] + seen["robust"]}


def _check_banded_launches(what, facts, backs, counts, seen):
    """K1 once per factorization (``facts`` in the run) and per
    least-squares solve, K2 at least once per backsolve; K5-K7 and every
    witness never."""
    others = dict(counts)
    k1 = others.pop("banded_factorize_cuda")
    k2 = others.pop("banded_solve_cuda")
    if k1 != facts + seen["least_squares"] or k2 < backs \
            or any(others.values()):
        raise AssertionError(f"{what}: kernels launched {counts}, "
                             f"{facts} factorizations, {backs} backsolves, "
                             f"{seen}")


def _check_restoration(stats, dtype, counts, seen):
    ref = RESTORATION_REFERENCE[dtype]
    got = _restoration_counters(stats, seen)
    if stats.status.name != ref["status"]:
        raise AssertionError(f"restoration {dtype}: status "
                             f"{stats.status.name}, JAX {ref['status']}")
    bad = {k: v for k, v in got.items()
           if not RESTORATION_SPREAD[dtype][k][0] <= v
           <= RESTORATION_SPREAD[dtype][k][1]}
    if bad:
        raise AssertionError(f"restoration {dtype}: {bad} outside the one-ulp "
                             f"spread {RESTORATION_SPREAD[dtype]}")
    if abs(stats.primal_feas - ref["inf_pr"]) > \
            RESTORATION_INF_PR_RTOL * ref["inf_pr"]:
        raise AssertionError(f"restoration {dtype}: inf_pr "
                             f"{stats.primal_feas!r}, JAX {ref['inf_pr']!r}")
    if not np.isfinite(stats.solution).all():
        raise AssertionError(f"restoration {dtype}: non-finite solution")
    _check_banded_launches(f"restoration {dtype}",
                           stats.counters["factorization_cnt"],
                           stats.counters["backsolve_cnt"], counts, seen)
    return got


def phase_restoration(torch, port):
    from madnlp_tpu_torch.models.instances import suite

    out = {}
    for dtype in ("float64", "float32"):
        stats, wall, counts, seen = _restoration_solve(torch, port, dtype)
        got = _check_restoration(stats, dtype, counts, seen)
        ref = RESTORATION_REFERENCE[dtype]
        emit({"phase": "restoration", "dtype": dtype, "theta": RESTORATION_THETA,
              "status": stats.status.name, **got,
              "equal_to_jax": all(got[k] == ref[k] for k in got),
              "inf_pr": stats.primal_feas, "objective": stats.objective,
              "reference": ref, "spread": RESTORATION_SPREAD[dtype],
              **({"reference_xla_loop": RESTORATION_XLA_FLOAT32}
                 if dtype == "float32" else {}),
              "least_squares_solves": seen["least_squares"],
              "launches": counts, "wall_s": wall,
              "iter_per_s": stats.iter / wall,
              "steps_per_s": got["steps"] / wall})
        out[dtype] = (stats, counts, seen)
    # the repeat runs under torch.profiler (which changes no arithmetic):
    # bit for bit the first float32 solve, and the card's busy share
    first, counts32, _ = out["float32"]
    repeat = {}

    def profiled():
        stats, wall, _, _ = _restoration_solve(torch, port, "float32")
        repeat["stats"] = stats
        return stats.iter, wall
    prof = _profile(torch, port, profiled, host=False)
    again = repeat["stats"]
    same = (again.objective == first.objective
            and np.array_equal(again.solution, first.solution)
            and np.array_equal(again.multipliers, first.multipliers)
            and again.counters == first.counters)
    emit({"phase": "restoration", "dtype": "float32", "repeat": True,
          "under_profiler": True, "bit_identical": same})
    if not same:
        raise AssertionError("the repeated float32 restoration solve differs")
    emit(dict(phase="restoration_profile", dtype="float32", **prof))
    single = {dtype: (stats, _restoration_counters(stats, seen_))
              for dtype, (stats, _, seen_) in out.items()}

    # the dense path (K7 where the condensed system has equality rows)
    for name, status in DENSE_RESTORATION.items():
        solver = port.MadNLPSolver(getattr(suite, name)(), device="cuda",
                                   print_level=port.PrintLevel.ERROR)
        seen = _count_steps(solver)
        _reset_all_counts()
        stats = solver.solve()
        torch.cuda.synchronize()
        counts = _all_counts()
        k7 = counts.pop("dense_ldlt_cuda")
        ldl = solver.opts.linear_solver == port.LinearSolver.LDL
        emit({"phase": "restoration_dense", "model": name,
              "status": stats.status.name, "iter": stats.iter,
              "objective": stats.objective, "counters": stats.counters,
              "restore": seen["restore"], "robust": seen["robust"],
              "kkt_system": solver.opts.kkt_system.name,
              "linear_solver": solver.opts.linear_solver.name,
              "K7_launches": k7, "jax_status": status})
        if stats.status.name != status:
            raise AssertionError(f"dense {name}: status {stats.status.name}, "
                                 f"JAX {status}")
        if name == "eigmina" and abs(stats.objective - EIGMINA_OPTIMUM) > 1e-6:
            raise AssertionError(f"eigmina: objective {stats.objective!r}")
        want = stats.counters["factorization_cnt"] + seen["least_squares"]
        if k7 != (want if ldl else 0) or any(counts.values()):
            raise AssertionError(f"dense {name}: K7 {k7}, others {counts}")
    return {"launches": (counts32["banded_factorize_cuda"],
                         counts32["banded_solve_cuda"]),
            "single": single}


def _count_batch_steps(solver, lanes):
    """Count each lane's steps by phase (its status at the start of each
    batched step) and the batched steps."""
    from madnlp_tpu_torch.utils.status import Status as S

    names = {int(S.REGULAR): "regular", int(S.RESTORE): "restore",
             int(S.ROBUST): "robust"}
    seen = {"batched_steps": 0,
            "lanes": [dict.fromkeys(names.values(), 0) for _ in range(lanes)]}
    bk = solver.batch_kernel
    inner = bk.step

    def counted(st):
        seen["batched_steps"] += 1
        for i, code in enumerate(st.status):
            if int(code) in names:
                seen["lanes"][i][names[int(code)]] += 1
        return inner(st)
    bk.step = counted
    return seen


def _profile_steps(torch, solver, first, count, out):
    """Run batched steps ``first`` .. ``first + count - 1`` of ``solver``'s
    next ``solve_batch`` under torch.profiler (device side only), and put
    their device time by kernel and busy share in ``out``."""
    from torch.profiler import ProfilerActivity, profile

    bk = solver.batch_kernel
    inner = bk.step
    done = [0]

    def step(st):
        if done[0] == first:
            torch.cuda.synchronize()
            out["prof"] = profile(activities=[ProfilerActivity.CUDA])
            out["prof"].start()
            out["t"] = time.perf_counter()
        st = inner(st)
        done[0] += 1
        if done[0] == first + count:
            torch.cuda.synchronize()
            wall = time.perf_counter() - out.pop("t")
            out["prof"].stop()
            out.update(_device_time(torch, out.pop("prof"), wall),
                       batched_steps=(first, first + count))
        return st
    bk.step = step


def _batch_restoration(torch, port, dtype, profiled=None):
    """One bulk ``solve_batch`` of BATCH_RESTORATION_SCALES on the card
    (model and set-up excluded from the wall), every kernel's count set to
    0 just before.  ``profiled``: a dict that receives the device time of
    the PROFILE_STEPS window (:func:`_profile_steps`).  Returns (summary,
    wall, kernel counts, step counts)."""
    from madnlp_tpu_torch.models.instances import opf

    solver = _banded_solver(
        port, opf.build_sparse(nb=600, seed=0, parametric=True), dtype)
    seen = _count_batch_steps(solver, len(BATCH_RESTORATION_SCALES))
    if profiled is not None:
        _profile_steps(torch, solver, *PROFILE_STEPS, profiled)
    torch.cuda.synchronize()
    _reset_all_counts()
    t = time.perf_counter()
    st = solver.solve_batch(BATCH_RESTORATION_SCALES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if profiled is not None and "device_busy_share" not in profiled:
        raise AssertionError("the profiled window of batched steps did not "
                             f"run: {seen['batched_steps']} steps")
    return port.batch_summary(solver.prob, st), wall, _all_counts(), seen


def _lane_counters(summ, seen, i):
    c, steps = summ["counters"], seen["lanes"][i]
    return {"iter": int(summ["iter"][i]),
            "factorization_cnt": int(c["factorization_cnt"][i]),
            "backsolve_cnt": int(c["backsolve_cnt"][i]),
            "restore": steps["restore"], "robust": steps["robust"],
            "steps": sum(steps.values())}


def _check_batch_restoration(port, dtype, summ, counts, seen, solved, resto):
    """``solved``: the reference (status, iter, factorizations,
    backsolves or None, objective) of each solving lane; ``resto``: the
    port's single restoration solve's counters."""
    where = f"batch_restoration {dtype}"
    for i, (status, iters, facts, backs, obj) in enumerate(solved):
        got = _lane_counters(summ, seen, i)
        name = port.Status(int(summ["status"][i])).name
        if (name, got["iter"], got["factorization_cnt"]) != (status, iters,
                                                            facts):
            raise AssertionError(f"{where} lane {i}: {name} {got}, reference "
                                 f"{status} {iters} {facts}")
        if abs(summ["objective"][i] - obj) > OBJ_RTOL * abs(obj):
            raise AssertionError(f"{where} lane {i}: objective "
                                 f"{summ['objective'][i]!r}, reference {obj!r}")
        if backs is not None and abs(got["backsolve_cnt"] - backs) > \
                BACKSOLVE_LANE_RTOL * backs:
            raise AssertionError(f"{where} lane {i}: backsolves "
                                 f"{got['backsolve_cnt']}, single {backs}")
    i = len(solved)
    got = _lane_counters(summ, seen, i)
    ref = RESTORATION_REFERENCE[dtype]
    name = port.Status(int(summ["status"][i])).name
    if name != ref["status"]:
        raise AssertionError(f"{where}: status {name}, JAX {ref['status']}")
    spread = BATCH_RESTORATION_SPREAD[dtype]
    if got != resto and any(not spread[k][0] <= v <= spread[k][1]
                            for k, v in got.items()):
        raise AssertionError(f"{where}: {got} neither the single solve's "
                             f"{resto} nor inside the spread {spread}")
    if abs(summ["inf_pr"][i] - ref["inf_pr"]) > \
            RESTORATION_INF_PR_RTOL * ref["inf_pr"]:
        raise AssertionError(f"{where}: inf_pr {summ['inf_pr'][i]!r}, JAX "
                             f"{ref['inf_pr']!r}")
    if not np.isfinite(summ["x"]).all():
        raise AssertionError(f"{where}: non-finite solution")
    others = dict(counts)
    k3 = others.pop("banded_factorize_batched_cuda")
    k4 = others.pop("banded_solve_batched_cuda")
    if k3 == 0 or k4 == 0 or any(others.values()):
        raise AssertionError(f"{where}: kernels launched {counts}")
    return got


def phase_batch_restoration(torch, port, single):
    """``single``: the ``restoration`` phase's single solves at 2.0."""
    out = {}
    for dtype in ("float64", "float32"):
        if dtype == "float64":
            solved = [WARM_REFERENCE[k][:3] + (None, WARM_REFERENCE[k][3])
                      for k in ("cold_1.0", "cold_1.04")]
        else:
            from madnlp_tpu_torch.models.instances import opf

            model = opf.build_sparse(nb=600, seed=0, parametric=True)
            solved = []
            for scale in BATCH_RESTORATION_SCALES[:2]:
                s = _banded_solver(port, model, dtype).solve(params=scale)
                solved.append((s.status.name, s.iter,
                               s.counters["factorization_cnt"],
                               s.counters["backsolve_cnt"], s.objective))
        summ, wall, counts, seen = _batch_restoration(torch, port, dtype)
        stats, resto = single[dtype]
        got = _check_batch_restoration(port, dtype, summ, counts, seen,
                                       solved, resto)
        lane_iters = int(summ["iter"].sum())
        k3 = counts["banded_factorize_batched_cuda"]
        k4 = counts["banded_solve_batched_cuda"]
        emit({"phase": "batch_restoration", "dtype": dtype,
              "scales": BATCH_RESTORATION_SCALES,
              "status": [port.Status(int(v)).name for v in summ["status"]],
              "iter": summ["iter"].tolist(),
              "factorization_cnt": summ["counters"]["factorization_cnt"]
              .tolist(),
              "backsolve_cnt": summ["counters"]["backsolve_cnt"].tolist(),
              "objective": summ["objective"].tolist(),
              "steps_by_phase": seen["lanes"],
              "batched_steps": seen["batched_steps"],
              "restoration_lane": got, "single_restoration": resto,
              "equal_to_single": got == resto,
              "single_solved_lanes": solved,
              "inf_pr": float(summ["inf_pr"][-1]),
              "K3_launches": k3, "K4_launches": k4,
              "K3_per_batched_step": k3 / seen["batched_steps"],
              "K4_per_batched_step": k4 / seen["batched_steps"],
              "launches": counts, "wall_s": wall,
              "lane_iterations": lane_iters,
              "lane_iter_per_s": lane_iters / wall})
        out[dtype] = summ
    # the float32 batch repeated: bit for bit, and the card's busy share
    # over a window of its batched steps under torch.profiler
    prof = {}
    summ, _, _, _ = _batch_restoration(torch, port, "float32", prof)
    same = _same_batch(summ, out["float32"]) and np.array_equal(
        summ["status"], out["float32"]["status"])
    emit({"phase": "batch_restoration", "dtype": "float32", "repeat": True,
          "profiled_batched_steps": prof["batched_steps"],
          "bit_identical": same})
    if not same:
        raise AssertionError("the repeated float32 restoration batch differs")
    emit(dict(phase="batch_restoration_profile", dtype="float32", **prof))


def phase_warm_start(torch, port):
    from madnlp_tpu_torch.models.instances import opf

    solver = _banded_solver(
        port, opf.build_sparse(nb=600, seed=0, parametric=True), "float64")
    seen = _count_steps(solver)
    runs = {}
    facts = backs = 0      # the solver's counters run on across re-solves
    for key, theta in (("cold_1.0", 1.0), ("warm_1.0", 1.0),
                       ("warm_1.04", 1.04)):
        torch.cuda.synchronize()
        _reset_all_counts()
        seen.update(dict.fromkeys(seen, 0))
        t = time.perf_counter()
        stats = solver.solve(params=theta)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = _all_counts()
        c = stats.counters
        _check_banded_launches(f"warm start {key}",
                               c["factorization_cnt"] - facts,
                               c["backsolve_cnt"] - backs, counts, seen)
        facts, backs = c["factorization_cnt"], c["backsolve_cnt"]
        runs[key] = stats
        line = {"phase": "warm_start", "run": key, "theta": theta,
                "status": stats.status.name, "iter": stats.iter,
                "factorization_cnt": stats.counters["factorization_cnt"],
                "objective": stats.objective,
                "state_theta": float(solver.state.theta),
                "launches": counts, "wall_s": wall}
        if key in WARM_REFERENCE:
            status, iters, facts, obj = WARM_REFERENCE[key]
            line["reference"] = WARM_REFERENCE[key]
            if (stats.status.name, stats.iter,
                    stats.counters["factorization_cnt"]) != (status, iters, facts) \
                    or abs(stats.objective - obj) > OBJ_RTOL * abs(obj):
                emit(line)
                raise AssertionError(f"warm start {key}: differs from JAX")
        else:
            status, iters, facts, obj = WARM_REFERENCE["cold_1.04"]
            line["jax_cold_1.04"] = WARM_REFERENCE["cold_1.04"]
            if stats.status.name != status \
                    or abs(stats.objective - obj) > WARM_OBJ_RTOL * abs(obj) \
                    or float(solver.state.theta) != theta:
                emit(line)
                raise AssertionError("warm start at 1.04: not the new "
                                     "instance's optimum")
        emit(line)
    return runs


def phase_checkpoint(torch, port):
    import tempfile

    from madnlp_tpu_torch.models.instances import opf
    from madnlp_tpu_torch.utils.checkpoint import resume, save_state
    from madnlp_tpu_torch.utils.status import Status as S

    def model():
        return opf.build_sparse(nb=600, seed=0)

    def steps(solver, st, n=None):
        k = solver.kernel
        step = {int(S.REGULAR): k.regular_step, int(S.RESTORE): k.restore_step,
                int(S.ROBUST): k.robust_step}
        done = 0
        while st.status in step and (n is None or done < n):
            st = step[st.status](st)
            done += 1
        return st

    whole = _banded_solver(port, model(), "float64").solve()
    first = _banded_solver(port, model(), "float64")
    st = steps(first, first.kernel.initialize(None), CHECKPOINT_AFTER)
    with tempfile.TemporaryDirectory() as folder:
        path = os.path.join(folder, "state.npz")
        save_state(st, path)
        size = os.path.getsize(path)
        second = _banded_solver(port, model(), "float64")
        _reset_all_counts()
        st2 = resume(second, path)
    on_card = st2.x.device.type == "cuda" and st2.RR.pp.device.type == "cuda"
    st2 = steps(second, st2)
    torch.cuda.synchronize()
    counts = _all_counts()
    resumed = second._stats(st2, 0.0)
    same = (resumed.iter == whole.iter and resumed.counters == whole.counters
            and np.array_equal(resumed.solution, whole.solution)
            and np.array_equal(resumed.multipliers, whole.multipliers)
            and resumed.objective == whole.objective)
    emit({"phase": "checkpoint", "after_steps": CHECKPOINT_AFTER,
          "file_bytes": size, "loaded_on_card": on_card,
          "status": resumed.status.name, "iter": resumed.iter,
          "uninterrupted_iter": whole.iter,
          "factorization_cnt": resumed.counters["factorization_cnt"],
          "uninterrupted_factorization_cnt":
              whole.counters["factorization_cnt"],
          "bit_identical": same, "launches_after_resume": counts})
    if not (same and on_card and resumed.status == port.Status.SOLVE_SUCCEEDED):
        raise AssertionError("the resumed solve differs from the "
                             "uninterrupted one")
    if not counts["banded_factorize_cuda"]:
        raise AssertionError("the resumed solve did not launch K1")


# -- 12. the step options ------------------------------------------------------


def _option_solve(torch, port, model, dtype, opts, banded=True):
    """One solve of ``model`` under the step options ``opts`` on the card
    (the flagship's options on the banded path, the defaults on the
    dense one; model and set-up excluded from the wall), every kernel's
    count set to 0 just before it.  Returns (stats, wall, kernel counts,
    step counts, the column counts of the banded solves' calls)."""
    from madnlp_tpu_torch.ops import banded_kernels as bk

    if banded:
        solver = _banded_solver(port, model, dtype, **opts)
    else:
        solver = port.MadNLPSolver(model, device="cuda", dtype=dtype,
                                   print_level=port.PrintLevel.ERROR, **opts)
    seen = _count_steps(solver)
    widths = {}
    solve = bk.solve

    def counting(struct, f, rhs):
        k = 1 if rhs.ndim == 1 else rhs.shape[1]
        widths[k] = widths.get(k, 0) + 1
        return solve(struct, f, rhs)
    bk.solve = counting
    torch.cuda.synchronize()
    _reset_all_counts()
    t = time.perf_counter()
    try:
        stats = solver.solve()
        torch.cuda.synchronize()
    finally:
        bk.solve = solve
    wall = time.perf_counter() - t
    return stats, wall, _all_counts(), seen, widths


def _check_option(what, stats, ref, spread, counts, seen, widths, kernel,
                  timed=False):
    """Held to the JAX package's ``ref``: status, iterations and
    factorizations exactly, the objective within ``OBJ_RTOL``, backsolves
    exactly in float64 (or within their one-ulp range, ``spread``) and
    within ``BACKSOLVE_RTOL`` in float32.  A ``timed`` quasi-Newton run at
    nb=600 must end SOLVE_SUCCEEDED at ``ref``'s objective (within
    ``OBJ_RTOL``), whatever the JAX package's status and counts there.
    Then the path's launches: ``kernel`` (K1, K7, or None for a
    factorization without a kernel) once per factorization and per
    least-squares start, K2 (the banded path) at least once per backsolve
    and, under compact L-BFGS, once per factorization with 2·max_history
    columns (the SMW solve); every other kernel and every witness never."""
    status, iters, facts, backs, obj = ref
    c = stats.counters
    got = {"status": stats.status.name, "iter": stats.iter,
           "factorization_cnt": c["factorization_cnt"],
           "backsolve_cnt": c["backsolve_cnt"], "objective": stats.objective}
    spread = spread or {}
    checks = {"objective": (obj * (1 - OBJ_RTOL), obj * (1 + OBJ_RTOL))}
    if timed:
        status = "SOLVE_SUCCEEDED"
    else:
        checks.update({
            "iter": (iters, iters), "factorization_cnt": (facts, facts),
            "backsolve_cnt": spread.get("backsolve_cnt", (backs, backs))})
        if "float32" in what and "backsolve_cnt" not in spread:
            checks["backsolve_cnt"] = (backs * (1 - BACKSOLVE_RTOL),
                                       backs * (1 + BACKSOLVE_RTOL))
    if got["status"] != status:
        raise AssertionError(f"{what}: {got['status']}, want {status} "
                             f"(JAX {ref})")
    bad = {k: got[k] for k, (lo, hi) in checks.items()
           if not lo <= got[k] <= hi}
    if bad:
        raise AssertionError(f"{what}: {bad}; JAX {ref}, allowed {checks}")
    if not np.isfinite(stats.solution).all():
        raise AssertionError(f"{what}: non-finite solution")
    others = dict(counts)
    _no_witness(others)
    want = c["factorization_cnt"] + seen["least_squares"]
    if kernel == "banded_factorize_cuda":
        _check_banded_launches(what, c["factorization_cnt"],
                               c["backsolve_cnt"], counts, seen)
        wide = widths.get(2 * STEP_QN_HISTORY, 0)
        if ("lbfgs" in what) != bool(wide) or (wide and wide != want):
            raise AssertionError(f"{what}: {wide} SMW solves of "
                                 f"{2 * STEP_QN_HISTORY} columns, {want} "
                                 f"factorizations")
        return
    k = others.pop(kernel) if kernel else 0
    if k != (want if kernel else 0) or any(others.values()):
        raise AssertionError(f"{what}: kernels launched {counts}, {want} "
                             f"factorizations")


def _option_line(what, stats, wall, counts, seen, widths, ref):
    c = stats.counters
    return {"run": what, "status": stats.status.name, "iter": stats.iter,
            "factorization_cnt": c["factorization_cnt"],
            "backsolve_cnt": c["backsolve_cnt"], "hess_cnt": c["hess_cnt"],
            "objective": stats.objective, "jax": ref,
            "least_squares_solves": seen["least_squares"],
            "K1": counts["banded_factorize_cuda"],
            "K2": counts["banded_solve_cuda"],
            "K7": counts["dense_ldlt_cuda"],
            "banded_solves_by_columns": widths,
            "K2_per_iter": counts["banded_solve_cuda"] / max(stats.iter, 1),
            "wall_s": wall, "iter_per_s": stats.iter / wall}


def _qn_options(port, name, opts):
    """``opts`` as the port's enums, with ``STEP_QN_MAX_ITER`` for a
    quasi-Newton run at nb=600."""
    out = _options(port, opts)
    if name in STEP_QUASI_NEWTON:
        out["max_iter"] = STEP_QN_MAX_ITER
    return out


def phase_step_options(torch, port):
    """The step options on the banded flagship (K1/K2): each of
    ``STEP_BANDED`` in float64 and float32 against the JAX package's
    numbers (``STEP_REFERENCE``; compact L-BFGS timed, held exactly in
    ``step_options_exact``), then float32 under ``kkt_scaling="k25"`` and
    under ``kkt_system="scaled_sparse"`` (the same run, bit for bit); the
    float32 quality-function and compact L-BFGS runs repeated under
    torch.profiler (bit for bit) for the card's busy share."""
    from madnlp_tpu_torch.models.instances import opf

    first = {}
    for dtype in ("float64", "float32"):
        for name, opts in STEP_BANDED.items():
            what = f"banded {dtype} {name}"
            model = opf.build_sparse(nb=STEP_NB, seed=0)
            stats, wall, counts, seen, widths = _option_solve(
                torch, port, model, dtype, _qn_options(port, name, opts))
            ref = STEP_REFERENCE[("banded", dtype, name)]
            emit({"phase": "step_options", "nb": STEP_NB,
                  **_option_line(what, stats, wall, counts, seen, widths,
                                 ref)})
            _check_option(what, stats, ref,
                          STEP_SPREAD.get(("banded", dtype, name)), counts,
                          seen, widths, "banded_factorize_cuda",
                          timed=name in STEP_QUASI_NEWTON)
            first[(dtype, name)] = stats
    for name in STEP_PROFILED:
        opts = _qn_options(port, name, STEP_BANDED[name])
        again = {}

        def profiled():
            stats, wall, _, _, _ = _option_solve(
                torch, port, opf.build_sparse(nb=STEP_NB, seed=0),
                "float32", opts)
            again["stats"] = stats
            return stats.iter, wall
        prof = _profile(torch, port, profiled, host=False)
        same = _same_stats(again["stats"], first[("float32", name)])
        emit(dict(phase="step_options_profile", run=f"banded float32 {name}",
                  bit_identical=same, **prof))
        if not same:
            raise AssertionError(f"the repeated float32 {name} solve differs")
    k25 = {}
    for key, opts in (("k25", {"kkt_scaling": "k25"}),
                      ("scaled_sparse", {"kkt_system": "scaled_sparse"})):
        what = f"banded float32 {key}"
        stats, wall, counts, seen, widths = _option_solve(
            torch, port, opf.build_sparse(nb=STEP_NB, seed=0), "float32",
            opts)
        ref = STEP_REFERENCE[("banded", "float32", "k25")]
        emit({"phase": "step_options", "nb": STEP_NB,
              **_option_line(what, stats, wall, counts, seen, widths, ref)})
        _check_option(what, stats, ref, None, counts, seen, widths,
                      "banded_factorize_cuda")
        k25[key] = stats
    if not _same_stats(k25["k25"], k25["scaled_sparse"]):
        raise AssertionError("kkt_system='scaled_sparse' is not the "
                             "kkt_scaling='k25' run")
    return first


def phase_step_options_dense(torch, port):
    """The step options on the dense nb=600 path in float64: damped BFGS
    (K7 factors the formed operator; timed), GMRES refinement (K7), and
    ``linear_solver=LU`` (inertia-free: LU has no inertia; a library
    factorization, no kernel), against the JAX package."""
    from madnlp_tpu_torch.models.instances import opf

    for name in STEP_DENSE_AT_NB:
        what = f"dense float64 {name}"
        stats, wall, counts, seen, widths = _option_solve(
            torch, port, opf.build(nb=STEP_NB, seed=0), "float64",
            _qn_options(port, name, STEP_DENSE[name]), banded=False)
        ref = STEP_REFERENCE[("dense", "float64", name)]
        emit({"phase": "step_options_dense", "nb": STEP_NB,
              **_option_line(what, stats, wall, counts, seen, widths, ref)})
        _check_option(what, stats, ref, None, counts, seen, widths,
                      None if name == "lu" else "dense_ldlt_cuda",
                      timed=name in STEP_QUASI_NEWTON)


def phase_step_options_exact(torch, port):
    """The quasi-Newton runs held exactly to the JAX package
    (``STEP_EXACT_REFERENCE``) at the largest flagship size at which both
    packages' judged runs agree (``STEP_EXACT``): banded compact L-BFGS
    in float64 and float32 (K1/K2, the 12-column SMW solve), dense
    compact L-BFGS and damped BFGS in float64 (K7)."""
    from madnlp_tpu_torch.models.instances import opf

    for (path, dtype, name), nb in STEP_EXACT.items():
        what = f"{path} {dtype} {name} nb={nb}"
        banded = path == "banded"
        opts = (STEP_BANDED if banded else STEP_DENSE)[name]
        model = (opf.build_sparse if banded else opf.build)(nb=nb, seed=0)
        stats, wall, counts, seen, widths = _option_solve(
            torch, port, model, dtype, _options(port, opts), banded=banded)
        ref = STEP_EXACT_REFERENCE[(path, dtype, name)]
        emit({"phase": "step_options_exact", "nb": nb,
              **_option_line(what, stats, wall, counts, seen, widths, ref)})
        _check_option(what, stats, ref,
                      STEP_EXACT_SPREAD.get((path, dtype, name)), counts,
                      seen, widths,
                      "banded_factorize_cuda" if banded
                      else "dense_ldlt_cuda")


def _option_batch(torch, port, model, dtype, opts, profiled=None):
    """One bulk ``solve_batch`` of ``model`` at BATCH_SCALES under the step
    options ``opts`` on the card (model and set-up excluded from the
    wall), every kernel's count set to 0 just before.  ``profiled``: a
    dict that receives the device time of the BATCH_STEP_PROFILED window
    of batched steps.  Returns (summary, wall, kernel counts, step counts,
    the column counts of K4's calls)."""
    from madnlp_tpu_torch.ops import banded_kernels as bk

    solver = _banded_solver(port, model, dtype, **opts)
    seen = _count_batch_steps(solver, len(BATCH_SCALES))
    if profiled is not None:
        _profile_steps(torch, solver, *BATCH_STEP_PROFILED, profiled)
    widths = {}
    solve_batched = bk.solve_batched

    def counting(struct, f, rhs, active):
        k = 1 if rhs.ndim == 2 else rhs.shape[2]
        widths[k] = widths.get(k, 0) + 1
        return solve_batched(struct, f, rhs, active)
    bk.solve_batched = counting
    torch.cuda.synchronize()
    _reset_all_counts()
    t = time.perf_counter()
    try:
        st = solver.solve_batch(BATCH_SCALES)
        torch.cuda.synchronize()
    finally:
        bk.solve_batched = solve_batched
    wall = time.perf_counter() - t
    if profiled is not None and "device_busy_share" not in profiled:
        raise AssertionError("the profiled window of batched steps did not "
                             f"run: {seen['batched_steps']} steps")
    return (port.batch_summary(solver.prob, st), wall, _all_counts(), seen,
            widths)


def _option_singles(port, model, dtype, opts):
    """The port's single solve of each scale of BATCH_SCALES on the card
    under ``opts`` (one solver, cold solves): (status, iterations,
    factorizations, backsolves, objective) arrays."""
    solver = _banded_solver(port, model, dtype, **opts)
    out = []
    for scale in BATCH_SCALES:
        solver.state = None
        s = solver.solve(params=float(scale))
        out.append((int(s.status), s.iter, s.counters["factorization_cnt"],
                    s.counters["backsolve_cnt"], s.objective))
    return [np.array(v) for v in zip(*out)]


def _check_option_batch(port, what, summ, counts, single, jax, widths=None,
                        spread=None):
    """Every lane against the port's single solve of its scale: exactly in
    status, iterations and factorizations, backsolves within
    BACKSOLVE_LANE_RTOL, or else (a lane that rounding parts from its
    single solve) both solves' counters inside the lane's one-ulp spread
    (``spread``: {lane: {counter: (lo, hi)}}); the objective within
    OBJ_RTOL.  The lanes of ``jax`` ({lane: (status, iter, factorizations,
    objective)}) exactly the JAX package's.  K3 and K4 launched, every
    other kernel and witness never; under compact L-BFGS (``widths``) one
    K4 launch of 2·max_history columns per batched factorization.
    Returns (the objective's largest relative difference, the lanes held
    to their spread)."""
    c = summ["counters"]
    status, iters, facts, backs, objs = single
    spread = spread or {}
    parted = []
    for i in range(len(status)):
        lane = (int(summ["status"][i]), int(summ["iter"][i]),
                int(c["factorization_cnt"][i]), int(c["backsolve_cnt"][i]))
        ref = (int(status[i]), int(iters[i]), int(facts[i]), int(backs[i]))
        if lane[:3] == ref[:3] and abs(lane[3] - ref[3]) <= \
                BACKSOLVE_LANE_RTOL * ref[3]:
            continue
        box = spread.get(i)
        inside = box is not None and lane[0] == ref[0] and all(
            lo <= v[k] <= hi
            for v in (lane, ref)
            for k, (lo, hi) in zip((1, 2, 3), (box["iter"],
                                               box["factorization_cnt"],
                                               box["backsolve_cnt"])))
        if not inside:
            raise AssertionError(f"{what} lane {i}: (status, iter, "
                                 f"factorizations, backsolves) {lane}, "
                                 f"single {ref}, spread {box}")
        parted.append(i)
    rel = np.abs(summ["objective"] - objs) / np.abs(objs)
    if rel.max() > OBJ_RTOL or not np.isfinite(summ["x"]).all():
        raise AssertionError(f"{what}: objective off by {rel.max()!r}")
    for i, (jstatus, jiter, jfacts, jobj) in jax.items():
        lane = (port.Status(int(summ["status"][i])).name,
                int(summ["iter"][i]), int(c["factorization_cnt"][i]))
        if lane != (jstatus, jiter, jfacts) or abs(
                summ["objective"][i] - jobj) > OBJ_RTOL * abs(jobj):
            raise AssertionError(f"{what} lane {i}: {lane} "
                                 f"{summ['objective'][i]!r}, JAX "
                                 f"{(jstatus, jiter, jfacts, jobj)}")
    others = dict(counts)
    _no_witness(others)
    k3 = others.pop("banded_factorize_batched_cuda")
    k4 = others.pop("banded_solve_batched_cuda")
    if k3 == 0 or k4 == 0 or any(others.values()):
        raise AssertionError(f"{what}: kernels launched {counts}")
    if widths is not None:
        wide = widths.get(2 * STEP_QN_HISTORY, 0)
        if wide != k3:
            raise AssertionError(f"{what}: {wide} K4 launches of "
                                 f"{2 * STEP_QN_HISTORY} columns, {k3} "
                                 f"batched factorizations")
    return float(rel.max()), parted


def _option_batch_line(port, what, summ, wall, counts, seen, widths, single,
                       rel, parted):
    c = summ["counters"]
    k3 = counts["banded_factorize_batched_cuda"]
    k4 = counts["banded_solve_batched_cuda"]
    lane_iters = int(summ["iter"].sum())
    return {"run": what, "lanes": len(BATCH_SCALES),
            "status": [port.Status(int(v)).name for v in summ["status"]],
            "iter": summ["iter"].tolist(),
            "factorization_cnt": c["factorization_cnt"].tolist(),
            "backsolve_cnt": c["backsolve_cnt"].tolist(),
            "iter_single": single[1].tolist(),
            "factorization_cnt_single": single[2].tolist(),
            "backsolve_cnt_single": single[3].tolist(),
            "lanes_held_to_their_spread": parted,
            "objective_max_rel_err_single": rel,
            "batched_steps": seen["batched_steps"],
            "K3_launches": k3, "K4_launches": k4,
            "K4_per_batched_step": k4 / seen["batched_steps"],
            "K4_launches_by_columns": widths,
            "launches": counts, "wall_s": wall,
            "lane_iterations": lane_iters,
            "lane_iter_per_s": lane_iters / wall}


def phase_batch_step_options(torch, port):
    """The step options inside ``solve_batch`` on the parametric flagship
    at BATCH_SCALES (K3/K4): each of BATCH_STEP_RUNS in one bulk run,
    every lane against the port's single solve of its scale on the card
    and lanes 0, 5, 10 and 15 against the JAX package's float64 single
    solves (BATCH_STEP_JAX); the run repeated, bit for bit, with the
    BATCH_STEP_PROFILED window of its batched steps under torch.profiler
    for the card's busy share; TIMED_OPTION_BATCHES more bulk runs, each
    bit for bit the first, for the median lane-iterations per second."""
    from madnlp_tpu_torch.models.instances import opf

    model = opf.build_sparse(nb=600, seed=0, parametric=True)
    out = {}
    for name, dtype in BATCH_STEP_RUNS:
        what = f"batch {dtype} {name}"
        opts = _options(port, BATCH_STEP_OPTIONS[name])
        single = _option_singles(port, model, dtype, opts)
        summ, wall, counts, seen, widths = _option_batch(
            torch, port, model, dtype, opts)
        jax = BATCH_STEP_JAX.get(name, {}) if dtype == "float64" else {}
        rel, parted = _check_option_batch(
            port, what, summ, counts, single, jax,
            spread=BATCH_SPREAD.get((name, dtype, 600)))
        line = _option_batch_line(port, what, summ, wall, counts, seen,
                                  widths, single, rel, parted)
        prof = {}
        again, _, _, _, _ = _option_batch(torch, port, model, dtype, opts,
                                          profiled=prof)
        same = _same_batch(again, summ)
        walls = []
        for _ in range(TIMED_OPTION_BATCHES):
            again, w, _, _, _ = _option_batch(torch, port, model, dtype, opts)
            same = same and _same_batch(again, summ)
            walls.append(w)
        med = statistics.median(walls)
        line.update(jax_lanes=sorted(jax), repeat_bit_identical=same,
                    timed_walls_s=walls, median_wall_s=med,
                    median_lane_iter_per_s=line["lane_iterations"] / med,
                    profiled_batched_steps=prof["batched_steps"],
                    device_busy_share=prof["device_busy_share"],
                    device_busy_ms=prof["device_busy_ms"],
                    profiled_wall_ms=prof["wall_ms"],
                    device_top_ms=prof["top_ms"])
        emit({"phase": "batch_step_options", **line})
        if not same:
            raise AssertionError(f"{what}: a repeated batch differs")
        out[(name, dtype)] = line
    return out


def phase_batch_step_options_exact(torch, port):
    """Compact L-BFGS inside ``solve_batch`` on the parametric flagship at
    BATCH_EXACT_NB and BATCH_SCALES, float64 and float32: every lane
    exactly the port's single solve on the card, the lanes of
    BATCH_EXACT_JAX the JAX package's; one K4 launch of 2·max_history
    columns per batched factorization.  Returns the float32 run's K4
    launches at that width."""
    from madnlp_tpu_torch.models.instances import opf

    model = opf.build_sparse(nb=BATCH_EXACT_NB, seed=0, parametric=True)
    opts = _options(port, STEP_BANDED["compact_lbfgs"])
    out = {}
    for dtype in ("float64", "float32"):
        what = f"batch {dtype} compact_lbfgs nb={BATCH_EXACT_NB}"
        single = _option_singles(port, model, dtype, opts)
        summ, wall, counts, seen, widths = _option_batch(
            torch, port, model, dtype, opts)
        rel, parted = _check_option_batch(
            port, what, summ, counts, single, BATCH_EXACT_JAX.get(dtype, {}),
            widths, BATCH_SPREAD.get(("compact_lbfgs", dtype,
                                      BATCH_EXACT_NB)))
        line = _option_batch_line(port, what, summ, wall, counts, seen,
                                  widths, single, rel, parted)
        emit({"phase": "batch_step_options_exact", "nb": BATCH_EXACT_NB,
              "jax_lanes": sorted(BATCH_EXACT_JAX.get(dtype, {})),
              "hess_cnt": summ["counters"]["hess_cnt"].tolist(), **line})
        out[dtype] = widths.get(2 * STEP_QN_HISTORY, 0)
    return out


# -- 15. the front ends and the test harness ------------------------------------


def _nl_solve(torch, port, path, dtype, keep=None, **options):
    """``solve_nl(path)`` on the card as an AMPL user's file reaches it
    (``sparse="auto"``), every kernel's count set to 0 just before; the
    wall includes the parse and the template compile.  ``keep`` collects
    the last band K1 factorized.  Returns (stats, wall, kernel counts)."""
    from madnlp_tpu_torch.models import nl
    from madnlp_tpu_torch.ops import banded_kernels as bk

    factorize = bk.factorize
    if keep is not None:
        def keeping(struct, band):
            keep["struct"], keep["band"] = struct, band.clone()
            return factorize(struct, band)
        bk.factorize = keeping
    torch.cuda.synchronize()
    _reset_all_counts()
    t = time.perf_counter()
    try:
        stats = nl.solve_nl(path, device="cuda", dtype=dtype,
                            print_level=port.PrintLevel.ERROR, **options)
        torch.cuda.synchronize()
    finally:
        bk.factorize = factorize
    return stats, time.perf_counter() - t, _all_counts()


def _check_counts(what, stats, ref, counts, expect, spread=None,
                  backsolve_rtol=0.0):
    """The status exactly the JAX package's ``ref`` and the objective
    within OBJ_RTOL of it; iterations, factorizations and backsolves
    exactly (backsolves within ``backsolve_rtol`` relative), or each count
    named in ``spread`` ({count: (lo, hi)}, a one-ulp spread where
    rounding moves it) inside its range; a finite solution; the kernels of
    ``expect`` ({name: launches}) launched exactly so often and every
    other kernel and witness never."""
    status, iters, facts, backs, obj = ref
    c = stats.counters
    got = {"iter": stats.iter, "factorization_cnt": c["factorization_cnt"],
           "backsolve_cnt": c["backsolve_cnt"]}
    want = {"iter": iters, "factorization_cnt": facts, "backsolve_cnt": backs}
    spread = spread or {}

    def held(k, v):
        if k in spread:
            return spread[k][0] <= v <= spread[k][1]
        rtol = backsolve_rtol if k == "backsolve_cnt" else 0.0
        return abs(v - want[k]) <= rtol * want[k]
    bad = {k: v for k, v in got.items() if not held(k, v)}
    if stats.status.name != status or bad:
        raise AssertionError(f"{what}: status {stats.status.name}, counts "
                             f"{got}; JAX {ref[:4]}, spread {spread}")
    if abs(stats.objective - obj) > OBJ_RTOL * abs(obj):
        raise AssertionError(f"{what}: objective {stats.objective!r}, "
                             f"JAX {obj!r}")
    if not np.isfinite(stats.solution).all():
        raise AssertionError(f"{what}: non-finite solution")
    others = dict(counts)
    _no_witness(others)
    launched = {k: others.pop(k) for k in expect}
    if launched != expect or any(others.values()):
        raise AssertionError(f"{what}: kernels launched {counts}, "
                             f"expected {expect}")


def _time_band(torch, st, band):
    """K1 and K2 on a solve's last band, timed by CUDA events beside
    their plain versions and their bounds."""
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.ops import banded_kernels as bk

    work = torch.empty_like(band)
    f = bk.factorize(st, band.clone())
    rhs = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (st.nbp * st.b, 1)), dtype=band.dtype, device=band.device)
    rwork = torch.empty_like(rhs)
    invL = torch.empty_like(f.invL)
    d = torch.ones((st.nbp * st.b,), dtype=band.dtype, device=band.device)
    pinv = torch.empty_like(f.invL)
    pd = torch.ones_like(d)
    times = {
        "K1": _time_events(
            torch, lambda: bk.banded_factorize_cuda(work, invL, d, st.nb,
                                                    st.b, st.bw),
            lambda: work.copy_(band), 20),
        "K1_plain": _time_events(
            torch, lambda: plain.factorize_columns(work, pinv, pd, st.nb,
                                                   st.b, st.bw),
            lambda: work.copy_(band), 1),
        "K2": _time_events(
            torch, lambda: bk.banded_solve_cuda(f.band, f.invL, f.d, rwork),
            lambda: rwork.copy_(rhs), 20),
        "K2_plain": _time_events(
            torch, lambda: plain.solve_padded(f.band, f.invL, f.d, rwork),
            lambda: rwork.copy_(rhs), 5),
    }
    dtype = "float32" if band.dtype == torch.float32 else "float64"
    return times, _bounds(st.nb, st.b, st.bw, band.element_size(), dtype)


def _nl_callback_ms(torch, model, x, counters, iters):
    """The model's callbacks at ``x`` timed apart by CUDA events (median of
    NL_CALLBACK_REPS calls), and their milliseconds per iteration of the
    solve whose ``counters`` are given."""
    y = x.new_zeros((model.m,))
    calls = {"obj": (lambda: model.obj(x), "obj_cnt"),
             "grad": (lambda: model.grad(x), "grad_cnt"),
             "hess_coords": (lambda: model.hess_coords(x, y, 1.0),
                             "hess_cnt")}
    ms, per_iter = {}, {}
    for name, (fn, counter) in calls.items():
        fn()
        ms[name] = _time_events(torch, fn, lambda: None, NL_CALLBACK_REPS)
        per_iter[name] = ms[name] * counters[counter] / iters
    return ms, per_iter


def phase_nl_sparse(torch, port):
    """``minsurf_nl(NL_NX)`` through ``solve_nl`` on the card (the template
    compiler, the banded KKT on K1/K2) in float64 and float32, each held to
    NL_REFERENCE, K1 launched once per factorization and K2 once per
    backsolve; the binary file and the ``.sol`` bit for bit, and the
    executable's ``.sol`` (run after the checked solves); K1/K2 against
    their plain versions on the solve's last band and timed there;
    TIMED_NL_SOLVES warmed re-solves, bit for bit the first, for the
    median iter/s, one more under torch.profiler for the busy share, and
    the callbacks' milliseconds per iteration.  Returns the float64
    solve's launches and the bands' times and bounds."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_nl_")
    try:
        return _nl_phase(torch, port, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _nl_phase(torch, port, tmp):
    import shutil

    from madnlp_tpu_torch.models import nl
    from madnlp_tpu_torch.testing import minsurf_nl

    text = os.path.join(tmp, "minsurf.nl")
    t = time.perf_counter()
    with open(text, "w") as f:
        f.write(minsurf_nl(NL_NX))
    written = time.perf_counter() - t
    out = _nl_checked(torch, port, nl, tmp, text, written)
    # the solver executable in a process of its own, on the card, once the
    # checked solves are done (nothing else runs beside it)
    stub = os.path.join(tmp, "cli")
    shutil.copyfile(text, stub + ".nl")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t_exe = time.perf_counter()
    exe = subprocess.run(
        [sys.executable, "-m", "madnlp_tpu_torch.models.nl", stub, "-AMPL"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    exe_s = time.perf_counter() - t_exe
    with open(out.pop("sol")) as f:
        sol_text = f.read()
    exe_ok = exe.returncode == 0 and os.path.exists(stub + ".sol")
    if exe_ok:
        with open(stub + ".sol") as f:
            exe_ok = f.read() == sol_text
    emit({"phase": "nl_sparse", "executable_rc": exe.returncode,
          "executable_sol_identical": exe_ok, "executable_s": exe_s,
          "executable_stderr_tail": exe.stderr[-500:]})
    if not exe_ok:
        raise AssertionError("nl_sparse: the executable's .sol differs")
    _nl_timing(torch, port, out)
    return out


def _nl_checked(torch, port, nl, tmp, text, written):
    """The checked solves of the nl_sparse phase (float64 writing the
    ``.sol``, float32, the binary file), the ``.sol`` read back, K1/K2
    against their plain versions on the last bands and timed there."""
    t = time.perf_counter()
    model = nl.read_nl(text, sparse=True)
    compiled = time.perf_counter() - t
    sol = os.path.join(tmp, "minsurf.sol")
    out, kept, stats = {"model": model, "sol": sol}, {}, {}
    for dtype in ("float64", "float32"):
        kept[dtype] = {}
        s, wall, counts = _nl_solve(
            torch, port, text, dtype, keep=kept[dtype],
            sol_path=sol if dtype == "float64" else None)
        ref = NL_REFERENCE[dtype]
        _check_counts(f"nl {dtype}", s, ref, counts,
                      {"banded_factorize_cuda": ref[2],
                       "banded_solve_cuda": s.counters["backsolve_cnt"]},
                      {"backsolve_cnt": NL_BACKSOLVE_SPREAD[dtype]}
                      if dtype in NL_BACKSOLVE_SPREAD else None)
        st = kept[dtype]["struct"]
        emit({"phase": "nl_sparse", "dtype": dtype, "n": model.n,
              "nnzh": model.nnzh, "status": s.status.name, "iter": s.iter,
              "objective": s.objective, "reference": ref,
              "counters": s.counters,
              "geometry": {"N": st.N, "b": st.b, "bw": st.bw, "nb": st.nb,
                           "W": st.W},
              "K1_launches": counts["banded_factorize_cuda"],
              "K2_launches": counts["banded_solve_cuda"],
              "solve_nl_wall_s": wall, "write_s": written,
              "parse_and_compile_s": compiled})
        stats[dtype] = s
        if dtype == "float64":
            out["launches"] = (counts["banded_factorize_cuda"],
                               counts["banded_solve_cuda"])
    out["stats"] = stats
    s64 = stats["float64"]

    binary = os.path.join(tmp, "minsurf_bin.nl")
    nl.convert_nl(text, binary)
    from_binary, _, _ = _nl_solve(torch, port, binary, "float64")
    primal, duals, code, msg = nl.read_sol(sol, model.n, model.m)
    sol_ok = (code == 0 and np.array_equal(primal, s64.solution)
              and np.array_equal(duals, s64.multipliers))
    emit({"phase": "nl_sparse",
          "binary_bit_identical": _same_stats(from_binary, s64),
          "sol_round_trip_bit_identical": sol_ok, "sol_code": code,
          "sol_message": msg})
    if not (_same_stats(from_binary, s64) and sol_ok):
        raise AssertionError("nl_sparse: the binary file or the .sol round "
                             "trip differs")

    # K1/K2 against their plain versions on the solve's last band: float64
    # held, float32 reported (an ill-conditioned KKT amplifies rounding)
    real = {dt: compare_kernels(torch, kept[dt]["struct"], kept[dt]["band"])
            for dt in ("float64", "float32")}
    st = kept["float64"]["struct"]
    emit({"phase": "nl_band", "b": st.b, "bw": st.bw, "nb": st.nb, "N": st.N,
          "float64_max_rel_err": real["float64"]["rel"],
          "float64_tol": REAL_BAND_RTOL,
          "float32_max_rel_err (reported)": real["float32"]["rel"],
          "inertia": {dt: r["inertia"] for dt, r in real.items()}})
    if max(real["float64"]["rel"].values()) > REAL_BAND_RTOL or \
            real["float64"]["inertia"][0] != real["float64"]["inertia"][1]:
        raise AssertionError("nl_band: K1/K2 disagree with plain")
    out["worst"] = {"band": real["float64"]["abs"]["band"],
                    "solve": real["float64"]["abs"]["solve"]}
    out["kept"] = kept
    return out


def _nl_timing(torch, port, out):
    """The nl_sparse phase's timings, once the executable is done: K1/K2
    on the last bands; per dtype TIMED_NL_SOLVES warmed cold re-solves of
    one solver (the solve alone, each bit for bit the checked solve) for
    the median iter/s, one more under torch.profiler, and the callbacks
    at the solution."""
    model, stats, kept = out.pop("model"), out.pop("stats"), out.pop("kept")
    out["times"], out["bounds"] = {}, {}
    for dt in ("float32", "float64"):
        times, bounds = _time_band(torch, kept[dt]["struct"],
                                      kept[dt]["band"])
        out["times"][dt], out["bounds"][dt] = times, bounds
        emit({"phase": "nl_band_timing", "dtype": dt, "ms": times,
              "bounds": {k: bounds[k] for k in ("K1", "K2")},
              "K1_share_of_bound": bounds["K1"]["bound_ms"] / times["K1"],
              "K2_share_of_bound": bounds["K2"]["bound_ms"] / times["K2"]})
    for dt in ("float64", "float32"):
        solver = port.MadNLPSolver(model, device="cuda", dtype=dt,
                                   print_level=port.PrintLevel.ERROR)

        def run():
            solver.state = None
            torch.cuda.synchronize()
            t = time.perf_counter()
            s = solver.solve()
            torch.cuda.synchronize()
            if not _same_stats(s, stats[dt]):
                raise AssertionError(f"nl {dt}: a repeated solve differs")
            return s.iter, time.perf_counter() - t
        walls = [run()[1] for _ in range(TIMED_NL_SOLVES)]
        med = statistics.median(walls)
        prof = _profile(torch, port, run=run, host=False)
        x = torch.as_tensor(stats[dt].solution, device="cuda")
        ms, per_iter = _nl_callback_ms(torch, model, x, stats[dt].counters,
                                       stats[dt].iter)
        iters = stats[dt].iter
        emit({"phase": "nl_timing", "dtype": dt, "repeats_bit_identical":
              TIMED_NL_SOLVES + 1, "wall_s": walls, "median_wall_s": med,
              "iter_per_s_median": iters / med,
              "iter_per_s_min": iters / max(walls),
              "iter_per_s_max": iters / min(walls),
              "callback_ms": ms, "callback_ms_per_iter": per_iter,
              "callbacks_share_of_wall": sum(per_iter.values())
              / (1e3 * med / iters),
              **{f"profile_{k}": v for k, v in prof.items()}})
        out[f"iter_per_s_{dt}"] = iters / med


def _frontend_models(port, torch, calls):
    """The models of tests/test_frontends.py in the port's vocabulary
    (torch functions written with operators), the host models' numpy
    callbacks counted in ``calls``: {name: (model, options)}."""
    from scipy.optimize import Bounds, LinearConstraint, NonlinearConstraint

    P = np.diag([1.0, 2.0, 3.0])

    def counted(name, fn):
        def f(*args):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        return f

    return {
        "scipy_hs15": (port.from_scipy(
            fun=lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
            x0=np.zeros(2),
            bounds=Bounds(lb=[-np.inf, -np.inf], ub=[0.5, np.inf]),
            constraints=[NonlinearConstraint(
                lambda x: torch.stack([x[0] * x[1], x[0] + x[1] ** 2]),
                lb=[1.0, 0.0], ub=[np.inf, np.inf])]), {}),
        "scipy_dict_linear": (port.from_scipy(
            fun=lambda x: ((x - 1.0) ** 2).sum(),
            x0=np.zeros(3),
            constraints=[
                {"type": "eq", "fun": lambda x: x[0] + x[1] + x[2] - 1.0},
                LinearConstraint(np.array([[1.0, -1.0, 0.0]]), lb=-1.0,
                                 ub=np.inf)]), {}),
        "host_qp": (port.host_model(
            counted("obj", lambda x: 0.5 * x @ P @ x - np.sum(x)),
            np.zeros(3), counted("grad", lambda x: P @ x - 1.0), m=1,
            cons=counted("cons", lambda x: np.array([np.sum(x)])),
            jac=counted("jac", lambda x: np.ones((1, 3))),
            lag_hess=counted("lag_hess", lambda x, y, ow: ow * P),
            lcon=[1.0], ucon=[1.0]), {}),
        "host_lbfgs": (port.host_model(
            counted("obj", lambda x: float(np.sum((x - 2.0) ** 2))),
            np.zeros(4), counted("grad", lambda x: 2.0 * (x - 2.0)),
            uvar=np.full(4, 1.5)),
            {"hessian_approximation":
             port.HessianApproximation.COMPACT_LBFGS}),
    }


def phase_frontends(torch, port):
    """``from_scipy`` and ``host_model`` on the card: each model of
    FRONTEND_REFERENCE held exactly to the JAX package's numbers, K7
    launched once per factorization and least-squares start where the
    condensed system factors with LDLᵀ (equality rows) and never under
    Cholesky; the host models' round trips per iteration."""
    k7_total = 0
    for name, ref in FRONTEND_REFERENCE.items():
        calls = {}
        model, opts = _frontend_models(port, torch, calls)[name]
        solver = port.MadNLPSolver(model, device="cuda",
                                   print_level=port.PrintLevel.ERROR, **opts)
        seen = _count_steps(solver)
        torch.cuda.synchronize()
        _reset_all_counts()
        t = time.perf_counter()
        s = solver.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = _all_counts()
        ldl = solver.opts.linear_solver == port.LinearSolver.LDL
        expect = ({"dense_ldlt_cuda": s.counters["factorization_cnt"]
                   + seen["least_squares"]} if ldl else {})
        _check_counts(f"frontends {name}", s, ref, counts, expect,
                      {"backsolve_cnt": (0, float("inf"))})
        k7_total += counts["dense_ldlt_cuda"]
        round_trips = sum(calls.values())
        emit({"phase": "frontends", "run": name, "status": s.status.name,
              "iter": s.iter, "objective": s.objective, "reference": ref,
              "counters": s.counters,
              "linear_solver": solver.opts.linear_solver.name,
              "kkt_system": solver.opts.kkt_system.name,
              "K7_launches": counts["dense_ldlt_cuda"],
              "least_squares_starts": seen["least_squares"],
              "host_calls": calls or None,
              "host_round_trips_per_iter": round_trips / max(s.iter, 1)
              if calls else None, "wall_s": wall})
    return k7_total


def phase_harness(torch, port):
    """The shipped harness on the card: ``test_linear_solver`` for every
    dense solver the port has (K7 for LDL and for HYKKT's K_γ),
    ``test_kkt_system`` on every KKT system it has (banded SPARSE,
    SPARSE_UNREDUCED and SPARSE_CONDENSED on K1/K2, LDL storage and HYKKT
    on K7), the whole behavior suite, and ``solve_jitted`` bit for bit
    ``solve()``."""
    import madnlp_tpu_torch.testing as mt
    from madnlp_tpu_torch.models.instances import hs15, sparse_qp

    LS, KS = port.LinearSolver, port.KKTSystem
    for solver in (LS.LDL, LS.CHOLESKY, LS.LU, LS.QR, LS.EVD,
                   LS.BLOCK_CHOLESKY, LS.HYKKT):
        _reset_all_counts()
        mt.test_linear_solver(solver, device="cuda")
        torch.cuda.synchronize()
        counts = _all_counts()
        # HYKKT factors K_γ with K7 on the card
        want = ({"dense_ldlt_cuda": 1} if solver in (LS.LDL, LS.HYKKT)
                else {})
        if {k: v for k, v in counts.items() if v} != want:
            raise AssertionError(f"harness {solver.name}: launches {counts}")
        emit({"phase": "harness", "test_linear_solver": solver.name,
              "launches": {k: v for k, v in counts.items() if v}})
    qp = lambda: sparse_qp.build(n=HARNESS_QP_N)  # noqa: E731
    cases = {
        "dense_ldl": (None, KS.DENSE, LS.LDL, {}, "K7"),
        "dense_evd": (None, KS.DENSE, LS.EVD, {}, None),
        "condensed_cholesky": (None, KS.DENSE_CONDENSED, None, {}, None),
        "condensed_ldl": (None, KS.DENSE_CONDENSED, LS.LDL, {}, "K7"),
        "sparse_dense_storage": (qp, KS.SPARSE, LS.LDL, {}, "K7"),
        "sparse_banded": (qp, KS.SPARSE, LS.BANDED, {}, "K1K2"),
        "sparse_banded_f32": (qp, KS.SPARSE, LS.BANDED,
                              {"dtype": "float32", "rtol": 1e-5}, "K1K2"),
        "scaled_sparse": (qp, KS.SCALED_SPARSE, LS.BANDED, {}, "K1K2"),
        "unreduced_banded": (qp, KS.SPARSE_UNREDUCED, LS.BANDED, {}, "K1K2"),
        "unreduced_dense_model": (None, KS.SPARSE_UNREDUCED, LS.LDL, {},
                                  "K7"),
        "condensed_banded": (qp, KS.SPARSE_CONDENSED, LS.BANDED, {}, "K1K2"),
        "dense_hykkt": (None, KS.DENSE, LS.HYKKT, {}, "K7"),
        "dense_block_cholesky": (None, KS.DENSE, LS.BLOCK_CHOLESKY, {}, None),
    }
    for name, (build, kkt, lin, opts, kernels) in cases.items():
        _reset_all_counts()
        mt.test_kkt_system(model=build() if build else None, kkt_system=kkt,
                           linear_solver=lin, device="cuda", **opts)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _all_counts().items() if v}
        want = {"K7": {"dense_ldlt_cuda": 1},
                "K1K2": {"banded_factorize_cuda": 1,
                         "banded_solve_cuda": 1}}.get(kernels, {})
        if counts != want:
            raise AssertionError(f"harness {name}: launches {counts}, "
                                 f"expected {want}")
        emit({"phase": "harness", "test_kkt_system": name,
              "launches": counts})
    _reset_all_counts()
    t = time.perf_counter()
    results = mt.run_behavior_suite(device="cuda")
    torch.cuda.synchronize()
    if set(results) != set(mt.BEHAVIOR_SUITE):
        raise AssertionError(f"behavior suite ran {sorted(results)}")
    emit({"phase": "harness", "behavior_suite": {
        k: [s.status.name, s.iter, s.objective] for k, s in results.items()},
        "launches": {k: v for k, v in _all_counts().items() if v},
        "wall_s": time.perf_counter() - t})
    a = port.MadNLPSolver(hs15.build(), device="cuda",
                          print_level=port.PrintLevel.ERROR).solve()
    b = port.MadNLPSolver(hs15.build(), device="cuda",
                          print_level=port.PrintLevel.ERROR).solve_jitted()
    same = _same_stats(a, b) and np.array_equal(a.multipliers_L,
                                                b.multipliers_L)
    emit({"phase": "harness", "solve_jitted_bit_identical": same,
          "iter": b.iter, "objective": b.objective})
    if not same:
        raise AssertionError("solve_jitted differs from solve()")

# -- 18-20. slice A4: the unreduced and condensed systems, HYKKT, BLOCK_CHOLESKY


def _a4_solve(torch, port, model, dtype, keep=None, **opts):
    """One solve of ``model`` on the card under ``opts`` (model and symbolic
    set-up excluded from the wall), every kernel's count and HYKKT's CG
    statistics set to 0 just before it and the Cholesky factorizations
    (``torch.linalg.cholesky_ex``) counted.  ``keep`` collects the last
    band K1 factored (``struct``, ``band``) and the last matrix K7 factored
    (``K``, ``block``).  Returns (stats, wall, kernel counts, CG
    statistics, Cholesky calls)."""
    from madnlp_tpu_torch.ops import banded_kernels as bk
    from madnlp_tpu_torch.ops import dense_kernels as dk
    from madnlp_tpu_torch.ops import dense_solvers as ds

    solver = port.MadNLPSolver(model, device="cuda", dtype=dtype,
                               print_level=port.PrintLevel.ERROR, **opts)
    factorize, dense_ldlt = bk.factorize, dk.dense_ldlt
    cholesky_ex = torch.linalg.cholesky_ex
    choleskys = [0]

    def keeping(struct, band):
        keep["struct"], keep["band"] = struct, band.clone()
        return factorize(struct, band)

    def keeping_dense(A, block=128):
        keep["K"], keep["block"] = A.clone(), block
        return dense_ldlt(A, block)

    def counted(*args, **kwargs):
        choleskys[0] += 1
        return cholesky_ex(*args, **kwargs)
    if keep is not None:
        bk.factorize, dk.dense_ldlt = keeping, keeping_dense
    torch.linalg.cholesky_ex = counted
    torch.cuda.synchronize()
    _reset_all_counts()
    ds.reset_cg_stats()
    t = time.perf_counter()
    try:
        stats = solver.solve()
        torch.cuda.synchronize()
    finally:
        bk.factorize, dk.dense_ldlt = factorize, dense_ldlt
        torch.linalg.cholesky_ex = cholesky_ex
    return (stats, time.perf_counter() - t, _all_counts(), dict(ds.CG_STATS),
            choleskys[0])


def _backward_errors(torch, struct, band):
    """The normwise backward errors ‖Kx − b‖∞ / (‖K‖∞‖x‖∞ + ‖b‖∞) of one
    seeded right-hand side solved by K1 then K2, and by the plain
    factorization then the plain solve, each on its own factor of the
    same band (K the symmetrized band in float64).  The band's
    conditioning does not amplify them, so a wrong factor or solve shows
    as a backward error far above the plain one's."""
    from madnlp_tpu_torch.ops import banded as plain
    from madnlp_tpu_torch.ops import banded_kernels as bk

    rhs = torch.as_tensor(np.random.default_rng(7).standard_normal(struct.N),
                          dtype=band.dtype, device=band.device)
    kx = bk.solve(struct, bk.factorize(struct, band.clone()), rhs)
    px = plain.banded_solve(struct, plain.banded_factorize(struct, band), rhs)
    sym = plain.banded_symmetrize(struct, band).double()
    ones = torch.ones(struct.N, dtype=torch.float64, device=band.device)
    norm_k = float(plain.banded_symv(struct, sym.abs(), ones).max())
    b = rhs.double()
    out = {}
    for name, x in (("K1+K2", kx), ("plain", px)):
        x = x.double()
        r = plain.banded_symv(struct, sym, x) - b
        out[name] = float(r.abs().max()
                          / (norm_k * x.abs().max() + b.abs().max()))
    return out


def _a4_timed(torch, port, what, model_fn, first, opts, dtype="float32"):
    """TIMED_A4_SOLVES more ``dtype`` solves, each bit for bit ``first``,
    for the median iter/s (with min and max), and one more under
    torch.profiler for the card's busy share."""
    def run():
        s, wall, _, _, _ = _a4_solve(torch, port, model_fn(), dtype, **opts)
        if not _same_stats(s, first):
            raise AssertionError(f"{what}: a repeated {dtype} solve differs")
        return s.iter, wall
    walls = [run()[1] for _ in range(TIMED_A4_SOLVES)]
    med = statistics.median(walls)
    prof = _profile(torch, port, run=run, host=False)
    return {"dtype": dtype, "timed_solves": TIMED_A4_SOLVES,
            "repeats_bit_identical": TIMED_A4_SOLVES + 1, "wall_s": walls,
            "median_wall_s": med, "iter_per_s_median": first.iter / med,
            "iter_per_s_min": first.iter / max(walls),
            "iter_per_s_max": first.iter / min(walls),
            **{f"profile_{k}": v for k, v in prof.items()}}


def _a4_banded_phase(torch, port, phase, opts, ref, spread, least_squares,
                     dtypes):
    """The banded phases of slice A4: the flagship model under ``opts`` on
    K1/K2 in each of ``dtypes``, held to the JAX package (``ref``, or
    ``spread`` where rounding moves the counts), K1 once per factorization
    and K2 at least once per backsolve (the least-squares start factors
    and solves once more where the system takes it); the last dtype's
    solve timed, each repeat bit for bit the first; K1/K2 against their plain
    versions on the float64 solve's last band and timed on every dtype's
    last band beside their bounds.  Returns the float64 launches, errors,
    times and bounds for the kernels line."""
    from madnlp_tpu_torch.models.instances import opf

    def model():
        return opf.build_sparse(nb=A4_NB, seed=0)
    kept, stats, out = {}, {}, {"times": {}, "bounds": {}}
    for dtype in dtypes:
        kept[dtype] = {}
        s, wall, counts, _, _ = _a4_solve(torch, port, model(), dtype,
                                          keep=kept[dtype], **opts)
        c = s.counters
        k1 = c["factorization_cnt"] + least_squares
        k2 = counts["banded_solve_cuda"]
        _check_counts(f"{phase} {dtype}", s, ref[dtype], counts,
                      {"banded_factorize_cuda": k1, "banded_solve_cuda": k2},
                      spread.get(dtype),
                      BACKSOLVE_RTOL if dtype == "float32" else 0.0)
        if k2 < c["backsolve_cnt"] + least_squares:
            raise AssertionError(f"{phase} {dtype}: K2 launched {k2} times, "
                                 f"backsolve_cnt {c['backsolve_cnt']}")
        st = kept[dtype]["struct"]
        emit({"phase": phase, "dtype": dtype, "status": s.status.name,
              "iter": s.iter, "objective": s.objective,
              "reference": ref[dtype], "spread": spread.get(dtype),
              "counters": c,
              "geometry": {"N": st.N, "b": st.b, "bw": st.bw, "nb": st.nb,
                           "W": st.W},
              "K1_launches": counts["banded_factorize_cuda"],
              "K2_launches": k2, "wall_s": wall,
              "iter_per_s": s.iter / wall})
        stats[dtype] = s
        if dtype == "float64":
            out["launches"] = (counts["banded_factorize_cuda"], k2)
    last = dtypes[-1]
    real = {dt: compare_kernels(torch, kept[dt]["struct"], kept[dt]["band"])
            for dt in dtypes}
    backward = _backward_errors(torch, kept["float64"]["struct"],
                                kept["float64"]["band"])
    # these bands are ill-conditioned at the solution (R3): the two solves
    # of one right-hand side part by up to 4e-4 relative with the summation
    # order, and the condensed factor's entries by 1e-4, so K1 then K2 is
    # held on both bands by its backward error beside that of the plain
    # factorization and solve; the unreduced factor (1e-17 from plain) is
    # also held entrywise as everywhere
    held = (() if phase == "sparse_condensed" else ("band", "invL", "d"))
    emit({"phase": f"{phase}_band", "float64_max_rel_err":
          real["float64"]["rel"], "float64_tol": REAL_BAND_RTOL,
          "held": held, "float64_backward_error": backward,
          "backward_tol": f"max(10 x plain, {BACKWARD_TOL})",
          "float32_max_rel_err (reported)": real.get(
              "float32", {}).get("rel"),
          "inertia": {dt: r["inertia"] for dt, r in real.items()}})
    if any(real["float64"]["rel"][k] > REAL_BAND_RTOL for k in held) or \
            backward["K1+K2"] > max(10.0 * backward["plain"],
                                    BACKWARD_TOL) or \
            real["float64"]["inertia"][0] != real["float64"]["inertia"][1]:
        raise AssertionError(f"{phase}: K1/K2 disagree with plain on the "
                             f"solve's band")
    out["worst"] = {"band": real["float64"]["abs"]["band"],
                    "solve": real["float64"]["abs"]["solve"]}
    for dt in dtypes:
        times, bounds = _time_band(torch, kept[dt]["struct"],
                                   kept[dt]["band"])
        out["times"][dt], out["bounds"][dt] = times, bounds
        emit({"phase": f"{phase}_band_timing", "dtype": dt, "ms": times,
              "bounds": {k: bounds[k] for k in ("K1", "K2")},
              "K1_share_of_bound": bounds["K1"]["bound_ms"] / times["K1"],
              "K2_share_of_bound": bounds["K2"]["bound_ms"] / times["K2"],
              "K1_launches_per_solve": stats[dt].counters[
                  "factorization_cnt"] + least_squares})
    # the repeats: each timed solve is held bit for bit to the first
    emit({"phase": f"{phase}_timing",
          **_a4_timed(torch, port, phase, model, stats[last], opts, last)})
    return out


def phase_sparse_unreduced(torch, port):
    """The flagship model under SPARSE_UNREDUCED on K1/K2 (N = 3·nw + m)
    in float64 and float32; the least-squares start factors and solves
    once more."""
    opts = {"kkt_system": port.KKTSystem.SPARSE_UNREDUCED,
            "linear_solver": port.LinearSolver.BANDED}
    return _a4_banded_phase(torch, port, "sparse_unreduced", opts,
                            UNREDUCED_REFERENCE, UNREDUCED_SPREAD, 1,
                            ("float64", "float32"))


def phase_sparse_condensed(torch, port):
    """The flagship model under SPARSE_CONDENSED on K1/K2 (the n×n SPD
    band) in float64, at the tolerance of the JAX package's tests of this
    system; its counts held to their one-ulp spread (ROADMAP §C, R3).
    Float32 is not run: the JAX package's float32 condensed solve reaches
    no solution (ROADMAP §C, R3)."""
    opts = {"kkt_system": port.KKTSystem.SPARSE_CONDENSED,
            "linear_solver": port.LinearSolver.BANDED, "tol": CONDENSED_TOL}
    return _a4_banded_phase(torch, port, "sparse_condensed", opts,
                            CONDENSED_REFERENCE, CONDENSED_SPREAD, 0,
                            ("float64",))


def _infeasible_model(port, torch):
    """The one-variable infeasible model of tests/test_config_matrix.py."""
    return port.create_model(
        obj=lambda x: x[0], cons=lambda x: torch.stack([x[0]]),
        n=1, m=1, x0=[0.0], lvar=[1.0], lcon=[0.0], ucon=[0.5])


def phase_range_space(torch, port):
    """The dense flagship under DENSE with HYKKT (K_γ through K7, the
    card's default backend; float64 and float32) and BLOCK_CHOLESKY
    (float64), and the infeasible model under DENSE + HYKKT (its robust
    steps in the ``rr`` mode), each held to the JAX package; HYKKT's K7
    launches (one per factorization and one for the least-squares start),
    no Cholesky under HYKKT, the CG's iterations per backsolve and host
    reads per iteration; K7 against its plain version on the float32
    solve's last K_γ and timed there beside its bound; the timed float32
    solves, each bit for bit the first."""
    from madnlp_tpu_torch.models.instances import opf
    from madnlp_tpu_torch.ops import dense_kernels as dk
    from madnlp_tpu_torch.ops.ldlt import ldlt_inertia, pad_identity

    def model():
        return opf.build(nb=A4_NB, seed=0)
    hykkt = {"kkt_system": port.KKTSystem.DENSE,
             "linear_solver": port.LinearSolver.HYKKT}
    out, stats, kept = {}, {}, {}
    runs = [("hykkt", "float64", model, hykkt),
            ("hykkt", "float32", model, hykkt),
            ("block_cholesky", "float64",
             lambda: opf.build(nb=BCHOL_NB, seed=0),
             {"kkt_system": port.KKTSystem.DENSE,
              "linear_solver": port.LinearSolver.BLOCK_CHOLESKY}),
            ("infeasible", "float64", lambda: _infeasible_model(port, torch),
             hykkt)]
    for name, dtype, build, opts in runs:
        keep = kept.setdefault(dtype, {}) if name == "hykkt" else None
        s, wall, counts, cg, chol = _a4_solve(torch, port, build(), dtype,
                                              keep=keep, **opts)
        c = s.counters
        expect = ({} if name == "block_cholesky"
                  else {"dense_ldlt_cuda": c["factorization_cnt"] + 1})
        _check_counts(f"range_space {name} {dtype}", s,
                      RANGE_SPACE_REFERENCE[(name, dtype)], counts, expect,
                      None,
                      BACKSOLVE_RTOL if dtype == "float32" else 0.0)
        if name != "block_cholesky" and chol:
            raise AssertionError(f"range_space {name} {dtype}: {chol} "
                                 f"Cholesky calls under hykkt_backend='ldl'")
        emit({"phase": "range_space", "run": name, "dtype": dtype,
              "status": s.status.name, "iter": s.iter,
              "objective": s.objective,
              "reference": RANGE_SPACE_REFERENCE[(name, dtype)],
              "counters": c, "K7_launches": counts["dense_ldlt_cuda"],
              "cholesky_calls": chol, "cg": cg,
              "cg_iterations_per_backsolve": cg["iterations"]
              / max(c["backsolve_cnt"], 1),
              "cg_iterations_per_cg_solve": cg["iterations"]
              / max(cg["solves"], 1),
              "host_reads_per_cg_iteration": cg["host_reads"]
              / max(cg["iterations"], 1),
              "wall_s": wall, "iter_per_s": s.iter / wall})
        stats[(name, dtype)] = s
        if (name, dtype) == ("hykkt", "float32"):
            out["launches"] = counts["dense_ldlt_cuda"]
    first = stats[("hykkt", "float32")]
    # K7 on the float32 solve's last K_γ (its op path: counts from 0 just
    # before, one launch read just after), against its plain version, timed
    K32, block = kept["float32"]["K"], kept["float32"]["block"]
    dk.reset_counts()
    kf = dk.dense_ldlt(K32, block)
    torch.cuda.synchronize()
    if dk.counts()["dense_ldlt_cuda"] != 1:
        raise AssertionError(f"K7 on K_γ: launches {dk.counts()}")
    pf = dk.dense_ldlt_plain(K32, block)
    kf64, pf64 = dk.dense_ldlt(K32.double(), block), dk.dense_ldlt_plain(
        K32.double(), block)
    torch.cuda.synchronize()
    rel64, abs64 = _factor_errors(torch, kf64, pf64)
    rel32, _ = _factor_errors(torch, kf, pf)
    inertia = {"float32": [ldlt_inertia(f) for f in (kf, pf)],
               "float64": [ldlt_inertia(f) for f in (kf64, pf64)]}
    padded = pad_identity(K32, block).contiguous()
    work = torch.empty_like(padded)
    times = {"K7": _time_events(
        torch, lambda: dk.dense_ldlt_cuda(work, block),
        lambda: work.copy_(padded), 10),
        "K7_plain": _time_events(
            torch, lambda: dk.dense_ldlt_plain(K32, block), lambda: None, 1)}
    bound = _dense_bound(padded.shape[0], K32.element_size(), "float32")
    emit({"phase": "range_space_kgamma", "N": K32.shape[0],
          "Np": padded.shape[0], "block": block,
          "float64_max_rel_err": rel64, "float64_tol": DENSE_MAIN_RTOL,
          "float32_max_rel_err (reported)": rel32, "inertia": inertia,
          "ms": times, "bound": bound,
          "K7_share_of_bound": bound["bound_ms"] / times["K7"],
          "K7_launches_per_solve": out["launches"]})
    if max(rel64.values()) > DENSE_MAIN_RTOL or \
            len(set(inertia["float64"])) != 1:
        raise AssertionError("range_space: K7 and plain disagree on K_γ")
    emit({"phase": "range_space_timing",
          **_a4_timed(torch, port, "range_space", model, first, hykkt)})
    out.update(worst=max(abs64.values()), times=times, bound=bound)
    return out


def _options(port, opts):
    """Option names as the port's enums (``"BarrierUpdate.LOQO"``)."""
    out = {}
    for k, v in opts.items():
        if isinstance(v, str) and "." in v:
            enum, member = v.split(".")
            v = getattr(getattr(port, enum), member)
        out[k] = v
    return out


def _same_stats(a, b):
    return (a.objective == b.objective and a.counters == b.counters
            and a.status == b.status
            and np.array_equal(a.solution, b.solution)
            and np.array_equal(a.multipliers, b.multipliers))


# -- main ----------------------------------------------------------------------


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    port = _import_port()
    smi = phase_device(torch)
    phase_build()
    worst = phase_kernels(torch)
    worst.update(phase_fused_kernels(torch))
    worst.update(phase_solve_witness(torch))
    phase_diag_step(torch)
    solve = phase_solve(torch, port)
    batch = phase_batch(torch, port, solve["iter_per_s_median"])
    phase_matpower_solve(torch, port)
    band118 = phase_case118_band(torch, port)
    worst["K7"] = phase_dense_kernels(torch)
    worst["K7_witness"] = phase_dense_witness(torch)
    dense = phase_dense_solve(torch, port)
    main_matrix = phase_dense_main_matrix(torch, dense["K"])
    def timed(phase, *args):
        t = time.perf_counter()
        got = phase(torch, port, *args)
        emit({"phase": phase.__name__[len("phase_"):], "phase_seconds":
              time.perf_counter() - t})
        return got

    resto = timed(phase_restoration)
    timed(phase_batch_restoration, resto["single"])
    timed(phase_warm_start)
    timed(phase_checkpoint)
    timed(phase_step_options)
    timed(phase_step_options_dense)
    timed(phase_step_options_exact)
    timed(phase_batch_step_options)
    k4_wide = timed(phase_batch_step_options_exact)
    nl_path = timed(phase_nl_sparse)
    timed(phase_frontends)
    timed(phase_harness)
    unreduced = timed(phase_sparse_unreduced)
    condensed = timed(phase_sparse_condensed)
    range_space = timed(phase_range_space)

    kernels = []
    for path, i, name, key, errs, line in (
            (solve, 0, "banded_factorize_cuda", "K1", ("band", "invL", "d"), 121),
            (solve, 1, "banded_solve_cuda", "K2", ("solve",), 439),
            (batch, 0, "banded_factorize_batched_cuda", "K3", ("K3",), 345),
            (batch, 1, "banded_solve_batched_cuda", "K4", ("K4",), 620)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "madnlp_tpu_torch/csrc/banded_ldlt.cu",
            "replaces": f"madnlp_tpu/ops/pallas_banded_stream.py:{line}",
            "launches": path["launches"][i],
            "max_abs_err": max(worst[e] for e in errs),
            "ms": path["times"][key], "plain_ms": path["times"][key + "_plain"],
            "bound_ms": path["bounds"][key]["bound_ms"],
            "bound_by": path["bounds"][key]["bound_by"],
            "library_ms": None,
        })
    for i, (name, key, line) in enumerate((
            ("banded_fused_factorize_cuda", "K5", 251),
            ("banded_fused_solve_cuda", "K6", 322))):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "madnlp_tpu_torch/csrc/banded_fused.cu",
            "replaces": f"madnlp_tpu/ops/pallas_banded.py:{line}",
            # K5 / K6 are ops of their own (0 launches on every solve
            # path); this is their op path's count on the case118 band
            "launches": band118["launches"][i],
            "max_abs_err": worst[key],
            "ms": band118["times"][key],
            "plain_ms": band118["times"][key + "_plain"],
            "bound_ms": band118["bounds"][key]["bound_ms"],
            "bound_by": band118["bounds"][key]["bound_by"],
            "library_ms": None,
        })
    # the witnesses of K5 and K6 (the kernels they replaced): 0 launches on
    # every solve path (asserted); this is their op path's count on the
    # case118 band
    for i, (name, key, line) in enumerate((
            ("banded_fused_factorize_reference_cuda (K5 witness)", "K5", 251),
            ("banded_fused_solve_reference_cuda (K6 witness)", "K6", 322))):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "madnlp_tpu_torch/csrc/banded_fused.cu",
            "replaces": f"madnlp_tpu/ops/pallas_banded.py:{line}",
            "launches": band118["witness_launches"][i],
            "max_abs_err": worst[key + "_witness"],
            "ms": band118["times"][key + "_witness"],
            "plain_ms": band118["times"][key + "_plain"],
            "bound_ms": band118["bounds"][key]["bound_ms"],
            "bound_by": band118["bounds"][key]["bound_by"],
            "library_ms": None,
        })
    # the witness of K2 / K4 (their one-CTA predecessor): 0 launches on every
    # solve path
    # (asserted); this is its op path's count in the timing phases
    for path, key, line in ((solve, "K2", 597), (batch, "K4", 620)):
        kernels.append({
            "name": f"banded_solve_reference_cuda ({key} witness)",
            "route": "cuda",
            "source": "madnlp_tpu_torch/csrc/banded_ldlt.cu",
            "replaces": f"madnlp_tpu/ops/pallas_banded_stream.py:{line}",
            "launches": path["witness_launches"],
            "max_abs_err": worst[key + "_witness"],
            "ms": path["times"][key + "_witness"],
            "plain_ms": path["times"][key + "_plain"],
            "bound_ms": path["bounds"][key]["bound_ms"],
            "bound_by": path["bounds"][key]["bound_by"],
            "library_ms": None,
        })
    # K4 on the 2·max_history columns of the batched SMW payload: its
    # launches over the float32 compact L-BFGS batch, its time and bound
    # from the kernels phase
    wide32 = worst["K4_wide"]["float32"]
    kernels.append({
        "name": f"banded_solve_batched_cuda (k={WIDE_K}, SMW)",
        "route": "cuda", "source": "madnlp_tpu_torch/csrc/banded_ldlt.cu",
        "replaces": "madnlp_tpu/ops/pallas_banded_stream.py:620",
        "launches": k4_wide["float32"], "max_abs_err": wide32["abs"],
        "ms": wide32["ms"][f"k{WIDE_K}"],
        "plain_ms": wide32["ms"][f"k{WIDE_K}_plain"],
        "bound_ms": wide32["bound"]["bound_ms"],
        "bound_by": wide32["bound"]["bound_by"], "library_ms": None,
    })
    # K1 and K2 on the .nl minimal surface's band (b = 256, bw = 1, nb =
    # 40), every field from the float64 solve_nl run: its launches, the
    # error against plain on its last band, and the times and bounds there
    for i, (name, key, line) in enumerate((
            ("banded_factorize_cuda (minsurf .nl band, float64)", "K1", 314),
            ("banded_solve_cuda (minsurf .nl band, float64)", "K2", 597))):
        t, b = nl_path["times"]["float64"], nl_path["bounds"]["float64"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "madnlp_tpu_torch/csrc/banded_ldlt.cu",
            "replaces": f"madnlp_tpu/ops/pallas_banded_stream.py:{line}",
            "launches": nl_path["launches"][i],
            "max_abs_err": nl_path["worst"]["band" if key == "K1"
                                            else "solve"],
            "ms": t[key], "plain_ms": t[key + "_plain"],
            "bound_ms": b[key]["bound_ms"], "bound_by": b[key]["bound_by"],
            "library_ms": None,
        })
    # K1 and K2 on the A4 systems' bands at nb=600 (the unreduced 4-block
    # system, N = 3·nw + m; the condensed n×n SPD band), every field from
    # the float64 solve: its launches, the error against plain on its last
    # band, the times and bounds there (the condensed factor's error is
    # reported; that band holds K1 then K2 by their backward error)
    for path, system in ((unreduced, "unreduced"),
                         (condensed, "condensed, held by backward error")):
        for i, (name, key, line) in enumerate((
                ("banded_factorize_cuda", "K1", 314),
                ("banded_solve_cuda", "K2", 597))):
            t, b = path["times"]["float64"], path["bounds"]["float64"]
            kernels.append({
                "name": f"{name} ({system} band, float64)", "route": "cuda",
                "source": "madnlp_tpu_torch/csrc/banded_ldlt.cu",
                "replaces": f"madnlp_tpu/ops/pallas_banded_stream.py:{line}",
                "launches": path["launches"][i],
                "max_abs_err": path["worst"]["band" if key == "K1"
                                             else "solve"],
                "ms": t[key], "plain_ms": t[key + "_plain"],
                "bound_ms": b[key]["bound_ms"], "bound_by": b[key]["bound_by"],
                "library_ms": None,
            })
    # K7 on HYKKT's K_γ (nw × nw) of the dense nb=600 solve in float32: the
    # solve's launches, the float64 error against plain on its last K_γ
    kernels.append({
        "name": "dense_ldlt_cuda (HYKKT K_gamma, float32)", "route": "cuda",
        "source": "madnlp_tpu_torch/csrc/dense_ldlt.cu",
        "replaces": "madnlp_tpu/ops/pallas_ldlt.py:132",
        "launches": range_space["launches"],
        "max_abs_err": range_space["worst"],
        "ms": range_space["times"]["K7"],
        "plain_ms": range_space["times"]["K7_plain"],
        "bound_ms": range_space["bound"]["bound_ms"],
        "bound_by": range_space["bound"]["bound_by"], "library_ms": None,
    })
    t32, b32 = main_matrix["times"]["float32"], main_matrix["bounds"]["float32"]
    kernels.append({
        "name": "dense_ldlt_cuda", "route": "cuda",
        "source": "madnlp_tpu_torch/csrc/dense_ldlt.cu",
        "replaces": "madnlp_tpu/ops/pallas_ldlt.py:132",
        # the dense float32 solve's launches (one per factorization and one
        # for the least-squares start)
        "launches": dense["launches"],
        "max_abs_err": worst["K7"],
        "ms": t32["K7"], "plain_ms": t32["K7_plain"],
        "bound_ms": b32["bound_ms"], "bound_by": b32["bound_by"],
        "library_ms": None,
    })
    # K7's witness (its first version): 0 launches on every solve path
    # (asserted); this is its op path's count on the dense main matrix
    kernels.append({
        "name": "dense_ldlt_reference_cuda (K7 witness)", "route": "cuda",
        "source": "madnlp_tpu_torch/csrc/dense_ldlt.cu",
        "replaces": "madnlp_tpu/ops/pallas_ldlt.py:132",
        "launches": main_matrix["witness_launches"],
        "max_abs_err": worst["K7_witness"],
        "ms": t32["K7_witness"], "plain_ms": t32["K7_plain"],
        "bound_ms": b32["bound_ms"], "bound_by": b32["bound_by"],
        "library_ms": None,
    })
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
