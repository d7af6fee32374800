"""Solver entry points — port of ``madnlp_tpu/ipm/solver.py`` (``MadNLPSolver``,
``solve``, ``solve_batch``, ``batch_summary``, ``madnlp``,
``ExecutionStats`` and the Ipopt-format printers).

The iteration runs as a host loop over device tensors, one step at a time
of the three-phase state machine (regular, soft restoration, robust
restoration: :mod:`.step`); a second ``solve`` warm-starts from the last
state.  ``solve_batch`` runs B same-structure scenarios of a parametric
sparse model in lock step (:mod:`.batch`), each lane through the same
three phases.  The KKT
system follows the JAX package's presets: dense-callback models default
to the condensed dense system (Cholesky without equality rows, LDLᵀ with
them), sparse models to the sparse system, banded where the ordering
gives a narrow band and dense storage otherwise.  Entry points run on the card:
``device=None`` means ``"cuda"``, and without CUDA they raise; pass
``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from ..kkt.condensed_dense import DenseCondensedKKT
from ..kkt.dense import DenseKKT
from ..kkt.sparse import SparseCondensedKKT, SparseKKT
from ..kkt.unreduced import DenseUnreducedKKT, SparseUnreducedKKT
from ..ops.banded import kkt_interleaved_ordering
from ..utils import log as logfmt
from ..utils.options import (
    HessianApproximation,
    KKTSystem,
    LinearSolver,
    MadNLPOptions,
    PrintLevel,
)
from ..utils.status import Status, get_status_output
from . import kernels as K
from .batch import BatchKernel
from .problem import build_problem
from .state import BatchState, State, split_lanes, stack_lanes
from .step import Kernel

_ACTIVE = (int(Status.REGULAR), int(Status.RESTORE), int(Status.ROBUST))

# kkt_system -> (class for a sparse-callback model, class for a dense one);
# a sparse model under DENSE / DENSE_CONDENSED is densified first
_KKT_CLASSES = {
    KKTSystem.SPARSE: (SparseKKT, DenseKKT),
    KKTSystem.SPARSE_CONDENSED: (SparseCondensedKKT, DenseCondensedKKT),
    KKTSystem.SPARSE_UNREDUCED: (SparseUnreducedKKT, DenseUnreducedKKT),
    KKTSystem.DENSE: (DenseKKT, DenseKKT),
    KKTSystem.DENSE_CONDENSED: (DenseCondensedKKT, DenseCondensedKKT),
}


def _later(what: str):
    return NotImplementedError(f"{what} comes in a later slice of the port")


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``"cuda"``; a CUDA device without CUDA raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the solver runs on the card by default; "
            "pass device='cpu' to run on the CPU")
    return device


@dataclasses.dataclass
class ExecutionStats:
    """Result container (reference: MadNLPExecutionStats, src/IPM/utils.jl)."""

    status: Status
    solution: np.ndarray
    objective: float
    constraints: np.ndarray
    multipliers: np.ndarray
    multipliers_L: np.ndarray
    multipliers_U: np.ndarray
    iter: int
    counters: dict
    dual_feas: float
    primal_feas: float
    solve_time: float

    def __repr__(self):
        return (
            f"ExecutionStats(status={self.status.name}, objective={self.objective:.8g}, "
            f"iter={self.iter}, primal_feas={self.primal_feas:.2e}, "
            f"dual_feas={self.dual_feas:.2e}, time={self.solve_time:.3f}s)"
        )


class MadNLPSolver:
    def __init__(self, model, options: Optional[MadNLPOptions] = None,
                 device=None, **kwargs):
        self.device = resolve_device(device)
        opts = options if options is not None else MadNLPOptions.create(**kwargs)
        if opts.kkt_system == KKTSystem.SCALED_SPARSE:
            # K2.5 (ScaledSparseKKTSystem, scaled_augmented.jl) is the
            # augmented system under the analytic √Ξ congruence scaling:
            # the SPARSE system with kkt_scaling="k25"
            opts = dataclasses.replace(opts, kkt_system=KKTSystem.SPARSE,
                                       kkt_scaling="k25")
        resolved = opts.resolve(dense_callback=model.is_dense, m=model.m)
        kkt_sys = resolved.kkt_system
        if kkt_sys not in _KKT_CLASSES:
            raise _later(f"kkt_system={kkt_sys}")
        if kkt_sys in (KKTSystem.DENSE, KKTSystem.DENSE_CONDENSED) \
                and not model.is_dense:
            # dense KKT systems consume the densified sparse model
            model = model.to_dense()
        self.model = model
        self.opts = resolved
        self.prob = build_problem(model, self.opts, self.device)
        p = self.prob
        if self.opts.ldl_block_size is None:
            # 128-wide panels once the KKT system is big enough to fill
            # them, 64 below that (the JAX package's rule)
            self.opts = dataclasses.replace(
                self.opts, ldl_block_size=128 if p.nw + p.m >= 1024 else 64)
        if opts.linear_solver is None:
            # condensed systems are SPD without equality rows -> Cholesky;
            # otherwise LDLᵀ; large sparse systems with a narrow band ->
            # the banded sparse direct factorization
            lin = (LinearSolver.CHOLESKY
                   if kkt_sys in (KKTSystem.DENSE_CONDENSED,
                                  KKTSystem.SPARSE_CONDENSED)
                   and p.n_eq == 0 else LinearSolver.LDL)
            if p.is_sparse and kkt_sys in (KKTSystem.SPARSE,
                                           KKTSystem.SPARSE_CONDENSED,
                                           KKTSystem.SPARSE_UNREDUCED):
                lin = self._sparse_preset(lin)
            self.opts = dataclasses.replace(self.opts, linear_solver=lin)
        # the JAX package's class table (ipm/solver.py:153-176): a dense-
        # callback model takes dense storage for the sparse systems too
        kkt = _KKT_CLASSES[kkt_sys][not p.is_sparse](p, self.opts)
        if p.is_sparse and self.opts.hessian_approximation in (
                HessianApproximation.BFGS, HessianApproximation.DAMPED_BFGS):
            raise NotImplementedError(
                "full-memory BFGS requires dense Hessian storage; use "
                "COMPACT_LBFGS (low-rank + SMW over the sparse KKT) or the "
                "dense callback path (model.to_dense())")
        self.kernel = Kernel(p, self.opts, kkt)
        self.batch_kernel = BatchKernel(self.kernel)
        self._output_fh = None
        self.state: Optional[State] = None

    def _sparse_preset(self, fallback):
        """Bandwidth-based preset for sparse callbacks: large systems whose
        interleaved RCM ordering yields a narrow band use the banded sparse
        direct factorization; everything else keeps the dense fallback."""
        p = self.prob
        N = p.nw + p.m
        if N < 1024:
            return fallback
        hr, hc = np.asarray(p.hess_rows), np.asarray(p.hess_cols)
        perm = kkt_interleaved_ordering(hr, hc, p.jac_rows_aug, p.jac_cols_aug,
                                        p.nw, p.m)
        iperm = np.empty(N, dtype=np.int64)
        iperm[perm] = np.arange(N)
        rows = np.concatenate([p.nw + np.asarray(p.jac_rows_aug), hr])
        cols = np.concatenate([np.asarray(p.jac_cols_aug), hc])
        W = int(np.abs(iperm[rows] - iperm[cols]).max(initial=0))
        b = self.opts.resolved_banded_block(N)
        w = (-(-W // b) + 1) * b
        return LinearSolver.BANDED if w * 4 <= N else fallback

    def close(self):
        if self._output_fh is not None:
            self._output_fh.close()
            self._output_fh = None

    def _print(self, msg, level=PrintLevel.NOTICE):
        if self.opts.print_level <= level:
            print(msg)
        if self.opts.output_file:
            if self._output_fh is None:
                self._output_fh = open(self.opts.output_file, "a")
            if self.opts.file_print_level <= level:
                self._output_fh.write(msg + "\n")
                self._output_fh.flush()

    def _print_iter(self, st: State):
        """Ipopt-format iteration line from the in-step log snapshot."""
        if self.opts.print_level > PrintLevel.INFO and not self.opts.output_file:
            return
        row = st.log_row
        k = int(row[0])
        if k % 10 == 0:
            self._print(logfmt.ITER_HEADER, PrintLevel.INFO)
        self._print(
            logfmt.format_iter(
                k, row[11] != 0.0, row[1] / st.scal.obj_scale,
                row[2], row[3], row[4],
                float(np.log10(max(row[5], 1e-300))),
                row[6], row[7], int(row[8]), int(row[9]),
                K.FTYPE_CHARS.get(int(row[10]), " "),
            ),
            PrintLevel.INFO,
        )

    def _print_summary(self, st: State, stats: ExecutionStats):
        obj_scale = st.scal.obj_scale
        c = stats.counters
        cviol = float(st.c.abs().max()) if st.c.numel() else 0.0
        for line in logfmt.format_summary(
            stats.iter, st.obj_val, st.obj_val / obj_scale,
            stats.dual_feas, stats.primal_feas, cviol, st.inf_compl, obj_scale,
            c["obj_cnt"], c["grad_cnt"], c["con_cnt"], c["jac_cnt"],
            c["hess_cnt"], c["factorization_cnt"], c["backsolve_cnt"],
            init_time=getattr(self, "_init_time", float("nan")),
            total_time=stats.solve_time,
        ):
            self._print(line)

    def _print_init(self):
        if self.opts.print_level > PrintLevel.NOTICE:
            return
        p = self.prob
        model = p.model
        if model.is_dense:
            nnzj = model.m * model.n
            nnzh = model.n * (model.n + 1) // 2
        else:
            nnzj, nnzh = len(model.jac_rows), len(model.hess_rows)
        lb, ub = p.lb_mask[: p.n], p.ub_mask[: p.n]
        n_free = int((~p.fixed_mask).sum()) if p.fixed_mask.any() else p.n
        ineq = p.ineq_mask
        lcon, ucon = np.asarray(model.lcon), np.asarray(model.ucon)
        c_lb = (lcon > -np.inf) & ~(ucon < np.inf) & ineq
        c_ub = ~(lcon > -np.inf) & (ucon < np.inf) & ineq
        c_both = (lcon > -np.inf) & (ucon < np.inf) & ineq
        for line in logfmt.format_init(
            nnzj, nnzh, n_free,
            int((lb & ~ub).sum()), int((lb & ub).sum()), int((~lb & ub).sum()),
            p.n_eq, p.ns,
            int(c_lb.sum()), int(c_both.sum()), int(c_ub.sum()),
        ):
            self._print(line)

    # ------------------------------------------------------------------

    def _params(self, params) -> Optional[torch.Tensor]:
        """The model's parameters on the solver's device (None for a model
        that takes none); a parametric model defaults to its ``params``."""
        if not self.model.is_parametric:
            return None
        if params is None:
            params = self.model.params
        return torch.as_tensor(np.asarray(params, dtype=np.float64),
                               device=self.device)

    def solve(self, params=None, max_wall_time: Optional[float] = None,
              intermediate_callback=None) -> ExecutionStats:
        """Solve from the model's initial point, or warm-start a re-solve;
        ``params`` are a parametric model's parameters (default:
        ``model.params``).

        A solver whose ``state`` is set and not INITIAL — after a solve, or
        after ``utils.checkpoint.resume`` — warm-starts through
        ``Kernel.reinitialize`` (the JAX package's rule): the primal
        variables go back to x0, the duals, slacks and scaling are kept, and
        the state takes the new ``params``.  Set ``state = None`` for a
        cold solve.

        ``intermediate_callback(info: dict) -> bool`` is invoked once per
        IPM iteration; returning False aborts with USER_REQUESTED_STOP."""
        t0 = time.time()
        max_wt = max_wall_time if max_wall_time is not None else self.opts.max_wall_time
        theta = self._params(params)
        if self.state is not None and self.state.status != int(Status.INITIAL):
            st = self.kernel.reinitialize(self.state, theta)
        else:
            st = self.kernel.initialize(theta)
            self._init_time = time.time() - t0
            self._print_init()
        step = {int(Status.REGULAR): self.kernel.regular_step,
                int(Status.RESTORE): self.kernel.restore_step,
                int(Status.ROBUST): self.kernel.robust_step}
        status = st.status
        while status in _ACTIVE:
            if intermediate_callback is not None:
                info = {
                    "iter": st.k,
                    "objective": st.obj_val * self.prob.sign / st.scal.obj_scale,
                    "inf_pr": st.inf_pr,
                    "inf_du": st.inf_du,
                    "mu": st.mu,
                }
                if intermediate_callback(info) is False:
                    st.status = int(Status.USER_REQUESTED_STOP)
                    break
            st = step[status](st)
            self._print_iter(st)
            status = st.status
            if time.time() - t0 > max_wt and status in _ACTIVE:
                status = st.status = int(Status.MAXIMUM_WALLTIME_EXCEEDED)
        self.state = st
        stats = self._stats(st, time.time() - t0)
        if st.status >= int(Status.SOLVE_SUCCEEDED):
            self._print_summary(st, stats)
        self._print(
            f"EXIT: {get_status_output(stats.status, self.opts.tol, self.opts.acceptable_tol)}"
        )
        return stats

    def solve_jitted(self, params=None) -> ExecutionStats:
        """The whole solve in one call, from the model's initial point (the
        JAX package's one-XLA-computation solve): a cold :meth:`solve`
        without its log and its wall-time limit, so its ``ExecutionStats``
        equal a cold ``solve()``'s bit for bit.  Here the steps are still
        host-driven; capturing them (CUDA graphs) is perf item P3 of the
        ROADMAP."""
        opts = self.opts
        self.opts = dataclasses.replace(opts, print_level=PrintLevel.ERROR,
                                        output_file="")
        try:
            self.state = None
            return self.solve(params, max_wall_time=math.inf)
        finally:
            self.opts = opts

    def solve_batch(self, params_batch, sharding=None, chunk_size="auto",
                    probe_iters="auto") -> BatchState:
        """Solve B same-structure scenarios of a parametric model, one per
        entry of ``params_batch`` (leading axis B), in lock step: every
        factorization runs through the batched band kernel K3 and every
        backsolve through K4 (their plain versions on the CPU).

        ``chunk_size``: solve the batch in chunks of this many lanes, one
        after the other, so that a straggler stalls only its own chunk.
        ``"auto"`` keeps a batch of at most 16 in one bulk run and
        otherwise takes the largest divisor of B that is at most 16;
        ``None`` forces one bulk run.  ``probe_iters``: when chunking, first
        run this many masked steps on the whole batch, sort the lanes by
        their remaining error (inf_pr + inf_du + inf_compl + μ) and chunk
        in that order (``"auto"`` = 3 when chunking, 0 disables).

        Each lane runs the single solve's three-phase state machine: a
        lane that needs soft or robust restoration (an overloaded scenario)
        takes its restoration steps inside the batch, while a finished lane
        waits unchanged (:meth:`.batch.BatchKernel.step`).  Every step
        option of the single solve runs per lane: the adaptive barriers,
        the inertia-free and inertia-ignoring corrections, compact L-BFGS
        (its SMW payload one K4 launch of 2p columns per factorization),
        GMRES refinement and the K2.5 scaling.

        Returns the final :class:`BatchState` in the original lane order;
        summary arrays via :func:`batch_summary`.  ``sharding``, dense KKT
        storage and the condensed and unreduced systems raise
        NotImplementedError (later slices of the port)."""
        if sharding is not None:
            raise _later("sharding= (a multi-device solve_batch)")
        kkt = self.kernel.kkt
        if type(kkt) is not SparseKKT or not kkt.banded:
            raise _later(f"solve_batch on kkt_system="
                         f"{self.opts.kkt_system.name} with "
                         f"linear_solver={self.opts.linear_solver.name} "
                         f"(A4b: dense KKT storage, a dense-callback model, "
                         f"the condensed and unreduced systems)")
        theta = torch.as_tensor(np.asarray(params_batch, dtype=np.float64),
                                device=self.device)
        B = int(theta.shape[0])
        if chunk_size == "auto":
            chunk_size = None
            if B > 16:
                chunk_size = max(c for c in range(1, 17) if B % c == 0)
                if chunk_size == 1:
                    chunk_size = None
        if probe_iters == "auto":
            probe_iters = 3 if chunk_size is not None else 0
        if chunk_size is not None and B % chunk_size:
            raise ValueError(f"batch size {B} is not a multiple of "
                             f"chunk_size {chunk_size}")
        st = self.batch_kernel.initialize(theta)
        if chunk_size is None:
            return self._run_lanes(st)
        order = np.arange(B)
        if probe_iters:
            st = self._run_lanes(st, steps=probe_iters)
            score = st.inf_pr + st.inf_du + st.inf_compl + st.mu
            order = np.argsort(score, kind="stable")
            st = st.take(order)
        st = stack_lanes([self._run_lanes(c)
                          for c in split_lanes(st, chunk_size)])
        return st.take(np.argsort(order)) if probe_iters else st

    def _run_lanes(self, st: BatchState, steps=None) -> BatchState:
        """Masked steps of the three-phase state machine until no lane is
        active (at most ``steps``)."""
        done = 0
        while np.isin(st.status, _ACTIVE).any() and (steps is None
                                                      or done < steps):
            st = self.batch_kernel.step(st)
            done += 1
        return st

    def _stats(self, st: State, solve_time: float) -> ExecutionStats:
        p = self.prob
        model = p.model
        x_t = st.x[: p.n]
        obj_scale = st.scal.obj_scale
        con_scale = st.scal.con_scale.cpu().numpy()
        x = x_t.cpu().numpy()
        y = st.y.cpu().numpy() * con_scale * (p.sign / obj_scale)
        zl = st.zl[: p.n].cpu().numpy() / obj_scale
        zu = st.zu[: p.n].cpu().numpy() / obj_scale
        cons = (p._call(model.cons, x_t, theta=st.theta).cpu().numpy()
                if p.m else np.zeros(0))
        if p.fixed_mask.any():
            # bound multipliers of fixed variables (update_z!,
            # nlpmodels.jl:1075-1087): the gradient of the Lagrangian
            with torch.enable_grad():
                xx = x_t.detach().requires_grad_(True)
                g = p._call(model.grad, xx, theta=st.theta)
                if p.m:
                    (jt,) = torch.autograd.grad(
                        p._call(model.cons, xx, theta=st.theta), xx,
                        grad_outputs=st.y * st.scal.con_scale)
                    g = g + jt
            g = g.detach().cpu().numpy()
            fm = p.fixed_mask
            zl[fm] = np.maximum(0.0, p.sign * g[fm])
            zu[fm] = np.maximum(0.0, -p.sign * g[fm])
        counters = {
            "k": st.k,
            "obj_cnt": st.obj_cnt,
            "grad_cnt": st.grad_cnt,
            "con_cnt": st.con_cnt,
            "jac_cnt": st.jac_cnt,
            "hess_cnt": st.hess_cnt,
            "factorization_cnt": st.factorization_cnt,
            "backsolve_cnt": st.backsolve_cnt,
            "t": st.t_cnt,
        }
        return ExecutionStats(
            status=Status(st.status),
            solution=x,
            objective=p.sign * st.obj_val / obj_scale,
            constraints=cons,
            multipliers=y,
            multipliers_L=zl,
            multipliers_U=zu,
            iter=st.k,
            counters=counters,
            dual_feas=st.inf_du,
            primal_feas=st.inf_pr,
            solve_time=solve_time,
        )


_COUNTERS = ("k", "obj_cnt", "grad_cnt", "con_cnt", "jac_cnt", "hess_cnt",
             "factorization_cnt", "backsolve_cnt")


def batch_summary(prob, st: BatchState) -> dict:
    """Summary arrays of a batched solve (leading lane axis), with the JAX
    package's keys (``status``, ``iter``, ``objective``, ``inf_pr``,
    ``inf_du``, ``x``) plus ``counters``: the per-lane counters under
    ``ExecutionStats.counters``' names."""
    obj_scale = st.scal.obj_scale.cpu().numpy()
    counters = {c: getattr(st, c).copy() for c in _COUNTERS}
    counters["t"] = st.t_cnt.copy()
    return {
        "status": st.status.copy(),
        "iter": st.k.copy(),
        "objective": prob.sign * st.obj_val / obj_scale,
        "inf_pr": st.inf_pr.copy(),
        "inf_du": st.inf_du.copy(),
        "x": st.x[:, : prob.n].cpu().numpy(),
        "counters": counters,
    }


def madnlp(model, device=None, **kwargs) -> ExecutionStats:
    """Build a solver and run it — mirror of ``madnlp(nlp; kwargs...)``;
    ``params=`` passes a parametric model's parameters."""
    params = kwargs.pop("params", None)
    solver = MadNLPSolver(model, device=device, **kwargs)
    try:
        return solver.solve(params=params)
    finally:
        solver.close()
