#!/usr/bin/env python3
"""The one-ulp spread of the restoration solve's counters.

``opf.build_sparse(nb=NB, seed=0, parametric=True)`` at load scale THETA
(banded KKT, μ-scaled Richardson, the flagship's options), which is
infeasible and takes the solver through soft and robust restoration,
solved once from the model's initial point and once per seed from that
point with every entry moved by at most one float64 ulp (seeded), as
``tests/test_torch_refine_f64.py`` does for the flagship.  Each solve runs
the hosted three-phase loop and counts its soft (RESTORE) and robust
(ROBUST) steps; its line carries the phase of every step (``g`` regular,
``s`` soft, ``r`` robust), so two packages' solves can be compared step
for step.  One JSON line per solve, then the spread: the range of every
counter over the solves.

    python3 tools/restoration_spread.py port --device cuda --dtype float32
    python3 tools/restoration_spread.py batch --device cuda --dtype float32
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/restoration_spread.py jax \\
        --dtype float64 --backend auto

``port`` runs the PyTorch port (on ``--device``); ``batch`` runs the
port's ``solve_batch`` of the load scales ``--lanes`` and THETA, driven
step by step through ``BatchKernel.step``, and reports the THETA lane (the
last), every lane's initial point moved by the seed's ulps; ``jax`` runs
the JAX package on the CPU (``--backend``: its ``banded_backend``, ``auto``
or ``pallas_interpret``, the TPU kernel's factorization order in interpret
mode).  ``--seeds N`` runs seeds 1..N after the unperturbed solve,
``--first S`` starts at seed S (to split a study over processes).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EPS = np.finfo(np.float64).eps
# the counters of a solve, in the order of a result line
KEYS = ("iter", "factorization_cnt", "backsolve_cnt", "restore", "robust",
        "steps")


def ulp(a, seed):
    """``a`` with every entry moved by at most one ulp (seeded)."""
    rng = np.random.default_rng(seed)
    return a * (1.0 + EPS * rng.integers(-1, 2, np.shape(a)))


def _trace(status_of, steps, st):
    """Run the three-phase loop from ``st`` (``steps`` maps REGULAR,
    RESTORE and ROBUST to their step functions, in that order); returns
    the final state and the phase of every step."""
    active = tuple(steps)
    phases = []
    while status_of(st) in active:
        s = status_of(st)
        phases.append("gsr"[active.index(s)])
        st = steps[s](st)
    return st, "".join(phases)


def run_port(args, seed):
    import torch

    import madnlp_tpu_torch as T
    from madnlp_tpu_torch.models.instances import opf
    from madnlp_tpu_torch.utils.status import Status as S

    model = opf.build_sparse(nb=args.nb, seed=0, parametric=True)
    if seed:
        model.x0 = ulp(model.x0, seed)
    solver = T.MadNLPSolver(
        model, device=args.device, linear_solver=T.LinearSolver.BANDED,
        dtype=args.dtype, richardson=T.RichardsonOptions(mu_scaled=True),
        print_level=T.PrintLevel.ERROR)
    k = solver.kernel
    t = time.perf_counter()
    st = k.initialize(solver._params(args.theta))
    st, phases = _trace(
        lambda s: s.status,
        {int(S.REGULAR): k.regular_step, int(S.RESTORE): k.restore_step,
         int(S.ROBUST): k.robust_step}, st)
    if args.device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return solver._stats(st, wall), phases


def run_batch(args, seed):
    import types

    import torch

    import madnlp_tpu_torch as T
    from madnlp_tpu_torch.models.instances import opf
    from madnlp_tpu_torch.utils.status import Status as S

    model = opf.build_sparse(nb=args.nb, seed=0, parametric=True)
    if seed:
        model.x0 = ulp(model.x0, seed)
    solver = T.MadNLPSolver(
        model, device=args.device, linear_solver=T.LinearSolver.BANDED,
        dtype=args.dtype, richardson=T.RichardsonOptions(mu_scaled=True),
        print_level=T.PrintLevel.ERROR)
    bk = solver.batch_kernel
    scales = [float(v) for v in args.lanes.split(",")] + [args.theta]
    t = time.perf_counter()
    st = bk.initialize(torch.tensor(scales, dtype=torch.float64,
                                    device=solver.device))
    active = (int(S.REGULAR), int(S.RESTORE), int(S.ROBUST))
    st, phases = _trace(lambda s: int(s.status[-1]),
                        dict.fromkeys(active, bk.step), st)
    while np.isin(st.status, active).any():
        st = bk.step(st)     # lanes that outlast the THETA lane
    if args.device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    summ = T.batch_summary(solver.prob, st)
    return types.SimpleNamespace(
        status=S(int(summ["status"][-1])), iter=int(summ["iter"][-1]),
        counters={k: int(v[-1]) for k, v in summ["counters"].items()},
        primal_feas=float(summ["inf_pr"][-1]),
        objective=float(summ["objective"][-1]), solve_time=wall), phases


def run_jax(args, seed):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import madnlp_tpu as J
    from madnlp_tpu.models.instances import opf
    from madnlp_tpu.utils.options import RichardsonOptions
    from madnlp_tpu.utils.status import Status as S

    model = opf.build_sparse(nb=args.nb, seed=0, parametric=True)
    if seed:
        model.x0 = ulp(model.x0, seed)
    solver = J.MadNLPSolver(
        model, linear_solver=J.LinearSolver.BANDED, dtype=args.dtype,
        richardson=RichardsonOptions(mu_scaled=True),
        banded_backend=args.backend, print_level=J.PrintLevel.ERROR)
    t = time.perf_counter()
    st = solver._init_fn(np.asarray(args.theta))
    st, phases = _trace(
        lambda s: int(s.status),
        {int(S.REGULAR): solver._regular, int(S.RESTORE): solver._restore,
         int(S.ROBUST): solver._robust}, st)
    wall = time.perf_counter() - t
    return solver._stats(st, wall), phases


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("package", choices=("port", "batch", "jax"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--nb", type=int, default=600)
    ap.add_argument("--theta", type=float, default=2.0)
    ap.add_argument("--lanes", default="1.0,1.04")
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--first", type=int, default=0)
    args = ap.parse_args()
    run = {"port": run_port, "batch": run_batch, "jax": run_jax}[
        args.package]
    rows = []
    for seed in range(args.first, args.seeds + 1):
        stats, phases = run(args, seed)
        c = stats.counters
        row = {"seed": seed, "status": stats.status.name, "iter": stats.iter,
               "factorization_cnt": c["factorization_cnt"],
               "backsolve_cnt": c["backsolve_cnt"],
               "restore": phases.count("s"), "robust": phases.count("r"),
               "steps": len(phases), "inf_pr": stats.primal_feas,
               "objective": stats.objective, "wall_s": stats.solve_time,
               "phases": phases}
        rows.append(row)
        print(json.dumps({"package": args.package, "dtype": args.dtype,
                          "backend": args.backend, **row}), flush=True)
    print(json.dumps({
        "package": args.package, "dtype": args.dtype, "backend": args.backend,
        "nb": args.nb, "theta": args.theta, "solves": len(rows),
        "statuses": sorted({r["status"] for r in rows}),
        "spread": {k: (min(r[k] for r in rows), max(r[k] for r in rows))
                   for k in KEYS}}), flush=True)


if __name__ == "__main__":
    main()
