#!/usr/bin/env python3
"""One-ulp twin studies of both packages' solves, and the step where two
solves part.

Where the port and the JAX package count differently on the same model
and options, this shows whether rounding explains it: a package solves
once as it is (seed 0) and once per seed from a copy moved by at most one
ulp, and the counters of every run are printed, one JSON line each, then
each package's spread (the range of every counter, the set of statuses).

    python3 tools/spread.py CASE [--pkg port|jax|both|batch] [--option OPT]
        [--dtype float64|float32] [--device cpu|cuda] [--nb NB]
        [--first S] [--seeds N] [--max-iter K]

Every case is one row of ``CASES``: its model (each package's own) with
its fixed options, and what a seed moves.

* ``flagship`` — ``opf.build_sparse(nb=NB, seed=0)`` on the banded KKT
  with μ-scaled Richardson, or with a dense option (``dbfgs``, ``dlbfgs``,
  ``gmres``, ``lu``) ``opf.build(nb=NB, seed=0)`` with default options,
  under ``--option`` (``STEP_OPTIONS``); the seed moves x0.
* ``inertia`` — ``opf.build_sparse(nb=NB, seed=0)`` (NB 14 by default)
  with ``linear_solver=BANDED`` and otherwise default options, under
  ``--option free|ignore`` (tests/test_torch_step_options_linear.py);
  the seed moves x0.
* ``restoration`` — the parametric flagship at load scale ``--theta``
  (infeasible at 2.0): the hosted three-phase loop, each step's phase
  (``g`` regular, ``s`` soft, ``r`` robust restoration) on the line.
  ``--pkg batch``: the port's ``solve_batch`` of ``--lanes`` and THETA
  driven through ``BatchKernel.step``, the THETA lane reported.
* ``dense32`` — the dense flagship (nb=600) in float32, every factorized
  matrix multiplied by 1 + 1.2e-7·(E + Eᵀ)/2 with E standard normal from
  a torch generator on the device seeded S − 1 (the port only).
* ``qr`` — ``hs15.build()`` with ``linear_solver=QR`` (AUTO takes the
  inertia-free correction); x0 is zero, so each factorized matrix is
  moved instead, by 1 + eps·(E + Eᵀ)/2 with E from numpy's generator
  (the same noise in both packages).
* ``rosenbrock`` — compact L-BFGS on the 10-variable Rosenbrock function
  from x0 = -1.2 (tests/test_quasi_newton.py); the seed moves x0.
* ``condensed`` — ``opf.build_sparse(nb=NB, seed=0)`` (NB 14 by
  default) under ``kkt_system=SPARSE_CONDENSED``, ``linear_solver=
  BANDED`` and ``tol=1e-6``; ``unreduced`` the same model under
  ``SPARSE_UNREDUCED`` + ``BANDED``; ``range_space`` the dense
  ``opf.build(nb=NB, seed=0)`` under ``DENSE`` + ``HYKKT`` with
  ``hykkt_backend="ldl"`` (``--option bchol``: ``BLOCK_CHOLESKY``); the
  seed moves x0 (chip_smoke.py's ``sparse_condensed``,
  ``sparse_unreduced`` and ``range_space`` phases).
* ``minsurf`` — the COPS minimal surface ``minsurf_nl(NB)`` (NB 100 by
  default: n = 10,201) read from its ``.nl`` file by each package's
  template compiler, default options (the banded KKT); the seed moves
  x0 (chip_smoke.py's ``nl_sparse`` phase).

``--pkg jax`` runs the JAX package on the CPU (a float32 banded run
through the Pallas kernels in interpret mode, ``--backend``
``pallas_interpret``, as ``chip_smoke.py``'s pins); ``port`` the PyTorch
port on ``--device`` (it imports no JAX, so it runs on the card);
``both`` the two side by side on the CPU.

``lanes``: the cold single solves of the parametric flagship
(``opf.build_sparse(nb=NB, seed=0, parametric=True)``, the banded
options) at the load scales ``LANE_SCALES[i]`` for each ``i`` of
``--indices`` (the 16 lanes of ``chip_smoke.py``'s batch), under
``--option``, one solver for every scale (``state = None`` before each
solve: one compile of the JAX package's steps), one JSON line each; the
pins of ``chip_smoke.py``'s ``batch_step_options`` phases.  ``--pkg
batch``: the port's ``solve_batch`` of all 16 scales, the lanes of
``--indices`` reported.  Seeds ``--first`` .. ``--seeds`` move x0 by at
most one ulp (seed 0 as it is), then each lane's spread is printed.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/spread.py lanes --pkg jax \
        --option qf --indices 0,5,10,15

``lockstep`` (not a spread): the JAX package and the port solve the
flagship under ``--option`` on the CPU from the same point, one IPM step
at a time.  After every step it prints the free-running distance of the
two iterates and the one-step distance: the port's step taken from the
JAX package's own state, carried across by ``state_from_arrays``,
against the JAX package's next state.  A one-step distance at rounding
level (1e-13 or less) at every step says the port takes the reference's
step, and that the free-running distance grows by amplification; a step
whose one-step distance jumps is a fault of that step.  ``--seed S``
runs the JAX package against its own one-ulp twin (seed S) instead, and
adds the yardstick of the one-step distance: the JAX package's step from
its own state with x moved by at most one ulp, against its step from the
state as it is.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/spread.py lockstep \\
        --option lbfgs --nb 600

Examples:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/spread.py flagship \\
        --pkg jax --option qf --dtype float64 --first 0 --seeds 0
    python3 tools/spread.py flagship --pkg port --device cuda \\
        --option lbfgs --dtype float32 --first 1 --seeds 6
    python3 tools/spread.py restoration --pkg batch --device cuda \\
        --dtype float32
    python3 tools/spread.py dense32 --device cuda --seeds 11
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/spread.py inertia \\
        --pkg both --option free
"""

import argparse
import json
import os
import sys
import time
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EPS = np.finfo(np.float64).eps
KEYS = ("iter", "factorization_cnt", "backsolve_cnt")
# chip_smoke.py's BATCH_SCALES: the load scales of its 16-lane batch
LANE_SCALES = np.linspace(0.92, 1.08, 16)


def ulp(a, seed):
    """``a`` with every entry moved by at most one float64 ulp (seeded)."""
    rng = np.random.default_rng(seed)
    return a * (1.0 + EPS * rng.integers(-1, 2, np.shape(a)))


# The step options by short name (enum members by name).  The four dense
# ones run on the dense flagship, the others on the banded one.
STEP_OPTIONS = {
    "default": {},
    "qf": {"barrier": "BarrierUpdate.QUALITY_FUNCTION"},
    "loqo": {"barrier": "BarrierUpdate.LOQO"},
    "free": {"inertia_correction_method": "InertiaCorrection.FREE"},
    "ignore": {"inertia_correction_method": "InertiaCorrection.IGNORE"},
    "lbfgs": {"hessian_approximation": "HessianApproximation.COMPACT_LBFGS"},
    "k25": {"kkt_scaling": "k25"},
    "dbfgs": {"hessian_approximation": "HessianApproximation.DAMPED_BFGS"},
    "dlbfgs": {"hessian_approximation": "HessianApproximation.COMPACT_LBFGS"},
    "gmres": {"iterator": "gmres"},
    "lu": {"linear_solver": "LinearSolver.LU"},
    "bchol": {"linear_solver": "LinearSolver.BLOCK_CHOLESKY"},
}
DENSE = ("dbfgs", "dlbfgs", "gmres", "lu")


def _package(name):
    """The package, its instance modules and its Richardson options."""
    if name == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import madnlp_tpu as pkg
        from madnlp_tpu.models.instances import hs15, opf
        from madnlp_tpu.ops import dense_solvers
        from madnlp_tpu.utils.options import RichardsonOptions
    else:
        import torch
        torch.set_num_threads(1)
        import madnlp_tpu_torch as pkg
        from madnlp_tpu_torch.models.instances import hs15, opf
        from madnlp_tpu_torch.ops import dense_solvers
        RichardsonOptions = pkg.RichardsonOptions
    return types.SimpleNamespace(name=name, pkg=pkg, opf=opf, hs15=hs15,
                                 ds=dense_solvers, R=RichardsonOptions)


def _options(P, option, a, banded):
    """The solver options of ``option`` in package ``P``, with the
    flagship's banded options where ``banded``."""
    pkg = P.pkg
    out = {"dtype": a.dtype, "print_level": pkg.PrintLevel.ERROR}
    if a.max_iter:
        out["max_iter"] = a.max_iter
    for k, v in STEP_OPTIONS[option].items():
        if "." in v:
            enum, member = v.split(".")
            v = getattr(getattr(pkg, enum), member)
        out[k] = v
    if banded:
        out.setdefault("linear_solver", pkg.LinearSolver.BANDED)
        out["richardson"] = P.R(mu_scaled=True)
        if P.name == "jax":
            out["banded_backend"] = a.backend or (
                "pallas_interpret" if a.dtype == "float32" else "auto")
    if P.name != "jax":
        out["device"] = a.device
    return out


def _trace(status_of, steps, st):
    """The three-phase loop from ``st`` (``steps`` maps REGULAR, RESTORE
    and ROBUST to their step functions, in that order); the final state
    and the phase of every step."""
    active = tuple(steps)
    phases = []
    while status_of(st) in active:
        s = status_of(st)
        phases.append("gsr"[active.index(s)])
        st = steps[s](st)
    return st, "".join(phases)


def _matrix_noise(P, seed, scale, torch_generator=False):
    """Patch ``P``'s dense ``factorize`` to multiply every matrix by
    1 + scale·(E + Eᵀ)/2; returns the undo."""
    factorize = P.ds.factorize
    if torch_generator:
        import torch
        gen = torch.Generator(device="cuda").manual_seed(seed - 1)

    def perturbed(K, *args, **kwargs):
        if torch_generator:
            E = torch.randn(K.shape, generator=gen, dtype=torch.float64,
                            device=K.device)
            K = (K * (1.0 + scale * (E + E.T) / 2.0)).to(K.dtype)
        else:
            E = np.random.default_rng(seed).standard_normal(tuple(K.shape))
            noise = 1.0 + scale * (E + E.T) / 2.0
            if P.name == "jax":
                import jax.numpy as jnp
                K = K * jnp.asarray(noise)
            else:
                import torch
                K = K * torch.as_tensor(noise, dtype=K.dtype, device=K.device)
        return factorize(K, *args, **kwargs)

    P.ds.factorize = perturbed
    return lambda: setattr(P.ds, "factorize", factorize)


def _solve(P, model, opts, a, trace=False, theta=None):
    """One solve; ``trace``: the hosted three-phase loop, with phases."""
    pkg = P.pkg
    if not trace:
        t = time.time()
        return pkg.madnlp(model, **opts), time.time() - t, None
    S = pkg.Status
    solver = pkg.MadNLPSolver(model, **opts)
    t = time.time()
    if P.name == "jax":
        st = solver._init_fn(np.asarray(theta))
        steps = {int(S.REGULAR): solver._regular,
                 int(S.RESTORE): solver._restore,
                 int(S.ROBUST): solver._robust}
        st, phases = _trace(lambda s: int(s.status), steps, st)
    else:
        k = solver.kernel
        st = k.initialize(solver._params(theta))
        st, phases = _trace(
            lambda s: s.status,
            {int(S.REGULAR): k.regular_step, int(S.RESTORE): k.restore_step,
             int(S.ROBUST): k.robust_step}, st)
        _sync(a)
    wall = time.time() - t
    return solver._stats(st, wall), wall, phases


def _sync(a):
    if a.device != "cpu":
        import torch
        torch.cuda.synchronize()


def _batch(P, model, opts, a):
    """The THETA lane of the port's ``solve_batch`` of ``--lanes`` and
    THETA, stepped through ``BatchKernel.step``."""
    import torch

    pkg = P.pkg
    S = pkg.Status
    solver = pkg.MadNLPSolver(model, **opts)
    bk = solver.batch_kernel
    scales = [float(v) for v in a.lanes.split(",")] + [a.theta]
    t = time.time()
    st = bk.initialize(torch.tensor(scales, dtype=torch.float64,
                                    device=solver.device))
    active = (int(S.REGULAR), int(S.RESTORE), int(S.ROBUST))
    st, phases = _trace(lambda s: int(s.status[-1]),
                        dict.fromkeys(active, bk.step), st)
    while np.isin(st.status, active).any():
        st = bk.step(st)     # lanes that outlast the THETA lane
    _sync(a)
    wall = time.time() - t
    summ = pkg.batch_summary(solver.prob, st)
    return types.SimpleNamespace(
        status=S(int(summ["status"][-1])), iter=int(summ["iter"][-1]),
        counters={k: int(v[-1]) for k, v in summ["counters"].items()},
        primal_feas=float(summ["inf_pr"][-1]),
        objective=float(summ["objective"][-1])), wall, phases


def _rosenbrock(P, x0):
    if P.name == "jax":
        import jax.numpy as xp
    else:
        import torch as xp
    return P.pkg.create_model(
        obj=lambda x: xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                             + (1 - x[:-1]) ** 2), n=10, x0=x0)


def _flagship(P, a):
    dense = a.option in DENSE
    model = (P.opf.build if dense else P.opf.build_sparse)(
        nb=a.nb or 600, seed=0)
    return model, _options(P, a.option, a, banded=not dense)


def _inertia(P, a):
    opts = _options(P, a.option, a, banded=False)
    opts["linear_solver"] = P.pkg.LinearSolver.BANDED
    return P.opf.build_sparse(nb=a.nb or 14, seed=0), opts


def _restoration(P, a):
    return (P.opf.build_sparse(nb=a.nb or 600, seed=0, parametric=True),
            _options(P, "default", a, banded=True))


def _dense32(P, a):
    opts = _options(P, "default", a, banded=False)
    opts["dtype"] = "float32"
    return P.opf.build(nb=a.nb or 600, seed=0), opts


def _qr(P, a):
    opts = _options(P, "default", a, banded=False)
    opts["linear_solver"] = P.pkg.LinearSolver.QR
    return P.hs15.build(), opts


def _rosenbrock_case(P, a):
    opts = _options(P, "lbfgs", a, banded=False)
    opts["max_iter"] = a.max_iter or 1000
    return _rosenbrock(P, np.full(10, -1.2)), opts


def _minsurf(P, a):
    """``minsurf_nl(NX)`` (``madnlp_tpu_torch/testing.py``; NX = --nb, 100
    by default) through each package's ``.nl`` template compiler, default
    options (the banded KKT at NX = 100, K1/K2 on the card)."""
    import importlib
    import tempfile

    from madnlp_tpu_torch.testing import minsurf_nl

    path = os.path.join(tempfile.mkdtemp(), "minsurf.nl")
    with open(path, "w") as f:
        f.write(minsurf_nl(a.nb or 100))
    nl = importlib.import_module(P.pkg.__name__ + ".models.nl")
    opts = _options(P, "default", a, banded=False)
    if P.name == "jax":
        opts["banded_backend"] = a.backend or (
            "pallas_interpret" if a.dtype == "float32" else "auto")
    return nl.read_nl(path, sparse=True), opts


def _a4_options(P, a, **extra):
    """Default options of package ``P`` with the A4 case's ``extra``
    (enum members by name, as in ``STEP_OPTIONS``)."""
    opts = _options(P, "default", a, banded=False)
    for k, v in extra.items():
        if isinstance(v, str) and "." in v:
            enum, member = v.split(".")
            v = getattr(getattr(P.pkg, enum), member)
        opts[k] = v
    return opts


def _condensed(P, a):
    return P.opf.build_sparse(nb=a.nb or 14, seed=0), _a4_options(
        P, a, kkt_system="KKTSystem.SPARSE_CONDENSED",
        linear_solver="LinearSolver.BANDED", tol=1e-6)


def _unreduced(P, a):
    return P.opf.build_sparse(nb=a.nb or 14, seed=0), _a4_options(
        P, a, kkt_system="KKTSystem.SPARSE_UNREDUCED",
        linear_solver="LinearSolver.BANDED")


def _range_space(P, a):
    extra = {"kkt_system": "KKTSystem.DENSE"}
    if a.option == "bchol":
        extra["linear_solver"] = "LinearSolver.BLOCK_CHOLESKY"
    else:
        extra.update(linear_solver="LinearSolver.HYKKT", hykkt_backend="ldl")
    return P.opf.build(nb=a.nb or 14, seed=0), _a4_options(P, a, **extra)


def _move_x0(P, model, seed):
    model.x0 = ulp(model.x0, seed)
    return model, None


def _move_rosenbrock_x0(P, model, seed):
    return _rosenbrock(P, ulp(np.full(10, -1.2), seed)), None


# The cases: (model and options of package P, what a seed moves: it
# returns the model and an undo for a patch or None).
CASES = {
    "flagship": (_flagship, _move_x0),
    "inertia": (_inertia, _move_x0),
    "restoration": (_restoration, _move_x0),
    "dense32": (_dense32, lambda P, model, seed: (
        model, _matrix_noise(P, seed, 1.2e-7, torch_generator=True))),
    "qr": (_qr, lambda P, model, seed: (model, _matrix_noise(P, seed, EPS))),
    "rosenbrock": (_rosenbrock_case, _move_rosenbrock_x0),
    "minsurf": (_minsurf, _move_x0),
    "condensed": (_condensed, _move_x0),
    "unreduced": (_unreduced, _move_x0),
    "range_space": (_range_space, _move_x0),
}


def run(case, P, a, seed):
    """One run of ``case`` in package ``P`` at ``seed``: its result row."""
    build, move = CASES[case]
    model, opts = build(P, a)
    undo, phases = None, None
    if seed:
        model, undo = move(P, model, seed)
    try:
        if a.pkg == "batch":
            stats, wall, phases = _batch(P, model, opts, a)
        else:
            stats, wall, phases = _solve(P, model, opts, a,
                                         trace=case == "restoration",
                                         theta=a.theta)
    finally:
        if undo:
            undo()
    c = stats.counters
    row = {"case": case, "pkg": a.pkg if a.pkg == "batch" else P.name,
           "option": a.option, "dtype": opts["dtype"], "nb": a.nb,
           "seed": seed, "status": stats.status.name, "iter": stats.iter,
           "factorization_cnt": c["factorization_cnt"],
           "backsolve_cnt": c["backsolve_cnt"],
           "objective": float(stats.objective), "seconds": wall}
    if phases is not None:
        row.update(restore=phases.count("s"), robust=phases.count("r"),
                   steps=len(phases), inf_pr=float(stats.primal_feas),
                   phases=phases)
    return row


def spread(a):
    names = {"both": ("jax", "port"), "batch": ("port",)}.get(a.pkg, (a.pkg,))
    packages = [_package(n) for n in names]
    rows = {}
    for seed in range(a.first, a.seeds + 1):
        for P in packages:
            row = run(a.case, P, a, seed)
            rows.setdefault(row["pkg"], []).append(row)
            print(json.dumps(row), flush=True)
    keys = KEYS + (("restore", "robust", "steps") if a.case == "restoration"
                   else ())
    for name, rs in rows.items():
        print(json.dumps({
            "case": a.case, "pkg": name, "option": a.option, "runs": len(rs),
            "statuses": sorted({r["status"] for r in rs}),
            "spread": {k: (min(r[k] for r in rs), max(r[k] for r in rs))
                       for k in keys},
            "objective": (min(r["objective"] for r in rs),
                          max(r["objective"] for r in rs))}), flush=True)


def jax_state_arrays(st):
    """The leaves of a JAX ``State`` as numpy, under the keys
    ``state_from_arrays`` reads (the persisted context left out)."""
    import jax.numpy as jnp

    out = {}

    def put(prefix, v):
        for name, x in zip(v._fields, v):
            if hasattr(x, "_fields"):
                put(f"{prefix}{name}.", x)
            else:
                out[f"{prefix}{name}"] = np.asarray(x)

    for name, v in zip(st._fields, st):
        if name == "ctx":
            continue
        if hasattr(v, "_fields"):
            put(f"{name}.", v)
        elif isinstance(v, (jnp.ndarray, np.ndarray)):
            out[name] = np.asarray(v)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    with np.errstate(invalid="ignore"):
        diff = np.where(a == b, 0.0, np.abs(a - b))
    scale = np.max(np.abs(b[np.isfinite(b)]), initial=0.0)
    return float(np.max(diff, initial=0.0) / max(scale, 1e-300))


def _lane_rows(P, a, seed, indices):
    """One row per lane of ``indices`` (see ``lanes``) at ``seed``."""
    pkg = P.pkg
    model = P.opf.build_sparse(nb=a.nb or 600, seed=0, parametric=True)
    if seed:
        model.x0 = ulp(model.x0, seed)
    solver = pkg.MadNLPSolver(model, **_options(P, a.option, a, banded=True))
    if a.pkg == "batch":
        t = time.time()
        summ = pkg.batch_summary(solver.prob, solver.solve_batch(LANE_SCALES))
        _sync(a)
        wall = time.time() - t
        c = summ["counters"]
        results = {i: (pkg.Status(int(summ["status"][i])).name,
                       int(summ["iter"][i]), int(c["factorization_cnt"][i]),
                       int(c["backsolve_cnt"][i]),
                       float(summ["objective"][i]), wall) for i in indices}
    else:
        results = {}
        for i in indices:
            solver.state = None
            t = time.time()
            if P.name == "jax":
                import jax.numpy as jnp
                stats = solver.solve(params=jnp.asarray(LANE_SCALES[i]))
            else:
                stats = solver.solve(params=float(LANE_SCALES[i]))
                _sync(a)
            c = stats.counters
            results[i] = (stats.status.name, stats.iter,
                          c["factorization_cnt"], c["backsolve_cnt"],
                          float(stats.objective), time.time() - t)
    return [{"case": "lanes", "pkg": a.pkg, "option": a.option,
             "dtype": a.dtype, "nb": a.nb or 600, "seed": seed, "lane": i,
             "scale": float(LANE_SCALES[i]), "status": r[0], "iter": r[1],
             "factorization_cnt": r[2], "backsolve_cnt": r[3],
             "objective": r[4], "seconds": r[5]}
            for i, r in results.items()]


def lanes(a):
    """The cold single solves (or the batch's lanes) of ``--indices`` at
    each seed (see the module docstring); one JSON line each, then each
    lane's spread over the seeds."""
    P = _package("port" if a.pkg == "batch" else a.pkg)
    indices = [int(v) for v in a.indices.split(",")]
    rows = {}
    for seed in range(a.first, a.seeds + 1):
        for row in _lane_rows(P, a, seed, indices):
            rows.setdefault(row["lane"], []).append(row)
            print(json.dumps(row), flush=True)
    if a.seeds > a.first:
        for i, rs in rows.items():
            print(json.dumps({
                "case": "lanes", "pkg": a.pkg, "option": a.option,
                "dtype": a.dtype, "lane": i, "runs": len(rs),
                "statuses": sorted({r["status"] for r in rs}),
                "spread": {k: (min(r[k] for r in rs), max(r[k] for r in rs))
                           for k in KEYS}}), flush=True)


def lockstep(a):
    """The JAX package and the port (or the JAX package's one-ulp twin,
    ``--seed``) step by step; one JSON line per step."""
    J, T = _package("jax"), _package("port")
    from madnlp_tpu_torch.ipm.state import state_from_arrays

    dense = a.option in DENSE
    a.device = "cpu"

    def solver(P, seed):
        model = (P.opf.build if dense else P.opf.build_sparse)(
            nb=a.nb or 600, seed=0)
        if seed:
            model.x0 = ulp(model.x0, seed)
        return P.pkg.MadNLPSolver(model, **_options(P, a.option, a,
                                                    banded=not dense))

    js = solver(J, 0)
    ts = solver(T, 0)
    k = ts.kernel
    twin = solver(J, a.seed) if a.seed else None
    jst = js._init_fn(())
    ost = twin._init_fn(()) if twin else k.initialize(None)
    active = (int(J.pkg.Status.REGULAR),)
    i = 0
    while int(jst.status) in active and int(ost.status) in active:
        carried = k.regular_step(state_from_arrays(jax_state_arrays(jst),
                                                   "cpu"))
        if twin:
            # the yardstick: the JAX package's own step from its state
            # with x moved by at most one ulp
            import jax.numpy as jnp
            moved = js._regular(jst._replace(
                x=jnp.asarray(ulp(np.asarray(jst.x), a.seed + i))))
        jst = js._regular(jst)
        ost = twin._regular(ost) if twin else k.regular_step(ost)
        ja = jax_state_arrays(jst)
        line = {"step": i, "k": int(jst.k),
                "one_step": {f: _rel(getattr(carried, f), ja[f])
                             for f in ("x", "y", "zl", "zu")},
                "one_step_mu": _rel(carried.mu, ja["mu"]),
                "jax_one_ulp": ({f: _rel(np.asarray(getattr(moved, f)), ja[f])
                                 for f in ("x", "y", "zl", "zu")}
                                if twin else None),
                "free": {f: _rel(np.asarray(getattr(ost, f)), ja[f])
                         for f in ("x", "y")},
                "mu": float(ja["mu"]), "inf_pr": float(ja["inf_pr"]),
                "inf_du": float(ja["inf_du"]),
                "one_step_inf": (float(carried.inf_pr),
                                 float(carried.inf_du),
                                 float(carried.inf_compl)),
                "del_w": (float(ja["del_w"]), float(carried.del_w)),
                "qn": ({"mem": (int(ja["qn.mem"]), carried.qn.mem),
                        "skipped": (int(ja["qn.skipped"]),
                                    carried.qn.skipped)}
                       if "qn.mem" in ja else None),
                "status": (int(jst.status), int(ost.status))}
        print(json.dumps(line), flush=True)
        i += 1
    print(json.dumps({"steps": i, "jax": int(jst.status),
                      "other": int(ost.status)}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", choices=tuple(CASES) + ("lanes", "lockstep"))
    ap.add_argument("--pkg", choices=("jax", "port", "both", "batch"),
                    default="port")
    ap.add_argument("--option", choices=sorted(STEP_OPTIONS),
                    default="default")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None,
                    help="the JAX package's banded_backend (default: "
                         "pallas_interpret in float32, auto in float64)")
    ap.add_argument("--nb", type=int, default=None, help="default 600")
    ap.add_argument("--theta", type=float, default=None,
                    help="restoration: the load scale (default 2.0)")
    ap.add_argument("--lanes", default="1.0,1.04")
    ap.add_argument("--indices", default="0,5,10,15",
                    help="lanes: indices into LANE_SCALES")
    ap.add_argument("--first", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=None,
                    help="the last seed (default 6; lanes: 0)")
    ap.add_argument("--seed", type=int, default=0,
                    help="lockstep: the JAX package's one-ulp twin")
    ap.add_argument("--max-iter", type=int, default=None)
    a = ap.parse_args()
    if a.case == "restoration" and a.theta is None:
        a.theta = 2.0
    if a.case == "lockstep":
        return lockstep(a)
    if a.seeds is None:
        # the spreads run six twins; the lanes one run as they are
        a.seeds = 0 if a.case == "lanes" else 6
    if a.case == "lanes":
        return lanes(a)
    return spread(a)


if __name__ == "__main__":
    main()
