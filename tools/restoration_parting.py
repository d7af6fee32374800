#!/usr/bin/env python3
"""Where the port's and the JAX package's restoration solves part, and by
how much the deciding test is met.

Both packages solve ``opf.build_sparse(nb=NB, seed=0, parametric=True)``
at load scale THETA (banded KKT, μ-scaled Richardson, float64) on the CPU
from the same initial point (``--seed`` moves it by one float64 ulp, as
``tools/spread.py`` does), one step of the three-phase loop at
a time and in lock step.  After every step both states are read and
compared: the relative distance of the iterates and of the constraint
values.  At the first step after which the two packages take different
phases, the decision that the step made is evaluated in both packages'
states with the same formulas (the port's kernels on the JAX state carried
across): the filter test of the new iterate (per entry, the larger of
``th_j - theta`` and ``ph_j - varphi``, so the smallest over the entries
decides), the infeasibility-reduction test of the robust exit
(``rir·theta_ref - theta``) and the soft restoration's error test
(``factor·soft_F - F``).  A decision whose deciding margin is smaller than
the packages' distance in the quantities it compares is a coin toss of the
rounding, not a fault of the algorithm.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/restoration_parting.py \\
        --nb 600 --seed 0

``--pair jax`` runs the JAX package against itself instead, its second
solve from the initial point moved by ``--seed``'s ulps: how far one ulp
carries the reference's own iterates over the same steps, the yardstick
for the port's distance.

``--pair batch`` runs the port alone, on ``--device`` in ``--dtype``: its
single solve against the last lane of its ``solve_batch`` of the load
scales ``--lanes`` and THETA (``BatchKernel.step``, K3/K4 on the card),
both from the same initial point.  It also reports the first step after
which the lane's iterate is no longer bit for bit the single solve's.
This mode imports no JAX:

    python3 tools/restoration_parting.py --pair batch --device cuda \
        --dtype float32

One JSON line per 25 steps while they agree, then the parting step's
line.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spread import ulp  # noqa: E402


def _arrays(st):
    """A JAX ``State``'s leaves as numpy under ``state_from_arrays``'s
    keys."""
    import jax

    out = {}

    def put(prefix, v):
        for name, a in zip(v._fields, v):
            if hasattr(a, "_fields"):
                put(f"{prefix}{name}.", a)
            else:
                out[f"{prefix}{name}"] = np.asarray(a)

    for name, v in zip(st._fields, st):
        if name in ("d", "p", "filter", "scal", "RR"):
            put(f"{name}.", v)
        elif isinstance(v, (jax.Array, np.ndarray)):
            out[name] = np.asarray(v)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    with np.errstate(invalid="ignore"):
        diff = np.where(a == b, 0.0, np.abs(a - b))
    scale = np.max(np.abs(b[np.isfinite(b)]), initial=0.0)
    return float(np.max(diff, initial=0.0) / max(scale, 1e-300))


def _decision(kernel, st, opts):
    """The scalars the step's exit tests read, evaluated on a port
    ``State`` with the port's kernels."""
    import torch

    from madnlp_tpu_torch.ipm import kernels as K

    lb, ub = kernel.lb, kernel.ub
    dl, du = kernel.slacks(st.x, st.xl, st.xu)
    theta = float(K.get_theta(st.c))
    varphi = float(K.get_varphi(st.obj_val, dl, du, lb, ub, st.mu))
    f = st.filter
    margins = [max(f.th[j] - theta, f.ph[j] - varphi) for j in range(f.count)]
    worst = int(np.argmin(margins)) if margins else -1
    F = float(K.get_F(st.c, st.f, st.zl, st.zu, st.jacl, dl, du, lb, ub,
                      st.mu))
    return {
        "theta": theta, "varphi": varphi,
        "filter_margin": margins[worst] if margins else None,
        "filter_entry": ([float(f.th[worst]), float(f.ph[worst])]
                         if margins else None),
        "robust_exit_margin": (opts.required_infeasibility_reduction
                               * st.RR.theta_ref - theta),
        "soft_F": st.soft_F, "F": F,
        "soft_margin": opts.soft_resto_pderror_reduction_factor * st.soft_F
        - F,
        "alpha": st.alpha, "l_cnt": st.l_cnt, "mu": st.mu,
        "mu_R": st.RR.mu_R, "theta_ref": st.RR.theta_ref,
        "x_norm": float(torch.abs(st.x).max()),
    }


def _lane(st, i):
    """Lane ``i`` of a ``BatchState`` with the fields of a ``State``."""
    import dataclasses
    import types

    import torch

    from madnlp_tpu_torch.ipm.kernels import Filter
    from madnlp_tpu_torch.ipm.state import RRState

    def one(v):
        if isinstance(v, Filter):
            return Filter(v.th[i], v.ph[i], int(v.count[i]))
        if isinstance(v, RRState):
            return types.SimpleNamespace(**{
                f.name: one(getattr(v, f.name))
                for f in dataclasses.fields(v)})
        if isinstance(v, tuple):
            return type(v)(*(one(a) for a in v))
        if torch.is_tensor(v) or isinstance(v, np.ndarray):
            a = v[i]
            return a.item() if np.ndim(a) == 0 else a
        return v

    return types.SimpleNamespace(**{f.name: one(getattr(st, f.name))
                                    for f in dataclasses.fields(st)})


def _inexact(lane, st):
    """The fields of a single ``State`` that lane ``lane`` does not hold
    bit for bit, with their relative distance."""
    import dataclasses

    import torch

    out = {}

    def cmp(name, a, b):
        if torch.is_tensor(b):
            a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
            if not torch.equal(a, b):
                out[name] = _rel(a.cpu(), b.cpu())
        elif isinstance(b, float) and a != b:
            out[name] = abs(a - b) / max(abs(b), 1e-300)

    for f in dataclasses.fields(st):
        a, b = getattr(lane, f.name, None), getattr(st, f.name)
        if f.name in ("d", "p"):
            for g, u, v in zip(b._fields, a, b):
                cmp(f"{f.name}.{g}", u, v)
        elif f.name == "RR":
            for g in dataclasses.fields(b):
                cmp(f"RR.{g.name}", getattr(a, g.name), getattr(b, g.name))
        elif a is not None:
            cmp(f.name, a, b)
    return out


def batch_vs_single(args):
    """The port's single solve against the THETA lane of its batch."""
    import torch

    import madnlp_tpu_torch as T
    from madnlp_tpu_torch.models.instances import opf
    from madnlp_tpu_torch.utils.status import Status as S

    model = opf.build_sparse(nb=args.nb, seed=0, parametric=True)
    if args.seed:
        model.x0 = ulp(model.x0, args.seed)
    solver = T.MadNLPSolver(
        model, device=args.device, linear_solver=T.LinearSolver.BANDED,
        dtype=args.dtype, richardson=T.RichardsonOptions(mu_scaled=True),
        print_level=T.PrintLevel.ERROR)
    k, bk = solver.kernel, solver.batch_kernel
    phase = {int(S.REGULAR): "g", int(S.RESTORE): "s", int(S.ROBUST): "r"}
    step = {int(S.REGULAR): k.regular_step, int(S.RESTORE): k.restore_step,
            int(S.ROBUST): k.robust_step}
    scales = [float(v) for v in args.lanes.split(",")] + [args.theta]
    sst = k.initialize(solver._params(args.theta))
    bst = bk.initialize(torch.tensor(scales, dtype=torch.float64,
                                     device=solver.device))
    phases, i, first = "", 0, None
    while int(sst.status) in step and int(bst.status[-1]) == int(sst.status):
        p = phase[int(sst.status)]
        sst = step[int(sst.status)](sst)
        bst = bk.step(bst)
        phases += p
        lane = _lane(bst, -1)
        dist = {"x": _rel(lane.x.cpu(), sst.x.cpu()),
                "c": _rel(lane.c.cpu(), sst.c.cpu())}
        if first is None and not (torch.equal(lane.x, sst.x)
                                  and torch.equal(lane.y, sst.y)):
            first = i
            print(json.dumps({"first_inexact_step": i, "phase": p,
                              "distance": dist,
                              "fields": _inexact(lane, sst)}), flush=True)
        if int(bst.status[-1]) != int(sst.status):
            print(json.dumps({
                "parting_step": i, "phase": p,
                "next": {"single": S(int(sst.status)).name,
                         "batch_lane": S(int(bst.status[-1])).name},
                "distance": dist, "first_inexact_step": first,
                "single": _decision(k, sst, solver.opts),
                "batch_lane": _decision(k, lane, solver.opts),
                "phases": phases}), flush=True)
            return
        if i % 25 == 0:
            print(json.dumps({"step": i, "phase": p, "distance": dist}),
                  flush=True)
        i += 1
    print(json.dumps({"no_parting": True, "steps": i, "phases": phases,
                      "first_inexact_step": first,
                      "single": S(int(sst.status)).name,
                      "batch_lane": S(int(bst.status[-1])).name}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nb", type=int, default=600)
    ap.add_argument("--theta", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pair", choices=("port", "jax", "batch"),
                    default="port")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--lanes", default="1.0,1.04")
    args = ap.parse_args()
    if args.pair == "batch":
        return batch_vs_single(args)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    import madnlp_tpu as J
    import madnlp_tpu_torch as T
    from madnlp_tpu.models.instances import opf as jopf
    from madnlp_tpu.utils.options import RichardsonOptions as JR
    from madnlp_tpu_torch.ipm.state import state_from_arrays
    from madnlp_tpu_torch.models.instances import opf as topf
    from madnlp_tpu_torch.utils.status import Status as S

    torch.set_num_threads(4)
    def jax_solver(seed):
        m = jopf.build_sparse(nb=args.nb, seed=0, parametric=True)
        if seed:
            m.x0 = ulp(m.x0, seed)
        return J.MadNLPSolver(m, linear_solver=J.LinearSolver.BANDED,
                              richardson=JR(mu_scaled=True),
                              print_level=J.PrintLevel.ERROR)

    phase = {int(S.REGULAR): "g", int(S.RESTORE): "s", int(S.ROBUST): "r"}
    tm = topf.build_sparse(nb=args.nb, seed=0, parametric=True)
    ts = T.MadNLPSolver(tm, device="cpu", linear_solver=T.LinearSolver.BANDED,
                        richardson=T.RichardsonOptions(mu_scaled=True),
                        print_level=T.PrintLevel.ERROR)
    k = ts.kernel
    if args.pair == "port":
        js = jax_solver(args.seed)
        if args.seed:
            tm.x0 = ulp(tm.x0, args.seed)
        tstep = {int(S.REGULAR): k.regular_step,
                 int(S.RESTORE): k.restore_step, int(S.ROBUST): k.robust_step}
        tst = k.initialize(ts._params(args.theta))
    else:
        js, other = jax_solver(0), jax_solver(args.seed)
        tstep = {int(S.REGULAR): other._regular,
                 int(S.RESTORE): other._restore, int(S.ROBUST): other._robust}
        tst = other._init_fn(np.asarray(args.theta))
    jstep = {int(S.REGULAR): js._regular, int(S.RESTORE): js._restore,
             int(S.ROBUST): js._robust}
    jst = js._init_fn(np.asarray(args.theta))
    def as_port(st):
        if args.pair == "port":
            return st
        out = state_from_arrays(_arrays(st), "cpu")
        out.theta = torch.tensor(args.theta, dtype=torch.float64)
        return out

    other_name = "port" if args.pair == "port" else f"jax_seed{args.seed}"
    phases, i = "", 0
    while int(jst.status) in jstep and int(tst.status) in tstep:
        if int(jst.status) != int(tst.status):
            break
        p = phase[int(tst.status)]
        jst = jstep[int(jst.status)](jst)
        tst = tstep[int(tst.status)](tst)
        phases += p
        ja = _arrays(jst)
        dist = {"x": _rel(tst.x, ja["x"]), "c": _rel(tst.c, ja["c"])}
        if int(jst.status) != int(tst.status):
            jport = state_from_arrays(ja, "cpu")
            jport.theta = torch.tensor(args.theta, dtype=torch.float64)
            print(json.dumps({
                "parting_step": i, "phase": p,
                "next": {"jax": S(int(jst.status)).name,
                         other_name: S(int(tst.status)).name},
                "distance": dist,
                other_name: _decision(k, as_port(tst), ts.opts),
                "jax": _decision(k, jport, ts.opts),
                "phases": phases}), flush=True)
            return
        if i % 25 == 0:
            print(json.dumps({"step": i, "phase": p, "distance": dist}),
                  flush=True)
        i += 1
    print(json.dumps({"no_parting": True, "steps": i, "phases": phases,
                      "jax": S(int(jst.status)).name,
                      other_name: S(int(tst.status)).name}), flush=True)


if __name__ == "__main__":
    main()
