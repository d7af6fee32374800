"""Model-ingestion front ends — port of ``madnlp_tpu/models/frontends.py``
(``from_scipy``, ``host_model``).

* :func:`from_scipy` — ingest a ``scipy.optimize.minimize``-style problem
  (callable + ``Bounds`` + ``LinearConstraint``/``NonlinearConstraint`` /
  dict constraints) into a :class:`DenseNLPModel` whose derivatives come
  from ``torch.func``.
* :func:`host_model` — a model whose callbacks run **on the host CPU**
  (arbitrary Python/NumPy code, no torch-traceability required) while the
  solver state stays on the device: per call the iterate goes to the host
  as numpy, the callback runs there, and its result comes back to the
  iterate's device as float64.  This is the JAX package's
  ``jax.pure_callback`` staging, by design, not a fallback.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .model import DenseNLPModel, DeviceConstants


def from_scipy(fun, x0, bounds=None, constraints=(), name="scipy_model"):
    """Build a :class:`DenseNLPModel` from ``scipy.optimize`` vocabulary.

    ``fun`` and constraint functions must be torch-traceable (use
    :func:`host_model` for opaque NumPy code); a function written with
    operators and indexing only (``(x[0] - 1)**2 + x[1]**2``) serves.
    Accepted constraints: ``scipy.optimize.NonlinearConstraint``,
    ``LinearConstraint``, or the ``minimize``-style dicts ``{"type":
    "eq"|"ineq", "fun": g}`` (with the scipy convention ``g(x) = 0`` /
    ``g(x) >= 0``)."""
    x0 = np.asarray(x0, dtype=np.float64)
    n = x0.shape[0]
    x0_t = torch.as_tensor(x0)          # the width probes' argument

    lvar = uvar = None
    if bounds is not None:
        if hasattr(bounds, "lb"):  # scipy.optimize.Bounds
            lvar = np.broadcast_to(np.asarray(bounds.lb, float), (n,))
            uvar = np.broadcast_to(np.asarray(bounds.ub, float), (n,))
        else:  # sequence of (lo, hi)
            arr = np.asarray(
                [(-np.inf if lo is None else lo, np.inf if hi is None else hi)
                 for lo, hi in bounds], dtype=float,
            )
            lvar, uvar = arr[:, 0], arr[:, 1]

    if isinstance(constraints, dict) or hasattr(constraints, "fun"):
        constraints = (constraints,)

    def _width(g):
        return torch.atleast_1d(torch.as_tensor(g(x0_t))).shape[0]

    funs, lcs, ucs, mats = [], [], [], {}
    for c in constraints:
        if isinstance(c, dict):
            g = c["fun"]
            width = _width(g)
            funs.append(lambda x, g=g: torch.atleast_1d(g(x)))
            if c["type"] == "eq":
                lcs.append(np.zeros(width))
                ucs.append(np.zeros(width))
            else:  # "ineq": g(x) >= 0
                lcs.append(np.zeros(width))
                ucs.append(np.full(width, np.inf))
        elif hasattr(c, "A"):  # LinearConstraint
            key = f"A{len(mats)}"
            mats[key] = np.atleast_2d(np.asarray(c.A, dtype=float))
            width = mats[key].shape[0]
            funs.append(lambda x, key=key: getattr(consts.on(x.device), key) @ x)
            lcs.append(np.broadcast_to(np.asarray(c.lb, float), (width,)))
            ucs.append(np.broadcast_to(np.asarray(c.ub, float), (width,)))
        else:  # NonlinearConstraint
            g = c.fun
            width = _width(g)
            funs.append(lambda x, g=g: torch.atleast_1d(g(x)))
            lcs.append(np.broadcast_to(np.asarray(c.lb, float), (width,)))
            ucs.append(np.broadcast_to(np.asarray(c.ub, float), (width,)))
    consts = DeviceConstants(**mats)

    m = int(sum(len(lo) for lo in lcs))
    cons = None
    if m:
        def cons(x):
            return torch.cat([f(x) for f in funs])

    return DenseNLPModel(
        n=n, m=m, obj=fun, cons=cons, x0=x0,
        lvar=lvar, uvar=uvar,
        lcon=np.concatenate(lcs) if m else None,
        ucon=np.concatenate(ucs) if m else None,
        name=name,
    )


def host_model(
    obj: Callable,
    x0,
    grad: Callable,
    m: int = 0,
    cons: Optional[Callable] = None,
    jac: Optional[Callable] = None,
    lag_hess: Optional[Callable] = None,
    lvar=None,
    uvar=None,
    lcon=None,
    ucon=None,
    name: str = "host_model",
) -> DenseNLPModel:
    """Model with host-side (arbitrary Python/NumPy) callbacks.

    Each callback gets numpy float64 arrays (``x``; ``x, y, obj_weight``
    for ``lag_hess``) copied from the solver's device, and its result goes
    back to that device as a float64 tensor of the expected shape.
    Derivatives cannot come from ``torch.func`` (the code is opaque to
    torch), so ``grad`` is required, ``jac`` is required when ``m > 0``,
    and a missing ``lag_hess`` should be paired with
    ``hessian_approximation=COMPACT_LBFGS``."""
    x0 = np.asarray(x0, dtype=np.float64)
    n = x0.shape[0]
    if m > 0 and (cons is None or jac is None):
        raise ValueError(
            "host_model with constraints requires cons and jac callbacks")

    def _host(a):
        return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a, dtype=np.float64))

    def _f(shape, fn, x, *args):
        out = np.asarray(fn(_host(x), *(_host(a) for a in args)),
                         dtype=np.float64).reshape(shape)
        return torch.as_tensor(out, device=x.device)

    model_kwargs = dict(
        obj=lambda x: _f((), obj, x),
        grad=lambda x: _f((n,), grad, x),
    )
    if m > 0:
        model_kwargs["cons"] = lambda x: _f((m,), cons, x)
        model_kwargs["jac"] = lambda x: _f((m, n), jac, x)
    if lag_hess is not None:
        model_kwargs["lag_hess"] = lambda x, y, ow: _f(
            (n, n), lag_hess, x, y, ow
        )
    else:
        # quasi-Newton placeholder — never evaluated under COMPACT_LBFGS/BFGS
        def _no_hess(x, y, ow):
            raise NotImplementedError(
                "host_model without lag_hess: use "
                "hessian_approximation=HessianApproximation.COMPACT_LBFGS"
            )

        model_kwargs["lag_hess"] = _no_hess

    return DenseNLPModel(
        n=n, m=m, x0=x0, lvar=lvar, uvar=uvar, lcon=lcon, ucon=ucon,
        name=name, **model_kwargs,
    )
