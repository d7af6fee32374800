"""Behavior-suite fixtures with reference solutions — port of
``madnlp_tpu/models/instances/suite.py`` (the pathological models of
``lib/MadNLPTests/src/MadNLPTests.jl:112-456`` and ``Instances/nls.jl``).

Every model of the JAX package's suite is here; ``eigmina`` and
``infeasible`` take the solver through feasibility restoration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import DenseNLPModel, create_model


def lootsma() -> DenseNLPModel:
    """Degenerate NLP (MadNLPTests.jl:155-198).  Variable layout matches the
    reference JuMP model: x[0] = par (fixed at 6), x[1:4] in [0, 5]."""

    def obj(x):
        return x[1] ** 3 + 11.0 * x[1] - x[0] * torch.sqrt(x[1]) + x[3]

    def cons(x):
        return torch.stack([
            -torch.sqrt(x[1]) - torch.sqrt(x[2]) + torch.sqrt(x[3]),
            torch.sqrt(x[1]) + torch.sqrt(x[2]) + torch.sqrt(x[3]),
        ])

    return DenseNLPModel(
        n=4,
        m=2,
        obj=obj,
        cons=cons,
        x0=np.array([6.0, 0.0, 0.0, 0.0]),
        lvar=np.array([6.0, 0.0, 0.0, 0.0]),
        uvar=np.array([6.0, 5.0, 5.0, 5.0]),
        lcon=np.array([0.0, 4.0]),
        ucon=np.array([np.inf, np.inf]),
        name="lootsma",
    )


LOOTSMA_SOLUTION = np.array([0.07415998565403112, 2.9848713863700236, 4.0000304145340415])
LOOTSMA_MULTIPLIERS = np.array([-2.000024518601535, -2.0000305441119535])


def eigmina(n: int = 101) -> DenseNLPModel:
    """101-variable minimal-eigenvalue NLP (MadNLPTests.jl:200-332):
    min x_n s.t. ||x_{1:n-1}||² = 1, x_i x_n = i x_i."""
    nm1 = n - 1

    def obj(x):
        return x[nm1]

    def cons(x):
        v = x[:nm1]
        sphere = torch.dot(v, v) - 1.0
        bilinear = v * x[nm1] - torch.arange(1, n, dtype=x.dtype,
                                             device=x.device) * v
        return torch.cat([sphere[None], bilinear])

    return DenseNLPModel(
        n=n,
        m=n,
        obj=obj,
        cons=cons,
        x0=np.full(n, 0.1),
        lvar=np.full(n, -1.0),
        uvar=np.full(n, 1.0),
        lcon=np.zeros(n),
        ucon=np.zeros(n),
        name="eigmina",
    )


def nls() -> DenseNLPModel:
    """Bound-constrained nonlinear least squares (Instances/nls.jl):
    min ½‖F(x)‖², F = (x₁-1, 10(x₂-x₁²)), 0 <= x <= 1."""

    def obj(x):
        f1 = x[0] - 1.0
        f2 = 10.0 * (x[1] - x[0] ** 2)
        return 0.5 * (f1**2 + f2**2)

    return create_model(
        obj=obj,
        n=2,
        x0=[-1.2, 1.0],
        lvar=[0.0, 0.0],
        uvar=[1.0, 1.0],
        name="nls",
    )


def infeasible() -> DenseNLPModel:
    """MadNLPTests `infeasible`: min sum((x-2)²) s.t. x₁ >= 1 (bound),
    x₁ <= -1 (constraint)."""
    return create_model(
        obj=lambda x: torch.sum((x - 2.0) ** 2),
        n=2,
        x0=[0.0, 0.0],
        cons=lambda x: x[0:1],
        m=1,
        lvar=[1.0, -np.inf],
        lcon=[-np.inf],
        ucon=[-1.0],
        name="infeasible",
    )


def unbounded() -> DenseNLPModel:
    """MadNLPTests `unbounded`: max x² free -> DIVERGING_ITERATES."""
    return create_model(
        obj=lambda x: x[0] ** 2,
        n=1,
        x0=[1.0],
        minimize=False,
        name="unbounded",
    )


def lp_issue75() -> DenseNLPModel:
    """MadNLPTests `lp_examodels_issue75` (MadNLPTests.jl:422-441): a plain
    LP that once broke the sparse wrapper path.  Optimum (15, 1.25),
    objective 205."""
    return create_model(
        obj=lambda x: 12.0 * x[0] + 20.0 * x[1],
        n=2,
        x0=[0.0, 0.0],
        cons=lambda x: torch.stack([6.0 * x[0] + 8.0 * x[1],
                                    7.0 * x[0] + 12.0 * x[1]]),
        m=2,
        lvar=[0.0, 0.0],
        uvar=[np.inf, 3.0],
        lcon=[100.0, 120.0],
        ucon=[np.inf, np.inf],
        name="lp_issue75",
    )


LP_ISSUE75_SOLUTION = np.array([15.0, 1.25])


def bound_qp() -> DenseNLPModel:
    """MadNLPTests `jump_array_type` model (MadNLPTests.jl:443-455):
    min x₁² + x₂² with x >= 1 — optimum at the bound corner (1, 1)."""
    return create_model(
        obj=lambda x: x[0] ** 2 + x[1] ** 2,
        n=2,
        x0=[2.0, 2.0],
        lvar=[1.0, 1.0],
        name="bound_qp",
    )
