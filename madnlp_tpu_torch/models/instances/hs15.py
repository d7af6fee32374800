"""Hock–Schittkowski problem 15 — port of
``madnlp_tpu/models/instances/hs15.py`` (``build``, the dense model with
``torch.func`` derivatives, and ``build_sparse``).

    min 100 (x2 - x1²)² + (1 - x1)²
    s.t. x1 x2 >= 1,  x1 + x2² >= 0,  x1 <= 0.5
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import DenseNLPModel, SparseNLPModel


def obj(x):
    return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2


def cons(x):
    return torch.stack([x[0] * x[1], x[0] + x[1] ** 2])


def build(x0=(0.0, 0.0), y0=(0.0, 0.0)) -> DenseNLPModel:
    return DenseNLPModel(
        n=2,
        m=2,
        obj=obj,
        cons=cons,
        x0=np.asarray(x0, dtype=np.float64),
        y0=np.asarray(y0, dtype=np.float64),
        lvar=[-np.inf, -np.inf],
        uvar=[0.5, np.inf],
        lcon=[1.0, 0.0],
        ucon=[np.inf, np.inf],
        name="hs15",
    )


def build_sparse(x0=(0.0, 0.0), y0=(0.0, 0.0)) -> SparseNLPModel:
    """Analytic sparse derivatives (hs15.jl:44-91); the gradient comes from
    torch autograd, as the JAX package's comes from ``jax.grad``."""

    def jac_coords(x):
        return torch.stack([x[1], x[0], torch.ones_like(x[0]), 2.0 * x[1]])

    def hess_coords(x, y, obj_weight):
        h11 = obj_weight * (-400.0 * x[1] + 1200.0 * x[0] ** 2 + 2.0)
        h21 = obj_weight * (-400.0 * x[0]) + y[0]
        h22 = obj_weight * 200.0 + 2.0 * y[1]
        return torch.stack([h11, h21, h22])

    return SparseNLPModel(
        n=2,
        m=2,
        obj=obj,
        cons=cons,
        x0=np.asarray(x0, dtype=np.float64),
        y0=np.asarray(y0, dtype=np.float64),
        jac_rows=[0, 0, 1, 1],
        jac_cols=[0, 1, 0, 1],
        jac_coords=jac_coords,
        hess_rows=[0, 1, 1],
        hess_cols=[0, 0, 1],
        hess_coords=hess_coords,
        lvar=[-np.inf, -np.inf],
        uvar=[0.5, np.inf],
        lcon=[1.0, 0.0],
        ucon=[np.inf, np.inf],
        name="hs15-sparse",
    )


# Two local optima (docs/src/quickstart.md:28-34): from x0=(0,0) MadNLP
# converges to (-0.792, -1.262), obj ≈ 360.38; from x0=(1,1) to (0.5, 2),
# obj = 306.5.
SOLUTION_OBJ_FROM_ZERO = 360.3797616
SOLUTION_OBJ_FROM_ONES = 306.5
