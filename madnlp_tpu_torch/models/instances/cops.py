"""COPS-style benchmark instances (Dolan–Moré COPS 3.0 problem families) —
port of ``madnlp_tpu/models/instances/cops.py`` (the same models, data and
starting points).

These four instances cover the structural variety the power-grid models
don't: pairwise-interaction objectives with many small equality
constraints (``elec``), ODE-collocation equality chains (``chain``), and
large bound-constrained discretized PDEs (``torsion``, ``minsurf``).

All are :class:`DenseNLPModel`\\ s whose derivatives come from
``torch.func``; objectives and constraints are vector expressions, grid
problems use stencil shifts, and ``elec``'s pair index arrays are device
constants (:class:`DeviceConstants`).  On the card they solve on the
dense path (the LDLᵀ kernel K7 where the KKT system has equality rows).
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import DenseNLPModel, DeviceConstants

__all__ = ["elec", "chain", "torsion", "minsurf"]


def elec(np_: int = 25, seed: int = 0) -> DenseNLPModel:
    """Distribution of electrons on a sphere (COPS 3.0 #2, Thomson problem).

        min  sum_{i<j} 1 / ||p_i - p_j||
        s.t. ||p_i||^2 = 1

    n = 3*np_ variables, np_ equality constraints.
    """
    rng = np.random.default_rng(seed)
    p0 = rng.normal(size=(np_, 3))
    p0 /= np.linalg.norm(p0, axis=1, keepdims=True)
    iu, ju = np.triu_indices(np_, k=1)
    consts = DeviceConstants(iuj=iu, juj=ju)

    def obj(x):
        k = consts.on(x.device)
        p = x.reshape(np_, 3)
        d = p[k.iuj] - p[k.juj]
        return torch.sum(1.0 / torch.sqrt(torch.sum(d * d, dim=1)))

    def cons(x):
        p = x.reshape(np_, 3)
        return torch.sum(p * p, dim=1) - 1.0

    return DenseNLPModel(
        n=3 * np_, m=np_, obj=obj, cons=cons, x0=p0.reshape(-1),
        lcon=np.zeros(np_), ucon=np.zeros(np_), name=f"cops_elec_{np_}",
    )


def chain(nh: int = 50, a: float = 1.0, b: float = 3.0,
          L: float = 4.0) -> DenseNLPModel:
    """Hanging chain of prescribed length (COPS 3.0 #4).

        min  int_0^1 y sqrt(1 + y'^2) dt
        s.t. int_0^1 sqrt(1 + y'^2) dt = L,  y(0)=a, y(1)=b

    Parameterized by the *slopes* ``u_j = y'(t_j)`` with the heights
    reconstructed by trapezoidal integration — the COPS model's own
    variable choice.  (A nodal-heights parameterization carries O(1/h)-
    scaled indefinite Lagrangian curvature and a degenerate straight-line
    start where the length constraint's reduced gradient vanishes
    exactly; the slope form is the well-conditioned discretization.)
    """
    n = nh + 1
    h = 1.0 / nh
    t = np.linspace(0.0, 1.0, n)
    # bowed start: y = a + (b-a) t - 4 t (1-t), u = y'
    x0 = (b - a) - 4.0 * (1.0 - 2.0 * t)

    def heights(u):
        incr = 0.5 * h * (u[:-1] + u[1:])
        return a + torch.cat([u.new_zeros((1,)), torch.cumsum(incr, 0)])

    def obj(u):
        y = heights(u)
        f = y * torch.sqrt(1.0 + u * u)
        return 0.5 * h * torch.sum(f[:-1] + f[1:])

    def cons(u):
        arc = torch.sqrt(1.0 + u * u)
        y = heights(u)
        length = 0.5 * h * torch.sum(arc[:-1] + arc[1:])
        return torch.stack([y[-1] - b, length - L])

    return DenseNLPModel(
        n=n, m=2, obj=obj, cons=cons, x0=x0,
        lcon=np.zeros(2), ucon=np.zeros(2), name=f"cops_chain_{nh}",
    )


def torsion(nx: int = 20, c: float = 5.0) -> DenseNLPModel:
    """Elastic–plastic torsion (COPS-family bound-constrained QP; also
    MINPACK-2 DPJB class): minimize the torsion energy of a bar of unit
    square cross-section subject to |v| <= dist(x, boundary).

        min  sum_cells 1/2 |grad v|^2 h^2 - c * sum h^2 v
    """
    n1 = nx + 1
    h = 1.0 / nx
    xs = np.linspace(0.0, 1.0, n1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    dist = np.minimum(np.minimum(X, 1 - X), np.minimum(Y, 1 - Y))

    def obj(x):
        v = x.reshape(n1, n1)
        vx = (v[1:, :] - v[:-1, :]) / h
        vy = (v[:, 1:] - v[:, :-1]) / h
        energy = 0.5 * h * h * (
            torch.sum(0.5 * (vx[:, 1:] ** 2 + vx[:, :-1] ** 2))
            + torch.sum(0.5 * (vy[1:, :] ** 2 + vy[:-1, :] ** 2))
        )
        return energy - c * h * h * torch.sum(v)

    return DenseNLPModel(
        n=n1 * n1, obj=obj, x0=np.zeros(n1 * n1),
        lvar=-dist.reshape(-1), uvar=dist.reshape(-1),
        name=f"cops_torsion_{nx}",
    )


def minsurf(nx: int = 20, obstacle: bool = True) -> DenseNLPModel:
    """Minimal surface with (optional) obstacle (COPS 3.0 #17 family).

    Minimize the surface area of v over the unit square with v = 0 on the
    boundary (enforced through equal bounds) and, with ``obstacle``,
    v >= 1 on the centre patch [0.25, 0.75]^2.
    """
    n1 = nx + 1
    h = 1.0 / nx
    xs = np.linspace(0.0, 1.0, n1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")

    def obj(x):
        v = x.reshape(n1, n1)
        # lower-triangle linearization of the area integrand per cell
        vx = (v[1:, 1:] - v[:-1, 1:]) / h
        vy = (v[1:, 1:] - v[1:, :-1]) / h
        area1 = torch.sqrt(1.0 + vx**2 + vy**2)
        wx = (v[1:, :-1] - v[:-1, :-1]) / h
        wy = (v[:-1, 1:] - v[:-1, :-1]) / h
        area2 = torch.sqrt(1.0 + wx**2 + wy**2)
        return 0.5 * h * h * torch.sum(area1 + area2)

    lvar = np.full((n1, n1), -np.inf)
    uvar = np.full((n1, n1), np.inf)
    boundary = (X == 0) | (X == 1) | (Y == 0) | (Y == 1)
    lvar[boundary] = uvar[boundary] = 0.0
    if obstacle:
        patch = (X >= 0.25) & (X <= 0.75) & (Y >= 0.25) & (Y <= 0.75)
        lvar[patch & ~boundary] = 1.0
    x0 = np.where(boundary, 0.0, 1.0).reshape(-1)
    return DenseNLPModel(
        n=n1 * n1, obj=obj, x0=x0,
        lvar=lvar.reshape(-1), uvar=uvar.reshape(-1),
        name=f"cops_minsurf_{nx}",
    )
