"""Richardson iterative refinement over a KKT operator — port of
``madnlp_tpu/ops/refine.py:solve_refine``.

Repeat ``x += K⁻¹(b - K x)`` until ``‖r‖ / (min(‖x‖, 1e6‖b‖) + ‖b‖) < tol``
or the iteration cap is hit; success means the ratio beat
``acceptable_tol``.  The loop runs on the host: one host read of the two
norms per sweep.  :func:`solve_refine_batched` runs the same loop for a
batch of lanes (the vmapped ``lax.while_loop`` of the JAX package): each
lane stops on its own ratio, and a sweep solves only the lanes still
running.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kkt.vec import KKTVec, kkt_where, norm_inf


def _ratio(norm_w, norm_x, norm_b):
    den = min(norm_x, 1e6 * norm_b) + norm_b
    if den == 0.0:
        return math.nan if norm_w == 0.0 else math.inf
    return norm_w / den


def solve_refine(solve_fn, mul_fn, b: KKTVec, max_iter: int, tol: float,
                 acceptable_tol: float):
    """Returns ``(x, converged, iters)``."""
    norm_b = float(norm_inf(b))
    x = KKTVec(*(torch.zeros_like(a) for a in b))
    w = b
    ir = 0
    ratio = prev = math.inf
    norm_w = norm_b
    while True:
        # Stagnation early-exit (as in the JAX package): with a
        # reduced-precision factor the residual plateaus long before `tol`;
        # once the ratio is acceptable and improving by <4x per sweep, more
        # sweeps are wasted backsolves.
        stalled = (ratio > 0.25 * prev) and (ratio < acceptable_tol)
        if not (ir < max_iter and ratio >= tol and not stalled):
            break
        dx = solve_fn(w)
        x = x.axpy(1.0, dx)
        kx = mul_fn(x)
        w = KKTVec(*(bb - kk for bb, kk in zip(b, kx)))
        norm_w, norm_x = torch.stack([norm_inf(w), norm_inf(x)]).tolist()
        prev, ratio = ratio, _ratio(norm_w, norm_x, norm_b)
        ir += 1
    converged = ratio < acceptable_tol
    # Inconsistent-singular guard: a genuine solve must at least reduce
    # the residual.
    converged = converged and (norm_w <= 0.999 * norm_b)
    # b == 0 -> x = 0 is exact.
    converged = converged or norm_b == 0.0
    return x, converged, ir


def solve_refine_batched(solve_fn, mul_fn, b: KKTVec, active, max_iter: int,
                         tol, acceptable_tol: float):
    """:func:`solve_refine` lane by lane over ``b`` (B, ·) for the lanes
    that ``active`` (numpy bool (B,)) selects; ``tol`` is a float or a
    ``(B,)`` array.  ``solve_fn(w, run)`` solves the lanes of the numpy
    mask ``run`` (one batched backsolve per sweep).  A lane that stops
    keeps its ``x``.  Returns ``(x, converged (B,), iters (B,))``; lanes
    outside ``active`` report 0 sweeps and are not converged."""
    B = len(active)
    tol = np.broadcast_to(np.asarray(tol, dtype=np.float64), (B,))
    norm_b = norm_inf(b).cpu().numpy()
    x = KKTVec(*(torch.zeros_like(a) for a in b))
    w = b
    ir = np.zeros(B, dtype=np.int64)
    ratio = np.full(B, math.inf)
    prev = np.full(B, math.inf)
    norm_w = norm_b.copy()
    run = np.asarray(active, dtype=bool).copy()
    while True:
        # the stagnation early-exit of solve_refine, per lane
        stalled = (ratio > 0.25 * prev) & (ratio < acceptable_tol)
        run &= (ir < max_iter) & (ratio >= tol) & ~stalled
        if not run.any():
            break
        on = torch.as_tensor(run, device=b.xp.device)
        dx = solve_fn(w, run)
        x = kkt_where(on, x.axpy(1.0, dx), x)
        kx = mul_fn(x)
        w = kkt_where(on, KKTVec(*(bb - kk for bb, kk in zip(b, kx))), w)
        nw_, nx_ = torch.stack([norm_inf(w), norm_inf(x)]).cpu().numpy()
        for i in np.flatnonzero(run):
            prev[i], ratio[i] = ratio[i], _ratio(nw_[i], nx_[i], norm_b[i])
            norm_w[i] = nw_[i]
        ir[run] += 1
    converged = (ratio < acceptable_tol) & (norm_w <= 0.999 * norm_b)
    converged |= norm_b == 0.0
    return x, converged & np.asarray(active, dtype=bool), ir
