"""The float32 refinement stalls of the nb600 ×16 scenario batch (ROADMAP
§C), settled on one factorization each.

At load scales 0.9307 (lane 1) and 1.0587 (lane 13) of
``np.linspace(0.92, 1.08, 16)`` the port's float32 solves of
``opf.build_sparse(nb=600, seed=0, parametric=True)`` (banded KKT,
μ-scaled Richardson) take extra δ-ladder factorizations where the JAX
package's CPU loop takes none: at some iterations Richardson refinement
hits its 10-sweep cap.  The question is whether that is a fault of the
port or the rounding of the factorization order it follows (the TPU
kernel's panel-blocked order).

For each of the two scenarios this runs the port's single float32 solve
on the CPU up to the first refinement that ends at the cap unconverged,
keeps that scaled KKT band, factors it three ways — the port's plain
factorization, the JAX package's Pallas kernel (``pallas_banded_
factorize_stream(..., interpret=True)``, the TPU kernel's order) and its
XLA band loop (``banded_factorize``) — and runs the port's refinement
with each factor on the same right-hand side, counting the sweeps; then
the same on five copies of the band perturbed by one float32 ulp.

Run it (a few minutes on the CPU):

    PYTHONPATH=. python tests/test_torch_refine_stall.py
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from madnlp_tpu.ops import banded as jbanded
from madnlp_tpu.ops.pallas_banded_stream import pallas_banded_factorize_stream

import madnlp_tpu_torch as T
from madnlp_tpu_torch.kkt.vec import KKTVec, norm_inf
from madnlp_tpu_torch.models.instances import opf
from madnlp_tpu_torch.ops import banded as plain
from madnlp_tpu_torch.ops import banded_kernels
from madnlp_tpu_torch.ops.banded import BandedFactor
from madnlp_tpu_torch.ops.refine import _ratio

SCALES = np.linspace(0.92, 1.08, 16)
LANES = (1, 13)
TRIALS = 6      # the captured band and five one-ulp perturbations of it


class _Stalled(Exception):
    pass


def capture_stall(scale):
    """Run the port's float32 single solve of one scenario until the first
    refinement that hits the sweep cap unconverged; returns the solver's
    KKT system, that refinement's context, right-hand side and μ, the
    scaled band it factored, and the iteration."""
    solver = T.MadNLPSolver(
        opf.build_sparse(nb=600, seed=0, parametric=True), device="cpu",
        linear_solver=T.LinearSolver.BANDED, dtype="float32",
        richardson=T.RichardsonOptions(mu_scaled=True),
        print_level=T.PrintLevel.ERROR)
    kkt = solver.kernel.kkt
    cap = solver.opts.richardson.max_iter
    seen = {"k": 0}
    factorize, refine = banded_kernels.factorize, kkt.solve_refine

    def keeping(struct, band):
        seen["band"] = band.clone()
        return factorize(struct, band)

    def watching(ctx, b, mu=None, active=None):
        x, ok, iters = refine(ctx, b, mu=mu, active=active)
        if mu is not None and iters >= cap and not ok:
            seen.update(ctx=ctx, b=b, mu=mu, iters=iters)
            raise _Stalled
        return x, ok, iters

    step = solver.kernel.regular_step

    def counting(st):
        seen["k"] = st.k
        return step(st)

    banded_kernels.factorize = keeping
    kkt.solve_refine = watching
    solver.kernel.regular_step = counting
    try:
        solver.solve(params=scale)
        raise AssertionError(f"scale {scale}: no refinement hit the cap")
    except _Stalled:
        pass
    finally:
        banded_kernels.factorize = factorize
        kkt.solve_refine = refine
    return kkt, seen


def _jax_struct(kkt):
    rows, cols, N = kkt._band_pattern()
    st = jbanded.BandStructure(rows, cols, N, block=kkt.bstruct.b,
                               perm=kkt._band_ordering())
    assert (st.b, st.bw, st.nb) == (kkt.bstruct.b, kkt.bstruct.bw,
                                    kkt.bstruct.nb)
    return st


def _to_port(f):
    return BandedFactor(*(torch.as_tensor(np.asarray(a)) for a in f))


def refine_with(kkt, seen, inner):
    """The port's refinement of the captured right-hand side with the
    factor ``inner`` in place of the solve's: (sweeps, converged, final
    residual ratio)."""
    ctx = seen["ctx"]
    ctx = ctx._replace(factor=ctx.factor._replace(inner=inner))
    x, ok, iters = kkt.solve_refine(ctx, seen["b"], mu=seen["mu"])
    w = KKTVec(*(bb - kk for bb, kk in zip(seen["b"], kkt.mul(ctx, x))))
    ratio = _ratio(float(norm_inf(w)), float(norm_inf(x)),
                   float(norm_inf(seen["b"])))
    return int(iters), bool(ok), ratio


def _factors(kkt, jst, band):
    return {
        "port": plain.banded_factorize(kkt.bstruct, band.clone()),
        "pallas": _to_port(pallas_banded_factorize_stream(
            jst, jnp.asarray(band.numpy()), interpret=True)),
        "xla": _to_port(jbanded.banded_factorize(
            jst, jnp.asarray(band.numpy()))),
    }


def stall_counts(lane, trials=TRIALS):
    """Refinement sweeps with the three factors of the captured band, and
    of ``trials - 1`` copies of it perturbed by one float32 ulp of seeded
    noise (relative 1.2e-7): the stall's sensitivity to rounding.  Each
    entry is ``(sweeps, converged)``."""
    kkt, seen = capture_stall(float(SCALES[lane]))
    jst = _jax_struct(kkt)
    band0 = seen["band"]
    rng = np.random.default_rng(0)
    rows = []
    for t in range(trials):
        band = band0 if t == 0 else band0 * (1.0 + 1.2e-7 * torch.as_tensor(
            rng.standard_normal(band0.shape), dtype=band0.dtype))
        rows.append({k: refine_with(kkt, seen, f)[:2]
                     for k, f in _factors(kkt, jst, band).items()})
    return {"lane": lane, "scale": float(SCALES[lane]),
            "iteration": seen["k"], "mu": seen["mu"],
            "solve_sweeps": seen["iters"], "trials": rows}


@pytest.mark.slow
@pytest.mark.parametrize("lane", LANES)
def test_stall_is_float32_rounding(lane):
    """ROADMAP §C, settled: on rounding-level perturbations of the stalled
    band, the TPU kernel's order (the Pallas interpreter) stalls as the
    port's plain factor does, and each of them also converges on some:
    the stall is float32 rounding in the panel-blocked order, not a fault
    of the port."""
    out = stall_counts(lane)
    cap = out["solve_sweeps"]
    port = [r["port"] for r in out["trials"]]
    pallas = [r["pallas"] for r in out["trials"]]
    assert port[0] == (cap, False)
    for runs in (port, pallas):
        assert any(sw == cap and not ok for sw, ok in runs)
        assert any(ok for _, ok in runs)


def dense_float32_spread(seeds=5):
    """The port's float32 dense nb=600 solve (default options) on the CPU,
    once as it is and once per seed with every factorized matrix perturbed
    by one float32 ulp of seeded symmetric noise (relative 1.2e-7): the
    spread of (iterations, factorization_cnt, backsolve_cnt) that rounding
    alone produces.  The JAX package's CPU solve takes (25, 28, 137)."""
    from madnlp_tpu_torch.ops import dense_solvers as ds

    factorize = ds.factorize
    model = opf.build(nb=600, seed=0)
    out = []
    for seed in [None] + list(range(seeds)):
        gen = None if seed is None else torch.Generator().manual_seed(seed)

        def perturbed(K, *args, **kwargs):
            if gen is not None:
                E = torch.randn(K.shape, generator=gen, dtype=torch.float64)
                K = (K * (1.0 + 1.2e-7 * (E + E.T) / 2.0)).to(K.dtype)
            return factorize(K, *args, **kwargs)

        ds.factorize = perturbed
        try:
            s = T.madnlp(model, device="cpu", dtype="float32",
                         print_level=T.PrintLevel.ERROR)
        finally:
            ds.factorize = factorize
        c = s.counters
        out.append((seed, s.status.name, s.iter, c["factorization_cnt"],
                    c["backsolve_cnt"], s.objective))
    return out


if __name__ == "__main__":
    torch.set_num_threads(4)
    for lane in LANES:
        print(stall_counts(lane), flush=True)
    for row in dense_float32_spread():
        print("dense nb600 float32 (seed, status, iter, factorizations, "
              "backsolves, objective):", row, flush=True)
