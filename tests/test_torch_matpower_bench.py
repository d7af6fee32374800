"""The MATPOWER ACOPF under the bench configuration (banded KKT,
μ-scaled Richardson refinement, ``bench.py:91-103``) on the CPU, the port
against the JAX package: case118 in float64 and float32, case30 in
float32, and (marked ``slow``) the case118×4 ring, the JAX package's bench
primary, which ``chip_smoke.py`` solves on the card.

Held: status, iteration count and ``factorization_cnt`` exactly, the
objective within 1e-8 relative, ``backsolve_cnt`` exactly in float64 and
within 6% in float32 (ROADMAP's parity rule), and the published optimum
within 1e-5 (4 × 129660.70 for the ring, exact by symmetry).

case30 in float32 is a δ-ladder case: its factorization count exceeds its
iterations, so the inertia of the float32 factor decides the trajectory.
There the reference is the JAX package run with
``banded_backend="pallas_interpret"``, the TPU kernel's panel-blocked
factorization order that the port follows (21 iterations, 22
factorizations); the JAX package's XLA band loop factors in another order
and takes 22 and 25 on the CPU (ROADMAP §C).
"""

import os

import pytest
import torch

import madnlp_tpu as J
from madnlp_tpu.models import matpower as jm
from madnlp_tpu.utils.options import RichardsonOptions as JRichardson

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models import matpower as tm

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
OBJ_RTOL = 1e-8
BACKSOLVE_RTOL = {"float64": 0.0, "float32": 0.06}
RING_OPTIMUM = 4 * 129660.70


def _case(name):
    if name == "case118x4_ring":
        return jm.tile_case(jm.parse_case(os.path.join(DATA, "case118.m")),
                            4, ties="ring")
    return jm.parse_case(os.path.join(DATA, f"{name}.m"))


def _summary(s):
    c = s.counters
    return (s.status.name, s.iter, c["factorization_cnt"], c["backsolve_cnt"],
            s.objective)


def _check(name, dtype, backend="auto"):
    case = _case(name)
    ref = _summary(J.madnlp(
        jm.build_acopf(case, sparse=True), print_level="error",
        linear_solver=J.LinearSolver.BANDED, dtype=dtype,
        richardson=JRichardson(mu_scaled=True), banded_backend=backend))
    got = _summary(T.madnlp(
        tm.build_acopf(case, sparse=True), device="cpu",
        print_level=T.PrintLevel.ERROR, linear_solver=T.LinearSolver.BANDED,
        dtype=dtype, richardson=T.RichardsonOptions(mu_scaled=True)))
    assert got[0] == ref[0] == "SOLVE_SUCCEEDED"
    assert got[1:3] == ref[1:3], (got, ref)
    assert abs(got[3] - ref[3]) <= BACKSOLVE_RTOL[dtype] * ref[3], (got, ref)
    assert abs(got[4] - ref[4]) <= OBJ_RTOL * abs(ref[4])
    return got


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_case118_bench_matches_jax(dtype):
    got = _check("case118", dtype)
    assert got[4] == pytest.approx(129660.70, rel=1e-5)


def test_case30_float32_matches_the_tpu_kernels_order():
    got = _check("case30", "float32", backend="pallas_interpret")
    assert got[2] > got[1]       # the δ ladder ran


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_case118x4_ring_bench_matches_jax(dtype):
    got = _check("case118x4_ring", dtype)
    assert got[4] == pytest.approx(RING_OPTIMUM, rel=1e-6)


def float32_spread(name, seeds=5):
    """The port's float32 bench solve of ``name`` on the CPU, once as it is
    and once per seed with every factorized band perturbed by one float32
    ulp of seeded noise (relative 1.2e-7 on each stored entry): the spread
    of (status, iterations, factorization_cnt, backsolve_cnt, objective)
    that rounding alone produces."""
    from madnlp_tpu_torch.ops import banded_kernels

    factorize = banded_kernels.factorize
    model = tm.build_acopf(_case(name), sparse=True)
    out = []
    for seed in [None] + list(range(seeds)):
        gen = None if seed is None else torch.Generator().manual_seed(seed)

        def perturbed(struct, band):
            if gen is not None:
                E = torch.randn(band.shape, generator=gen, dtype=torch.float64)
                band = (band.double() * (1.0 + 1.2e-7 * E)).to(band.dtype)
            return factorize(struct, band)

        banded_kernels.factorize = perturbed
        try:
            s = T.madnlp(model, device="cpu", print_level=T.PrintLevel.ERROR,
                         linear_solver=T.LinearSolver.BANDED, dtype="float32",
                         richardson=T.RichardsonOptions(mu_scaled=True))
        finally:
            banded_kernels.factorize = factorize
        out.append((seed,) + _summary(s))
    return out


if __name__ == "__main__":
    # the rounding spread of the float32 counts (ROADMAP §C):
    #   PYTHONPATH=. python tests/test_torch_matpower_bench.py
    torch.set_num_threads(4)
    for name in ("case118", "case118x4_ring"):
        for row in float32_spread(name):
            print(f"{name} float32 (seed, status, iter, factorizations, "
                  f"backsolves, objective):", row, flush=True)
