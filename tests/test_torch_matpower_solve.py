"""Whole MATPOWER ACOPF solves of the port on the CPU against the JAX
package, default options: case9, case14 and case30 (sparse models; the
smart preset picks the sparse KKT system with dense storage and LDLᵀ at
this size), and case30 with the bench configuration in float64 (banded
KKT, μ-scaled Richardson, as ``bench.py:91-103`` runs it).  Each is held
to the reference's status, iteration count and ``factorization_cnt``
exactly, ``backsolve_cnt`` exactly (float64), and the objective within
1e-8 relative (ROADMAP's parity rule).  Then the published MATPOWER optima
of case9 … case118 (tests/test_realcases.py) within 1e-5, from the port's
default solves.  The float32 and case118 bench solves are in
tests/test_torch_matpower_bench.py.
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
# MATPOWER's published AC-OPF optima, $/hr (tests/test_realcases.py:39-45)
PUBLISHED = {"case9": 5296.69, "case14": 8081.53, "case30": 576.89,
             "case57": 41737.79, "case118": 129660.70}
SOLVES = [("case9", None), ("case14", None), ("case30", None),
          ("case30", "float64")]


def _path(name):
    return os.path.join(DATA, f"{name}.m")


def _options(pkg, dtype):
    """Default options (``dtype=None``) or the bench configuration."""
    if dtype is None:
        return {}
    rich = (T.RichardsonOptions if pkg is T else JRichardson)(mu_scaled=True)
    return dict(linear_solver=pkg.LinearSolver.BANDED, dtype=dtype,
                richardson=rich)


def _summary(s):
    c = s.counters
    return (s.status.name, s.iter, c["factorization_cnt"], c["backsolve_cnt"],
            s.objective)


@pytest.fixture(scope="module")
def port_solves():
    """The port's solve of each case (default options where not given),
    computed once per module."""
    cache = {}

    def get(name, dtype=None):
        if (name, dtype) not in cache:
            s = T.madnlp(tm.load_acopf(_path(name)), device="cpu",
                         print_level=T.PrintLevel.ERROR,
                         **_options(T, dtype))
            cache[name, dtype] = _summary(s)
        return cache[name, dtype]
    return get


@pytest.mark.parametrize("name,dtype", SOLVES)
def test_solve_matches_jax(name, dtype, port_solves):
    ref = _summary(J.madnlp(jm.load_acopf(_path(name)), print_level="error",
                            **_options(J, dtype)))
    got = port_solves(name, dtype)
    assert got[0] == ref[0] == "SOLVE_SUCCEEDED"
    assert got[1:4] == ref[1:4], (got, ref)
    assert abs(got[4] - ref[4]) <= OBJ_RTOL * abs(ref[4])


@pytest.mark.parametrize("name", list(PUBLISHED))
def test_published_optimum(name, port_solves):
    got = port_solves(name)
    assert got[0] == "SOLVE_SUCCEEDED"
    assert got[4] == pytest.approx(PUBLISHED[name], rel=1e-5)
