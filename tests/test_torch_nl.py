"""Whole ``.nl`` solves of the port (madnlp_tpu_torch/models/nl.py) against
the JAX package's, on the CPU, and the port's ``.sol`` file and solver
executable.

* hs15 read from its ``.nl`` file (tests/test_nl.py) through the dense
  compiler: condensed dense KKT, LDLᵀ (K7's plain version here).
* ``minsurf_nl(8)`` through the template compiler on the banded sparse
  path (``linear_solver=BANDED``: K1/K2's plain versions, N = 81), its 32
  fixed boundary variables through MakeParameter.
* Each against the JAX package's solve of the same file: status,
  iterations, ``factorization_cnt`` and ``backsolve_cnt`` exactly
  (float64), the objective within 1e-8 relative.
* ``solve_nl`` writes the ``.sol`` file, ``read_sol`` gives back the
  primal and the duals bit for bit with solve code 0, and ``main([...,
  "device=cpu"])`` writes the same file; the binary encoding of the file,
  little- and big-endian, solves bit for bit as the text does.
"""

import numpy as np
import pytest
import torch

import madnlp_tpu as J
from madnlp_tpu.models import nl as jnl
from madnlp_tpu_torch.models import nl as tnl
from madnlp_tpu_torch.testing import minsurf_nl
from madnlp_tpu_torch.utils.options import LinearSolver
from tests.test_nl import HS15_NL

torch.set_num_threads(1)

OBJ_RTOL = 1e-8


def _counts(s):
    return (s.status.name, s.iter, s.counters["factorization_cnt"],
            s.counters["backsolve_cnt"])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("nl")
    out = {}
    for name, text in (("hs15", HS15_NL), ("minsurf", minsurf_nl(8))):
        p = d / f"{name}.nl"
        p.write_text(text)
        out[name] = str(p)
    return out


@pytest.fixture(scope="module")
def hs15_port(files):
    return tnl.solve_nl(files["hs15"], device="cpu", print_level="ERROR")


def _same(a, b):
    return (_counts(a) == _counts(b) and a.objective == b.objective
            and np.array_equal(a.solution, b.solution)
            and np.array_equal(a.multipliers, b.multipliers))


@pytest.mark.parametrize("case", ["hs15", "minsurf_banded"])
def test_solve_matches_jax(files, hs15_port, case):
    if case == "hs15":
        jax_stats = J.madnlp(jnl.read_nl(files["hs15"]), print_level="ERROR")
        port = hs15_port
    else:
        path = files["minsurf"]
        jax_stats = J.madnlp(jnl.read_nl(path, sparse=True),
                             linear_solver=J.LinearSolver.BANDED,
                             print_level="ERROR")
        solver = tnl.read_nl(path, sparse=True)
        port = tnl.solve_nl(path, sparse=True, device="cpu",
                            linear_solver=LinearSolver.BANDED,
                            print_level="ERROR")
        assert not solver.is_dense and solver.n == 81
    assert _counts(port) == _counts(jax_stats)
    assert port.status.name == "SOLVE_SUCCEEDED"
    assert abs(port.objective - jax_stats.objective) <= \
        OBJ_RTOL * abs(jax_stats.objective)
    np.testing.assert_allclose(port.solution, jax_stats.solution, atol=1e-6)


def test_sol_file_and_executable(files, hs15_port, tmp_path):
    sol = str(tmp_path / "hs15.sol")
    stats = tnl.solve_nl(files["hs15"], sol_path=sol, device="cpu",
                         print_level="ERROR")
    assert _same(stats, hs15_port)
    primal, duals, code, msg = tnl.read_sol(sol, 2, 2)
    assert code == 0 and "SOLVE_SUCCEEDED" in msg
    np.testing.assert_array_equal(primal, stats.solution)
    np.testing.assert_array_equal(duals, stats.multipliers)
    # the executable: model stub, -AMPL, key=value options
    stub = str(tmp_path / "cli")
    with open(stub + ".nl", "w") as f:
        f.write(HS15_NL)
    assert tnl.main([stub, "-AMPL", "device=cpu", "print_level=ERROR"]) == 0
    with open(stub + ".sol") as f, open(sol) as g:
        assert f.read() == g.read()
    # the JAX package's reader takes the port's file
    jp, jd, jcode, _ = jnl.read_sol(sol, 2, 2)
    np.testing.assert_array_equal(jp, primal)
    assert jcode == 0


@pytest.mark.parametrize("big_endian", [False, True])
def test_binary_file_solves_bit_for_bit(files, hs15_port, tmp_path,
                                        big_endian):
    bp = str(tmp_path / "hs15_bin.nl")
    tnl.write_nl_binary(bp, tnl._parse_nl(files["hs15"]), big_endian)
    assert open(bp, "rb").read(1) == b"b"
    stats = tnl.solve_nl(bp, device="cpu", print_level="ERROR")
    assert _same(stats, hs15_port)
