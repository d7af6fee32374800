"""Checkpoints under the step options, on the CPU, without the JAX
package: a state saved under the monotone barrier loads under the quality
function (the template's KKT context kept) and the reverse (no context),
as in tests/test_checkpoint.py; runs under compact L-BFGS and under the
quality function on the banded nb=14 ACOPF saved after 4 steps resume to
the uninterrupted solve bit for bit (the low-rank Hessian and quasi-Newton
memory, and the persisted factor, carried); the context's fields take the
template's value where the file's differ, and every other mismatch still
raises."""

import numpy as np
import pytest
import torch

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models.instances import dummy_qp as tdqp
from madnlp_tpu_torch.models.instances import opf as topf
from madnlp_tpu_torch.utils.checkpoint import (load_state, resume, save_state,
                                               state_arrays)
from madnlp_tpu_torch.utils.status import Status as S

torch.set_num_threads(1)

ACTIVE = (int(S.REGULAR), int(S.RESTORE), int(S.ROBUST))


def _steps(solver, st, n=None):
    k = solver.kernel
    step = {int(S.REGULAR): k.regular_step, int(S.RESTORE): k.restore_step,
            int(S.ROBUST): k.robust_step}
    done = 0
    while st.status in ACTIVE and (n is None or done < n):
        st = step[st.status](st)
        done += 1
    return st


def test_barrier_rules_load_each_others_checkpoints(tmp_path):
    mono = T.MadNLPSolver(tdqp.build(20, 5), device="cpu")
    qf = T.MadNLPSolver(tdqp.build(20, 5), device="cpu",
                        barrier=T.BarrierUpdate.QUALITY_FUNCTION)
    st = _steps(mono, mono.kernel.initialize(), 2)
    assert st.ctx is None
    save_state(st, str(tmp_path / "mono"))
    template = qf.kernel.initialize()
    loaded = load_state(str(tmp_path / "mono"), template)
    assert torch.equal(loaded.x, st.x) and loaded.k == st.k
    assert loaded.ctx is not None
    assert torch.equal(loaded.ctx.factor.d, template.ctx.factor.d)

    sta = _steps(qf, qf.kernel.initialize(), 1)
    assert sta.ctx is not None
    save_state(sta, str(tmp_path / "adaptive"))
    back = load_state(str(tmp_path / "adaptive"), mono.kernel.initialize())
    assert torch.equal(back.x, sta.x) and back.ctx is None


def _opf14(**opts):
    return T.MadNLPSolver(topf.build_sparse(nb=14, seed=0), device="cpu",
                          linear_solver=T.LinearSolver.BANDED,
                          print_level=T.PrintLevel.ERROR, **opts)


RESUMED = {
    "compact_lbfgs": {"hessian_approximation":
                      T.HessianApproximation.COMPACT_LBFGS},
    "quality_function": {"barrier": T.BarrierUpdate.QUALITY_FUNCTION},
}


@pytest.mark.parametrize("name", sorted(RESUMED))
def test_resume_under_a_step_option_is_bit_for_bit(name, tmp_path):
    opts = RESUMED[name]
    whole = _opf14(**opts)
    ref = whole._stats(_steps(whole, whole.kernel.initialize()), 0.0)
    first = _opf14(**opts)
    st = _steps(first, first.kernel.initialize(), 4)
    path = str(tmp_path / "state.npz")
    save_state(st, path)
    keys = state_arrays(st)
    assert ("qn.Sk" in keys and "hess.U" in keys) if name == "compact_lbfgs" \
        else "ctx.factor.inner.band" in keys
    second = _opf14(**opts)
    st2 = _steps(second, resume(second, path))
    got = second._stats(st2, 0.0)
    assert got.status == T.Status.SOLVE_SUCCEEDED
    assert got.iter == ref.iter and got.counters == ref.counters
    assert got.objective == ref.objective
    assert np.array_equal(got.solution, ref.solution)


STRICT_CASES = [("missing", "qn.Sk"), ("shape", "hess.U"),
                ("extra", "qn.bogus")]


def test_load_stays_strict_outside_the_context(tmp_path):
    """A missing quasi-Newton field, a low-rank Hessian of another shape
    and an extra field each raise ``ValueError`` naming the field."""
    solver = _opf14(hessian_approximation=T.HessianApproximation.COMPACT_LBFGS)
    saved = state_arrays(_steps(solver, solver.kernel.initialize(), 2))
    for case, field in STRICT_CASES:
        arrays = dict(saved)
        if case == "missing":
            del arrays[field]
        elif case == "shape":
            arrays[field] = arrays[field][:, :-1]
        else:
            arrays[field] = np.zeros(3)
        path = str(tmp_path / f"{case}.npz")
        np.savez(path, **arrays)
        with pytest.raises(ValueError, match=field):
            load_state(path, solver.kernel.zero_state())


def test_context_fields_take_the_template_where_they_differ(tmp_path):
    solver = _opf14(barrier=T.BarrierUpdate.QUALITY_FUNCTION)
    st = _steps(solver, solver.kernel.initialize(), 2)
    arrays = dict(state_arrays(st))
    arrays["ctx.factor.d"] = arrays["ctx.factor.d"][:-1]
    del arrays["ctx.pr_diag"]
    arrays["ctx.bogus"] = np.zeros(3)
    path = str(tmp_path / "ctx.npz")
    np.savez(path, **arrays)
    template = solver.kernel.zero_state()
    loaded = load_state(path, template)
    assert torch.equal(loaded.ctx.factor.d, template.ctx.factor.d)
    assert torch.equal(loaded.ctx.pr_diag, template.ctx.pr_diag)
    assert torch.equal(loaded.ctx.factor.inner.band, st.ctx.factor.inner.band)
    assert torch.equal(loaded.x, st.x)
