"""Port-only contracts of slice A4 (no JAX): ``solve_batch`` on the new
KKT systems and solvers raises for slice A4b at its entry, and a
checkpoint taken inside robust restoration under HYKKT and the quality
function (whose persisted context holds a factor in HYKKT's ``rr`` mode)
resumes bit for bit.
"""

import pytest
import torch

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models.instances import opf as topf
from madnlp_tpu_torch.utils.checkpoint import resume, save_state
from madnlp_tpu_torch.utils.status import Status as S

torch.set_num_threads(1)

HYKKT = dict(kkt_system="dense", linear_solver="hykkt", hykkt_backend="ldl")


def _infeasible():
    """The one-variable infeasible model of tests/test_config_matrix.py."""
    return T.create_model(
        obj=lambda x: x[0], cons=lambda x: torch.stack([x[0]]),
        n=1, m=1, x0=[0.0], lvar=[1.0], lcon=[0.0], ucon=[0.5])


@pytest.mark.parametrize("build,opts", [
    ("sparse", dict(kkt_system="sparse_condensed", linear_solver="banded")),
    ("sparse", dict(kkt_system="sparse_unreduced", linear_solver="banded")),
    ("sparse", dict(kkt_system="sparse", linear_solver="hykkt")),
    ("dense", dict(kkt_system="dense", linear_solver="block_cholesky")),
])
def test_solve_batch_on_the_a4_systems_raises(build, opts):
    model = getattr(topf, "build_sparse" if build == "sparse" else "build")(
        nb=10, seed=0, parametric=True)
    solver = T.MadNLPSolver(model, device="cpu", print_level="error", **opts)
    with pytest.raises(NotImplementedError, match="A4b.*later slice"):
        solver.solve_batch([0.95, 1.05])


def test_checkpoint_inside_hykkt_restoration(tmp_path):
    """Under HYKKT and the quality function the persisted context is a
    factor; inside robust restoration its mode is ``rr``.  Saved there,
    resumed in a fresh solver and finished: bit for bit the uninterrupted
    solve."""
    def solver():
        return T.MadNLPSolver(
            _infeasible(), device="cpu", print_level="error",
            barrier=T.BarrierUpdate.QUALITY_FUNCTION, **HYKKT)

    def run(sv, st, n=None):
        k = sv.kernel
        step = {int(S.REGULAR): k.regular_step,
                int(S.RESTORE): k.restore_step, int(S.ROBUST): k.robust_step}
        done = 0
        while st.status in step and (n is None or done < n):
            st, done = step[st.status](st), done + 1
        return st

    whole = run(solver(), solver().kernel.initialize(None))
    first = solver()
    st = run(first, first.kernel.initialize(None), 6)
    assert st.status == int(S.ROBUST) and st.ctx.factor.inner.meta[2]
    path = str(tmp_path / "state.npz")
    save_state(st, path)
    second = solver()
    st2 = resume(second, path)
    assert st2.ctx.factor.inner.meta == st.ctx.factor.inner.meta
    st2 = run(second, st2)
    assert st2.status == whole.status == int(S.INFEASIBLE_PROBLEM_DETECTED)
    assert st2.k == whole.k and torch.equal(st2.x, whole.x)
    assert torch.equal(st2.y, whole.y) and st2.obj_val == whole.obj_val
