"""The adaptive barrier's kernels (``ipm/barrier.py``) against the JAX
package's on one state: the quality function ``_quality_function`` at
five σ and the LOQO rule ``_adaptive_mu_loqo`` on the JAX package's
initial state of ``dummy_qp.build(20, 5)`` (its bound duals replaced by
seeded ones), carried across by ``state_from_arrays``, with seeded affine
and centering steps: within 1e-12 relative (helpers in
tests/test_torch_step_options.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madnlp_tpu as J
from madnlp_tpu.ipm import barrier as jbar
from madnlp_tpu.kkt.vec import KKTVec as JVec
from madnlp_tpu.models.instances import dummy_qp as jdqp

import madnlp_tpu_torch as T
from madnlp_tpu_torch.ipm import barrier as tbar
from madnlp_tpu_torch.ipm.state import state_from_arrays
from madnlp_tpu_torch.kkt.vec import KKTVec as TVec
from madnlp_tpu_torch.models.instances import dummy_qp as tdqp

from test_torch_step_options import UNIT_RTOL


def _jax_state_arrays(st):
    """The leaves of a JAX ``State`` as numpy, under the keys
    ``state_from_arrays`` reads (the persisted context left out)."""
    out = {}

    def put(prefix, v):
        for name, a in zip(v._fields, v):
            if hasattr(a, "_fields"):
                put(f"{prefix}{name}.", a)
            else:
                out[f"{prefix}{name}"] = np.asarray(a)

    for name, v in zip(st._fields, st):
        if name == "ctx":
            continue
        if hasattr(v, "_fields"):
            put(f"{name}.", v)
        elif isinstance(v, (jnp.ndarray, np.ndarray)):
            out[name] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def qp_states():
    js = J.MadNLPSolver(jdqp.build(20, 5),
                        barrier=J.BarrierUpdate.QUALITY_FUNCTION)
    st = js._init_fn()
    rng = np.random.default_rng(7)
    nw = st.x.shape[0]
    st = st._replace(zl=jnp.where(js.kernel.lb, rng.uniform(0.1, 2.0, nw), 0.0),
                     zu=jnp.where(js.kernel.ub, rng.uniform(0.1, 2.0, nw), 0.0))
    ts = T.MadNLPSolver(tdqp.build(20, 5), device="cpu",
                        barrier=T.BarrierUpdate.QUALITY_FUNCTION)
    return js.kernel, st, ts.kernel, state_from_arrays(_jax_state_arrays(st),
                                                       "cpu")


@pytest.mark.parametrize("sigma", [0.0, 0.1, 0.5, 0.9999, 1.0])
def test_quality_function_matches_jax(sigma, qp_states):
    jk, jst, tk, tst = qp_states
    p = tk.prob
    rng = np.random.default_rng(11)
    aff, cen = ([rng.standard_normal(k) * scale
                 for k in (p.nw, p.m, p.nw, p.nw)] for scale in (0.5, 0.05))
    res_p, res_d = 0.7, 1.3
    want = jbar._quality_function(
        jk, jst, jnp.asarray(sigma), JVec(*map(jnp.asarray, aff)),
        JVec(*map(jnp.asarray, cen)), jnp.asarray(res_p), jnp.asarray(res_d))
    got = tbar._quality_function(
        tk, tst, sigma, TVec(*map(torch.tensor, aff)),
        TVec(*map(torch.tensor, cen)), res_p, res_d)
    np.testing.assert_allclose(got, float(want), rtol=UNIT_RTOL)


def test_loqo_rule_matches_jax(qp_states):
    jk, jst, tk, tst = qp_states
    want = float(jbar._adaptive_mu_loqo(jk, jst, None))
    np.testing.assert_allclose(tbar._adaptive_mu_loqo(tk, tst, None), want,
                               rtol=UNIT_RTOL)
    assert 0.0 < want < 1.0
