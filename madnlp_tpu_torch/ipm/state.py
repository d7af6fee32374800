"""Solver state of the PyTorch port — ``madnlp_tpu/ipm/state.py:State``.

Vectors are float64 tensors on the solver's device; scalars (barrier,
residuals, step sizes, regularization) are host floats and counters host
ints, because the port's iteration makes its decisions on the host.  The
state is updated in place by the step functions.  :class:`RRState` is the
robust (ℓ1-penalty) restoration phase's part, ``State.RR``; the soft
restoration's backups and error ``soft_F`` are fields of :class:`State`.
``hess`` is the Hessian's values, its (n, n) matrix or, under compact
L-BFGS on a sparse KKT system, a :class:`.quasi_newton.LowRankHessian`;
``qn`` is the quasi-Newton memory, ``barrier_free_mode`` the adaptive
barrier's mode, and ``ctx`` the KKT context of the last factorization,
which only an adaptive barrier reads (its probing solves; None under the
monotone rule).

:func:`state_from_arrays` builds a state from the JAX package's ``State``
converted to numpy, so one iteration can be run in both packages from the
same point.

:class:`BatchState` is the state of ``solve_batch``: the same fields with a
leading lane axis — vectors ``(B, ·)`` on the device, per-lane scalars and
counters ``(B,)`` numpy arrays on the host, the filter ``(B, capacity)`` —
plus ``theta``, the lanes' model parameters.  Its restoration part is the
same as one solve's with a lane axis: the soft restoration's backups
``(B, ·)``, ``soft_F`` and ``rr_init_needed`` ``(B,)``, and ``RR`` an
:class:`RRState` whose vectors are ``(B, ·)``, whose scalars are ``(B,)``
numpy arrays and whose filter is ``(B, capacity)``.  So are the step
options' fields: ``qn`` a :class:`.quasi_newton.QNState` with a lane
axis, ``hess`` a batched :class:`.quasi_newton.LowRankHessian` under
compact L-BFGS, ``barrier_free_mode`` a ``(B,)`` bool array, and ``ctx``
the batched KKT context of each lane's last factorization (adaptive
barriers only, else None).
:meth:`BatchState.take`, :func:`split_lanes` and :func:`stack_lanes`
reorder, chunk and rejoin lanes, every field included;
:func:`batch_state_from_arrays` carries a batch of JAX states across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kkt.vec import KKTVec, kkt_zeros
from .kernels import Filter, filter_init, filter_stack
from .problem import Scaling
from .quasi_newton import LowRankHessian, QNState, qn_zeros


@dataclasses.dataclass
class RRState:
    """Robust (ℓ1-penalty) restoration phase state (restoration.jl:1-37):
    the p/n slacks of the constraint residual and their duals, the
    proximal term's reference point and weights, the restoration barrier
    μ_R and its own filter."""

    f_R: torch.Tensor       # (nw,)
    x_ref: torch.Tensor     # (nw,)
    D_R: torch.Tensor       # (nw,)
    pp: torch.Tensor        # (m,)
    nn: torch.Tensor
    zp: torch.Tensor
    zn: torch.Tensor
    dpp: torch.Tensor
    dnn: torch.Tensor
    dzp: torch.Tensor
    dzn: torch.Tensor
    pp_trial: torch.Tensor
    nn_trial: torch.Tensor
    filter: Filter
    obj_val_R: float = 0.0
    theta_ref: float = 0.0
    obj_val_R_trial: float = 0.0
    inf_pr_R: float = 0.0
    inf_du_R: float = 0.0
    inf_compl_R: float = 0.0
    mu_R: float = 1.0
    tau_R: float = 0.99
    zeta: float = 1.0


def rr_zeros(nw: int, m: int, filter_capacity: int, device,
             lanes=None) -> RRState:
    """A zero :class:`RRState`; with ``lanes``, the batched one."""
    lead = () if lanes is None else (lanes,)

    def z(k):
        return torch.zeros(lead + (k,), dtype=torch.float64, device=device)

    R = RRState(
        f_R=z(nw), x_ref=z(nw), D_R=z(nw), pp=z(m), nn=z(m),
        zp=z(m) + 1.0, zn=z(m) + 1.0, dpp=z(m), dnn=z(m), dzp=z(m),
        dzn=z(m), pp_trial=z(m), nn_trial=z(m),
        filter=filter_init(filter_capacity))
    if lanes is not None:
        R.filter = filter_stack([R.filter] * lanes)
        for f in _RR_FLOATS:
            setattr(R, f, np.full(lanes, getattr(R, f), dtype=np.float64))
    return R


@dataclasses.dataclass
class State:
    # primal-dual iterate (nw,) / (m,)
    x: torch.Tensor
    y: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    xl: torch.Tensor
    xu: torch.Tensor
    # evaluations at the current iterate
    obj_val: float
    f: torch.Tensor
    c: torch.Tensor
    jac: torch.Tensor       # (nnzj + ns,) values, or the (m, nw) matrix
    hess: object            # (nnzh,) values, the (n, n) matrix, or a
    #                         LowRankHessian (compact L-BFGS, sparse KKT)
    jacl: torch.Tensor      # (nw,) Aᵀy
    # trial point
    x_trial: torch.Tensor
    obj_val_trial: float
    c_trial: torch.Tensor
    # direction / rhs
    d: KKTVec
    p: KKTVec
    # barrier / filter
    mu: float
    tau: float
    filter: Filter
    theta_max: float = 0.0
    theta_min: float = 0.0
    # regularization
    del_w: float = 0.0
    del_c: float = 0.0
    del_w_last: float = 0.0
    # residuals
    inf_pr: float = 0.0
    inf_du: float = 0.0
    inf_compl: float = 0.0
    inf_compl_mu: float = 0.0
    # step info
    alpha: float = 0.0
    alpha_z: float = 0.0
    ftype: int = 0
    # counters
    k: int = 0
    l_cnt: int = 0
    acceptable_cnt: int = 0
    unsuccessful_iterate: int = 0
    restoration_fail_count: int = 0
    t_cnt: int = 0
    factorization_cnt: int = 0
    backsolve_cnt: int = 0
    last_ir: int = 0
    obj_cnt: int = 0
    grad_cnt: int = 0
    con_cnt: int = 0
    jac_cnt: int = 0
    hess_cnt: int = 0
    status: int = 0
    scal: Scaling = None
    # soft restoration (restore!): the primal-dual error and the regular
    # iterate to return to when it switches to robust restoration
    soft_F: float = 0.0
    backup_x: torch.Tensor = None
    backup_y: torch.Tensor = None
    backup_c: torch.Tensor = None
    # robust restoration
    RR: RRState = None
    rr_init_needed: bool = False   # ROBUST entered, restorer not set up yet
    # adaptive barrier: free mode (True) or its monotone fallback
    barrier_free_mode: bool = True
    theta: object = None    # the model's parameters (parametric models)
    # quasi-Newton memory (p = 0 columns unless compact L-BFGS)
    qn: QNState = None
    # the KKT context of the last factorization (adaptive barriers only)
    ctx: object = None
    # iteration-log snapshot taken at the reference's print_iter position:
    # k, obj, inf_pr, inf_du, inf_compl, mu, del_w, alpha, ir, ls, ftype,
    # is_resto
    log_row: list = dataclasses.field(default_factory=lambda: [0.0] * 12)


def state_zeros(nw: int, m: int, jac: torch.Tensor, hess,
                filter_capacity: int, device, n: int = 0,
                qn_mem: int = 0) -> State:
    """A zero state; ``jac`` and ``hess`` are the problem's templates (value
    vectors for a sparse problem, matrices for a dense one, a
    LowRankHessian under compact L-BFGS on a sparse one), ``n`` the number
    of variables and ``qn_mem`` the quasi-Newton memory's columns."""
    def z(k):
        return torch.zeros((k,), dtype=torch.float64, device=device)

    return State(
        x=z(nw), y=z(m), zl=z(nw), zu=z(nw),
        xl=z(nw) - torch.inf, xu=z(nw) + torch.inf,
        obj_val=0.0, f=z(nw), c=z(m), jac=jac, hess=hess, jacl=z(nw),
        x_trial=z(nw), obj_val_trial=0.0, c_trial=z(m),
        d=kkt_zeros(nw, m, device), p=kkt_zeros(nw, m, device),
        mu=1e-1, tau=0.99, filter=filter_init(filter_capacity),
        scal=Scaling(1.0, torch.ones((m,), dtype=torch.float64, device=device)),
        backup_x=z(nw), backup_y=z(m), backup_c=z(m),
        RR=rr_zeros(nw, m, filter_capacity, device),
        qn=qn_zeros(n, qn_mem, device),
    )


_RR_FLOATS = ("obj_val_R", "theta_ref", "obj_val_R_trial", "inf_pr_R",
              "inf_du_R", "inf_compl_R", "mu_R", "tau_R", "zeta")
_VECTORS = ("x", "y", "zl", "zu", "xl", "xu", "f", "c", "jac", "hess", "jacl",
            "x_trial", "c_trial")   # the batch's tensors; one state's "hess"
#                                     may be a LowRankHessian instead
_FLOATS = ("obj_val", "obj_val_trial", "mu", "tau", "theta_max", "theta_min",
           "del_w", "del_c", "del_w_last", "inf_pr", "inf_du", "inf_compl",
           "inf_compl_mu", "alpha", "alpha_z")
_INTS = ("ftype", "k", "l_cnt", "acceptable_cnt", "unsuccessful_iterate",
         "restoration_fail_count", "t_cnt", "factorization_cnt",
         "backsolve_cnt", "last_ir", "obj_cnt", "grad_cnt", "con_cnt",
         "jac_cnt", "hess_cnt", "status")


def state_from_arrays(d: dict, device) -> State:
    """Build a :class:`State` from the leaves of the JAX package's ``State``
    converted to numpy.  Keys are the JAX field names; nested tuples use
    dotted keys: ``"d.xp"``…``"d.zu"``, ``"p.xp"``…, ``"filter.th"``,
    ``"filter.ph"``, ``"filter.count"``, ``"scal.obj_scale"``,
    ``"scal.con_scale"``, and ``"log_row"``.  The restoration leaves
    (``"backup_x"``, ``"backup_y"``, ``"backup_c"``, ``"soft_F"``,
    ``"rr_init_needed"`` and ``"RR.<field>"``, ``"RR.filter.th"``…) are
    read where present and zero otherwise.  The low-rank Hessian of compact
    L-BFGS on a sparse problem comes as ``"hess.diag"``, ``"hess.U"``,
    ``"hess.V"`` in place of ``"hess"``; the quasi-Newton memory as
    ``"qn.<field>"`` and the adaptive barrier's mode as
    ``"barrier_free_mode"``, each read where present (an empty memory and
    free mode otherwise).  The JAX package's persisted KKT context
    (``"ctx.*"``) is not read: the port keeps its own factor there, which
    an adaptive barrier's probing solves take from the previous
    factorization."""

    def vec(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), device=device)

    def filt(prefix):
        return Filter(
            np.asarray(d[f"{prefix}.th"], dtype=np.float64).copy(),
            np.asarray(d[f"{prefix}.ph"], dtype=np.float64).copy(),
            int(d[f"{prefix}.count"]),
        )

    fields = {k: vec(d[k]) for k in _VECTORS if k != "hess"}
    fields["hess"] = (vec(d["hess"]) if "hess" in d else LowRankHessian(
        *(vec(d[f"hess.{k}"]) for k in LowRankHessian._fields)))
    fields.update({k: float(d[k]) for k in _FLOATS})
    fields.update({k: int(d[k]) for k in _INTS})
    for name in ("d", "p"):
        fields[name] = KKTVec(*(vec(d[f"{name}.{part}"])
                                for part in KKTVec._fields))
    fields["filter"] = filt("filter")
    fields["scal"] = Scaling(float(d["scal.obj_scale"]),
                             vec(d["scal.con_scale"]))
    fields["log_row"] = [float(v) for v in np.asarray(d["log_row"])]
    st = State(**fields)
    nw, m = st.x.shape[0], st.y.shape[0]
    st.barrier_free_mode = bool(d.get("barrier_free_mode", True))
    if "qn.Sk" in d:
        st.qn = QNState(
            *(vec(d[f"qn.{k}"]) for k in QNState._fields[:5]),
            mem=int(d["qn.mem"]), skipped=int(d["qn.skipped"]),
            instantiated=bool(d["qn.instantiated"]))
    else:
        # an exact-Hessian state: the memory is never read
        st.qn = qn_zeros(st.hess.shape[0] if st.hess.ndim == 2 else nw, 0,
                         device)
    for k, size in (("backup_x", nw), ("backup_y", m), ("backup_c", m)):
        setattr(st, k, vec(d[k]) if k in d else st.x.new_zeros(size))
    st.soft_F = float(d.get("soft_F", 0.0))
    st.rr_init_needed = bool(d.get("rr_init_needed", False))
    st.RR = rr_zeros(nw, m, len(st.filter.th), device)
    if "RR.pp" in d:
        for f in dataclasses.fields(RRState):
            cur = getattr(st.RR, f.name)
            if f.name == "filter":
                val = filt("RR.filter")
            elif torch.is_tensor(cur):
                val = vec(d[f"RR.{f.name}"])
            else:
                val = float(d[f"RR.{f.name}"])
            setattr(st.RR, f.name, val)
    return st


@dataclasses.dataclass
class BatchState:
    """:class:`State` with a leading lane axis (``solve_batch``).  Vector
    fields are ``(B, ·)`` float64 tensors; the ``_FLOATS`` fields are
    float64 and the ``_INTS`` fields int64 numpy arrays ``(B,)``; the filter
    holds ``(B, capacity)`` tables; ``scal`` a ``(B,)`` objective scale and a
    ``(B, m)`` constraint scale; ``theta`` the ``(B,)`` parameters."""

    x: torch.Tensor
    y: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    xl: torch.Tensor
    xu: torch.Tensor
    f: torch.Tensor
    c: torch.Tensor
    jac: torch.Tensor
    hess: object            # (B, nnzh) values, or a batched LowRankHessian
    jacl: torch.Tensor
    x_trial: torch.Tensor
    c_trial: torch.Tensor
    d: KKTVec
    p: KKTVec
    filter: Filter
    scal: Scaling
    theta: torch.Tensor
    obj_val: np.ndarray = None
    obj_val_trial: np.ndarray = None
    mu: np.ndarray = None
    tau: np.ndarray = None
    theta_max: np.ndarray = None
    theta_min: np.ndarray = None
    del_w: np.ndarray = None
    del_c: np.ndarray = None
    del_w_last: np.ndarray = None
    inf_pr: np.ndarray = None
    inf_du: np.ndarray = None
    inf_compl: np.ndarray = None
    inf_compl_mu: np.ndarray = None
    alpha: np.ndarray = None
    alpha_z: np.ndarray = None
    ftype: np.ndarray = None
    k: np.ndarray = None
    l_cnt: np.ndarray = None
    acceptable_cnt: np.ndarray = None
    unsuccessful_iterate: np.ndarray = None
    restoration_fail_count: np.ndarray = None
    t_cnt: np.ndarray = None
    factorization_cnt: np.ndarray = None
    backsolve_cnt: np.ndarray = None
    last_ir: np.ndarray = None
    obj_cnt: np.ndarray = None
    grad_cnt: np.ndarray = None
    con_cnt: np.ndarray = None
    jac_cnt: np.ndarray = None
    hess_cnt: np.ndarray = None
    status: np.ndarray = None
    # soft restoration, per lane
    soft_F: np.ndarray = None
    backup_x: torch.Tensor = None
    backup_y: torch.Tensor = None
    backup_c: torch.Tensor = None
    # robust restoration: an RRState with a lane axis
    RR: RRState = None
    rr_init_needed: np.ndarray = None
    # step options, per lane: the quasi-Newton memory, the adaptive
    # barrier's mode, the last factorization's context (adaptive barriers)
    qn: QNState = None
    barrier_free_mode: np.ndarray = None
    ctx: object = None

    @property
    def lanes(self) -> int:
        return int(self.theta.shape[0])

    def take(self, order) -> "BatchState":
        """The lanes in ``order`` (a permutation or a selection)."""
        order = np.asarray(order, dtype=np.int64)
        idx = torch.as_tensor(order, device=self.x.device)

        def pick(v):
            if v is None:
                return None
            if isinstance(v, RRState):
                return RRState(**{f.name: pick(getattr(v, f.name))
                                  for f in dataclasses.fields(v)})
            if isinstance(v, tuple):
                return _rebuild(v, [pick(a) for a in v])
            if torch.is_tensor(v):
                return v[idx]
            return v[order].copy()

        return BatchState(**{f.name: pick(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


def _rebuild(like: tuple, items: list) -> tuple:
    """A tuple of ``like``'s type (a NamedTuple or a plain tuple) holding
    ``items``."""
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def split_lanes(st: BatchState, size: int) -> list:
    """Consecutive chunks of ``size`` lanes."""
    return [st.take(np.arange(i, i + size)) for i in range(0, st.lanes, size)]


def _join(vs):
    v = vs[0]
    if v is None:
        return None
    if isinstance(v, tuple):
        return _rebuild(v, [_join(list(a)) for a in zip(*vs)])
    if isinstance(v, RRState):
        return RRState(**{f.name: _join([getattr(s, f.name) for s in vs])
                          for f in dataclasses.fields(v)})
    if torch.is_tensor(v):
        return torch.cat(vs)
    return np.concatenate(vs)


def stack_lanes(parts: list) -> BatchState:
    """Rejoin chunks made by :func:`split_lanes` (in their order)."""
    return BatchState(**{f.name: _join([getattr(s, f.name) for s in parts])
                         for f in dataclasses.fields(BatchState)})


def batch_state_zeros(lanes: int, nw: int, m: int, nnzj: int, hess,
                      filter_capacity: int, theta: torch.Tensor,
                      device, n: int = 0, qn_mem: int = 0) -> BatchState:
    """A zero batch of ``lanes`` lanes; ``hess`` is the Hessian's batched
    template (the problem's ``hess_template(lanes)``), ``n`` the number of
    variables and ``qn_mem`` the quasi-Newton memory's columns."""
    def z(k):
        return torch.zeros((lanes, k), dtype=torch.float64, device=device)

    fields = {k: np.zeros(lanes) for k in _FLOATS}
    fields.update({k: np.zeros(lanes, dtype=np.int64) for k in _INTS})
    return BatchState(
        x=z(nw), y=z(m), zl=z(nw), zu=z(nw), xl=z(nw) - torch.inf,
        xu=z(nw) + torch.inf, f=z(nw), c=z(m), jac=z(nnzj), hess=hess,
        jacl=z(nw), x_trial=z(nw), c_trial=z(m),
        d=kkt_zeros(nw, m, device, lanes), p=kkt_zeros(nw, m, device, lanes),
        filter=filter_stack([filter_init(filter_capacity)] * lanes),
        scal=Scaling(torch.ones(lanes, dtype=torch.float64, device=device),
                     torch.ones((lanes, m), dtype=torch.float64,
                                device=device)),
        theta=theta, soft_F=np.zeros(lanes), backup_x=z(nw), backup_y=z(m),
        backup_c=z(m), RR=rr_zeros(nw, m, filter_capacity, device, lanes),
        rr_init_needed=np.zeros(lanes, dtype=bool),
        qn=qn_zeros(n, qn_mem, device, lanes),
        barrier_free_mode=np.ones(lanes, dtype=bool), **fields)


def batch_state_from_arrays(d: dict, device) -> BatchState:
    """:func:`state_from_arrays` with a leading lane axis on every leaf:
    the same keys, each holding the stacked ``(B, ...)`` leaves of B JAX
    states (a batched JAX ``State`` converted to numpy), plus ``"theta"``,
    the ``(B,)`` parameters.  The restoration leaves, the low-rank Hessian
    (``"hess.diag"``, ``"hess.U"``, ``"hess.V"``), the quasi-Newton memory
    (``"qn.<field>"``) and ``"barrier_free_mode"`` are read where present,
    as :func:`state_from_arrays` reads them; ``ctx`` stays None (the
    caller sets the port's own context where an adaptive barrier needs
    one)."""

    def vec(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), device=device)

    def filt(prefix):
        return Filter(
            np.asarray(d[f"{prefix}.th"], dtype=np.float64).copy(),
            np.asarray(d[f"{prefix}.ph"], dtype=np.float64).copy(),
            np.asarray(d[f"{prefix}.count"], dtype=np.int64).copy(),
        )

    fields = {k: vec(d[k]) for k in _VECTORS if k != "hess"}
    fields["hess"] = (vec(d["hess"]) if "hess" in d else LowRankHessian(
        *(vec(d[f"hess.{k}"]) for k in LowRankHessian._fields)))
    fields.update({k: np.asarray(d[k], dtype=np.float64).copy()
                   for k in _FLOATS})
    fields.update({k: np.asarray(d[k], dtype=np.int64).copy() for k in _INTS})
    for name in ("d", "p"):
        fields[name] = KKTVec(*(vec(d[f"{name}.{part}"])
                                for part in KKTVec._fields))
    fields["filter"] = filt("filter")
    fields["scal"] = Scaling(vec(d["scal.obj_scale"]),
                             vec(d["scal.con_scale"]))
    fields["theta"] = vec(d["theta"])
    B, nw = fields["x"].shape
    m = fields["y"].shape[1]
    st = BatchState(**fields)
    for k, size in (("backup_x", nw), ("backup_y", m), ("backup_c", m)):
        setattr(st, k, vec(d[k]) if k in d else st.x.new_zeros((B, size)))
    st.soft_F = np.asarray(d.get("soft_F", np.zeros(B)),
                           dtype=np.float64).copy()
    st.rr_init_needed = np.asarray(d.get("rr_init_needed", np.zeros(B)),
                                   dtype=bool).copy()
    st.RR = rr_zeros(nw, m, st.filter.th.shape[1], device, B)
    if "RR.pp" in d:
        for f in dataclasses.fields(RRState):
            if f.name == "filter":
                val = filt("RR.filter")
            elif f.name in _RR_FLOATS:
                val = np.asarray(d[f"RR.{f.name}"], dtype=np.float64).copy()
            else:
                val = vec(d[f"RR.{f.name}"])
            setattr(st.RR, f.name, val)
    st.barrier_free_mode = np.asarray(d.get("barrier_free_mode",
                                            np.ones(B)), dtype=bool).copy()
    if "qn.Sk" in d:
        st.qn = QNState(
            *(vec(d[f"qn.{k}"]) for k in QNState._fields[:5]),
            mem=np.asarray(d["qn.mem"], dtype=np.int64).copy(),
            skipped=np.asarray(d["qn.skipped"], dtype=np.int64).copy(),
            instantiated=np.asarray(d["qn.instantiated"], dtype=bool).copy())
    else:
        st.qn = qn_zeros(0, 0, device, B)
    return st
