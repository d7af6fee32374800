"""Synthetic AC optimal power flow — port of
``madnlp_tpu/models/instances/opf.py`` (``build``, ``build_sparse``).

The instance generator (:func:`_network`, :func:`_instance`) is a copy of
the JAX package's numpy code, so the same ``(nb, seed)`` gives identical
instance data in both packages.

:func:`build` is the dense-Ybus model (a :class:`DenseNLPModel`): the bus
injections ``S = V ∘ conj(Y V)`` as complex128 matrix products, with
closed-form polar derivatives from Wirtinger calculus (``analytic=True``)
or derivatives from ``torch.func`` (``analytic=False``).

:func:`build_sparse` is the edge-local sparse model.  Its derivatives are
closed forms of the per-edge flows (the JAX package gets the same values
by ``vmap`` of ``jacfwd``/``hessian`` over the edge list): with
``θ = va_i − va_j``, ``vv = vm_i·vm_j`` and each edge output
``f = vv·h(θ)``,

    ∂f/∂va_i = vv·h'   ∂f/∂va_j = −vv·h'   ∂f/∂vm_i = vm_j·h   ∂f/∂vm_j = vm_i·h

and ``h'' = −h``, so the 4×4 edge Hessian of ``Σ w_o f_o`` needs only
``H = Σ w_o h_o`` and ``H' = Σ w_o h_o'``.

Bus sums of edge flows are gather-sums over a host-built contributor table
(:mod:`..ops.segment`), so the constraint values are bit-identical from run
to run on the card.  Every sparse callable broadcasts over a leading lane
axis (``x (B, n)``), which is how ``solve_batch`` evaluates a batch of
scenarios in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.segment import segment_map, segment_sum
from ..model import DenseNLPModel, DeviceConstants, SparseNLPModel


def _network(nb: int, rng):
    """Ring + chords topology; returns the complex Ybus and the edge list
    (ei, ej, g_e, b_e) plus diagonal shunt susceptance."""
    edges = [(i, (i + 1) % nb) for i in range(nb)]
    # chords are *local* in ring distance, like real transmission networks
    # (near-planar, ~1.3 branches/bus): random long-range chords would make
    # the graph an expander, which no fill-reducing ordering can help —
    # unrepresentative of pglib cases
    n_chords = nb // 3
    max_span = max(3, min(30, nb // 20))
    for _ in range(n_chords):
        i = int(rng.integers(0, nb))
        span = int(rng.integers(2, max_span + 1))
        j = (i + span) % nb
        if i != j:
            edges.append((min(i, j), max(i, j)))
    ei = np.array([e[0] for e in edges])
    ej = np.array([e[1] for e in edges])
    r = rng.uniform(0.01, 0.05, len(edges))
    x = rng.uniform(0.05, 0.2, len(edges))
    y = 1.0 / (r + 1j * x)
    bsh = rng.uniform(0.0, 0.02, nb)

    Y = np.zeros((nb, nb), dtype=np.complex128)
    for k, (i, j) in enumerate(edges):
        Y[i, j] -= y[k]
        Y[j, i] -= y[k]
        Y[i, i] += y[k]
        Y[j, j] += y[k]
    Y[np.diag_indices(nb)] += 1j * bsh
    return Y, (ei, ej, np.real(y), np.imag(y), bsh)


def _instance(nb: int, seed: int) -> dict:
    """All numpy instance data of the ``(nb, seed)`` instance."""
    rng = np.random.default_rng(seed)
    Y, (ei, ej, ge, be, bsh) = _network(nb, rng)
    ng = max(2, nb // 4)
    gen_bus = np.unique(np.concatenate([[0], rng.integers(0, nb, ng - 1)]))
    ng = len(gen_bus)

    # draw an interior operating point and derive feasible loads
    vm0 = rng.uniform(0.95, 1.05, nb)
    va0 = np.concatenate([[0.0], rng.uniform(-0.2, 0.2, nb - 1)])
    V0 = vm0 * np.exp(1j * va0)
    S0 = V0 * np.conj(Y @ V0)
    pg0 = rng.uniform(0.2, 0.8, ng)
    qg0 = rng.uniform(-0.2, 0.2, ng)
    Pd = -np.real(S0)
    Qd = -np.imag(S0)
    Pd[gen_bus] += pg0
    Qd[gen_bus] += qg0
    pg_max = pg0 + rng.uniform(0.5, 1.0, ng)
    qg_box = np.abs(qg0) + rng.uniform(0.5, 1.0, ng)
    c2 = rng.uniform(0.5, 2.0, ng)
    c1 = rng.uniform(5.0, 20.0, ng)
    return dict(
        Y=Y, ei=ei, ej=ej, ge=ge, be=be, bsh=bsh, ng=ng, gen_bus=gen_bus,
        pg0=pg0, qg0=qg0, Pd=Pd, Qd=Qd, pg_max=pg_max, qg_box=qg_box,
        c2=c2, c1=c1,
    )


def _bounds(nb, ng, pg_max, qg_box):
    lvar = np.concatenate(
        [np.full(nb, -np.pi), np.full(nb, 0.9), np.zeros(ng), -qg_box]
    )
    uvar = np.concatenate(
        [np.full(nb, np.pi), np.full(nb, 1.1), pg_max, qg_box]
    )
    # slack bus angle fixed at 0
    lvar[0] = uvar[0] = 0.0
    return lvar, uvar


def build(nb: int = 118, seed: int = 0, parametric: bool = False,
          analytic: bool = True) -> DenseNLPModel:
    """Dense-Ybus ACOPF, n = 2·nb + 2·ng variables ``[va, vm, pg, qg]`` and
    m = 2·nb power-balance rows (same instance as the JAX package's
    ``opf.build(nb, seed, parametric, analytic)``).

    ``analytic=True`` installs the closed-form polar derivatives: with
    ``S = diag(V)·conj(Y V)``, ``u = V/vm`` and ``M = diag(V)·conj(Y)·
    diag(conj V)``,

        dS/dθ  = j·(diag(S) − M)
        dS/dvm = diag(S/vm) + M·diag(1/vm)

    and, for ``T = Re[wᵀS]`` with ``w = yP − j·yQ``, the Hessian from
    ``Hc = (diag(w)·conj(Y) + Yᵀ·diag(conj w))/2``, ``g = Hc·conj(V)``,
    ``Z = diag(V)·Hc·diag(conj V)``:

        H_θθ = 2Re Z − 2 diag(Re[g∘V])
        H_θv = −2 Im Z·diag(1/vm) − 2 diag(Im[g∘V]/vm)
        H_vv = 2Re Z ∘ (1/vm)(1/vm)ᵀ

    ``analytic=False`` leaves them to ``torch.func``.  ``parametric=True``:
    ``params`` is a scalar load-scaling factor multiplying Pd/Qd (the loads
    enter additively, so the derivatives ignore it)."""
    data = _instance(nb, seed)
    ng, gen_bus = int(data["ng"]), np.asarray(data["gen_bus"], np.int64)
    n = 2 * nb + 2 * ng
    m = 2 * nb
    # constant generator jacobian columns: dP_i/dpg_g = -1, dQ/dqg = -1
    Jg = np.zeros((m, 2 * ng))
    Jg[gen_bus, np.arange(ng)] = -1.0
    Jg[nb + gen_bus, ng + np.arange(ng)] = -1.0
    # bus-by-generator incidence: Pg = A_g·pg without in-place writes, so
    # that torch.func can differentiate the constraints (analytic=False)
    Ag = np.zeros((nb, ng))
    Ag[gen_bus, np.arange(ng)] = 1.0
    K = DeviceConstants(Y=data["Y"], Ag=Ag, Pd=data["Pd"], Qd=data["Qd"],
                        c2=data["c2"], c1=data["c1"], Jg=Jg,
                        gen_diag=2 * nb + np.arange(ng))

    def voltages(x):
        va, vm = x[:nb], x[nb:2 * nb]
        return vm, torch.complex(vm * torch.cos(va), vm * torch.sin(va))

    def cons_scaled(x, scale):
        k = K.on(x.device)
        _, V = voltages(x)
        S = V * torch.conj(k.Y @ V)
        Pg = k.Ag @ x[2 * nb:2 * nb + ng]
        Qg = k.Ag @ x[2 * nb + ng:]
        return torch.cat([S.real - Pg + scale * k.Pd,
                          S.imag - Qg + scale * k.Qd])

    def obj_x(x):
        k = K.on(x.device)
        pg = x[2 * nb:2 * nb + ng]
        return torch.sum(k.c2 * pg**2 + k.c1 * pg)

    def grad_x(x):
        k = K.on(x.device)
        g = torch.zeros_like(x)
        g[2 * nb:2 * nb + ng] = 2.0 * k.c2 * x[2 * nb:2 * nb + ng] + k.c1
        return g

    def jac_x(x):
        k = K.on(x.device)
        vm, V = voltages(x)
        S = V * torch.conj(k.Y @ V)
        M = V[:, None] * torch.conj(k.Y) * torch.conj(V)[None, :]
        dth = 1j * (torch.diag(S) - M)
        dvm = torch.diag(S / vm) + M / vm[None, :]
        return torch.cat([torch.cat([dth.real, dvm.real, k.Jg[:nb]], 1),
                          torch.cat([dth.imag, dvm.imag, k.Jg[nb:]], 1)])

    def hess_x(x, y, obj_weight):
        k = K.on(x.device)
        vm, V = voltages(x)
        w = torch.complex(y[:nb], -y[nb:])
        Hc = 0.5 * (w[:, None] * torch.conj(k.Y) + k.Y.T * torch.conj(w)[None, :])
        gV = (Hc @ torch.conj(V)) * V
        Z = V[:, None] * Hc * torch.conj(V)[None, :]
        inv_vm = 1.0 / vm
        Htt = 2.0 * Z.real - 2.0 * torch.diag(gV.real)
        Htv = -2.0 * Z.imag * inv_vm[None, :] - 2.0 * torch.diag(gV.imag * inv_vm)
        Hvv = 2.0 * Z.real * (inv_vm[:, None] * inv_vm[None, :])
        H = x.new_zeros((n, n))
        H[:nb, :nb] = Htt
        H[:nb, nb:2 * nb] = Htv
        H[nb:2 * nb, :nb] = Htv.T
        H[nb:2 * nb, nb:2 * nb] = Hvv
        H[k.gen_diag, k.gen_diag] = 2.0 * obj_weight * k.c2
        return H

    if parametric:
        def cons(x, scale):
            return cons_scaled(x, scale)

        def obj(x, scale):
            return obj_x(x)

        def grad(x, scale):
            return grad_x(x)

        def jac(x, scale):
            return jac_x(x)

        def lag_hess(x, y, obj_weight, scale):
            return hess_x(x, y, obj_weight)
    else:
        def cons(x):
            return cons_scaled(x, 1.0)

        obj, grad, jac, lag_hess = obj_x, grad_x, jac_x, hess_x

    lvar, uvar = _bounds(nb, ng, data["pg_max"], data["qg_box"])
    return DenseNLPModel(
        n=n,
        m=m,
        obj=obj,
        cons=cons,
        grad=grad,
        jac=jac if analytic else None,
        lag_hess=lag_hess if analytic else None,
        x0=np.concatenate([np.zeros(nb), np.ones(nb), data["pg0"],
                           data["qg0"]]),
        lvar=lvar,
        uvar=uvar,
        lcon=np.zeros(m),
        ucon=np.zeros(m),
        params=np.ones(()) if parametric else None,
        name=f"synthetic_acopf_nb{nb}",
    )


def build_sparse(nb: int = 118, seed: int = 0,
                 parametric: bool = False) -> SparseNLPModel:
    """Sparse ACOPF with edge-local derivatives, n = 2·nb + 2·ng variables
    and m = 2·nb power-balance rows (same instance as the JAX package's
    ``opf.build_sparse(nb, seed, parametric)``).

    ``parametric=True``: ``params`` is a scalar load-scaling factor that
    multiplies Pd/Qd — the multi-scenario model of ``solve_batch``.  The
    loads enter the constraints additively, so the derivative callbacks
    ignore it."""
    return build_sparse_from_instance(_instance(nb, seed), parametric)


def _edge_terms(g, b, c, s):
    """(h, h') of the four edge outputs (p_i, p_j, q_i, q_j), each
    (…, nl, 4); the off-diagonal Ybus entry of the edge is −(g + jb)."""
    h = torch.stack([-g * c - b * s, -g * c + b * s,
                     -g * s + b * c, g * s + b * c], dim=-1)
    hp = torch.stack([g * s - b * c, g * s + b * c,
                      -g * c - b * s, g * c - b * s], dim=-1)
    return h, hp


def build_sparse_from_instance(data: dict,
                               parametric: bool = False) -> SparseNLPModel:
    """Build the sparse ACOPF model from an instance dict as returned by
    ``_instance`` (numpy arrays; the JAX package's dict works as is)."""
    ei = np.asarray(data["ei"], dtype=np.int64)
    ej = np.asarray(data["ej"], dtype=np.int64)
    ge, be, bsh = data["ge"], data["be"], data["bsh"]
    gen_bus = np.asarray(data["gen_bus"], dtype=np.int64)
    ng = int(data["ng"])
    pg0, qg0 = data["pg0"], data["qg0"]
    Pd, Qd = data["Pd"], data["Qd"]
    pg_max, qg_box = data["pg_max"], data["qg_box"]
    c2, c1 = data["c2"], data["c1"]
    nb = len(Pd)
    n = 2 * nb + 2 * ng
    m = 2 * nb

    # diagonal Ybus terms: G_ii = Σ g_e, B_ii = Σ b_e + bsh
    Gd = np.zeros(nb)
    Bd = np.asarray(bsh, dtype=np.float64).copy()
    np.add.at(Gd, ei, ge)
    np.add.at(Gd, ej, ge)
    np.add.at(Bd, ei, be)
    np.add.at(Bd, ej, be)

    K = DeviceConstants(
        ei=ei, ej=ej, ge=ge, be=be, Gd=Gd, Bd=Bd, gen_bus=gen_bus,
        Pd=Pd, Qd=Qd, c2=c2, c1=c1,
        # bus i collects the i-side flow of its edges, then the j-side
        bus_table=segment_map(np.concatenate([ei, ej]), nb),
    )

    def split(x):
        return (x[..., :nb], x[..., nb:2 * nb], x[..., 2 * nb:2 * nb + ng],
                x[..., 2 * nb + ng:])

    def edge_state(x, k):
        va, vm = x[..., :nb], x[..., nb:2 * nb]
        th = va[..., k.ei] - va[..., k.ej]
        vmi, vmj = vm[..., k.ei], vm[..., k.ej]
        return torch.cos(th), torch.sin(th), vmi, vmj, vmi * vmj

    def cons_scaled(x, scale):
        k = K.on(x.device)
        _, vm, pg, qg = split(x)
        c, s, _, _, vv = edge_state(x, k)
        h, _ = _edge_terms(k.ge, k.be, c, s)
        flows = vv[..., None] * h                     # (..., nl, 4)
        P = segment_sum(torch.cat([flows[..., 0], flows[..., 1]], -1),
                        k.bus_table)
        Q = segment_sum(torch.cat([flows[..., 2], flows[..., 3]], -1),
                        k.bus_table)
        P = P + k.Gd * vm**2
        Q = Q - k.Bd * vm**2
        Pg = torch.zeros_like(P)
        Qg = torch.zeros_like(Q)
        Pg[..., k.gen_bus] = pg                       # gen_bus is unique
        Qg[..., k.gen_bus] = qg
        return torch.cat([P - Pg + scale * k.Pd, Q - Qg + scale * k.Qd], -1)

    def obj_x(x):
        k = K.on(x.device)
        pg = split(x)[2]
        return torch.sum(k.c2 * pg**2 + k.c1 * pg, dim=-1)

    def grad_x(x):
        k = K.on(x.device)
        g = torch.zeros_like(x)
        g[..., 2 * nb:2 * nb + ng] = 2.0 * k.c2 * split(x)[2] + k.c1
        return g

    # ---- static sparse structure (as in the JAX package) -----------------
    row_of_out = np.stack([ei, ej, nb + ei, nb + ej], axis=1)       # (nl, 4)
    col_of_in = np.stack([ei, ej, nb + ei, nb + ej], axis=1)        # (nl, 4)
    jac_rows = [np.repeat(row_of_out, 4, axis=1).reshape(-1)]
    jac_cols = [np.tile(col_of_in, (1, 4)).reshape(-1)]
    jac_rows += [np.arange(nb), nb + np.arange(nb)]
    jac_cols += [nb + np.arange(nb), nb + np.arange(nb)]
    jac_rows += [gen_bus, nb + gen_bus]
    jac_cols += [2 * nb + np.arange(ng), 2 * nb + ng + np.arange(ng)]
    jac_rows = np.concatenate(jac_rows)
    jac_cols = np.concatenate(jac_cols)

    def jac_coords(x):
        k = K.on(x.device)
        lead = x.shape[:-1]
        vm = x[..., nb:2 * nb]
        c, s, vmi, vmj, vv = edge_state(x, k)
        h, hp = _edge_terms(k.ge, k.be, c, s)
        # J_e[o, i] for outputs o = (p_i, p_j, q_i, q_j) and inputs
        # i = (va_i, va_j, vm_i, vm_j)
        J_e = torch.stack([vv[..., None] * hp, -vv[..., None] * hp,
                           vmj[..., None] * h, vmi[..., None] * h], dim=-1)
        node_p = 2.0 * k.Gd * vm
        node_q = -2.0 * k.Bd * vm
        gen = x.new_full(lead + (2 * ng,), -1.0)
        return torch.cat([J_e.reshape(lead + (-1,)), node_p, node_q, gen], -1)

    # hessian: per-edge 4×4 lower triangle (10 entries), node vm², gen pg²
    tril_i, tril_j = np.tril_indices(4)
    hr_e = col_of_in[:, tril_i]
    hc_e = col_of_in[:, tril_j]
    swap = hr_e < hc_e
    hess_rows = np.concatenate([np.where(swap, hc_e, hr_e).reshape(-1),
                                nb + np.arange(nb), 2 * nb + np.arange(ng)])
    hess_cols = np.concatenate([np.where(swap, hr_e, hc_e).reshape(-1),
                                nb + np.arange(nb), 2 * nb + np.arange(ng)])

    def hess_coords(x, y, obj_weight):
        """``obj_weight``: a float, or ``(B, 1)`` for a batch."""
        k = K.on(x.device)
        lead = x.shape[:-1]
        c, s, vmi, vmj, vv = edge_state(x, k)
        h, hp = _edge_terms(k.ge, k.be, c, s)
        yP, yQ = y[..., :nb], y[..., nb:]
        w4 = torch.stack([yP[..., k.ei], yP[..., k.ej], yQ[..., k.ei],
                          yQ[..., k.ej]], dim=-1)
        H = (w4 * h).sum(dim=-1)
        Hp = (w4 * hp).sum(dim=-1)
        aa = -vv * H                                  # ∂²/∂va_i² (h'' = −h)
        zero = torch.zeros_like(H)
        # tril order (0,0) (1,0) (1,1) (2,0) (2,1) (2,2) (3,0) (3,1) (3,2) (3,3)
        vals_e = torch.stack([aa, -aa, aa, vmj * Hp, -vmj * Hp, zero,
                              vmi * Hp, -vmi * Hp, H, zero], dim=-1)
        node = 2.0 * (k.Gd * yP - k.Bd * yQ)
        gen = (2.0 * obj_weight * k.c2).expand(lead + (ng,))
        return torch.cat([vals_e.reshape(lead + (-1,)), node, gen], -1)

    lvar = np.concatenate(
        [np.full(nb, -np.pi), np.full(nb, 0.9), np.zeros(ng), -qg_box]
    )
    uvar = np.concatenate(
        [np.full(nb, np.pi), np.full(nb, 1.1), pg_max, qg_box]
    )
    lvar[0] = uvar[0] = 0.0
    x0 = np.concatenate([np.zeros(nb), np.ones(nb), pg0, qg0])

    if parametric:
        def cons(x, scale):
            # (B,) scales against (B, m) rows; a 0-d scale broadcasts as is
            return cons_scaled(x, scale[..., None] if scale.ndim else scale)

        def obj(x, scale):
            return obj_x(x)

        def grad(x, scale):
            return grad_x(x)

        def jac_p(x, scale):
            return jac_coords(x)

        def hess_p(x, y, obj_weight, scale):
            return hess_coords(x, y, obj_weight)
    else:
        def cons(x):
            return cons_scaled(x, 1.0)

        obj, grad, jac_p, hess_p = obj_x, grad_x, jac_coords, hess_coords

    return SparseNLPModel(
        n=n,
        m=m,
        obj=obj,
        cons=cons,
        grad=grad,
        x0=x0,
        jac_rows=jac_rows,
        jac_cols=jac_cols,
        jac_coords=jac_p,
        hess_rows=hess_rows,
        hess_cols=hess_cols,
        hess_coords=hess_p,
        lvar=lvar,
        uvar=uvar,
        lcon=np.zeros(m),
        ucon=np.zeros(m),
        params=np.ones(()) if parametric else None,
        name=f"synthetic_acopf_sparse_nb{nb}",
    )
