"""MATPOWER case front end — port of ``madnlp_tpu/models/matpower.py``.

Real-data users load MATPOWER / pglib-opf ``.m`` case files.  This module
parses the case format (:func:`parse_case`, host-side regex and numpy, a
copy of the JAX package's code), normalises it to per-unit arrays
(:func:`_prepare`), builds multi-area test systems from verified cases
(:func:`tile_case`, :func:`interconnect_cases`) and builds the polar ACOPF
(:func:`build_acopf`) as

* ``sparse=True`` — a :class:`SparseNLPModel` with **branch-local
  derivatives**: per-branch 4×4 Jacobian and Hessian blocks of the branch
  end flows, nnz-sized evaluation.  The JAX package gets them by
  ``vmap(jacfwd)`` / ``vmap(hessian)`` of :func:`_branch_flows` and
  :func:`_branch_s2`; here they are closed forms (:func:`_flow_jac`,
  :func:`_flow_hess`, :func:`_s2_jac`, :func:`_s2_hess`).  With
  ``θ = va_f − va_t``, ``vv = vm_f·vm_t`` and each output
  ``F_o = a_o·vm² + vv·h_o(θ)``, ``h_o'' = −h_o``, so the Hessian of
  ``Σ w_o F_o`` needs only ``H = Σ w_o h_o``, ``H' = Σ w_o h_o'`` and the
  weighted quadratic coefficients.  ``parametric=True`` makes the load
  scale a parameter, which ``solve_batch`` batches over.
* ``sparse=False`` — a :class:`DenseNLPModel`: closed-form polar
  derivatives of the bus injections on the real and imaginary parts of the
  complex Ybus (``analytic=True``), or derivatives from ``torch.func``
  (``analytic=False``).

Formulation (polar, per-unit), MATPOWER's standard ACOPF:

    min  sum_g cost_g(pg_g * baseMVA)
    s.t. S_inj,i(V) + Ysh_i |V_i|^2 - (Sg - Sd)_i = 0        (2 nb rows)
         |S_f(V)|^2 <= rate_a^2,  |S_t(V)|^2 <= rate_a^2     (per rated branch)
         angmin <= va_f - va_t <= angmax                     (per limited branch)
         VMIN <= vm <= VMAX, va_ref fixed, gen boxes

Bus sums (branch flows into buses, generators into buses, duplicate
coordinates of the dense Hessian) are gathers over host-built contributor
tables (:mod:`..ops.segment`), never scatter-adds, so every callback gives
the same bits on every run on the card.  Every sparse callable broadcasts
over a leading lane axis (``x (B, n)``).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..ops.segment import segment_map, segment_sum
from .model import DenseNLPModel, DeviceConstants, SparseNLPModel

__all__ = ["parse_case", "build_acopf", "load_acopf"]


# --------------------------------------------------------------------------
# Parser
# --------------------------------------------------------------------------

_ASSIGN_RE = re.compile(r"mpc\.(\w+)\s*=\s*", re.S)


def _strip_comments(text: str) -> str:
    return "\n".join(line.split("%", 1)[0] for line in text.splitlines())


def _parse_matrix(body: str):
    """Rows separated by ';' or newlines, numbers by whitespace/commas.
    Returns a list of lists (possibly ragged, e.g. gencost)."""
    rows = []
    for chunk in re.split(r"[;\n]", body):
        toks = [t for t in re.split(r"[,\s]+", chunk.strip()) if t]
        if toks:
            rows.append([float(t) for t in toks])
    return rows


def parse_case(source: str) -> dict:
    """Parse MATPOWER case text (or a path to a ``.m`` file).

    Returns ``{"baseMVA": float, "bus": (nb,13+) array, "gen": array,
    "branch": array, "gencost": list-of-lists, "name": str}``.
    """
    if "\n" not in source and source.endswith(".m"):
        with open(source) as f:
            text = f.read()
        name = source.rsplit("/", 1)[-1][:-2]
    else:
        text = source
        m = re.search(r"function\s+mpc\s*=\s*(\w+)", text)
        name = m.group(1) if m else "matpower_case"

    text = _strip_comments(text)
    case = {"name": name, "version": "2"}
    for m in _ASSIGN_RE.finditer(text):
        key = m.group(1)
        rest = text[m.end():]
        if rest.lstrip().startswith("["):
            body = rest[rest.index("[") + 1: rest.index("]")]
            rows = _parse_matrix(body)
            if key == "gencost":
                case[key] = rows          # ragged: keep as list of lists
            else:
                width = min(len(r) for r in rows)
                case[key] = np.array([r[:width] for r in rows], dtype=np.float64)
        else:
            tok = rest.split(";", 1)[0].strip().strip("'\"")
            try:
                case[key] = float(tok)
            except ValueError:
                case[key] = tok
    for req in ("baseMVA", "bus", "gen", "branch"):
        if req not in case:
            raise ValueError(f"MATPOWER case missing mpc.{req}")
    return case


# --------------------------------------------------------------------------
# Case -> per-unit arrays
# --------------------------------------------------------------------------


def _prepare(case: dict) -> dict:
    """Normalize a parsed case into per-unit numpy arrays with 0-based
    consecutive bus indices; drops out-of-service branches and gens."""
    base = float(case["baseMVA"])
    bus = np.asarray(case["bus"], dtype=np.float64)
    gen = np.atleast_2d(np.asarray(case["gen"], dtype=np.float64))
    branch = np.atleast_2d(np.asarray(case["branch"], dtype=np.float64))

    nb = bus.shape[0]
    bus_ids = bus[:, 0].astype(np.int64)
    id2idx = {int(b): i for i, b in enumerate(bus_ids)}

    # gens: drop status==0
    if gen.shape[1] >= 8:
        gen = gen[gen[:, 7] > 0]
    gbus = np.array([id2idx[int(b)] for b in gen[:, 0]], dtype=np.int64)
    ng = len(gbus)

    # branches: drop status==0
    if branch.shape[1] >= 11:
        branch = branch[branch[:, 10] > 0]
    fbus = np.array([id2idx[int(b)] for b in branch[:, 0]], dtype=np.int64)
    tbus = np.array([id2idx[int(b)] for b in branch[:, 1]], dtype=np.int64)
    r, x, bc = branch[:, 2], branch[:, 3], branch[:, 4]
    ys = 1.0 / (r + 1j * x)
    tap = branch[:, 8].copy() if branch.shape[1] > 8 else np.ones(len(fbus))
    tap[tap == 0.0] = 1.0
    shift = (
        np.deg2rad(branch[:, 9]) if branch.shape[1] > 9 else np.zeros(len(fbus))
    )
    t = tap * np.exp(1j * shift)
    ych = 1j * bc / 2.0
    # standard MATPOWER pi-model admittances (makeYbus)
    Yff = (ys + ych) / (t * np.conj(t))
    Yft = -ys / np.conj(t)
    Ytf = -ys / t
    Ytt = ys + ych

    rate_a = branch[:, 5] / base if branch.shape[1] > 5 else np.zeros(len(fbus))
    if branch.shape[1] >= 13:
        angmin = np.deg2rad(branch[:, 11])
        angmax = np.deg2rad(branch[:, 12])
    else:
        angmin = np.full(len(fbus), -2 * np.pi)
        angmax = np.full(len(fbus), 2 * np.pi)

    # gencost -> per-gen polynomial coefficients of pg (per-unit), increasing
    # power order (the baseMVA^k rescale is folded in host-side)
    gencost = case.get("gencost")
    if gencost is None:
        C = np.zeros((ng, 2))
        C[:, 1] = base  # default linear cost = Pg in MW
    else:
        rows = [gencost[i] for i in range(len(gencost))]
        # gencost tracks the ORIGINAL gen table: norig rows of P costs,
        # optionally followed by norig rows of Q costs.  Split at norig
        # FIRST, then apply the same status filter used on the gen table,
        # so off-line gens never donate their cost rows to survivors.
        orig = np.atleast_2d(np.asarray(case["gen"], dtype=np.float64))
        norig = orig.shape[0]
        keep = orig[:, 7] > 0 if orig.shape[1] >= 8 else np.ones(norig, bool)
        if len(rows) >= 2 * norig:
            rows = rows[:norig]  # drop the reactive-power cost block
        if len(rows) == norig:
            rows = [r for r, k in zip(rows, keep) if k]
        if len(rows) != ng:
            raise ValueError(
                f"gencost has {len(gencost)} rows for {norig} gens "
                f"({ng} in service); expected norig or 2*norig rows"
            )
        K = 0
        coefs = []
        for row in rows:
            model = int(row[0])
            if model != 2:
                raise ValueError(
                    "only polynomial gencost (MODEL=2) is supported; "
                    "piecewise-linear costs must be pre-converted"
                )
            ncoef = int(row[3])
            c = np.array(row[4: 4 + ncoef], dtype=np.float64)[::-1]  # inc. order
            coefs.append(c)
            K = max(K, len(c))
        C = np.zeros((ng, max(K, 1)))
        for g, c in enumerate(coefs):
            # cost(pg_pu) = sum_k c_k (pg_pu * base)^k
            C[g, : len(c)] = c * base ** np.arange(len(c))

    ref = np.where(bus[:, 1] == 3)[0]
    return dict(
        base=base, nb=nb, ng=ng, gbus=gbus,
        Pd=bus[:, 2] / base, Qd=bus[:, 3] / base,
        gsh=bus[:, 4] / base, bsh=bus[:, 5] / base,
        vm0=bus[:, 7], va0=np.deg2rad(bus[:, 8]),
        vmax=bus[:, 11] if bus.shape[1] > 11 else np.full(nb, 1.1),
        vmin=bus[:, 12] if bus.shape[1] > 12 else np.full(nb, 0.9),
        pg0=gen[:, 1] / base, qg0=gen[:, 2] / base,
        qmax=gen[:, 3] / base, qmin=gen[:, 4] / base,
        pmax=gen[:, 8] / base, pmin=gen[:, 9] / base,
        fbus=fbus, tbus=tbus,
        Yff=Yff, Yft=Yft, Ytf=Ytf, Ytt=Ytt,
        rate_a=rate_a, angmin=angmin, angmax=angmax,
        ref=ref, cost_coefs=C, name=case.get("name", "matpower_case"),
    )


def _branch_consts(d):
    """Real/imag parts of the four pi-model admittances, stacked (nl, 8)."""
    return np.stack(
        [np.real(d["Yff"]), np.imag(d["Yff"]),
         np.real(d["Yft"]), np.imag(d["Yft"]),
         np.real(d["Ytf"]), np.imag(d["Ytf"]),
         np.real(d["Ytt"]), np.imag(d["Ytt"])], axis=1,
    )


# --------------------------------------------------------------------------
# Branch-local flows and their closed-form derivatives.  z (…, 4) holds
# (va_f, va_t, vm_f, vm_t), c (…, 8) the admittances (gff, bff, gft, bft,
# gtf, btf, gtt, btt); outputs are ordered (pf, pt, qf, qt).
# --------------------------------------------------------------------------


def _branch_terms(z, c):
    """(vm_f, vm_t, vv, h, h', a_f, a_t): each flow output is
    ``F_o = a_f[o]·vm_f² + a_t[o]·vm_t² + vv·h_o(θ)`` with ``h_o'' = −h_o``;
    h, h', a_f, a_t are (…, 4)."""
    vaf, vat, vmf, vmt = z.unbind(-1)
    gff, bff, gft, bft, gtf, btf, gtt, btt = c.unbind(-1)
    th = vaf - vat
    cth, sth = torch.cos(th), torch.sin(th)
    h = torch.stack([gft * cth + bft * sth, gtf * cth - btf * sth,
                     gft * sth - bft * cth, -(gtf * sth + btf * cth)], -1)
    hp = torch.stack([bft * cth - gft * sth, -(gtf * sth + btf * cth),
                      gft * cth + bft * sth, btf * sth - gtf * cth], -1)
    zero = torch.zeros_like(gff)
    a_f = torch.stack([gff, zero, -bff, zero], -1)
    a_t = torch.stack([zero, gtt, zero, -btt], -1)
    return vmf, vmt, vmf * vmt, h, hp, a_f, a_t


def _branch_flows(z, c):
    """Branch end flows (pf, pt, qf, qt), (…, 4).

    Sf = Vf conj(Yff Vf + Yft Vt), St = Vt conj(Ytf Vf + Ytt Vt)."""
    vaf, vat, vmf, vmt = z.unbind(-1)
    gff, bff, gft, bft, gtf, btf, gtt, btt = c.unbind(-1)
    th = vaf - vat
    cth, sth = torch.cos(th), torch.sin(th)
    vv = vmf * vmt
    pf = vmf**2 * gff + vv * (gft * cth + bft * sth)
    qf = -(vmf**2) * bff + vv * (gft * sth - bft * cth)
    pt = vmt**2 * gtt + vv * (gtf * cth - btf * sth)
    qt = -(vmt**2) * btt - vv * (gtf * sth + btf * cth)
    return torch.stack([pf, pt, qf, qt], -1)


def _branch_s2(z, c):
    """(|Sf|^2, |St|^2) for the thermal-limit rows, (…, 2)."""
    pf, pt, qf, qt = _branch_flows(z, c).unbind(-1)
    return torch.stack([pf**2 + qf**2, pt**2 + qt**2], -1)


def _flow_jac(z, c):
    """Jacobian of :func:`_branch_flows`, (…, 4 outputs, 4 inputs)."""
    vmf, vmt, vv, h, hp, a_f, a_t = _branch_terms(z, c)
    vmf, vmt, vv = vmf[..., None], vmt[..., None], vv[..., None]
    return torch.stack([vv * hp, -vv * hp, vmt * h + 2.0 * vmf * a_f,
                        vmf * h + 2.0 * vmt * a_t], -1)


def _flow_hess(z, c, w4):
    """Hessian of ``Σ_o w4[o]·F_o``, (…, 4, 4)."""
    vmf, vmt, vv, h, hp, a_f, a_t = _branch_terms(z, c)
    H = (w4 * h).sum(-1)
    Hp = (w4 * hp).sum(-1)
    Af = (w4 * a_f).sum(-1)
    At = (w4 * a_t).sum(-1)
    aa = -vv * H
    r0 = torch.stack([aa, -aa, vmt * Hp, vmf * Hp], -1)
    r1 = torch.stack([-aa, aa, -vmt * Hp, -vmf * Hp], -1)
    r2 = torch.stack([vmt * Hp, -vmt * Hp, 2.0 * Af, H], -1)
    r3 = torch.stack([vmf * Hp, -vmf * Hp, H, 2.0 * At], -1)
    return torch.stack([r0, r1, r2, r3], -2)


def _s2_jac(z, c):
    """Jacobian of :func:`_branch_s2`, (…, 2, 4)."""
    F = _branch_flows(z, c)
    J = _flow_jac(z, c)
    jf = 2.0 * (F[..., 0, None] * J[..., 0, :] + F[..., 2, None] * J[..., 2, :])
    jt = 2.0 * (F[..., 1, None] * J[..., 1, :] + F[..., 3, None] * J[..., 3, :])
    return torch.stack([jf, jt], -2)


def _s2_hess(z, c, w2):
    """Hessian of ``w2[0]·|Sf|² + w2[1]·|St|²``, (…, 4, 4): the Gauss-Newton
    part ``2 Σ w (∇p∇pᵀ + ∇q∇qᵀ)`` plus the flows' Hessian weighted by
    ``2 w·(p, q)``."""
    F = _branch_flows(z, c)
    J = _flow_jac(z, c)
    w = torch.stack([w2[..., 0], w2[..., 1], w2[..., 0], w2[..., 1]], -1)
    gn = 2.0 * torch.einsum("...o,...oi,...oj->...ij", w, J, J)
    return gn + _flow_hess(z, c, 2.0 * w * F)


def _poly_cols(C):
    """Split polynomial coefficient matrix into value/derivative tables."""
    K = C.shape[1]
    pows = np.arange(K)
    d1 = C * pows                      # coefficient of pg^(k-1)
    d2 = C * pows * (pows - 1)         # coefficient of pg^(k-2)
    return C, d1, d2, K


def build_acopf(case: dict, sparse: bool = True, branch_limits: bool = True,
                analytic: bool = True, parametric: bool = False):
    """Build the ACOPF NLP from a parsed case (see :func:`parse_case`).

    ``parametric=True`` (sparse only): ``params`` is a scalar load-scale
    multiplying Pd/Qd — enables ``solve_batch`` multi-scenario batching.

    For the dense form, ``analytic=True`` installs closed-form polar
    power-flow derivatives for the balance block (the dSbus_dV /
    d2Sbus_dV2 formulas, valid for the general non-symmetric Ybus that
    taps and phase shifters produce) plus the branch-local closed forms for
    the thermal-limit rows; ``analytic=False`` leaves the derivatives to
    ``torch.func``."""
    if parametric and not sparse:
        raise ValueError("parametric mode requires sparse=True")
    d = _prepare(case)
    nb, ng = d["nb"], d["ng"]
    fbus, tbus = d["fbus"], d["tbus"]
    consts = _branch_consts(d)

    lim_sel = np.where(d["rate_a"] > 0)[0] if branch_limits else np.array([], int)
    nlim = len(lim_sel)
    # angmin=angmax=0 is MATPOWER's 'angle difference unconstrained'
    # sentinel (caseformat doc) — exclude it, else every such branch gains
    # a spurious va_f == va_t equality.
    ang_ok = ((d["angmin"] > -np.pi) | (d["angmax"] < np.pi)) & ~(
        (d["angmin"] == 0.0) & (d["angmax"] == 0.0)
    )
    ang_sel = np.where(ang_ok)[0] if branch_limits else np.array([], int)
    nang = len(ang_sel)

    n = 2 * nb + 2 * ng
    m = 2 * nb + 2 * nlim + nang

    gbus = d["gbus"]
    C, D1, D2, Kc = _poly_cols(d["cost_coefs"])
    col_of_in = np.stack([fbus, tbus, nb + fbus, nb + tbus], axis=1)
    K = DeviceConstants(
        C=C, D1=D1, D2=D2, pows=np.arange(Kc, dtype=np.float64),
        pows1=np.maximum(np.arange(Kc) - 1, 0).astype(np.float64),
        pows2=np.maximum(np.arange(Kc) - 2, 0).astype(np.float64),
        Pd=d["Pd"], Qd=d["Qd"], gsh=d["gsh"], bsh=d["bsh"],
        f=fbus, t=tbus, consts=consts,
        lim_f=fbus[lim_sel], lim_t=tbus[lim_sel], lim_c=consts[lim_sel],
        ang_f=fbus[ang_sel], ang_t=tbus[ang_sel],
        # bus i collects the f-side flow of its branches, then the t-side
        bus_table=segment_map(np.concatenate([fbus, tbus]), nb),
        # several generators may sit on one bus
        gen_table=segment_map(gbus, nb),
    )

    def split(x):
        return (x[..., :nb], x[..., nb:2 * nb], x[..., 2 * nb:2 * nb + ng],
                x[..., 2 * nb + ng:])

    def obj(x):
        k = K.on(x.device)
        pg = split(x)[2]
        # sum_g sum_k C[g,k] pg^k
        return torch.sum(k.C * pg[..., None] ** k.pows, dim=(-2, -1))

    def grad(x):
        k = K.on(x.device)
        g = torch.zeros_like(x)
        pg = split(x)[2]
        g[..., 2 * nb:2 * nb + ng] = torch.sum(k.D1 * pg[..., None] ** k.pows1,
                                               dim=-1)
        return g

    def branch_z(va, vm, f, t):
        return torch.stack([va[..., f], va[..., t], vm[..., f], vm[..., t]], -1)

    def cons_scaled(x, scale):
        k = K.on(x.device)
        va, vm, pg, qg = split(x)
        flows = _branch_flows(branch_z(va, vm, k.f, k.t), k.consts)  # (…, nl, 4)
        P = segment_sum(torch.cat([flows[..., 0], flows[..., 1]], -1),
                        k.bus_table)
        Q = segment_sum(torch.cat([flows[..., 2], flows[..., 3]], -1),
                        k.bus_table)
        P = P + k.gsh * vm**2
        Q = Q - k.bsh * vm**2
        Pg = segment_sum(pg, k.gen_table)
        Qg = segment_sum(qg, k.gen_table)
        out = [P - Pg + scale * k.Pd, Q - Qg + scale * k.Qd]
        if nlim:
            s2 = _branch_s2(branch_z(va, vm, k.lim_f, k.lim_t), k.lim_c)
            out.append(s2.reshape(s2.shape[:-2] + (-1,)))
        if nang:
            out.append(va[..., k.ang_f] - va[..., k.ang_t])
        return torch.cat(out, -1)

    def cons(x):
        return cons_scaled(x, 1.0)

    # bounds
    lvar = np.concatenate([np.full(nb, -2 * np.pi), d["vmin"],
                           d["pmin"], d["qmin"]])
    uvar = np.concatenate([np.full(nb, 2 * np.pi), d["vmax"],
                           d["pmax"], d["qmax"]])
    for rb in d["ref"]:
        lvar[rb] = uvar[rb] = d["va0"][rb]
    lcon = np.concatenate([np.zeros(2 * nb),
                           np.full(2 * nlim, -np.inf),
                           d["angmin"][ang_sel]])
    # interleave sf2/st2 per branch: ucon rows are (sf2_0, st2_0, sf2_1, ...)
    ucon = np.concatenate([np.zeros(2 * nb),
                           np.repeat(d["rate_a"][lim_sel] ** 2, 2),
                           d["angmax"][ang_sel]])
    x0 = np.concatenate([
        d["va0"],
        np.clip(d["vm0"], d["vmin"] + 1e-4, d["vmax"] - 1e-4),
        np.clip(d["pg0"], d["pmin"], d["pmax"]),
        np.clip(d["qg0"], d["qmin"], d["qmax"]),
    ])
    name = d["name"]

    if not sparse:
        jac_fn = lag_hess_fn = None
        if analytic:
            jac_fn, lag_hess_fn = _dense_derivatives(
                d, K, split, branch_z, n, m, nlim, lim_sel, ang_sel)
        return DenseNLPModel(
            n=n, m=m, obj=obj, cons=cons, x0=x0,
            jac=jac_fn, lag_hess=lag_hess_fn,
            lvar=lvar, uvar=uvar, lcon=lcon, ucon=ucon,
            name=f"acopf_{name}",
        )

    # ---- sparse structure (branch-local derivatives) ---------------------
    # balance-block jacobian: per-branch 4 outputs x 4 inputs
    row_of_out = np.stack([fbus, tbus, nb + fbus, nb + tbus], axis=1)
    jac_rows = [np.repeat(row_of_out, 4, axis=1).reshape(-1)]
    jac_cols = [np.tile(col_of_in, (1, 4)).reshape(-1)]
    # bus-shunt diagonal d(P_i)/d(vm_i), d(Q_i)/d(vm_i)
    jac_rows += [np.arange(nb), nb + np.arange(nb)]
    jac_cols += [nb + np.arange(nb), nb + np.arange(nb)]
    # generator columns (duplicate (row,col) pairs from multiple gens on one
    # bus are summed by the KKT assembly's contributor gathers)
    jac_rows += [gbus, nb + gbus]
    jac_cols += [2 * nb + np.arange(ng), 2 * nb + ng + np.arange(ng)]
    if nlim:
        lim_rows = 2 * nb + np.arange(2 * nlim).reshape(nlim, 2)
        jac_rows += [np.repeat(lim_rows, 4, axis=1).reshape(-1)]
        jac_cols += [np.tile(col_of_in[lim_sel], (1, 2)).reshape(-1)]
    if nang:
        ang_rows = 2 * nb + 2 * nlim + np.arange(nang)
        jac_rows += [ang_rows, ang_rows]
        jac_cols += [fbus[ang_sel], tbus[ang_sel]]
    jac_rows = np.concatenate(jac_rows)
    jac_cols = np.concatenate(jac_cols)

    def jac_coords(x):
        k = K.on(x.device)
        lead = x.shape[:-1]
        va, vm, _, _ = split(x)
        Jb = _flow_jac(branch_z(va, vm, k.f, k.t), k.consts)      # (…, nl, 4, 4)
        parts = [Jb.reshape(lead + (-1,)),
                 2.0 * k.gsh * vm, -2.0 * k.bsh * vm,
                 x.new_full(lead + (2 * ng,), -1.0)]
        if nlim:
            Jl = _s2_jac(branch_z(va, vm, k.lim_f, k.lim_t), k.lim_c)
            parts.append(Jl.reshape(lead + (-1,)))
        if nang:
            parts.append(torch.cat([x.new_ones(lead + (nang,)),
                                    x.new_full(lead + (nang,), -1.0)], -1))
        return torch.cat(parts, -1)

    # hessian: per-branch 4x4 lower triangles (balance + limit blocks),
    # bus-shunt vm^2 diagonal, gen-cost pg^k diagonal
    tril_i, tril_j = np.tril_indices(4)

    def _tril_coords(var_of):
        hr = var_of[:, tril_i]
        hc = var_of[:, tril_j]
        swap = hr < hc
        return np.where(swap, hc, hr), np.where(swap, hr, hc)

    hr_b, hc_b = _tril_coords(col_of_in)
    hess_rows = [hr_b.reshape(-1), nb + np.arange(nb), 2 * nb + np.arange(ng)]
    hess_cols = [hc_b.reshape(-1), nb + np.arange(nb), 2 * nb + np.arange(ng)]
    if nlim:
        hr_l, hc_l = _tril_coords(col_of_in[lim_sel])
        hess_rows.append(hr_l.reshape(-1))
        hess_cols.append(hc_l.reshape(-1))
    hess_rows = np.concatenate(hess_rows)
    hess_cols = np.concatenate(hess_cols)

    def hess_coords(x, y, obj_weight):
        """``obj_weight``: a float, or ``(B, 1)`` for a batch."""
        k = K.on(x.device)
        lead = x.shape[:-1]
        va, vm, pg, _ = split(x)
        yP, yQ = y[..., :nb], y[..., nb:2 * nb]
        w4 = torch.stack([yP[..., k.f], yP[..., k.t], yQ[..., k.f],
                          yQ[..., k.t]], -1)
        Hb = _flow_hess(branch_z(va, vm, k.f, k.t), k.consts, w4)  # (…, nl, 4, 4)
        node = 2.0 * (k.gsh * yP - k.bsh * yQ)
        gen = obj_weight * torch.sum(k.D2 * pg[..., None] ** k.pows2, dim=-1)
        parts = [Hb[..., tril_i, tril_j].reshape(lead + (-1,)), node, gen]
        if nlim:
            yl = y[..., 2 * nb:2 * nb + 2 * nlim].reshape(lead + (nlim, 2))
            Hl = _s2_hess(branch_z(va, vm, k.lim_f, k.lim_t), k.lim_c, yl)
            parts.append(Hl[..., tril_i, tril_j].reshape(lead + (-1,)))
        return torch.cat(parts, -1)

    if parametric:
        # loads enter the balance rows additively: every derivative
        # callback is scale-independent (solve_batch multi-scenario OPF)
        def cons_p(x, scale):
            # (B,) scales against (B, m) rows; a 0-d scale broadcasts as is
            return cons_scaled(x, scale[..., None] if scale.ndim else scale)

        return SparseNLPModel(
            n=n, m=m,
            obj=lambda x, p: obj(x),
            cons=cons_p,
            grad=lambda x, p: grad(x),
            x0=x0,
            jac_rows=jac_rows, jac_cols=jac_cols,
            jac_coords=lambda x, p: jac_coords(x),
            hess_rows=hess_rows, hess_cols=hess_cols,
            hess_coords=lambda x, y, ow, p: hess_coords(x, y, ow),
            lvar=lvar, uvar=uvar, lcon=lcon, ucon=ucon,
            params=np.ones(()),
            name=f"acopf_{name}_sparse_parametric",
        )
    return SparseNLPModel(
        n=n, m=m, obj=obj, cons=cons, grad=grad, x0=x0,
        jac_rows=jac_rows, jac_cols=jac_cols, jac_coords=jac_coords,
        hess_rows=hess_rows, hess_cols=hess_cols, hess_coords=hess_coords,
        lvar=lvar, uvar=uvar, lcon=lcon, ucon=ucon,
        name=f"acopf_{name}_sparse",
    )


def _dense_derivatives(d, K, split, branch_z, n, m, nlim, lim_sel, ang_sel):
    """Closed-form dense ``jac(x) (m, n)`` and ``lag_hess(x, y, w) (n, n)``
    of the ACOPF: the polar bus-injection derivatives on the real and
    imaginary parts ``Gm, Bm`` of the complex Ybus, the constant generator
    and angle-difference rows, and the branch-local thermal-limit blocks."""
    nb, ng = d["nb"], d["ng"]
    fbus, tbus, gbus = d["fbus"], d["tbus"], d["gbus"]
    nang = len(ang_sel)
    # full complex Ybus (branches + bus shunts), host-side
    Ybus = np.zeros((nb, nb), dtype=np.complex128)
    np.add.at(Ybus, (fbus, fbus), d["Yff"])
    np.add.at(Ybus, (fbus, tbus), d["Yft"])
    np.add.at(Ybus, (tbus, fbus), d["Ytf"])
    np.add.at(Ybus, (tbus, tbus), d["Ytt"])
    Ybus[np.diag_indices(nb)] += d["gsh"] + 1j * d["bsh"]
    Jg = np.zeros((m, 2 * ng))
    Jg[gbus, np.arange(ng)] = -1.0
    Jg[nb + gbus, ng + np.arange(ng)] = -1.0
    ang_rows = 2 * nb + 2 * nlim + np.arange(nang)
    Jang = np.zeros((m, n))
    Jang[ang_rows, fbus[ang_sel]] = 1.0
    Jang[ang_rows, tbus[ang_sel]] = -1.0
    lim_cols = np.stack([fbus, tbus, nb + fbus, nb + tbus], axis=1)[lim_sel]
    lim_rows = 2 * nb + np.arange(2 * nlim).reshape(nlim, 2)
    lim = {}
    if nlim:
        # the limit blocks of different branches share buses: their Hessian
        # entries are summed into the dense matrix by a contributor gather
        hpos = (lim_cols[:, :, None] * n + lim_cols[:, None, :]).reshape(-1)
        hflat, hinv = np.unique(hpos, return_inverse=True)
        lim = dict(
            jlim=(lim_rows[:, :, None] * n + lim_cols[:, None, :]).reshape(-1),
            hflat=hflat, htable=segment_map(hinv.ravel(), len(hflat)))
    D = DeviceConstants(Gm=np.real(Ybus), Bm=np.imag(Ybus), Jg=Jg, Jang=Jang,
                        gen_diag=2 * nb + np.arange(ng), **lim)

    def _parts(x, k):
        va, vm, _, _ = split(x)
        cos, sin = torch.cos(va), torch.sin(va)
        e, f = vm * cos, vm * sin
        Ir = k.Gm @ e - k.Bm @ f
        Ii = k.Gm @ f + k.Bm @ e
        P = e * Ir + f * Ii
        Q = f * Ir - e * Ii
        Cr = e[:, None] * e[None, :] + f[:, None] * f[None, :]
        Ci = f[:, None] * e[None, :] - e[:, None] * f[None, :]
        return va, vm, e, f, P, Q, Cr, Ci

    def jac(x):
        k, c = D.on(x.device), K.on(x.device)
        va, vm, e, f, P, Q, Cr, Ci = _parts(x, k)
        CrG_CiB = Cr * k.Gm + Ci * k.Bm
        CiG_CrB = Ci * k.Gm - Cr * k.Bm
        inv_vm = 1.0 / vm
        dP_dth = torch.diag(-Q) + CiG_CrB
        dQ_dth = torch.diag(P) - CrG_CiB
        dP_dvm = torch.diag(P * inv_vm) + CrG_CiB * inv_vm[None, :]
        dQ_dvm = torch.diag(Q * inv_vm) + CiG_CrB * inv_vm[None, :]
        J = x.new_zeros((m, n))
        J[:nb, :nb] = dP_dth
        J[:nb, nb:2 * nb] = dP_dvm
        J[nb:2 * nb, :nb] = dQ_dth
        J[nb:2 * nb, nb:2 * nb] = dQ_dvm
        J[:, 2 * nb:] = k.Jg
        if nlim:
            # each limit row holds four distinct columns: no duplicates
            Jl = _s2_jac(branch_z(va, vm, c.lim_f, c.lim_t), c.lim_c)
            J.view(-1)[k.jlim] = Jl.reshape(-1)
        if nang:
            J = J + k.Jang
        return J

    def lag_hess(x, y, obj_weight):
        k, c = D.on(x.device), K.on(x.device)
        va, vm, e, f, P, Q, Cr, Ci = _parts(x, k)
        Gm, Bm = k.Gm, k.Bm
        yP, yQ = y[:nb], y[nb:2 * nb]
        Hcr = 0.5 * (
            yP[:, None] * Gm - yQ[:, None] * Bm
            + Gm.T * yP[None, :] - Bm.T * yQ[None, :]
        )
        Hci = 0.5 * (
            -(yQ[:, None] * Gm) - yP[:, None] * Bm
            + Bm.T * yP[None, :] + Gm.T * yQ[None, :]
        )
        gr = Hcr @ e + Hci @ f
        gi = Hci @ e - Hcr @ f
        ReZ = Cr * Hcr - Ci * Hci
        ImZ = Cr * Hci + Ci * Hcr
        inv_vm = 1.0 / vm
        Htt = 2.0 * ReZ - 2.0 * torch.diag(gr * e - gi * f)
        Htv = -2.0 * ImZ * inv_vm[None, :] - 2.0 * torch.diag(
            (gr * f + gi * e) * inv_vm)
        Hvv = 2.0 * ReZ * (inv_vm[:, None] * inv_vm[None, :])
        H = x.new_zeros((n, n))
        H[:nb, :nb] = Htt
        H[:nb, nb:2 * nb] = Htv
        H[nb:2 * nb, :nb] = Htv.T
        H[nb:2 * nb, nb:2 * nb] = Hvv
        pg = split(x)[2]
        H[k.gen_diag, k.gen_diag] = obj_weight * torch.sum(
            c.D2 * pg[:, None] ** c.pows2, dim=1)
        if nlim:
            yl = y[2 * nb:2 * nb + 2 * nlim].reshape(nlim, 2)
            Hl = _s2_hess(branch_z(va, vm, c.lim_f, c.lim_t), c.lim_c, yl)
            Hf = H.view(-1)
            Hf[k.hflat] = Hf[k.hflat] + segment_sum(Hl.reshape(-1), k.htable)
        return H

    return jac, lag_hess


def load_acopf(path: str, sparse: bool = True, branch_limits: bool = True):
    """Parse a MATPOWER ``.m`` file and build the ACOPF model."""
    return build_acopf(parse_case(path), sparse=sparse,
                       branch_limits=branch_limits)


def tile_case(case: dict, K: int, ties: str = "ring", n_tie: int = 3,
              tie_r: float = 0.01, tie_x: float = 0.05) -> dict:
    """Multi-area interconnection of ``K`` copies of a REAL case.

    * ``ties=None`` — ``K`` electrically independent areas solved as ONE
      NLP: each copy keeps its slack bus, and the optimal objective is
      EXACTLY ``K×`` the published single-area optimum.
    * ``ties="ring"`` — consecutive copies are tied at the ``n_tie``
      highest-voltage load buses through r+jx lines (one global slack).
    * ``ties="grid2d"`` — copies arranged on a ``rows×cols`` grid
      (``K`` factored as square as possible), tied along horizontal AND
      vertical grid edges.

    The exact ``K×`` anchor holds for BOTH tied variants: every tie
    connects bus ``b`` of copy ``i`` to the *same* bus ``b`` of copy
    ``j``, so the configuration with all copies at the single-area
    optimum has equal complex voltages at every tie's endpoints — zero
    tie flow, feasible, and stationary by symmetry.

    Bus ids of copy ``k`` are shifted by ``k * 10**ceil(log10(max_id+1))``.
    """
    bus = np.atleast_2d(np.asarray(case["bus"], dtype=np.float64))
    gen = np.atleast_2d(np.asarray(case["gen"], dtype=np.float64))
    branch = np.atleast_2d(np.asarray(case["branch"], dtype=np.float64))
    gencost = case.get("gencost")
    off = 10 ** int(np.ceil(np.log10(bus[:, 0].max() + 1)))

    # gencost tracks the gen table: norig P-cost rows optionally followed
    # by norig Q-cost rows — keep the two blocks contiguous when tiling
    pcost = qcost = None
    if gencost is not None:
        norig = gen.shape[0]
        rows = [list(r) for r in gencost]
        if len(rows) >= 2 * norig:
            pcost, qcost = rows[:norig], rows[norig: 2 * norig]
        else:
            pcost = rows

    buses, gens, branches = [], [], []
    for k in range(K):
        b = bus.copy()
        b[:, 0] += k * off
        if ties is not None and k > 0:
            # single global slack: demote other copies' slack to PV
            b[b[:, 1] == 3, 1] = 2
        g = gen.copy()
        g[:, 0] += k * off
        br = branch.copy()
        br[:, 0] += k * off
        br[:, 1] += k * off
        buses.append(b)
        gens.append(g)
        branches.append(br)
    costs = (pcost * K if pcost else []) + (qcost * K if qcost else [])

    if ties is not None and K > 1:
        # tie buses: the n_tie highest-voltage load buses (deterministic)
        load = bus[bus[:, 2] > 0] if (bus[:, 2] > 0).any() else bus
        order = np.lexsort((load[:, 2], load[:, 9]))[::-1]
        tie_ids = load[order[:n_tie], 0].astype(np.int64)
        width = branch.shape[1]
        if ties == "grid2d":
            rows_g = int(np.floor(np.sqrt(K)))
            while K % rows_g:
                rows_g -= 1
            cols_g = K // rows_g
            if rows_g == 1 and cols_g == 1:
                raise ValueError("grid2d ties need K > 1")
            grid = np.arange(K).reshape(rows_g, cols_g)
            pairs = [
                (int(grid[i, j]), int(grid[i, j + 1]))
                for i in range(rows_g) for j in range(cols_g - 1)
            ] + [
                (int(grid[i, j]), int(grid[i + 1, j]))
                for i in range(rows_g - 1) for j in range(cols_g)
            ]
        else:
            pairs = [(k, (k + 1) % K) for k in range(K if K > 2 else 1)]
        for k, k2 in pairs:
            for tid in tie_ids:
                row = np.zeros(width)
                row[0] = tid + k * off
                row[1] = tid + k2 * off
                row[2], row[3] = tie_r, tie_x
                if width > 10:
                    row[10] = 1.0            # in service
                if width >= 13:
                    row[11], row[12] = -360.0, 360.0
                branches.append(row[None, :])

    out = dict(case)
    out["bus"] = np.concatenate(buses)
    out["gen"] = np.concatenate(gens)
    out["branch"] = np.concatenate(branches)
    if gencost is not None:
        out["gencost"] = costs
    tie_tag = "x%d" % K if ties is None else "x%d_%s" % (K, ties)
    out["name"] = f"{case.get('name', 'case')}_{tie_tag}"
    return out


def interconnect_cases(cases, ties: str = "chain", n_tie: int = 3,
                       tie_r: float = 0.01, tie_x: float = 0.05) -> dict:
    """Heterogeneous interconnection of DIFFERENT real cases (e.g.
    case57 + case118) into one system.

    * ``ties=None`` — electrically independent union as ONE NLP: the
      optimum is EXACTLY the sum of the published per-case optima (each
      area keeps its slack).
    * ``ties="chain"`` — consecutive cases tied at their ``n_tie``
      highest-voltage load buses (pairwise, one global slack).  Areas with
      different marginal costs trade power over the ties, so the objective
      is only *near* the sum.

    All cases must share ``baseMVA``.
    """
    if len(cases) < 2:
        raise ValueError("interconnect_cases needs at least two cases")
    base_mva = {float(c.get("baseMVA", 100.0)) for c in cases}
    if len(base_mva) != 1:
        raise ValueError(f"baseMVA mismatch: {base_mva}")
    max_id = max(
        int(np.atleast_2d(np.asarray(c["bus"]))[:, 0].max()) for c in cases
    )
    off = 10 ** int(np.ceil(np.log10(max_id + 1)))

    buses, gens, branches, pcosts, qcosts = [], [], [], [], []
    have_q = all(
        c.get("gencost") is not None
        and len(c["gencost"]) >= 2 * np.atleast_2d(np.asarray(c["gen"])).shape[0]
        for c in cases
    )
    tie_bus_ids = []
    width = max(
        np.atleast_2d(np.asarray(c["branch"])).shape[1] for c in cases
    )
    for k, c in enumerate(cases):
        bus = np.atleast_2d(np.asarray(c["bus"], dtype=np.float64)).copy()
        gen = np.atleast_2d(np.asarray(c["gen"], dtype=np.float64)).copy()
        br = np.atleast_2d(np.asarray(c["branch"], dtype=np.float64))
        w0 = br.shape[1]
        if w0 < width:  # pad to the widest branch table with MATPOWER
            # defaults for the PADDED columns only (status in-service,
            # angle limits open) — zeros would silently disable branches
            pad = np.zeros((br.shape[0], width - w0))
            br = np.concatenate([br, pad], axis=1)
            if w0 <= 10 < width:
                br[:, 10] = 1.0
            for col in (11, 12):
                if w0 <= col < width:
                    br[:, col] = -360.0 if col == 11 else 360.0
        br = br.copy()
        load = bus[bus[:, 2] > 0] if (bus[:, 2] > 0).any() else bus
        order = np.lexsort((load[:, 2], load[:, 9]))[::-1]
        tie_bus_ids.append(
            load[order[:n_tie], 0].astype(np.int64) + k * off
        )
        bus[:, 0] += k * off
        if ties is not None and k > 0:
            bus[bus[:, 1] == 3, 1] = 2       # single global slack
        gen[:, 0] += k * off
        br[:, 0] += k * off
        br[:, 1] += k * off
        buses.append(bus)
        gens.append(gen)
        branches.append(br)
        gc = c.get("gencost")
        if gc is not None:
            norig = gen.shape[0]
            rows = [list(r) for r in gc]
            pcosts.extend(rows[:norig])
            if have_q:
                qcosts.extend(rows[norig: 2 * norig])

    if ties is not None:
        for k in range(len(cases) - 1):
            npair = min(len(tie_bus_ids[k]), len(tie_bus_ids[k + 1]))
            for a, b in zip(tie_bus_ids[k][:npair], tie_bus_ids[k + 1][:npair]):
                row = np.zeros(width)
                row[0], row[1] = a, b
                row[2], row[3] = tie_r, tie_x
                if width > 10:
                    row[10] = 1.0
                if width >= 13:
                    row[11], row[12] = -360.0, 360.0
                branches.append(row[None, :])

    names = "+".join(c.get("name", "case") for c in cases)
    return {
        "baseMVA": base_mva.pop(),
        "bus": np.concatenate(buses),
        "gen": np.concatenate(gens),
        "branch": np.concatenate(branches),
        "gencost": pcosts + qcosts,
        "name": f"mix_{names}" + ("" if ties is None else f"_{ties}"),
    }
