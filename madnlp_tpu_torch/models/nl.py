"""AMPL ``.nl`` front end — port of ``madnlp_tpu/models/nl.py``
(``read_nl``, ``write_sol``, ``read_sol``, ``solve_nl``, ``convert_nl``,
``write_nl_binary`` and the solver executable ``main``).

Reads the text (``g`` header) and binary (``b`` header, either byte order)
encodings of an ``.nl`` file (D. Gay, "Writing .nl files", 2005) into
nested-tuple expression graphs, compiles them into torch callables whose
derivatives come from ``torch.func`` (the dense compiler here) or into a
:class:`~.model.SparseNLPModel` with exact COO sparsity (the template
compiler, :mod:`.nl_sparse`), and writes the matching ``.sol`` file, so
the port serves as an AMPL / Pyomo solver executable::

    model = read_nl("hs015.nl")
    stats = madnlp(model)                 # on the card; device="cpu" here
    write_sol("hs015.sol", stats, model)

or from a shell::

    python -m madnlp_tpu_torch.models.nl model.nl -AMPL tol=1e-8
    madnlp-tpu-torch-ampl model -AMPL device=cpu

The parser is the JAX package's, line for line, so both packages read a
file into the same ``ParsedNL``.  Each opcode maps to the torch function
with the JAX package's value and derivative: ties of ``max``/``min`` (and
``less``) split the derivative in halves, ``abs`` has derivative 1 at 0,
``floor`` and ``ceil`` 0 at their steps, and integer powers stay integer
powers.
Not supported (clear errors): complementarity constraints, logical
constraints, external functions, piecewise-linear terms, suffixes inside
binary files.
"""

from __future__ import annotations

import struct
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from .model import DenseNLPModel, DeviceConstants

# --------------------------------------------------------------------------
# opcode table (ASL opcode.hd numbering — the on-disk format's operator ids)
#
# An operand is a tensor or, for a subexpression made of constants only, a
# Python float; the torch functions get tensors (:func:`_lift`).
# --------------------------------------------------------------------------


def _lift(args, like):
    """Python-float operands as 0-d tensors of ``like``'s dtype and device
    (``like``: the first tensor operand, else the evaluation's reference
    tensor)."""
    ref = next((a for a in args if isinstance(a, torch.Tensor)), like)
    return [a if isinstance(a, torch.Tensor)
            else torch.full((), float(a), dtype=ref.dtype, device=ref.device)
            for a in args]


def _abs(a):
    # |a| with the JAX package's derivative at 0 (1, where torch.abs has 0);
    # adding 0.0 turns where's -0.0 into abs's +0.0
    return torch.where(a >= 0, a, -a) + 0.0


def _maximum(a, b):
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return max(a, b)
    return torch.maximum(*_lift((a, b), None))


def _minimum(a, b):
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return min(a, b)
    return torch.minimum(*_lift((a, b), None))


_BINARY = {
    0: lambda a, b: a + b,
    1: lambda a, b: a - b,
    2: lambda a, b: a * b,
    3: lambda a, b: a / b,
    4: torch.fmod,                               # AMPL `rem`
    6: lambda a, b: _maximum(a - b, 0.0),        # AMPL `less`
    48: torch.atan2,
    55: lambda a, b: torch.trunc(a / b),         # integer `div`
}

_UNARY = {
    13: torch.floor,
    14: torch.ceil,
    15: _abs,
    16: lambda a: -a,
    37: torch.tanh,
    38: torch.tan,
    39: torch.sqrt,
    40: torch.sinh,
    41: torch.sin,
    42: torch.log10,
    43: torch.log,
    44: torch.exp,
    45: torch.cosh,
    46: torch.cos,
    47: torch.atanh,
    49: torch.atan,
    50: torch.asinh,
    51: torch.asin,
    52: torch.acosh,
    53: torch.acos,
}

# the operators that take Python floats as they are
_ARITHMETIC = {0, 1, 2, 3, 16}

# relational / boolean opcodes (used inside `if` conditions)
_RELATIONAL = {
    22: lambda a, b: a < b,
    23: lambda a, b: a <= b,
    24: lambda a, b: a == b,
    28: lambda a, b: a >= b,
    29: lambda a, b: a > b,
    30: lambda a, b: a != b,
}

_NARY = {
    11: lambda args: _reduce(_minimum, args),      # MINLIST
    12: lambda args: _reduce(_maximum, args),      # MAXLIST
    54: lambda args: sum(args[1:], args[0]),       # OPSUMLIST
}

_OP_NAMES = {
    5: "pow", 20: "or", 21: "and", 34: "not", 35: "if",
    56: "precision", 57: "round", 58: "trunc", 59: "count",
    60: "numberof", 61: "numberofs", 64: "piecewise-linear term",
    79: "external function call",
}


def _reduce(f, args):
    out = args[0]
    for a in args[1:]:
        out = f(out, a)
    return out


# --------------------------------------------------------------------------
# source readers — one segment grammar, two on-disk encodings.
#
# Text: one token/record per line, `#` starts a comment.  Binary (AMPL's
# default, `b` header): the SAME segment/expression structure — segment
# letters and expression node letters stay single ASCII bytes (the ASL
# reader shares one edag_peek switch across modes) — with the numeric
# payloads as native binary: 4-byte ints, 8-byte doubles, 2-byte shorts
# ('s' nodes) and 4-byte longs ('l' nodes); no newlines, no comments.
# --------------------------------------------------------------------------

class _Stream:
    def __init__(self, lines: List[str]):
        self.lines = lines
        self.pos = 0

    def next(self) -> Optional[str]:
        while self.pos < len(self.lines):
            raw = self.lines[self.pos]
            self.pos += 1
            body = raw.split("#", 1)[0].strip()
            if body:
                return body
        return None

    def expect(self) -> str:
        tok = self.next()
        if tok is None:
            raise ValueError("unexpected end of .nl file")
        return tok


class _TextSrc:
    """Text-format record source (line tokens)."""

    def __init__(self, lines: List[str]):
        self._s = _Stream(lines)

    def seg(self) -> Optional[Tuple[str, List[str]]]:
        tok = self._s.next()
        if tok is None:
            return None
        return tok[0], tok[1:].split()

    def iv(self) -> Tuple[int, float]:            # (index, value) record
        i, v = self._s.expect().split()
        return int(i), float(v)

    def int1(self) -> int:
        return int(self._s.expect())

    def count(self) -> int:                        # N-ary operand count
        return int(self._s.expect())

    def bound(self) -> Tuple[float, float]:
        return _read_bound(self._s.expect())

    def suffix(self, n: int) -> None:              # skip n (idx, val) records
        for _ in range(n):
            self._s.expect()

    def expr_tok(self) -> Tuple[str, object]:
        tok = self._s.expect()
        c, rest = tok[0], tok[1:].strip()
        if c in "nsl":                 # numeric / short / long constant
            return "n", float(rest)
        if c == "v":
            return "v", int(rest)
        if c == "o":
            return "o", int(rest.split()[0])
        return c, rest                 # f/h/garbage — _read_expr raises


class _BinSrc:
    """Binary-format record source (struct decoding over the payload that
    follows the 10-line ASCII header)."""

    def __init__(self, data: bytes, little_endian: bool = True):
        self._d = data
        self._p = 0
        self._e = "<" if little_endian else ">"

    def _chr(self) -> Optional[str]:
        if self._p >= len(self._d):
            return None
        c = chr(self._d[self._p])
        self._p += 1
        return c

    def _unpack(self, fmt: str, size: int):
        if self._p + size > len(self._d):
            raise ValueError("unexpected end of binary .nl payload")
        v = struct.unpack_from(self._e + fmt, self._d, self._p)[0]
        self._p += size
        return v

    def _int(self) -> int:
        return self._unpack("i", 4)

    def _dbl(self) -> float:
        return self._unpack("d", 8)

    # segment-header parameter counts, by segment letter
    _SEG_NPARAMS = {"C": 1, "O": 2, "x": 1, "d": 1, "r": 0, "b": 0,
                    "k": 1, "K": 1, "J": 2, "G": 2, "V": 3}

    def seg(self) -> Optional[Tuple[str, List[str]]]:
        c = self._chr()
        if c is None:
            return None
        if c == "S":
            raise NotImplementedError(
                ".nl suffixes in BINARY files unsupported (suffix names are "
                "writer-dependent strings); re-export in text mode"
            )
        if c in ("L", "F"):
            return c, []               # main loop raises with a clear message
        n = self._SEG_NPARAMS.get(c)
        if n is None:
            raise ValueError(f"unknown binary .nl segment {c!r}")
        return c, [str(self._int()) for _ in range(n)]

    def iv(self) -> Tuple[int, float]:
        return self._int(), self._dbl()

    def int1(self) -> int:
        return self._int()

    def count(self) -> int:
        return self._int()

    def bound(self) -> Tuple[float, float]:
        code = self._chr()             # bound codes stay ASCII digit bytes
        if code == "0":
            return self._dbl(), self._dbl()
        if code == "1":
            return -np.inf, self._dbl()
        if code == "2":
            return self._dbl(), np.inf
        if code == "3":
            return -np.inf, np.inf
        if code == "4":
            v = self._dbl()
            return v, v
        if code == "5":
            raise NotImplementedError(
                ".nl complementarity constraints (bound code 5) unsupported"
            )
        raise ValueError(f"bad bound code in binary .nl: {code!r}")

    def suffix(self, n: int) -> None:  # unreachable: seg() rejects 'S'
        raise NotImplementedError(".nl suffixes in binary files unsupported")

    def expr_tok(self) -> Tuple[str, object]:
        c = self._chr()
        if c == "n":
            return "n", self._dbl()
        if c == "s":                   # short int constant, 2 bytes
            return "n", float(self._unpack("h", 2))
        if c == "l":                   # long int constant, 4 bytes
            return "n", float(self._int())
        if c == "v":
            return "v", self._int()
        if c == "o":
            return "o", self._int()
        return c or "", ""             # f/h/EOF — _read_expr raises


# --------------------------------------------------------------------------
# expression graph: parse (prefix order) and evaluate (torch)
# --------------------------------------------------------------------------

def _read_expr(src):
    """Read one prefix-order expression; returns a nested-tuple AST."""
    c, val = src.expr_tok()
    if c == "n":                       # numeric constant
        return ("const", float(val))
    if c == "v":                       # variable or defined-variable reference
        return ("var", int(val))
    if c == "o":
        op = int(val)
        if op in _NARY:
            count = src.count()
            return (op, tuple(_read_expr(src) for _ in range(count)))
        if op in _BINARY or op in _RELATIONAL or op in (5, 20, 21):
            return (op, (_read_expr(src), _read_expr(src)))
        if op in _UNARY or op == 34:
            return (op, (_read_expr(src),))
        if op == 35:                   # OPIFnl: if cond then e1 else e2
            return (op, (_read_expr(src), _read_expr(src), _read_expr(src)))
        raise NotImplementedError(
            f".nl opcode o{op} ({_OP_NAMES.get(op, 'unknown')}) is not "
            "supported (smooth NLP opcodes only)"
        )
    if c == "f":
        raise NotImplementedError(".nl external function calls (f) unsupported")
    if c == "h":
        raise NotImplementedError(".nl string arguments (h) unsupported")
    raise ValueError(f"unexpected token in .nl expression: {(c, val)!r}")


def _apply(kind, payload, args, like):
    """Apply operator ``kind`` of the AST node ``(kind, payload)`` to its
    evaluated operands ``args`` (tensors or Python floats; ``like`` is the
    reference tensor that gives a constant its dtype and device)."""
    if kind == 5:                      # pow — keep integer powers exact for AD
        expo = payload[1]
        if expo[0] == "const" and float(expo[1]).is_integer():
            return args[0] ** int(expo[1])
        return args[0] ** args[1]
    if kind in _NARY:
        return _NARY[kind](args)
    if kind in _RELATIONAL:
        return _RELATIONAL[kind](*args)
    if kind not in _ARITHMETIC:
        args = _lift(args, like)
    if kind in _BINARY:
        return _BINARY[kind](*args)
    if kind in _UNARY:
        return _UNARY[kind](*args)
    if kind == 20:
        return torch.logical_or(args[0], args[1])
    if kind == 21:
        return torch.logical_and(args[0], args[1])
    if kind == 34:
        return torch.logical_not(args[0])
    if kind == 35:
        return torch.where(args[0], args[1], args[2])
    raise AssertionError(f"unreachable opcode {kind}")


def _eval_expr(node, env, like=None):
    """Evaluate an AST against ``env`` (index -> scalar tensor); ``like``
    gives constants their dtype and device where an operator needs a
    tensor."""
    kind, payload = node
    if kind == "const":
        return payload
    if kind == "var":
        return env[payload]
    args = [_eval_expr(a, env, like) for a in payload]
    return _apply(kind, payload, args, like)


def _expr_is_zero(node) -> bool:
    return node is None or (node[0] == "const" and node[1] == 0.0)


# --------------------------------------------------------------------------
# bounds records (shared by `r` and `b` segments)
# --------------------------------------------------------------------------

def _read_bound(tok: str) -> Tuple[float, float]:
    parts = tok.split()
    code = int(parts[0])
    if code == 0:
        return float(parts[1]), float(parts[2])
    if code == 1:
        return -np.inf, float(parts[1])
    if code == 2:
        return float(parts[1]), np.inf
    if code == 3:
        return -np.inf, np.inf
    if code == 4:
        v = float(parts[1])
        return v, v
    if code == 5:
        raise NotImplementedError(
            ".nl complementarity constraints (bound code 5) unsupported"
        )
    raise ValueError(f"bad bound code in .nl: {tok!r}")


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

class NLInfo:
    """Side-band data from the .nl header needed to write a .sol file."""

    def __init__(self, options, n_var, n_con):
        self.options = options          # ints echoed back in the .sol Options block
        self.n_var = n_var
        self.n_con = n_con


class ParsedNL:
    """Raw parse result of a text .nl file: expression graphs (nested-tuple
    ASTs in prefix order), linear J/G segments, bounds, and initial points —
    the input to both the dense compiler (:func:`read_nl`) and the sparse
    template compiler (:mod:`.nl_sparse`)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _parse_nl(path: str) -> ParsedNL:
    with open(path, "rb") as f:
        raw = f.read()
    if not raw:
        raise ValueError(f"{path}: empty file")
    fmt = chr(raw[0])
    if fmt not in ("g", "b"):
        raise ValueError(f"{path}: not a .nl file (header {raw[:10]!r})")

    # The header is ASCII text in BOTH formats: the format line + 9 lines
    # of integers.  For binary files the payload starts right after the
    # 10th newline (exact — the byte offset matters); text files tolerate
    # blank / comment-only lines inside the header (ASL strips them too).
    hdr_end = 0
    nl_pos = raw.find(b"\n")
    if nl_pos < 0:
        raise ValueError(f"{path}: truncated .nl header")
    first = raw[:nl_pos].decode("ascii", "replace")
    hdr_end = nl_pos + 1
    header_opts = [int(t) for t in first[1:].split("#", 1)[0].split()]
    hdr = []
    while len(hdr) < 9:
        nl_pos = raw.find(b"\n", hdr_end)
        if nl_pos < 0:
            raise ValueError(f"{path}: truncated .nl header")
        ln = raw[hdr_end:nl_pos].decode("ascii", "replace")
        hdr_end = nl_pos + 1
        row = [_int_or_float(t) for t in ln.split("#", 1)[0].split()]
        if not row:
            if fmt == "b":
                # binary payload offset is byte-exact: an empty integer
                # line can't be skipped over, it is a corrupt header
                raise ValueError(
                    f"{path}: malformed .nl header (blank integer line "
                    f"in a binary file)")
            continue  # text: skip blank / comment-only header lines
        hdr.append(row)

    n_var, n_con, n_obj = int(hdr[0][0]), int(hdr[0][1]), int(hdr[0][2])
    if n_obj == 0:
        raise ValueError(f"{path}: no objective in model")

    if fmt == "b":
        # header line 6 (hdr[4]) = (linear network vars, functions, arith,
        # flags); arith is the ASL Arith_Kind: 1 = IEEE little-endian,
        # 2 = IEEE big-endian (0 appears only in text files).  N.B. the
        # discrete-variables line is hdr[5] — reading arith from there
        # silently parsed big-endian files as little-endian (ADVICE r2).
        arith = int(hdr[4][2]) if len(hdr) > 4 and len(hdr[4]) > 2 else 1
        if arith not in (0, 1, 2):
            raise NotImplementedError(
                f"{path}: non-IEEE binary .nl (arith={arith}) unsupported"
            )
        s = _BinSrc(raw[hdr_end:], little_endian=(arith != 2))
    else:
        s = _TextSrc(raw[hdr_end:].decode("latin-1").splitlines())

    con_expr = [None] * n_con
    obj_expr = [None] * n_obj
    obj_sense = [0] * n_obj            # 0 = minimize, 1 = maximize
    jac_lin = [[] for _ in range(n_con)]   # (var, coef)
    grad_lin = [[] for _ in range(n_obj)]
    lcon = np.zeros(n_con)
    ucon = np.zeros(n_con)
    lvar = np.full(n_var, -np.inf)
    uvar = np.full(n_var, np.inf)
    x0 = np.zeros(n_var)
    y0 = np.zeros(n_con)
    defined = []                        # (index, [(var, coef)], expr) in file order

    while True:
        rec = s.seg()
        if rec is None:
            break
        c, rest = rec
        if c == "C":
            con_expr[int(rest[0])] = _read_expr(s)
        elif c == "O":
            i = int(rest[0])
            obj_sense[i] = int(rest[1])
            obj_expr[i] = _read_expr(s)
        elif c == "x":
            for _ in range(int(rest[0])):
                i, v = s.iv()
                x0[i] = v
        elif c == "d":
            for _ in range(int(rest[0])):
                i, v = s.iv()
                y0[i] = v
        elif c == "r":
            for i in range(n_con):
                lcon[i], ucon[i] = s.bound()
        elif c == "b":
            for i in range(n_var):
                lvar[i], uvar[i] = s.bound()
        elif c in "kK":
            for _ in range(int(rest[0])):   # cumulative col counts — AD recovers
                s.int1()
        elif c == "J":
            i, k = int(rest[0]), int(rest[1])
            for _ in range(k):
                jac_lin[i].append(s.iv())
        elif c == "G":
            i, k = int(rest[0]), int(rest[1])
            for _ in range(k):
                grad_lin[i].append(s.iv())
        elif c == "V":
            vi, nlin = int(rest[0]), int(rest[1])
            lin = [s.iv() for _ in range(nlin)]
            defined.append((vi, lin, _read_expr(s)))
        elif c == "S":                  # suffix: skip n (index, value) records
            s.suffix(int(rest[1]))
        elif c == "L":
            raise NotImplementedError(".nl logical constraints (L) unsupported")
        elif c == "F":
            raise NotImplementedError(".nl imported functions (F) unsupported")
        else:
            raise ValueError(f"unknown .nl segment {(c, rest)!r}")

    return ParsedNL(
        path=path, header_opts=header_opts,
        n_var=n_var, n_con=n_con, n_obj=n_obj,
        con_expr=con_expr, obj_expr=obj_expr, obj_sense=obj_sense,
        jac_lin=jac_lin, grad_lin=grad_lin,
        lcon=lcon, ucon=ucon, lvar=lvar, uvar=uvar, x0=x0, y0=y0,
        defined=defined,
    )


def read_nl(path: str, objno: int = 0, sparse: bool = False):
    """Parse a ``.nl`` file (text ``g`` or binary ``b`` format, auto-
    detected from the header) into an NLP model.

    The expression graphs become torch callables; derivatives come from
    ``torch.func``.  The returned model carries an ``nl_info`` attribute
    for :func:`write_sol`.

    With ``sparse=True`` the expression graphs are compiled through the
    template compiler (:mod:`.nl_sparse`) into a :class:`SparseNLPModel`
    with exact Jacobian/Lagrangian-Hessian COO sparsity and nnz-sized
    vmapped local AD — use this for large models so the solver's sparse
    KKT formulations (the banded factorization among them) apply.
    """
    parsed = _parse_nl(path)
    if objno >= parsed.n_obj:
        raise ValueError(
            f"{path}: objno {objno} out of range ({parsed.n_obj} objectives)")
    if sparse:
        from .nl_sparse import compile_sparse

        model = compile_sparse(parsed, objno)
    else:
        model = _compile_dense(parsed, objno)
    model.nl_info = NLInfo(parsed.header_opts, parsed.n_var, parsed.n_con)
    return model


# --------------------------------------------------------------------------
# binary mirror writer — re-encodes a parsed model in `b` format.  Used by
# the round-trip tests to validate the binary reader (the text writer's
# mirror, per the format note in "Writing .nl Files" that both encodings
# share one segment grammar) and as a conversion tool for distributing
# compact model files.
# --------------------------------------------------------------------------

def _emit_expr_bin(node, out: bytearray, e: str = "<") -> None:
    kind, payload = node
    if kind == "const":
        out += b"n" + struct.pack(e + "d", float(payload))
    elif kind == "var":
        out += b"v" + struct.pack(e + "i", int(payload))
    else:
        out += b"o" + struct.pack(e + "i", int(kind))
        if kind in _NARY:
            out += struct.pack(e + "i", len(payload))
        for child in payload:
            _emit_expr_bin(child, out, e)


def _emit_bound_bin(lo: float, hi: float, out: bytearray,
                    e: str = "<") -> None:
    if lo == hi:
        out += b"4" + struct.pack(e + "d", lo)
    elif np.isinf(lo) and np.isinf(hi):
        out += b"3"
    elif np.isinf(lo):
        out += b"1" + struct.pack(e + "d", hi)
    elif np.isinf(hi):
        out += b"2" + struct.pack(e + "d", lo)
    else:
        out += b"0" + struct.pack(e + "dd", lo, hi)


def write_nl_binary(path: str, parsed: ParsedNL,
                    big_endian: bool = False) -> None:
    """Write ``parsed`` back out as a binary-format (`b` header) .nl file,
    little-endian (ASL arith 1) or, with ``big_endian``, big-endian (arith
    2); the little-endian file is byte for byte the JAX package's."""
    e = ">" if big_endian else "<"
    i4 = lambda v: struct.pack(e + "i", int(v))  # noqa: E731
    d8 = lambda v: struct.pack(e + "d", float(v))  # noqa: E731
    n_var, n_con, n_obj = parsed.n_var, parsed.n_con, parsed.n_obj
    n_nlcon = sum(not _expr_is_zero(x) for x in parsed.con_expr)
    n_nlobj = sum(not _expr_is_zero(x) for x in parsed.obj_expr)
    nnz_j = sum(len(r) for r in parsed.jac_lin)
    nnz_g = sum(len(r) for r in parsed.grad_lin)
    opts = " ".join(str(o) for o in (parsed.header_opts or [3, 0, 1, 0]))
    header = (
        f"b{opts}\n"
        f" {n_var} {n_con} {n_obj} 0 0\n"
        f" {n_nlcon} {n_nlobj}\n"
        " 0 0\n"
        f" {n_var} {n_var} {n_var}\n"
        f" 0 0 {2 if big_endian else 1} 1\n"   # linear net vars, funcs, ARITH, flags
        " 0 0 0 0 0\n"
        f" {nnz_j} {nnz_g}\n"
        " 0 0\n"
        f" {len(parsed.defined)} 0 0 0 0\n"
    ).encode("ascii")

    out = bytearray()
    for vi, lin, expr in parsed.defined:
        out += b"V" + i4(vi) + i4(len(lin)) + i4(0)
        for j, cj in lin:
            out += i4(j) + d8(cj)
        _emit_expr_bin(expr, out, e)
    for i, x in enumerate(parsed.con_expr):
        out += b"C" + i4(i)
        _emit_expr_bin(x if x is not None else ("const", 0.0), out, e)
    for i, x in enumerate(parsed.obj_expr):
        out += b"O" + i4(i) + i4(parsed.obj_sense[i])
        _emit_expr_bin(x if x is not None else ("const", 0.0), out, e)
    if np.any(parsed.x0):
        nz = [(i, v) for i, v in enumerate(parsed.x0) if v != 0.0]
        out += b"x" + i4(len(nz))
        for i, v in nz:
            out += i4(i) + d8(v)
    if np.any(parsed.y0):
        nz = [(i, v) for i, v in enumerate(parsed.y0) if v != 0.0]
        out += b"d" + i4(len(nz))
        for i, v in nz:
            out += i4(i) + d8(v)
    if n_con:
        out += b"r"
        for lo, hi in zip(parsed.lcon, parsed.ucon):
            _emit_bound_bin(lo, hi, out, e)
    out += b"b"
    for lo, hi in zip(parsed.lvar, parsed.uvar):
        _emit_bound_bin(lo, hi, out, e)
    for i, row in enumerate(parsed.jac_lin):
        if row:
            out += b"J" + i4(i) + i4(len(row))
            for j, cj in row:
                out += i4(j) + d8(cj)
    for i, row in enumerate(parsed.grad_lin):
        if row:
            out += b"G" + i4(i) + i4(len(row))
            for j, cj in row:
                out += i4(j) + d8(cj)
    with open(path, "wb") as f:
        f.write(header)
        f.write(bytes(out))


def convert_nl(src: str, dst: str) -> None:
    """Re-encode a .nl file (either format) as binary-format ``dst``."""
    write_nl_binary(dst, _parse_nl(src))


def _compile_dense(parsed: ParsedNL, objno: int) -> DenseNLPModel:
    n_var, n_con = parsed.n_var, parsed.n_con
    con_expr, obj_expr = parsed.con_expr, parsed.obj_expr
    jac_lin, grad_lin = parsed.jac_lin, parsed.grad_lin
    defined = parsed.defined

    # ---- compile to torch callables ------------------------------------
    # Linear parts as a dense matrix/vector (static, built host-side,
    # copied to each device that evaluates them).
    A = np.zeros((n_con, n_var))
    for i, terms in enumerate(jac_lin):
        for v, cf in terms:
            A[i, v] += cf
    g0 = np.zeros(n_var)
    for v, cf in grad_lin[objno]:
        g0[v] += cf
    consts = DeviceConstants(A=A, g0=g0)

    defined_sorted = defined            # .nl guarantees definition-before-use order
    o_expr = obj_expr[objno]
    maximize = parsed.obj_sense[objno] == 1

    def _env(x):
        env = dict(enumerate(x.unbind(0)))
        for vi, lin, expr in defined_sorted:
            val = _eval_expr(expr, env, x)
            for v, cf in lin:
                val = val + cf * env[v]
            env[vi] = val
        return env

    def _scalar(v, x):
        return x.new_zeros(()) + v      # a Python float as a 0-d tensor

    def obj(x):
        val = (_eval_expr(o_expr, _env(x), x)
               if not _expr_is_zero(o_expr) else 0.0)
        if np.any(g0):
            val = val + torch.dot(consts.on(x.device).g0.to(x.dtype), x)
        return _scalar(val, x)

    cons = None
    if n_con:
        lin_rows = np.any(A != 0.0, axis=1)

        def cons(x):
            env = _env(x)
            body = torch.stack([
                _scalar(_eval_expr(e, env, x) if not _expr_is_zero(e)
                        else 0.0, x)
                for e in con_expr])
            if lin_rows.any():
                body = body + consts.on(x.device).A.to(x.dtype) @ x
            return body

    return DenseNLPModel(
        n=n_var, m=n_con, obj=obj, cons=cons, x0=parsed.x0,
        lvar=parsed.lvar, uvar=parsed.uvar, lcon=parsed.lcon,
        ucon=parsed.ucon, y0=parsed.y0,
        minimize=not maximize, name=parsed.path,
    )


def _int_or_float(t: str):
    try:
        return int(t)
    except ValueError:
        return float(t)


# --------------------------------------------------------------------------
# .sol writer — ASL format read back by AMPL / Pyomo / AmplNLWriter
# --------------------------------------------------------------------------

_SOLVE_RESULT = {
    # Status -> AMPL solve_result_num class
    "SOLVE_SUCCEEDED": 0,
    "SOLVED_TO_ACCEPTABLE_LEVEL": 100,
    "INFEASIBLE_PROBLEM_DETECTED": 200,
    "DIVERGING_ITERATES": 300,
    "MAXIMUM_ITERATIONS_EXCEEDED": 400,
    "MAXIMUM_WALLTIME_EXCEEDED": 400,
    "USER_REQUESTED_STOP": 400,
}


def write_sol(path: str, stats, model, message: Optional[str] = None) -> None:
    """Write an AMPL ``.sol`` answer file for ``stats`` obtained on a model
    returned by :func:`read_nl`: the duals and the primal, each as
    ``%.17g`` (read back bit for bit)."""
    info = getattr(model, "nl_info", None) or NLInfo([1, 1, 0], model.n, model.m)
    code = _SOLVE_RESULT.get(stats.status.name, 500)
    if message is None:
        message = (f"madnlp_tpu_torch: {stats.status.name} after "
                   f"{stats.iter} iterations")
    opts = list(info.options) if info.options else [1, 1, 0]
    duals = np.asarray(stats.multipliers, dtype=float)[: info.n_con]
    primal = np.asarray(stats.solution, dtype=float)[: info.n_var]
    with open(path, "w") as f:
        for line in message.splitlines():
            f.write(line + "\n")
        f.write("\n")
        f.write("Options\n")
        f.write(f"{len(opts)}\n")
        for o in opts:
            f.write(f"{o}\n")
        f.write(f"{info.n_con} {len(duals)}\n")
        f.write(f"{info.n_var} {len(primal)}\n")
        for v in duals:
            f.write(f"{v:.17g}\n")
        for v in primal:
            f.write(f"{v:.17g}\n")
        f.write(f"objno 0 {code}\n")


def read_sol(path: str, n_var: int, n_con: int):
    """Read back a .sol file (testing / interop helper).  Returns
    ``(primal, duals, solve_result_num, message)``."""
    with open(path) as f:
        lines = f.read().splitlines()
    i = lines.index("Options")
    msg = "\n".join(l for l in lines[:i] if l)
    nopt = int(lines[i + 1])
    j = i + 2 + nopt
    ncon_line = lines[j].split()
    nvar_line = lines[j + 1].split()
    nd, np_ = int(ncon_line[1]), int(nvar_line[1])
    duals = np.array([float(v) for v in lines[j + 2 : j + 2 + nd]])
    primal = np.array([float(v) for v in lines[j + 2 + nd : j + 2 + nd + np_]])
    code = 500
    for l in lines[j + 2 + nd + np_ :]:
        if l.startswith("objno"):
            code = int(l.split()[2])
    return primal, duals, code, msg


# --------------------------------------------------------------------------
# AMPL solver-executable entry point
# --------------------------------------------------------------------------

def solve_nl(path: str, sol_path: Optional[str] = None, sparse="auto",
             **options):
    """Read ``path``, solve, optionally write the ``.sol`` next to it.

    ``sparse``: ``True``/``False`` force the sparse/dense compiler;
    ``"auto"`` (default, and what the AMPL executable uses) picks the
    sparse template compiler once the model is big enough that dense
    storage hurts (n ≥ 256).  The solve runs on the card unless the
    options hold ``device="cpu"``."""
    from ..ipm.solver import madnlp

    if sparse == "auto":
        sparse = _parse_nl(path).n_var >= 256
    model = read_nl(path, sparse=sparse)
    stats = madnlp(model, **options)
    if sol_path:
        write_sol(sol_path, stats, model)
    return stats


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m madnlp_tpu_torch.models.nl model[.nl] [-AMPL] [key=value ...]``

    Behaves like an AMPL solver binary: reads ``model.nl``, writes
    ``model.sol``.  Extra ``key=value`` arguments go through the tolerant
    option intake (unknown keys warn-and-ignore, like the reference);
    ``sparse=auto|yes|no`` picks the compiler and ``device=cpu`` runs the
    solve on the CPU (the card otherwise)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: madnlp-tpu-torch-ampl model[.nl] [-AMPL] "
              "[key=value ...]",
              file=sys.stderr)
        return 2
    stub = argv[0]
    nl_path = stub if stub.endswith(".nl") else stub + ".nl"
    base = nl_path[:-3]
    options = {}
    for arg in argv[1:]:
        if arg == "-AMPL" or arg.startswith("-"):
            continue
        if "=" in arg:
            k, v = arg.split("=", 1)
            options[k] = v
    sparse = str(options.pop("sparse", "auto")).lower()
    if sparse != "auto":
        sparse = sparse in ("1", "yes", "true")
    stats = solve_nl(nl_path, sol_path=base + ".sol", sparse=sparse, **options)
    return 0 if stats.status.name in _SOLVE_RESULT else 1


if __name__ == "__main__":
    raise SystemExit(main())
