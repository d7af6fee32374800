"""The port's ``.nl`` reader (madnlp_tpu_torch/models/nl.py) against the JAX
package's, at the parse level, in pure Python (no JAX solve, no torch):

* ``_parse_nl`` of every fixture of tests/test_nl.py and
  tests/test_nl_sparse.py (hs15, the maximised LP with its dual-init and
  suffix segments, the defined variable, ``chain_nl(6)``), of ``TIES_NL``
  (every operator of the opcode tables, defined below) and of
  ``minsurf_nl(3)``, read in text form, as ``write_nl_binary`` writes it
  (the port's writer byte for byte the JAX package's) and as the port
  writes it big-endian, gives the same ``ParsedNL`` in both packages,
  field for field: the counts, the header options, the bounds, x0 and y0,
  ``jac_lin`` and ``grad_lin``, the defined variables, the senses and the
  expression ASTs as equal nested tuples;
* the hand-made big-endian file of tests/test_nl.py, a text header with a
  blank and a comment-only line, and a binary header whose discrete-
  variables line looks like a non-IEEE arith code parse alike;
* unsupported opcodes, segments and bound codes and every malformed
  header raise the same exception with the same message in both.
"""

import struct

import numpy as np
import pytest

from madnlp_tpu.models import nl as jnl
from madnlp_tpu_torch.models import nl as tnl
from madnlp_tpu_torch.testing import minsurf_nl
from tests.test_nl import DEFVAR_NL, HS15_NL, LP_NL, _be_binary_fixture
from tests.test_nl_sparse import chain_nl

# Every operator of the opcode tables on three variables: max/min lists,
# abs, `less`, floor, ceil, rem, atan2, log10, integer div, `if` on a
# relational, the smooth unary functions, a non-integer power, negation
# and a subexpression of constants only (sin 0.3).  Its callbacks are held
# to the JAX package's at points on the ties and kinks
# (tests/test_torch_nl_callbacks.py, tests/test_torch_nl_sparse.py).
TIES_NL = """g3 1 1 0\t# every opcode of the tables
 3 7 1 0 0
 7 1
 0 0
 3 3 3
 0 0 0 1
 0 0 0 0 0
 2 3
 0 0
 0 0 0 0 0
C0
o12
3
v0
v1
n0.5
C1
o0
o11
2
v0
v1
o15
v2
C2
o2
o6
v0
v1
v2
C3
o54
3
o13
v0
o14
v1
o2
v2
o4
v0
n0.7
C4
o54
3
o48
v0
v1
o42
o0
o2
v2
v2
n1
o2
o55
v0
n0.3
v1
C5
o35
o28
v0
v1
o2
v0
v2
o41
v1
C6
o54
9
o38
o2
n0.1
v0
o40
v1
o47
o2
n0.1
v2
o49
v0
o50
v1
o51
o2
n0.1
v2
o52
o0
o2
v1
v1
n2
o53
o2
n0.1
v0
o43
o0
o2
v1
v1
n1
O0 0
o54
7
o5
o1
v0
v1
n2
o37
v2
o44
o2
n0.1
v0
o39
o0
o2
v1
v1
n1
o45
o2
n0.2
v2
o5
o0
o2
v1
v1
n2
n1.5
o2
o41
n0.3
o16
v0
x3
0 0.25
1 0.5
2 -0.25
r
3
2 -1
1 4
0 -2 2
3
4 0.5
3
b
3
0 -1 1
2 -3
J0 1
2 0.5
J6 1
0 1
G0 3
0 0
1 0
2 1
"""

FIXTURES = {
    "hs15": HS15_NL,
    "lp": LP_NL,
    "defvar": DEFVAR_NL,
    "chain": chain_nl(6),
    "ties": TIES_NL,
    "minsurf": minsurf_nl(3),
}

FIELDS = ("header_opts", "n_var", "n_con", "n_obj", "con_expr", "obj_expr",
          "obj_sense", "jac_lin", "grad_lin", "defined")
ARRAYS = ("lcon", "ucon", "lvar", "uvar", "x0", "y0")


def _assert_same_parse(a, b):
    assert a.path == b.path
    for f in FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.fixture
def nl_file(tmp_path):
    def write(data, name="model.nl"):
        p = tmp_path / name
        if isinstance(data, str):
            p.write_text(data)
        else:
            p.write_bytes(data)
        return str(p)

    return write


@pytest.mark.parametrize("encoding", ["text", "binary", "big_endian"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_parse_matches_the_jax_reader(nl_file, tmp_path, name, encoding):
    path = nl_file(FIXTURES[name])
    if encoding == "binary":
        jp, tp = str(tmp_path / "jax.nl"), str(tmp_path / "port.nl")
        jnl.convert_nl(path, jp)
        tnl.convert_nl(path, tp)
        with open(jp, "rb") as fj, open(tp, "rb") as ft:
            assert fj.read() == ft.read()
        path = tp
    elif encoding == "big_endian":
        be = str(tmp_path / "be.nl")
        tnl.write_nl_binary(be, tnl._parse_nl(path), big_endian=True)
        with open(be, "rb") as f:
            assert f.read().split(b"\n")[5] == b" 0 0 2 1"
        path = be
    theirs, ours = jnl._parse_nl(path), tnl._parse_nl(path)
    _assert_same_parse(theirs, ours)
    # and the same model as the text file in either encoding
    text = tnl._parse_nl(nl_file(FIXTURES[name], "text.nl"))
    assert ours.con_expr == text.con_expr and ours.obj_expr == text.obj_expr


def _blank_header_line(text):
    lines = text.split("\n")
    lines.insert(3, "")
    lines.insert(5, "# a comment-only line")
    return "\n".join(lines)


def _patched_binary(tmp_path, line, new=None, insert=False):
    bp = str(tmp_path / "lp_bin.nl")
    src = tmp_path / "lp.nl"
    src.write_text(LP_NL)
    jnl.convert_nl(str(src), bp)
    lines = open(bp, "rb").read().split(b"\n", 10)
    if insert:
        lines.insert(line, b"")
    else:
        lines[line] = new
    return b"\n".join(lines)


@pytest.mark.parametrize("case", ["big_endian_by_hand", "blank_text_header",
                                  "discrete_line"])
def test_header_cases_parse_alike(nl_file, tmp_path, case):
    data = {
        "big_endian_by_hand": lambda: _be_binary_fixture(),
        "blank_text_header": lambda: _blank_header_line(HS15_NL),
        "discrete_line": lambda: _patched_binary(tmp_path, 6, b" 0 0 7 0 0"),
    }[case]()
    path = nl_file(data, "case.nl")
    _assert_same_parse(jnl._parse_nl(path), tnl._parse_nl(path))


def _binary_with(tmp_path, payload, arith=1):
    header = (f"b3 0 1 0\n 1 0 1 0 0\n 0 1\n 0 0\n 1 1 1\n 0 0 {arith} 1\n"
              " 0 0 0 0 0\n 0 0\n 0 0\n 0 0 0 0 0\n").encode("ascii")
    obj = b"O" + struct.pack("<ii", 0, 0) + b"v" + struct.pack("<i", 0)
    return header + obj + payload


BAD = {
    "unknown_opcode": lambda t: HS15_NL.replace("o2\nv0\nv1", "o64\nv0\nv1", 1),
    "round_opcode": lambda t: HS15_NL.replace("o2\nv0\nv1", "o57\nv0\nv1", 1),
    "external_function": lambda t: HS15_NL.replace("o2\nv0\nv1", "f0 2\nv0\nv1", 1),
    "string_argument": lambda t: HS15_NL.replace("o2\nv0\nv1", "h3:abc\nv0\nv1", 1),
    "garbage_token": lambda t: HS15_NL.replace("o2\nv0\nv1", "q1\nv0\nv1", 1),
    "logical_constraint": lambda t: HS15_NL + "L0\nv0\n",
    "imported_function": lambda t: HS15_NL + "F0 1 0 f\n",
    "unknown_segment": lambda t: HS15_NL + "Z0\n",
    "complementarity": lambda t: HS15_NL.replace("r\n2 1\n2 0", "r\n5 1 1\n2 0", 1),
    "bad_bound_code": lambda t: HS15_NL.replace("r\n2 1\n2 0", "r\n7 1\n2 0", 1),
    "empty_file": lambda t: b"",
    "not_nl": lambda t: "x3 1 1 0\n",
    "truncated_header": lambda t: "\n".join(HS15_NL.split("\n")[:5]),
    "no_objective": lambda t: HS15_NL.replace(" 2 2 1 0 0", " 2 2 0 0 0", 1),
    "truncated_expression": lambda t: HS15_NL[:HS15_NL.index("C1")] + "C1\no0\n",
    "binary_blank_header": lambda t: _patched_binary(t, 4, insert=True),
    "binary_non_ieee": lambda t: _binary_with(t, b"b3", arith=3),
    "binary_suffix": lambda t: _binary_with(t, b"S" + struct.pack("<ii", 0, 1)),
    "binary_unknown_segment": lambda t: _binary_with(t, b"Q"),
    "binary_complementarity": lambda t: _binary_with(t, b"b5"),
    "binary_bad_bound": lambda t: _binary_with(t, b"b9"),
    "binary_truncated": lambda t: _binary_with(t, b"x" + struct.pack("<i", 1)),
    "binary_logical": lambda t: _binary_with(t, b"L"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_rejections_match_the_jax_reader(nl_file, tmp_path, case):
    path = nl_file(BAD[case](tmp_path), "bad.nl")
    with pytest.raises(Exception) as theirs:
        jnl._parse_nl(path)
    with pytest.raises(Exception) as ours:
        tnl._parse_nl(path)
    assert type(ours.value) is type(theirs.value)
    assert str(ours.value) == str(theirs.value)
    assert isinstance(ours.value, (ValueError, NotImplementedError))


def test_objno_out_of_range_raises_alike(nl_file):
    path = nl_file(HS15_NL)
    with pytest.raises(ValueError) as theirs:
        jnl.read_nl(path, objno=1)
    with pytest.raises(ValueError) as ours:
        tnl.read_nl(path, objno=1)
    assert str(ours.value) == str(theirs.value)
