"""DiffSL bridge: parse DiffSL model text and compile it to JAX callables.

The reference compiles DiffSL (a tensor DSL for ODE/DAE systems) to native
code via LLVM/Cranelift with Enzyme for derivatives (reference
crates/diffsol/src/ode_equations/diffsl.rs:38-330 and the external diffsl
crate).  The JAX equivalent needs no separate codegen stage: the
parsed tensor graph is *traced* into jittable JAX callables -- XLA is the
JIT and jax AD replaces Enzyme.  Constant tensors (literal-keyed matrices
like heat2d's D_ij) are folded to numpy arrays at build time so tracing
never loops over thousands of literals.

Language subset (everything the reference's own DiffSL models use --
test_models/{robertson,heat1d,heat2d,foodweb,exponential_decay*}.rs and the
diffsol-c JIT tests):

* tensor definitions ``name { ... }`` / ``name_i { ... }`` /
  ``name_ij { ... }`` (rank from the subscript);
* scalar entries, labeled entries (``x = 1`` -- the label becomes an
  identifier for that block), indexed entries ``(3): v``, range entries
  ``(0:5): v`` / ``(0..5): v`` (both separators), labeled range entries
  ``(0:n): c2 = 1.0e5``;
* 2-D keyed entries ``(i, j): v`` and *diagonal-run* range pairs
  ``(0..n, 1..n+1): v`` (ranges of equal length zip along a band; a
  length-1 range broadcasts).  A keyed tensor's shape is inferred from its
  highest keyed index -- anchor structurally-zero trailing rows/cols with
  an explicit ``(n-1, n-1): 0.0`` entry (generated models do);
* arithmetic ``+ - * /``, unary minus, calls (sin, cos, tan, exp, log,
  sqrt, abs, pow, tanh, sinh, cosh, sigmoid, heaviside, min, max, ...);
* implicit contraction: within each product term, indices that do not
  appear in the destination tensor's subscript are summed
  (``F_i { A_ij * u_j }`` is a mat-vec; ``b_i { xx_i * yy_i }`` stays
  elementwise);
* special tensors: ``in_i`` (parameters with defaults), ``u_i`` (states +
  initial values), ``dudt_i`` (derivative labels), ``M_i`` (mass action,
  linear in the dudt labels), ``F_i`` (rhs), ``out_i``, ``stop_i`` (root
  functions), ``reset_i``; ``t`` is available in every expression.

The model-index built-in ``N`` (reference diffsl.rs `set_model_index`;
diffsol-c ode_solver_type.rs:66 sets it to the index of the root that
fired before each reset, logistic_time_reset_jit.rs) is supported as a
HIDDEN TRAILING STATE: models referencing ``N`` gain one extra state
(dy/dt = 0, mass diag 1, init 0) holding the current index; the bridge
emits an index-aware ``reset_n`` the drivers call with the fired root's
index.  The functional equivalent of `set_model_index(m)` mid-trajectory
is setting that trailing state; `N` selects between sub-models exactly as
in the reference's multi-model test (``F_i { r_i[N] * y }``).
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

__all__ = ["parse", "compile_diffsl", "DiffslModel", "DiffslError"]

SPECIAL = ("in", "u", "dudt", "M", "F", "out", "stop", "reset")

_FUNCS = {
    "sin": "sin", "cos": "cos", "tan": "tan", "exp": "exp", "log": "log",
    "ln": "log", "log10": "log10", "sqrt": "sqrt", "abs": "abs",
    "tanh": "tanh", "sinh": "sinh", "cosh": "cosh", "asin": "arcsin",
    "acos": "arccos", "atan": "arctan", "floor": "floor", "ceil": "ceil",
    "sign": "sign", "arcsinh": "arcsinh", "asinh": "arcsinh",
    "arccosh": "arccosh", "acosh": "arccosh", "arctanh": "arctanh",
    "atanh": "arctanh",
}
_FUNCS2 = {"pow": "power", "min": "minimum", "max": "maximum",
           "atan2": "arctan2", "copysign": "copysign"}


class DiffslError(ValueError):
    """Raised on DiffSL parse or semantic errors."""


# --------------------------------------------------------------------------
# lexer
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*)
  | (?P<num>(\d+\.(?!\.)\d*|\.\d+|\d+)([eE][+-]?\d+)?)
  | (?P<name>[A-Za-z][A-Za-z0-9_]*)
  | (?P<dotdot>\.\.)
  | (?P<op>[{}(),;:=+\-*/^\[\]])
    """,
    re.VERBOSE,
)


def _tokenize(src: str):
    toks = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise DiffslError(f"unexpected character {src[pos]!r} at {pos}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        kind = m.lastgroup
        val = m.group()
        if val == ";":
            # the reference grammar accepts ';' as a tensor-element
            # separator interchangeably with ',' (e.g. the lorenz example's
            # F_i { ...; ...; }); normalize at the lexer
            val = ","
        toks.append((kind, val))
    toks.append(("eof", ""))
    return toks


# --------------------------------------------------------------------------
# AST
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Num:
    v: float


@dataclass(frozen=True)
class Ref:
    """Identifier reference, optionally subscripted: u_i -> Ref('u', 'i').

    ``slc`` is an optional element-range slice ``x_i[a:b]`` (pybamm-
    generated models slice state segments into electrode regions)."""

    name: str
    idx: str  # "" for bare references
    slc: Optional[tuple] = None  # (start, stop) or None


@dataclass(frozen=True)
class Call:
    fn: str
    args: tuple


@dataclass(frozen=True)
class Bin:
    op: str  # + - * / ^
    l: object
    r: object


@dataclass(frozen=True)
class Neg:
    x: object


@dataclass(frozen=True)
class Entry:
    """One entry of a tensor block."""

    expr: object = None
    label: Optional[str] = None
    # 1-D range (start, stop) or 2-D ((r0, r1), (c0, c1)); None = inferred
    rng: Optional[tuple] = None


@dataclass(frozen=True)
class TensorDef:
    name: str
    idx: str  # subscript letters ("", "i", "ij")
    entries: tuple


_IDX_SUFFIX = re.compile(r"^(.*[A-Za-z0-9])_([ijklmn]{1,3})$")


def _split_subscript(name: str):
    m = _IDX_SUFFIX.match(name)
    if m:
        return m.group(1), m.group(2)
    return name, ""


class _Parser:
    def __init__(self, src: str):
        self.toks = _tokenize(src)
        self.pos = 0

    def peek(self, k=0):
        return self.toks[min(self.pos + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect(self, val):
        kind, v = self.next()
        if v != val:
            raise DiffslError(f"expected {val!r}, got {v!r}")
        return v

    # ---- model ----
    def model(self):
        defs = []
        while self.peek()[0] != "eof":
            defs.append(self.tensor_def())
        return defs

    def tensor_def(self):
        kind, raw = self.next()
        if kind != "name":
            raise DiffslError(f"expected tensor name, got {raw!r}")
        name, idx = _split_subscript(raw)
        self.expect("{")
        entries = []
        while self.peek()[1] != "}":
            entries.append(self.entry(rank=len(idx)))
            if self.peek()[1] == ",":
                self.next()
        self.expect("}")
        return TensorDef(name, idx, tuple(entries))

    # ---- entries ----
    def entry(self, rank: int):
        rng = None
        if self.peek()[1] == "(" and self._looks_like_range():
            rng = self.range_spec()
        label = None
        if (
            self.peek()[0] == "name"
            and self.peek(1)[1] == "="
        ):
            label = self.next()[1]
            self.next()  # '='
        expr = self.expr()
        return Entry(expr=expr, label=label, rng=rng)

    def _looks_like_range(self):
        """Lookahead: '(' INT [(:|..) INT] [',' INT [(:|..) INT]] ')' ':'"""
        i = self.pos
        toks = self.toks

        def at(j):
            return toks[min(j, len(toks) - 1)]

        if at(i)[1] != "(":
            return False
        j = i + 1
        for _ in range(2):  # up to two range components
            if at(j)[0] != "num" or "." in at(j)[1]:
                return False
            j += 1
            if at(j)[1] == ":" or at(j)[0] == "dotdot":
                j += 1
                if at(j)[0] != "num" or "." in at(j)[1]:
                    return False
                j += 1
            if at(j)[1] == ",":
                j += 1
                continue
            break
        if at(j)[1] != ")":
            return False
        return at(j + 1)[1] == ":"

    def range_spec(self):
        self.expect("(")
        parts = [self._one_range()]
        if self.peek()[1] == ",":
            self.next()
            parts.append(self._one_range())
        self.expect(")")
        self.expect(":")
        return tuple(parts)

    def _one_range(self):
        kind, v = self.next()
        if kind != "num":
            raise DiffslError(f"expected integer in range, got {v!r}")
        start = int(v)
        if self.peek()[1] == ":" or self.peek()[0] == "dotdot":
            self.next()
            kind, v = self.next()
            if kind != "num":
                raise DiffslError(f"expected integer in range, got {v!r}")
            return (start, int(v))
        return (start, start + 1)

    # ---- expressions (precedence climbing) ----
    def expr(self):
        return self._add()

    def _add(self):
        node = self._mul()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            node = Bin(op, node, self._mul())
        return node

    def _mul(self):
        node = self._unary()
        while self.peek()[1] in ("*", "/"):
            op = self.next()[1]
            node = Bin(op, node, self._unary())
        return node

    def _unary(self):
        if self.peek()[1] == "-":
            self.next()
            return Neg(self._unary())
        if self.peek()[1] == "+":
            self.next()
            return self._unary()
        return self._pow()

    def _pow(self):
        node = self._atom()
        if self.peek()[1] == "^":
            self.next()
            return Bin("^", node, self._unary())
        return node

    def _atom(self):
        kind, v = self.next()
        if kind == "num":
            return Num(float(v))
        if v == "(":
            node = self.expr()
            self.expect(")")
            return node
        if kind == "name":
            if self.peek()[1] == "(":
                self.next()
                args = []
                while self.peek()[1] != ")":
                    args.append(self.expr())
                    if self.peek()[1] == ",":
                        self.next()
                self.expect(")")
                return Call(v, tuple(args))
            base, idx = _split_subscript(v)
            slc = None
            if self.peek()[1] == "[":
                self.next()
                k1, a = self.next()
                if k1 == "num" and self.peek()[1] == ":":
                    self.next()
                    k2, b = self.next()
                    if k2 != "num":
                        raise DiffslError(
                            f"expected integer in slice, got {b!r}"
                        )
                    self.expect("]")
                    slc = ("slice", int(a), int(b))
                elif k1 == "num":
                    self.expect("]")
                    slc = ("index", Num(float(a)))
                elif k1 == "name":
                    # dynamic index by an identifier (the model-index
                    # built-in: r_i[N])
                    self.expect("]")
                    slc = ("index", Ref(*_split_subscript(a)))
                else:
                    raise DiffslError(f"bad subscript {a!r} in []")
            return Ref(base, idx, slc)
        raise DiffslError(f"unexpected token {v!r} in expression")


def parse(src: str) -> list:
    """Parse DiffSL source into a list of TensorDef."""
    return _Parser(src).model()


# --------------------------------------------------------------------------
# semantic analysis + evaluation
# --------------------------------------------------------------------------


def _refs(node, out):
    if isinstance(node, Ref):
        out.add(node.name)
        if node.slc is not None and node.slc[0] == "index":
            _refs(node.slc[1], out)  # dynamic index: r_i[N]
    elif isinstance(node, Call):
        for a in node.args:
            _refs(a, out)
    elif isinstance(node, Bin):
        _refs(node.l, out)
        _refs(node.r, out)
    elif isinstance(node, Neg):
        _refs(node.x, out)
    return out


def _tensor_refs(td: TensorDef):
    out = set()
    for e in td.entries:
        _refs(e.expr, out)
    return out


class _Eval:
    """Evaluate an expression tree to (array, letters).

    ``letters`` names the axes of ``array`` (e.g. "ij").  ``dest`` is the
    destination tensor's subscript: inside every product term, letters not
    in ``dest`` are contracted (implicit summation over indices absent from
    the assignment target -- the DiffSL convention; A_ij * u_j sums j while
    xx_i * yy_i stays elementwise because i IS the destination index).
    """

    def __init__(self, xp, env, dims, dest, dtype=None):
        self.xp = xp  # numpy or jax.numpy
        self.env = env  # name -> (array, rank)
        self.dims = dims  # letter -> size (filled as discovered)
        self.dest = dest
        # literal dtype: under jax x64 a bare f64 literal would promote
        # every f32 intermediate back to f64, defeating the f32 tier
        self.dtype = dtype

    def _align(self, vals):
        """Broadcast (arr, letters) values to a common letter string."""
        letters = ""
        for _a, ls in vals:
            for c in ls:
                if c not in letters:
                    letters += c
        out = []
        for a, ls in vals:
            # move/insert axes to match `letters`
            a = self.xp.asarray(a)
            # current order -> target order
            perm_src = [ls.index(c) for c in letters if c in ls]
            a = self.xp.transpose(a, perm_src) if a.ndim > 1 else a
            shape = []
            src_axis = 0
            for c in letters:
                if c in ls:
                    shape.append(a.shape[src_axis])
                    src_axis += 1
                else:
                    shape.append(1)
            a = a.reshape(tuple(shape)) if letters else a
            out.append(a)
        return out, letters

    def _contract(self, a, letters):
        """Sum axes whose letters are not in the destination subscript."""
        keep = [c for c in letters if c in self.dest]
        drop_axes = tuple(
            k for k, c in enumerate(letters) if c not in self.dest
        )
        if drop_axes:
            a = self.xp.sum(a, axis=drop_axes)
        return a, "".join(keep)

    def eval(self, node, top: bool = True):
        """Evaluate ``node``; ``top`` marks TERM-level position (the entry
        top and the spine of its +/- tree).  Implicit contraction over
        indices absent from the destination happens only at term level --
        at the top of each additive term and of each product chain there.
        Inside function arguments, powers and nested factors everything is
        pure elementwise broadcasting (a pybamm-DFN expression like
        ``c_ij * pow(K - f(u_j), 0.5)`` must keep j alive until the
        enclosing product with the _ij tensor)."""
        xp = self.xp
        if isinstance(node, Num):
            return xp.asarray(node.v, self.dtype), ""
        if isinstance(node, Neg):
            a, ls = self.eval(node.x, top)
            return -a, ls
        if isinstance(node, Ref):
            if node.name not in self.env:
                raise DiffslError(f"undefined identifier {node.name!r}")
            arr, rank = self.env[node.name]
            if rank == 0 and len(node.idx) == 1:
                # a length-1 segment label referenced as a vector
                # (pybamm M_i lists scalar dudt labels as `name_i`)
                return xp.reshape(xp.asarray(arr), (1,)), node.idx
            if len(node.idx) not in (rank, 0):
                raise DiffslError(
                    f"{node.name} has rank {rank}, subscripted _{node.idx}"
                )
            if rank == 0:
                return xp.asarray(arr), ""
            if not node.idx:
                if rank == 1 and np.prod(np.shape(arr)) == 1:
                    return xp.reshape(xp.asarray(arr), ()), ""
                raise DiffslError(
                    f"rank-{rank} tensor {node.name!r} referenced without "
                    "a subscript"
                )
            arr = xp.asarray(arr)
            if node.slc is not None:
                if rank != 1:
                    raise DiffslError(
                        f"slice on rank-{rank} tensor {node.name!r}"
                    )
                if node.slc[0] == "slice":
                    _tag, a, b = node.slc
                    if not 0 <= a <= b <= int(arr.shape[0]):
                        raise DiffslError(
                            f"slice [{a}:{b}] out of range for "
                            f"{node.name!r} (length {int(arr.shape[0])})"
                        )
                    arr = arr[a:b]
                else:  # dynamic element index: r_i[N]
                    iv, ils = self.eval(node.slc[1], top=False)
                    if ils:
                        raise DiffslError(
                            f"index into {node.name!r} must be a scalar"
                        )
                    if self.xp is np:
                        return xp.asarray(arr[int(iv)]), ""
                    import jax.numpy as _jnp

                    idx32 = _jnp.clip(
                        _jnp.asarray(iv).astype(_jnp.int32), 0,
                        arr.shape[0] - 1,
                    )
                    return _jnp.take(arr, idx32), ""
            for c, size in zip(node.idx, arr.shape):
                if self.dims.setdefault(c, size) != size:
                    raise DiffslError(
                        f"index {c} bound to sizes {self.dims[c]} and {size}"
                    )
            return arr, node.idx
        if isinstance(node, Call):
            # Function arguments are NON-top positions: no contraction
            # happens inside an expression.  The reference compiler
            # translates each tensor element to ONE loop nest that
            # evaluates the whole scalar expression at a multi-index and
            # accumulates into the (possibly contracted) target -- so
            # F_i { exp(A_ij * u_j) } is sum_j exp(A_ij u_j), and a
            # repeated index inside an argument is ELEMENTWISE, not an
            # early contraction (the reference's own pybamm DFN depends
            # on this: `constant20_ij * (constant6_j * exp(-c *
            # max(constant3_j * porosity..._j, 10)))`, pybamm_dfn.diffsl:
            # 5333, is elementwise in j inside the exp and contracts j
            # once at the element top).
            vals = [self.eval(a, top=False) for a in node.args]
            arrs, letters = self._align(vals)
            if node.fn in _FUNCS and len(arrs) == 1:
                return getattr(xp, _FUNCS[node.fn])(arrs[0]), letters
            if node.fn in _FUNCS2 and len(arrs) == 2:
                return getattr(xp, _FUNCS2[node.fn])(*arrs), letters
            if node.fn == "sigmoid" and len(arrs) == 1:
                return 1.0 / (1.0 + xp.exp(-arrs[0])), letters
            if node.fn == "heaviside" and len(arrs) == 1:
                return xp.where(arrs[0] >= 0, 1.0, 0.0), letters
            raise DiffslError(
                f"unknown function {node.fn!r}/{len(arrs)} args"
            )
        if isinstance(node, Bin):
            if node.op in ("*", "/"):
                # Einstein summation is per product TERM, not per binary
                # node: flatten the whole * / chain, combine ALL factors on
                # the union index set, THEN contract once at the chain top
                # (A_ij * u_j * w_j must be sum_j A_ij u_j w_j, not
                # (A@u)_i * sum w).  Factors are NON-top positions: an
                # additive or function subexpression inside keeps all its
                # indices for this chain's contraction.
                factors = []

                def flatten(nd, inverted):
                    if isinstance(nd, Bin) and nd.op in ("*", "/"):
                        flatten(nd.l, inverted)
                        flatten(nd.r, inverted ^ (nd.op == "/"))
                    else:
                        factors.append((self.eval(nd, top=False), inverted))

                flatten(node, False)
                arrs, letters = self._align([v for v, _inv in factors])
                acc = arrs[0]  # leftmost factor is never inverted
                for a, (_v, inv) in zip(arrs[1:], factors[1:]):
                    acc = acc / a if inv else acc * a
                if top:
                    return self._contract(acc, letters)
                return acc, letters
            lv = self.eval(node.l, top)
            rv = self.eval(node.r, top)
            if node.op == "^":
                # a power applies WITHIN a term (u_i ^ 2 is sum u_i^2 at a
                # scalar destination, not (sum u)^2): combine elementwise,
                # contraction happens at the enclosing term/entry level
                (la, ra), letters = self._align([lv, rv])
                return la**ra, letters
            # additive at term level: each side is its own term -> contract
            # independently; in nested positions, pure broadcasting
            if top:
                lv = self._contract(*lv)
                rv = self._contract(*rv)
            (la, ra), letters = self._align([lv, rv])
            if node.op == "+":
                return la + ra, letters
            return la - ra, letters
        raise DiffslError(f"cannot evaluate node {node!r}")


def _entry_length(arr_letters, rng):
    if rng is not None:
        (a, b) = rng[0]
        return b - a
    arr, letters = arr_letters
    if letters == "":
        return 1
    if len(letters) == 1:
        return int(np.shape(arr)[0])
    raise DiffslError("vector entry evaluated to rank > 1")


def _eval_vector(td: TensorDef, ev: _Eval, length_hint=None):
    """Evaluate a rank-1 tensor definition to a flat array.

    Returns (array, segments) where segments = [(label, start, length)].
    """
    xp = ev.xp
    pieces = []
    segments = []
    pos = 0
    for e in td.entries:
        # index letters are scoped PER ENTRY: different entries of one
        # vector may bind i to different segment lengths (pybamm models
        # tile F_i from 400-, 60- and 20-row blocks)
        ev_e = _Eval(xp, ev.env, {}, ev.dest, ev.dtype)
        val = ev_e.eval(e.expr)
        val = ev_e._contract(*val)
        n = _entry_length(val, e.rng)
        arr, letters = val
        if e.rng is not None:
            start = e.rng[0][0]
            if start != pos:
                raise DiffslError(
                    f"{td.name}: range starts at {start}, expected {pos} "
                    "(entries must tile the tensor contiguously)"
                )
        if letters == "":
            arr = xp.broadcast_to(xp.reshape(arr, (1,)), (n,))
        elif int(np.shape(arr)[0]) != n:
            raise DiffslError(
                f"{td.name}: entry length {np.shape(arr)[0]} != range {n}"
            )
        pieces.append(arr)
        if e.label:
            segments.append((e.label, pos, n))
        pos += n
    return xp.concatenate(pieces) if pieces else xp.zeros((0,)), segments


def _eval_matrix(td: TensorDef, ev: _Eval):
    """Evaluate a rank-2 tensor definition to a dense array.

    Keyed entries use diagonal-run semantics: ``(a..b, c..d)`` zips the two
    ranges (equal lengths; a length-1 range broadcasts), placing ``v`` along
    that band -- this is how heat1d writes its tridiagonal A_ij
    (reference test_models/heat1d.rs:38-42).
    """
    xp = ev.xp
    keyed = [e for e in td.entries if e.rng is not None]
    unkeyed = [e for e in td.entries if e.rng is None]
    if unkeyed and keyed:
        raise DiffslError(f"{td.name}: mixed keyed and unkeyed 2-D entries")
    if unkeyed:
        if len(unkeyed) != 1:
            raise DiffslError(f"{td.name}: one unkeyed 2-D entry allowed")
        arr, letters = ev.eval(unkeyed[0].expr)
        if letters != td.idx:
            raise DiffslError(
                f"{td.name}: 2-D entry has letters {letters!r}, "
                f"want {td.idx!r}"
            )
        return arr

    # fast path: all-constant keyed entries -> build with numpy once
    nrow = max(r[0][1] for r in (e.rng for e in keyed))
    ncol = max(r[1][1] if len(r) > 1 else r[0][1]
               for r in (e.rng for e in keyed))
    rows, cols, vals = [], [], []
    traced_parts = []
    for e in keyed:
        r = e.rng
        (r0, r1) = r[0]
        (c0, c1) = r[1] if len(r) > 1 else r[0]
        nr, nc = r1 - r0, c1 - c0
        if nr != nc and 1 not in (nr, nc):
            raise DiffslError(
                f"{td.name}: range pair lengths {nr} x {nc} cannot zip"
            )
        cnt = max(nr, nc)
        ridx = np.arange(r0, r1) if nr > 1 else np.full(cnt, r0)
        cidx = np.arange(c0, c1) if nc > 1 else np.full(cnt, c0)
        lit = None
        if isinstance(e.expr, Num):
            lit = e.expr.v
        elif isinstance(e.expr, Neg) and isinstance(e.expr.x, Num):
            lit = -e.expr.x.v
        if lit is not None:
            rows.append(ridx)
            cols.append(cidx)
            vals.append(np.full(cnt, lit))
        else:
            # keyed entries assign scalars: evaluate with an empty
            # destination so any term indices fully contract
            ev0 = _Eval(ev.xp, ev.env, dict(ev.dims), "", ev.dtype)
            arr, letters = ev0._contract(*ev0.eval(e.expr))
            if letters:
                raise DiffslError(
                    f"{td.name}: keyed 2-D entries must be scalars"
                )
            traced_parts.append((ridx, cidx, arr, cnt))
    mat = np.zeros((nrow, ncol))
    if rows:
        mat[np.concatenate(rows), np.concatenate(cols)] = np.concatenate(vals)
    out = ev.xp.asarray(mat, ev.dtype) if ev.dtype is not None else (
        ev.xp.asarray(mat)
    )
    for ridx, cidx, arr, cnt in traced_parts:
        out = out.at[ridx, cidx].set(arr) if hasattr(out, "at") else _npset(
            out, ridx, cidx, arr
        )
    return out


def _npset(mat, ridx, cidx, arr):
    mat = np.array(mat)
    mat[ridx, cidx] = arr
    return mat


# --------------------------------------------------------------------------
# model compilation
# --------------------------------------------------------------------------


@dataclass
class DiffslModel:
    """A parsed + semantically-analysed DiffSL model.

    ``compile_diffsl`` produces this; :meth:`make_callables` yields the
    (rhs, init, mass, root, out, reset) JAX closures that plug into
    :class:`diffsol_tpu.problem.OdeBuilder` (the analog of the
    reference DiffSl equations object, diffsl.rs:290-330).
    """

    source: str
    defs: list
    order: list  # evaluation order of intermediate tensor names
    param_labels: list  # [(name, start, len)] from in_i
    default_params: np.ndarray
    state_segments: list  # [(label, start, len)] from u_i
    dudt_segments: list
    nstates: int
    has_mass: bool
    has_root: bool
    has_out: bool
    has_reset: bool
    state_dep: set = field(default_factory=set)  # transitively state-dep
    constants: dict = field(default_factory=dict)
    # model references the `N` built-in: the model index rides as a hidden
    # trailing state (nstates reports the DSL count; callables carry +1)
    uses_n: bool = False

    # ---- serialization (reference solve_serialization.rs role) ----
    def serialize(self) -> str:
        """Portable JSON form (the source IS the model; tracing is cheap --
        no compiled-object shipping needed, unlike the reference's
        LLVM-object serialization, solve_serialization.rs:1-83)."""
        return json.dumps(
            {
                "format": "diffsol_tpu.diffsl.v1",
                "source": self.source,
                "default_params": [float(x) for x in self.default_params],
                "nstates": self.nstates,
            }
        )

    @staticmethod
    def deserialize(text: str) -> "DiffslModel":
        d = json.loads(text)
        if d.get("format") != "diffsol_tpu.diffsl.v1":
            raise DiffslError(f"unknown serialization format {d.get('format')}")
        return compile_diffsl(d["source"])

    # ---- callables ----
    def make_callables(self, dtype=None):
        """Build the (rhs, init, mass, root, out, reset) JAX closures.

        ``dtype`` (the builder's precision tier) casts the folded constants
        and all literals so f32 problems trace f32 arithmetic end to end.
        """
        import jax.numpy as jnp

        by_name = {td.name: td for td in self.defs}
        param_labels = self.param_labels
        state_segs = self.state_segments
        dudt_segs = self.dudt_segments
        n = self.nstates
        # `N` rides as a hidden trailing state (dy/dt = 0, mass diag 1),
        # updated to the fired root's index by the index-aware reset
        uses_n = self.uses_n
        n_full = n + 1 if uses_n else n
        consts = {
            k: (jnp.asarray(v[0], dtype), v[1])
            for k, v in self.constants.items()
        }
        order = self.order

        def base_env(t, p):
            env = dict(consts)
            env["t"] = (t, 0)
            env["pi"] = (jnp.asarray(math.pi, dtype), 0)
            for name, start, ln in param_labels:
                if ln == 1:
                    env[name] = (p[start], 0)
                else:
                    env[name] = (p[start:start + ln], 1)
            return env

        state_dep = self.state_dep

        def eval_intermediates(env, skip_state_deps=False):
            for name in order:
                if skip_state_deps and name in state_dep:
                    continue
                td = by_name[name]
                # index letters are scoped per tensor definition
                ev = _Eval(jnp, env, {}, td.idx, dtype)
                if len(td.idx) <= 1:
                    arr, _segs = _eval_vector(td, ev)
                    if td.idx == "":
                        arr = arr.reshape(())
                    env[name] = (arr, len(td.idx))
                else:
                    env[name] = (_eval_matrix(td, ev), 2)
            return env

        def bind_state(env, y):
            base = y[:n]
            env["u"] = (base, 1)
            if uses_n:
                env["N"] = (y[n], 0)
            for name, start, ln in state_segs:
                env[name] = (
                    (base[start], 0) if ln == 1
                    else (base[start:start + ln], 1)
                )
            return env

        def eval_special(tdname, env):
            td = by_name[tdname]
            ev = _Eval(jnp, env, {}, td.idx, dtype)
            arr, _ = _eval_vector(td, ev)
            return arr

        def init(t, p):
            env = eval_intermediates(base_env(t, p), skip_state_deps=True)
            td = by_name["u"]
            ev = _Eval(jnp, env, {}, td.idx or "i", dtype)
            arr, _ = _eval_vector(td, ev)
            arr = arr.reshape((n,))
            if uses_n:
                arr = jnp.concatenate([arr, jnp.zeros((1,), arr.dtype)])
            return arr

        def rhs(t, y, p):
            yf = y.reshape((n_full,))
            env = bind_state(base_env(t, p), yf)
            env = eval_intermediates(env)
            f = eval_special("F", env).reshape((n,))
            if uses_n:
                f = jnp.concatenate([f, jnp.zeros((1,), f.dtype)])
            return f.reshape(y.shape)

        callables = {"rhs": rhs, "init": init}

        if self.has_mass:
            def mass_action(t, p, v):
                vf = v.reshape((n_full,))
                vb = vf[:n]
                env = base_env(t, p)
                env["dudt"] = (vb, 1)
                for name, start, ln in dudt_segs:
                    env[name] = (
                        (vb[start], 0) if ln == 1
                        else (vb[start:start + ln], 1)
                    )
                env = eval_intermediates(env, skip_state_deps=True)
                m = eval_special("M", env)
                if uses_n:  # hidden index row is differential: M v = v
                    m = jnp.concatenate([m, vf[n:]])
                return m

            def mass(t, p):
                import jax

                # M_i is linear in dudt: the matrix is its exact jacobian
                return jax.jacfwd(
                    lambda v: mass_action(t, p, v)
                )(jnp.zeros((n_full,), dtype))

            callables["mass"] = mass

        def make_state_fn(tdname):
            def f(t, y, p):
                env = bind_state(base_env(t, p), y.reshape((n_full,)))
                env = eval_intermediates(env)
                return eval_special(tdname, env)

            return f

        if self.has_root:
            callables["root"] = make_state_fn("stop")
        if self.has_out:
            callables["out"] = make_state_fn("out")
        if self.has_reset:
            if uses_n:
                plain = make_state_fn("reset")

                def reset(t, y, p):
                    # evaluated with the CURRENT hidden index (used only by
                    # API consumers; drivers apply reset_n at events)
                    yf = y.reshape((n_full,))
                    return jnp.concatenate([plain(t, y, p), yf[n:]])

                def reset_n(t, y, p, k):
                    # reference protocol: N <- index of the fired root,
                    # THEN the reset applies (ode_solver_type.rs:66)
                    yf = y.reshape((n_full,))
                    kf = jnp.asarray(k, yf.dtype).reshape((1,))
                    env = bind_state(base_env(t, p), yf)
                    env["N"] = (kf[0], 0)
                    env = eval_intermediates(env)
                    vals = eval_special("reset", env)
                    return jnp.concatenate([vals, kf])

                callables["reset"] = reset
                callables["reset_n"] = reset_n
            else:
                callables["reset"] = make_state_fn("reset")

        return callables


def compile_diffsl(source: str) -> DiffslModel:
    """Parse + analyse DiffSL source (reference build_from_diffsl path,
    builder.rs `build_from_diffsl` -> diffsl.rs:239-330)."""
    defs = parse(source)
    by_name = {}
    for td in defs:
        if td.name in by_name:
            raise DiffslError(f"duplicate tensor {td.name!r}")
        by_name[td.name] = td

    if "u" not in by_name or "F" not in by_name:
        raise DiffslError("a DiffSL model needs `u` (states) and `F` (rhs)")

    # the model-index built-in `N` (reference diffsl.rs set_model_index +
    # diffsol-c ode_solver_type.rs:66: N is set to the index of the root
    # that fired, before the reset applies): carried as a HIDDEN trailing
    # state (dy/dt = 0) updated by the index-aware reset
    uses_n = any(
        "N" in _tensor_refs(td) for td in defs if "N" not in by_name
    )

    # ---- in_i: parameter labels + defaults ----
    param_labels, defaults = [], []
    if "in" in by_name:
        pos = 0
        ev = _Eval(np, {"pi": (np.pi, 0)}, {}, "i")
        for e in by_name["in"].entries:
            if e.label is None:
                raise DiffslError("in_i entries must be `name = default`")
            arr, letters = ev.eval(e.expr)
            ln = 1 if letters == "" else int(np.shape(arr)[0])
            param_labels.append((e.label, pos, ln))
            defaults.extend(np.ravel(arr).tolist() if ln > 1 else [float(arr)])
            pos += ln
    default_params = np.asarray(defaults, dtype=np.float64)

    # ---- classify constant tensors (fold with numpy at build time) ----
    state_labels = {e.label for e in by_name["u"].entries if e.label}
    dudt_labels = set()
    if "dudt" in by_name:
        dudt_labels = {e.label for e in by_name["dudt"].entries if e.label}
    dynamic = (
        {"t", "u", "dudt", "N"}
        | state_labels
        | dudt_labels
        | {pl[0] for pl in param_labels}
        | set(SPECIAL)
    )
    constants = {}
    order = []
    const_env = {"pi": (np.pi, 0)}
    for td in defs:
        if td.name in SPECIAL:
            continue
        refs = _tensor_refs(td)
        if refs & dynamic or any(r not in const_env and r not in constants
                                 for r in refs if r != "pi"):
            dynamic.add(td.name)
            order.append(td.name)
            continue
        env = dict(const_env)
        env.update(constants)
        ev = _Eval(np, env, {}, td.idx)
        try:
            if len(td.idx) <= 1:
                arr, _segs = _eval_vector(td, ev)
                if td.idx == "":
                    arr = np.reshape(arr, ())
                constants[td.name] = (np.asarray(arr), len(td.idx))
            else:
                constants[td.name] = (np.asarray(_eval_matrix(td, ev)), 2)
        except DiffslError:
            dynamic.add(td.name)
            order.append(td.name)

    # transitive state-dependency: tensors that (directly or through other
    # tensors) read u/dudt or their labels cannot be evaluated at init time
    state_roots = {"u", "dudt", "N"} | state_labels | dudt_labels
    state_dep = set()
    for td in defs:
        if td.name in SPECIAL:
            continue
        if _tensor_refs(td) & (state_roots | state_dep):
            state_dep.add(td.name)

    # ---- state layout ----
    # evaluate u with constants only to size the state vector; entries may
    # reference constant tensors (heat2d: y = init_i)
    env = dict(const_env)
    env.update(constants)
    for name, start, ln in param_labels:
        v = default_params[start:start + ln]
        env[name] = (v[0], 0) if ln == 1 else (v, 1)
    env["t"] = (np.asarray(0.0), 0)
    # intermediates that u might need and that are param-only
    for name in order:
        td = by_name[name]
        if name in state_dep:
            continue
        ev = _Eval(np, env, {}, td.idx)
        try:
            if len(td.idx) <= 1:
                arr, _ = _eval_vector(td, ev)
                env[name] = (
                    np.reshape(arr, ()) if td.idx == "" else arr,
                    len(td.idx),
                )
            else:
                env[name] = (_eval_matrix(td, ev), 2)
        except DiffslError:
            pass
    ev = _Eval(np, env, {}, by_name["u"].idx or "i")
    y0, state_segments = _eval_vector(by_name["u"], ev)
    nstates = int(np.shape(y0)[0])

    dudt_segments = []
    if "dudt" in by_name:
        ev = _Eval(np, env, {}, by_name["dudt"].idx or "i")
        _d0, dudt_segments = _eval_vector(by_name["dudt"], ev)

    return DiffslModel(
        source=source,
        defs=defs,
        order=order,
        param_labels=param_labels,
        default_params=default_params,
        state_segments=state_segments,
        dudt_segments=dudt_segments,
        nstates=nstates,
        has_mass="M" in by_name,
        has_root="stop" in by_name,
        has_out="out" in by_name,
        has_reset="reset" in by_name,
        state_dep=state_dep,
        constants=constants,
        uses_n=uses_n,
    )
