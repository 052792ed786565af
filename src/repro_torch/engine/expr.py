"""Expression / predicate algebra -> vectorized evaluation (paper: ExprEval).

The paper JIT-compiles expression evaluation to avoid type-dispatch
branching; here XLA *is* that JIT -- expressions build jnp computations and
whole plans compile to one program (engine/pipeline.py).

Predicates additionally expose ``bounds()``: the (lo, hi) interval per
column they imply, which Scan uses for SMA container/block pruning (§3.5).

Mirrors ``src/repro/engine/expr.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


class Expr:
    def __call__(self, cols: Dict[str, Any]):
        raise NotImplementedError

    # -- operator sugar ---------------------------------------------------
    def _bin(self, other, op):
        return BinOp(op, self, _wrap(other))

    def __add__(self, o): return self._bin(o, "+")
    def __sub__(self, o): return self._bin(o, "-")
    def __mul__(self, o): return self._bin(o, "*")
    def __truediv__(self, o): return self._bin(o, "/")
    def __lt__(self, o): return self._bin(o, "<")
    def __le__(self, o): return self._bin(o, "<=")
    def __gt__(self, o): return self._bin(o, ">")
    def __ge__(self, o): return self._bin(o, ">=")
    def __eq__(self, o): return self._bin(o, "==")   # noqa: PYI032
    def __ne__(self, o): return self._bin(o, "!=")   # noqa: PYI032
    def __and__(self, o): return self._bin(o, "&")
    def __or__(self, o): return self._bin(o, "|")
    __hash__ = None  # type: ignore[assignment]

    def bounds(self) -> Dict[str, Tuple[Optional[float], Optional[float]]]:
        """col -> (lo, hi) interval implied by this predicate (for SMA
        pruning); empty when nothing can be inferred."""
        return {}

    def columns(self) -> set:
        return set()

    def signature(self) -> str:
        """Stable structural key (shape + literals) for the executor's
        plan cache: two predicates with equal signatures build identical
        jnp programs."""
        raise NotImplementedError


def _wrap(v) -> "Expr":
    return v if isinstance(v, Expr) else Lit(v)


@dataclasses.dataclass(eq=False)
class Col(Expr):
    name: str

    def __call__(self, cols):
        return cols[self.name]

    def columns(self):
        return {self.name}

    def signature(self):
        return f"c:{self.name}"


@dataclasses.dataclass(eq=False)
class Lit(Expr):
    value: Any

    def __call__(self, cols):
        return self.value

    def signature(self):
        return f"l:{self.value!r}"


_OPS: Dict[str, Callable] = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "&": lambda a, b: a & b, "|": lambda a, b: a | b,
}


@dataclasses.dataclass(eq=False)
class BinOp(Expr):
    op: str
    lhs: Expr
    rhs: Expr

    def __call__(self, cols):
        return _OPS[self.op](self.lhs(cols), self.rhs(cols))

    def columns(self):
        return self.lhs.columns() | self.rhs.columns()

    def signature(self):
        return f"({self.lhs.signature()}{self.op}{self.rhs.signature()})"

    def bounds(self):
        # comparison of a column against a literal
        if isinstance(self.lhs, Col) and isinstance(self.rhs, Lit):
            v = self.rhs.value
            iv = {"==": (v, v), "<": (None, v), "<=": (None, v),
                  ">": (v, None), ">=": (v, None)}.get(self.op)
            return {self.lhs.name: iv} if iv else {}
        if isinstance(self.rhs, Col) and isinstance(self.lhs, Lit):
            v = self.lhs.value
            iv = {"==": (v, v), ">": (None, v), ">=": (None, v),
                  "<": (v, None), "<=": (v, None)}.get(self.op)
            return {self.rhs.name: iv} if iv else {}
        if self.op == "&":
            out = dict(self.lhs.bounds())
            for c, (lo, hi) in self.rhs.bounds().items():
                plo, phi = out.get(c, (None, None))
                out[c] = (_tighter(plo, lo, max), _tighter(phi, hi, min))
            return out
        return {}


def _tighter(a, b, pick):
    if a is None:
        return b
    if b is None:
        return a
    return pick(a, b)


def exact_int_interval(e: Expr):
    """If ``e`` is exactly a conjunction of integer comparisons on ONE
    column, return (col, lo, hi) with INCLUSIVE bounds (None = open side);
    else None. Unlike bounds() -- which is conservative and fine for SMA
    pruning -- this is exact, as required by the RLE-scalar COUNT path."""
    if not isinstance(e, BinOp):
        return None
    if e.op == "&":
        a = exact_int_interval(e.lhs)
        b = exact_int_interval(e.rhs)
        if a is None or b is None or a[0] != b[0]:
            return None
        col_ = a[0]
        lo = a[1] if b[1] is None else (b[1] if a[1] is None
                                        else max(a[1], b[1]))
        hi = a[2] if b[2] is None else (b[2] if a[2] is None
                                        else min(a[2], b[2]))
        return (col_, lo, hi)
    lhs, rhs, op = e.lhs, e.rhs, e.op
    if isinstance(rhs, Col) and isinstance(lhs, Lit):
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "=="}
        if op not in flip:
            return None
        lhs, rhs, op = rhs, lhs, flip[op]
    if not (isinstance(lhs, Col) and isinstance(rhs, Lit)):
        return None
    v = rhs.value
    if not isinstance(v, (int, np.integer)):
        return None
    v = int(v)
    iv = {"==": (v, v), "<": (None, v - 1), "<=": (None, v),
          ">": (v + 1, None), ">=": (v, None)}.get(op)
    return (lhs.name, iv[0], iv[1]) if iv else None


def interval_decompose(e: Expr
                       ) -> Optional[Dict[str, Tuple[Optional[int],
                                                     Optional[int]]]]:
    """Exact multi-column decomposition: if ``e`` is a conjunction of
    integer comparisons, each on a single column, return
    ``{col: (lo, hi)}`` with INCLUSIVE bounds (None = open side); else
    None.  The compressed-domain executor rewrites these intervals into
    dictionary code ranges, so -- like ``exact_int_interval`` -- this must
    be exact, not conservative; any untranslatable part rejects the whole
    predicate."""
    if not isinstance(e, BinOp):
        return None
    if e.op == "&":
        a = interval_decompose(e.lhs)
        b = interval_decompose(e.rhs)
        if a is None or b is None:
            return None
        out = dict(a)
        for c, (lo, hi) in b.items():
            plo, phi = out.get(c, (None, None))
            out[c] = (_tighter(plo, lo, max), _tighter(phi, hi, min))
        return out
    one = exact_int_interval(e)
    if one is None:
        return None
    return {one[0]: (one[1], one[2])}


def col(name: str) -> Col:
    return Col(name)


def lit(v) -> Lit:
    return Lit(v)
