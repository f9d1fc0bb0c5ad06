"""Mini-jsonnet: a from-scratch pure-Python evaluator for the jsonnet subset
used by RSPNet-style experiment configs.

The reference framework evaluates configs with the C++ ``_jsonnet`` binding
(reference: framework/config.py:2,64-68). That binding is not available here,
so this module implements the language subset the config surface actually
exercises (reference: config/**/*.jsonnet, *.libsonnet):

- ``local`` bindings (file level, expression level, and object level)
- ``import`` with a pluggable import callback (needed for the
  ``__base_config__`` / ``__addition_config__`` / ``__arg_i__`` virtual
  imports, reference: framework/config.py:44-68)
- object literals with ``:``, ``::`` (hidden), ``:::`` (forced visible) and
  ``+:`` (merge with super) fields, object-level ``local`` and ``assert``
- late-bound ``self`` / ``super`` / ``$`` across object inheritance
  (``a + b`` and juxtaposition ``base { ... }``)
- functions (``local f(x) = ...;`` and ``function(x) ...``), default args
- ``if/then/else``, full binary/unary operator set, ``%`` string formatting
- arrays, array/string indexing and slicing, comprehensions
- the ``std`` builtins used by the configs plus a safety margin

Evaluation is lazy (thunks with caching), matching jsonnet semantics so that
computed fields like ``size: if std.length($.moco.diff_speed) == 0 ...``
(reference: config/pretrain/moco-train-base.jsonnet:41-43) resolve against the
final composed object.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["evaluate_snippet", "evaluate_file", "JsonnetError"]


class JsonnetError(Exception):
    """Raised for lexing, parsing, or evaluation errors."""

    def __init__(self, msg: str, filename: str = "", line: int = 0):
        loc = f"{filename}:{line}: " if filename else ""
        super().__init__(f"{loc}{msg}")


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

KEYWORDS = {
    "local", "import", "importstr", "if", "then", "else", "true", "false",
    "null", "self", "super", "function", "assert", "error", "in", "for",
    "tailstrict",
}

# Multi-char operators, longest first.
OPERATORS = [
    ":::", "+:::",
    "+::", "::", "+:",
    "==", "!=", "<=", ">=", "&&", "||", "<<", ">>",
    "+", "-", "*", "/", "%", "<", ">", "=", ":", ";", ",", ".", "(", ")",
    "[", "]", "{", "}", "!", "&", "|", "^", "~", "$",
]


@dataclass
class Token:
    kind: str          # 'ident', 'keyword', 'number', 'string', 'op', 'eof'
    value: Any
    line: int


def _lex(src: str, filename: str) -> List[Token]:
    toks: List[Token] = []
    i, n, line = 0, len(src), 1
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if c == "#" or src.startswith("//", i):
            while i < n and src[i] != "\n":
                i += 1
            continue
        if src.startswith("/*", i):
            end = src.find("*/", i + 2)
            if end < 0:
                raise JsonnetError("unterminated block comment", filename, line)
            line += src.count("\n", i, end)
            i = end + 2
            continue
        if src.startswith("|||", i):
            # Text block: skip to first newline, gather until a line whose
            # first non-ws chars are '|||'.
            j = src.find("\n", i)
            if j < 0:
                raise JsonnetError("bad text block", filename, line)
            j += 1
            lines = []
            term_pos = -1
            while j < n:
                k = src.find("\n", j)
                if k < 0:
                    k = n
                seg = src[j:k]
                stripped = seg.lstrip()
                if stripped.startswith("|||"):
                    # terminator may be followed by more tokens on the
                    # same line (the common `|||,` form): resume lexing
                    # right after the closing bars
                    term_pos = j + (len(seg) - len(stripped)) + 3
                    break
                lines.append(seg)
                j = k + 1
            if term_pos < 0:
                raise JsonnetError("unterminated text block", filename, line)
            # strip common leading whitespace
            indents = [len(s) - len(s.lstrip()) for s in lines if s.strip()]
            pad = min(indents) if indents else 0
            text = "".join(s[pad:] + "\n" for s in lines)
            toks.append(Token("string", text, line))
            line += src.count("\n", i, term_pos)
            i = term_pos
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            while j < n and (src[j].isdigit() or src[j] in ".eE" or
                             (src[j] in "+-" and j > i and src[j - 1] in "eE")):
                j += 1
            txt = src[i:j]
            try:
                val = int(txt)
            except ValueError:
                try:
                    val = float(txt)
                except ValueError:
                    raise JsonnetError(f"invalid number {txt!r}", filename,
                                       line)
            toks.append(Token("number", val, line))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            toks.append(Token("keyword" if word in KEYWORDS else "ident", word, line))
            i = j
            continue
        if c in "'\"":
            # optional @ verbatim strings handled below
            i2, out = i + 1, []
            while i2 < n and src[i2] != c:
                ch = src[i2]
                if ch == "\\":
                    i2 += 1
                    if i2 >= n:
                        raise JsonnetError("bad escape", filename, line)
                    esc = src[i2]
                    mapping = {"n": "\n", "t": "\t", "r": "\r", "b": "\b",
                               "f": "\f", "\\": "\\", "'": "'", '"': '"', "/": "/"}
                    if esc == "u":
                        out.append(chr(int(src[i2 + 1:i2 + 5], 16)))
                        i2 += 4
                    elif esc in mapping:
                        out.append(mapping[esc])
                    else:
                        raise JsonnetError(f"bad escape \\{esc}", filename, line)
                else:
                    if ch == "\n":
                        line += 1
                    out.append(ch)
                i2 += 1
            if i2 >= n:
                raise JsonnetError("unterminated string", filename, line)
            toks.append(Token("string", "".join(out), line))
            i = i2 + 1
            continue
        if c == "@" and i + 1 < n and src[i + 1] in "'\"":
            q = src[i + 1]
            i2, out = i + 2, []
            while i2 < n:
                if src[i2] == q:
                    if i2 + 1 < n and src[i2 + 1] == q:
                        out.append(q)
                        i2 += 2
                        continue
                    break
                out.append(src[i2])
                i2 += 1
            toks.append(Token("string", "".join(out), line))
            i = i2 + 1
            continue
        for op in OPERATORS:
            if src.startswith(op, i):
                toks.append(Token("op", op, line))
                i += len(op)
                break
        else:
            raise JsonnetError(f"unexpected character {c!r}", filename, line)
    toks.append(Token("eof", None, line))
    return toks


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclass
class Node:
    line: int = 0


@dataclass
class Lit(Node):
    value: Any = None


@dataclass
class Var(Node):
    name: str = ""


@dataclass
class SelfE(Node):
    pass


@dataclass
class DollarE(Node):
    pass


@dataclass
class SuperIndex(Node):
    index: Node = None


@dataclass
class ArrayE(Node):
    items: List[Node] = field(default_factory=list)


@dataclass
class ArrayComp(Node):
    body: Node = None
    var: str = ""
    seq: Node = None
    conds: List[Node] = field(default_factory=list)


@dataclass
class ObjField:
    name: Node           # expression producing a string (Lit for plain names)
    body: Node
    visibility: str      # ':', '::', ':::'
    plus: bool           # f+: v
    params: Optional[List[Tuple[str, Optional[Node]]]] = None  # method sugar


@dataclass
class ObjectE(Node):
    fields: List[ObjField] = field(default_factory=list)
    locals_: List[Tuple[str, Node]] = field(default_factory=list)
    asserts: List[Tuple[Node, Optional[Node]]] = field(default_factory=list)


@dataclass
class LocalE(Node):
    binds: List[Tuple[str, Node]] = field(default_factory=list)
    body: Node = None


@dataclass
class CondE(Node):
    cond: Node = None
    then: Node = None
    els: Optional[Node] = None


@dataclass
class BinOp(Node):
    op: str = ""
    lhs: Node = None
    rhs: Node = None


@dataclass
class UnOp(Node):
    op: str = ""
    operand: Node = None


@dataclass
class Index(Node):
    target: Node = None
    index: Node = None


@dataclass
class SliceE(Node):
    target: Node = None
    lo: Optional[Node] = None
    hi: Optional[Node] = None
    step: Optional[Node] = None


@dataclass
class Apply(Node):
    fn: Node = None
    args: List[Node] = field(default_factory=list)
    kwargs: List[Tuple[str, Node]] = field(default_factory=list)


@dataclass
class FunctionE(Node):
    params: List[Tuple[str, Optional[Node]]] = field(default_factory=list)
    body: Node = None


@dataclass
class ImportE(Node):
    path: str = ""
    raw: bool = False


@dataclass
class ErrorE(Node):
    msg: Node = None


@dataclass
class AssertE(Node):
    cond: Node = None
    msg: Optional[Node] = None
    body: Node = None


@dataclass
class InSuper(Node):
    index: Node = None


# ---------------------------------------------------------------------------
# Parser (recursive descent, precedence climbing)
# ---------------------------------------------------------------------------

_BINARY_PREC = {
    "||": 1, "&&": 2, "|": 3, "^": 4, "&": 5,
    "==": 6, "!=": 6,
    "<": 7, ">": 7, "<=": 7, ">=": 7, "in": 7,
    "<<": 8, ">>": 8,
    "+": 9, "-": 9,
    "*": 10, "/": 10, "%": 10,
}


class _Parser:
    def __init__(self, toks: List[Token], filename: str):
        self.toks = toks
        self.pos = 0
        self.filename = filename

    # -- token helpers ----------------------------------------------------
    def peek(self, offset: int = 0) -> Token:
        return self.toks[min(self.pos + offset, len(self.toks) - 1)]

    def _split_double_colon(self) -> None:
        """Inside a slice, a '::' token (lexed greedily for hidden
        fields) is two ':' delimiters — e.g. arr[1::2]."""
        t = self.peek()
        if t.kind == "op" and t.value == "::":
            self.toks[self.pos] = Token("op", ":", t.line)
            self.toks.insert(self.pos + 1, Token("op", ":", t.line))

    def next(self) -> Token:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect_op(self, op: str) -> Token:
        t = self.next()
        if t.kind != "op" or t.value != op:
            raise JsonnetError(f"expected {op!r}, got {t.value!r}", self.filename, t.line)
        return t

    def expect_kw(self, kw: str) -> Token:
        t = self.next()
        if t.kind != "keyword" or t.value != kw:
            raise JsonnetError(f"expected {kw!r}, got {t.value!r}", self.filename, t.line)
        return t

    def at_op(self, op: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value == op

    def at_kw(self, kw: str) -> bool:
        t = self.peek()
        return t.kind == "keyword" and t.value == kw

    # -- grammar -----------------------------------------------------------
    def parse(self) -> Node:
        e = self.expr()
        t = self.peek()
        if t.kind != "eof":
            raise JsonnetError(f"unexpected trailing token {t.value!r}", self.filename, t.line)
        return e

    def expr(self) -> Node:
        return self.binary(0)

    def binary(self, min_prec: int) -> Node:
        lhs = self.unary()
        while True:
            t = self.peek()
            op = None
            if t.kind == "op" and t.value in _BINARY_PREC:
                op = t.value
            elif t.kind == "keyword" and t.value == "in":
                op = "in"
            if op is None or _BINARY_PREC[op] < min_prec:
                return lhs
            self.next()
            # 'e in super'
            if op == "in" and self.at_kw("super"):
                self.next()
                lhs = InSuper(line=t.line, index=lhs)
                continue
            rhs = self.binary(_BINARY_PREC[op] + 1)
            lhs = BinOp(line=t.line, op=op, lhs=lhs, rhs=rhs)

    def unary(self) -> Node:
        t = self.peek()
        if t.kind == "op" and t.value in ("-", "+", "!", "~"):
            self.next()
            return UnOp(line=t.line, op=t.value, operand=self.unary())
        return self.postfix()

    def postfix(self) -> Node:
        e = self.primary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value == ".":
                self.next()
                name = self.next()
                if name.kind not in ("ident", "keyword"):
                    raise JsonnetError("expected field name", self.filename, name.line)
                e = Index(line=t.line, target=e, index=Lit(line=name.line, value=name.value))
            elif t.kind == "op" and t.value == "[":
                self.next()
                lo = hi = step = None
                self._split_double_colon()
                if not self.at_op(":"):
                    lo = self.expr()
                self._split_double_colon()
                if self.at_op(":"):
                    self.next()
                    self._split_double_colon()
                    if not self.at_op("]") and not self.at_op(":"):
                        hi = self.expr()
                    if self.at_op(":"):
                        self.next()
                        if not self.at_op("]"):
                            step = self.expr()
                    self.expect_op("]")
                    e = SliceE(line=t.line, target=e, lo=lo, hi=hi, step=step)
                else:
                    self.expect_op("]")
                    e = Index(line=t.line, target=e, index=lo)
            elif t.kind == "op" and t.value == "(":
                self.next()
                args, kwargs = [], []
                while not self.at_op(")"):
                    if (self.peek().kind == "ident" and self.peek(1).kind == "op"
                            and self.peek(1).value == "="):
                        kname = self.next().value
                        self.next()
                        kwargs.append((kname, self.expr()))
                    else:
                        args.append(self.expr())
                    if self.at_op(","):
                        self.next()
                if self.at_kw("tailstrict"):
                    self.next()
                self.expect_op(")")
                e = Apply(line=t.line, fn=e, args=args, kwargs=kwargs)
            elif t.kind == "op" and t.value == "{":
                # object application: e { ... }
                obj = self.object_literal()
                e = BinOp(line=t.line, op="+", lhs=e, rhs=obj)
            else:
                return e

    def primary(self) -> Node:
        t = self.peek()
        if t.kind == "number" or t.kind == "string":
            self.next()
            return Lit(line=t.line, value=t.value)
        if t.kind == "keyword":
            if t.value in ("true", "false"):
                self.next()
                return Lit(line=t.line, value=t.value == "true")
            if t.value == "null":
                self.next()
                return Lit(line=t.line, value=None)
            if t.value == "self":
                self.next()
                return SelfE(line=t.line)
            if t.value == "super":
                self.next()
                nt = self.next()
                if nt.kind == "op" and nt.value == ".":
                    name = self.next()
                    return SuperIndex(line=t.line, index=Lit(line=name.line, value=name.value))
                if nt.kind == "op" and nt.value == "[":
                    idx = self.expr()
                    self.expect_op("]")
                    return SuperIndex(line=t.line, index=idx)
                raise JsonnetError("expected '.' or '[' after super", self.filename, t.line)
            if t.value == "import" or t.value == "importstr":
                self.next()
                p = self.next()
                if p.kind != "string":
                    raise JsonnetError("import path must be a string literal", self.filename, p.line)
                return ImportE(line=t.line, path=p.value, raw=t.value == "importstr")
            if t.value == "local":
                self.next()
                binds = [self.bind()]
                while self.at_op(","):
                    self.next()
                    binds.append(self.bind())
                self.expect_op(";")
                return LocalE(line=t.line, binds=binds, body=self.expr())
            if t.value == "if":
                self.next()
                cond = self.expr()
                self.expect_kw("then")
                then = self.expr()
                els = None
                if self.at_kw("else"):
                    self.next()
                    els = self.expr()
                return CondE(line=t.line, cond=cond, then=then, els=els)
            if t.value == "function":
                self.next()
                self.expect_op("(")
                params = self.params()
                return FunctionE(line=t.line, params=params, body=self.expr())
            if t.value == "error":
                self.next()
                return ErrorE(line=t.line, msg=self.expr())
            if t.value == "assert":
                self.next()
                cond = self.expr()
                msg = None
                if self.at_op(":"):
                    self.next()
                    msg = self.expr()
                self.expect_op(";")
                return AssertE(line=t.line, cond=cond, msg=msg, body=self.expr())
            raise JsonnetError(f"unexpected keyword {t.value!r}", self.filename, t.line)
        if t.kind == "ident":
            self.next()
            return Var(line=t.line, name=t.value)
        if t.kind == "op":
            if t.value == "$":
                self.next()
                return DollarE(line=t.line)
            if t.value == "(":
                self.next()
                e = self.expr()
                self.expect_op(")")
                return e
            if t.value == "[":
                self.next()
                items: List[Node] = []
                while not self.at_op("]"):
                    first = self.expr()
                    if self.at_kw("for") and not items:
                        self.next()
                        var = self.next().value
                        self.expect_kw("in")
                        seq = self.expr()
                        conds = []
                        while self.at_kw("if"):
                            self.next()
                            conds.append(self.expr())
                        self.expect_op("]")
                        return ArrayComp(line=t.line, body=first, var=var, seq=seq, conds=conds)
                    items.append(first)
                    if self.at_op(","):
                        self.next()
                self.expect_op("]")
                return ArrayE(line=t.line, items=items)
            if t.value == "{":
                return self.object_literal()
        raise JsonnetError(f"unexpected token {t.value!r}", self.filename, t.line)

    def bind(self) -> Tuple[str, Node]:
        name = self.next()
        if name.kind != "ident":
            raise JsonnetError("expected identifier in local", self.filename, name.line)
        if self.at_op("("):
            self.next()
            params = self.params()
            self.expect_op("=")
            return name.value, FunctionE(line=name.line, params=params, body=self.expr())
        self.expect_op("=")
        return name.value, self.expr()

    def params(self) -> List[Tuple[str, Optional[Node]]]:
        params: List[Tuple[str, Optional[Node]]] = []
        while not self.at_op(")"):
            pname = self.next().value
            default = None
            if self.at_op("="):
                self.next()
                default = self.expr()
            params.append((pname, default))
            if self.at_op(","):
                self.next()
        self.expect_op(")")
        return params

    def object_literal(self) -> ObjectE:
        start = self.expect_op("{")
        obj = ObjectE(line=start.line)
        while not self.at_op("}"):
            t = self.peek()
            if t.kind == "keyword" and t.value == "local":
                self.next()
                obj.locals_.append(self.bind())
            elif t.kind == "keyword" and t.value == "assert":
                self.next()
                cond = self.expr()
                msg = None
                if self.at_op(":"):
                    self.next()
                    msg = self.expr()
                obj.asserts.append((cond, msg))
            else:
                obj.fields.append(self.object_field())
            if self.at_op(","):
                self.next()
            elif not self.at_op("}"):
                raise JsonnetError("expected ',' or '}' in object",
                                   self.filename, self.peek().line)
        self.next()  # consume '}'
        return obj

    def object_field(self) -> ObjField:
        t = self.peek()
        name_node: Node
        if t.kind in ("ident", "keyword") and t.kind != "op":
            self.next()
            name_node = Lit(line=t.line, value=t.value)
        elif t.kind == "string":
            self.next()
            name_node = Lit(line=t.line, value=t.value)
        elif t.kind == "op" and t.value == "[":
            self.next()
            name_node = self.expr()
            self.expect_op("]")
        else:
            raise JsonnetError(f"bad field name {t.value!r}", self.filename, t.line)

        params = None
        if self.at_op("("):
            self.next()
            params = self.params()

        op = self.next()
        if op.kind != "op":
            raise JsonnetError("expected ':' after field name", self.filename, op.line)
        plus = op.value.startswith("+")
        vis = op.value[1:] if plus else op.value
        if vis not in (":", "::", ":::"):
            raise JsonnetError(f"bad field separator {op.value!r}", self.filename, op.line)
        body = self.expr()
        if params is not None:
            body = FunctionE(line=op.line, params=params, body=body)
        return ObjField(name=name_node, body=body, visibility=vis, plus=plus)


# ---------------------------------------------------------------------------
# Runtime values
# ---------------------------------------------------------------------------

class _Thunk:
    __slots__ = ("fn", "value", "done")

    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn
        self.done = False
        self.value = None

    def force(self) -> Any:
        if not self.done:
            self.value = self.fn()
            self.done = True
            self.fn = None
        return self.value


class _Env:
    """Immutable-ish lexical environment (chained dict)."""
    __slots__ = ("vars", "parent")

    def __init__(self, vars: Dict[str, Any], parent: Optional["_Env"]):
        self.vars = vars
        self.parent = parent

    def lookup(self, name: str):
        env = self
        while env is not None:
            if name in env.vars:
                return env.vars[name]
            env = env.parent
        raise KeyError(name)


class JObject:
    """A composed jsonnet object: a chain of layers (leftmost = base)."""

    def __init__(self, layers: List[Tuple[ObjectE, _Env, "_Interp"]],
                 interp: "_Interp"):
        # each layer carries its DEFINING interpreter so field bodies
        # (and their relative imports) evaluate against the file that
        # declared them, even after `+` composition across files
        self.layers = layers          # ordered base -> derived
        self.interp = interp
        self._cache: Dict[str, Any] = {}
        # field name -> (layer_idx, ObjField, visibility) resolved top-down
        self._index: Dict[str, Tuple[int, ObjField, str]] = {}
        self._build_index()

    def _build_index(self):
        # Resolve field names per layer (names can be computed expressions).
        vis_map: Dict[str, str] = {}
        for li, (node, env, interp) in enumerate(self.layers):
            for f in node.fields:
                name = interp.field_name(f, env)
                if name is None:
                    continue
                # visibility inheritance: ':' keeps prior visibility if the
                # field already exists; '::' forces hidden; ':::' forces show
                prev = vis_map.get(name)
                if f.visibility == "::":
                    vis = "hidden"
                elif f.visibility == ":::":
                    vis = "visible"
                else:
                    vis = prev if prev is not None else "visible"
                vis_map[name] = vis
                self._index[name] = (li, f, vis)

    def field_names(self, include_hidden: bool = False) -> List[str]:
        names = []
        seen = set()
        for li, (node, env, interp) in enumerate(self.layers):
            for f in node.fields:
                name = interp.field_name(f, env)
                if name is None or name in seen:
                    continue
                seen.add(name)
                if include_hidden or self._index[name][2] == "visible":
                    names.append(name)
        return names

    def has_field(self, name: str, include_hidden: bool = True) -> bool:
        if name not in self._index:
            return False
        return include_hidden or self._index[name][2] == "visible"

    def _field_def_below(self, name: str, layer_idx: int):
        """Find the definition of `name` in layers strictly below layer_idx."""
        for li in range(layer_idx - 1, -1, -1):
            node, env, interp = self.layers[li]
            for f in node.fields:
                if interp.field_name(f, env) == name:
                    return li, f
        return None

    def _eval_field_at(self, name: str, layer_idx: int, f: ObjField) -> Any:
        node, env, interp = self.layers[layer_idx]
        fenv = interp.make_object_env(self, layer_idx, node, env)
        val_thunk = lambda: interp.eval(f.body, fenv)
        if f.plus:
            below = self._field_def_below(name, layer_idx)
            if below is not None:
                base_val = self._eval_field_at(name, below[0], below[1])
                return interp.binop_plus(base_val, val_thunk(), f.body.line)
        return val_thunk()

    def get(self, name: str) -> Any:
        if name in self._cache:
            v = self._cache[name]
            if isinstance(v, _Thunk):
                return v.force()
            return v
        if name not in self._index:
            raise JsonnetError(f"object has no field {name!r}")
        li, f, _vis = self._index[name]
        th = _Thunk(lambda: self._eval_field_at(name, li, f))
        self._cache[name] = th
        return th.force()

    def super_get(self, name: str, above_layer: int) -> Any:
        below = self._field_def_below(name, above_layer)
        if below is None:
            raise JsonnetError(f"super object has no field {name!r}")
        return self._eval_field_at(name, below[0], below[1])

    def super_has(self, name: str, above_layer: int) -> bool:
        return self._field_def_below(name, above_layer) is not None

    def run_asserts(self):
        for li, (node, env, interp) in enumerate(self.layers):
            for cond, msg in node.asserts:
                fenv = interp.make_object_env(self, li, node, env)
                if not _truthy(interp.eval(cond, fenv)):
                    message = "object assertion failed"
                    if msg is not None:
                        message = _to_display(interp.eval(msg, fenv))
                    raise JsonnetError(str(message))


class JFunction:
    def __init__(self, params, body, env, interp, name="anonymous"):
        self.params = params
        self.body = body
        self.env = env
        self.interp = interp
        self.name = name

    def call(self, args: List[Any], kwargs: Dict[str, Any], line: int = 0) -> Any:
        bound: Dict[str, Any] = {}
        names = [p for p, _ in self.params]
        for i, a in enumerate(args):
            if i >= len(names):
                raise JsonnetError(f"too many args to {self.name}", line=line)
            bound[names[i]] = a
        for k, v in kwargs.items():
            if k not in names:
                raise JsonnetError(f"unknown parameter {k!r}", line=line)
            bound[k] = v
        env = _Env(bound, self.env)
        for pname, default in self.params:
            if pname not in bound:
                if default is None:
                    raise JsonnetError(f"missing argument {pname!r} to {self.name}", line=line)
                bound[pname] = self.interp.eval(default, env)
        return self.interp.eval(self.body, env)


def _truthy(v: Any) -> bool:
    if not isinstance(v, bool):
        raise JsonnetError(f"condition must be boolean, got {type(v).__name__}")
    return v


def _to_display(v: Any) -> str:
    if isinstance(v, str):
        return v
    return json.dumps(_manifest_py(v))


def _manifest_py(v: Any):
    """Best-effort conversion for display; full manifestation is in _Interp."""
    return v


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------

class _Interp:
    def __init__(self, import_callback=None, filename="<snippet>"):
        self.import_callback = import_callback
        self.filename = filename
        self._import_cache: Dict[str, Any] = {}
        self._ast_cache: Dict[str, Node] = {}
        self.std = _make_std(self)

    # -- environments -------------------------------------------------------
    def make_object_env(self, obj: JObject, layer_idx: int,
                        node: ObjectE, env: _Env) -> _Env:
        """Environment for evaluating a field body of `node` (layer layer_idx
        of composite `obj`): binds self/super/$ plus object-level locals."""
        vars: Dict[str, Any] = {
            "self": obj,
            "__super_base__": (obj, layer_idx),
        }
        # '$' refers to the lexically outermost object; if the literal was
        # nested in another object's field, the enclosing env already has '$'.
        try:
            env.lookup("$")
            has_dollar = True
        except KeyError:
            has_dollar = False
        if not has_dollar:
            vars["$"] = obj
        oenv = _Env(vars, env)
        if node.locals_:
            lvars: Dict[str, Any] = {}
            lenv = _Env(lvars, oenv)
            for lname, lbody in node.locals_:
                lvars[lname] = _Thunk(
                    lambda b=lbody: self.eval(b, lenv))
            return lenv
        return oenv

    def field_name(self, f: ObjField, env: _Env) -> Optional[str]:
        if isinstance(f.name, Lit):
            return f.name.value
        v = self.eval(f.name, env)
        if v is None:
            return None
        if not isinstance(v, str):
            raise JsonnetError("computed field name must be a string")
        return v

    # -- main eval ----------------------------------------------------------
    def eval(self, node: Node, env: _Env) -> Any:
        method = getattr(self, "_eval_" + type(node).__name__, None)
        if method is None:
            raise JsonnetError(f"cannot evaluate {type(node).__name__}")
        return method(node, env)

    def _eval_Lit(self, n: Lit, env):
        return n.value

    def _eval_Var(self, n: Var, env: _Env):
        try:
            v = env.lookup(n.name)
        except KeyError:
            if n.name == "std":
                return self.std
            raise JsonnetError(f"unknown variable {n.name!r}", self.filename, n.line)
        if isinstance(v, _Thunk):
            return v.force()
        return v

    def _eval_SelfE(self, n, env: _Env):
        try:
            return env.lookup("self")
        except KeyError:
            raise JsonnetError("self used outside object", self.filename, n.line)

    def _eval_DollarE(self, n, env: _Env):
        try:
            v = env.lookup("$")
        except KeyError:
            raise JsonnetError("$ used outside object", self.filename, n.line)
        return v

    def _eval_SuperIndex(self, n: SuperIndex, env: _Env):
        try:
            obj, layer_idx = env.lookup("__super_base__")
        except KeyError:
            raise JsonnetError("super used outside object", self.filename, n.line)
        name = self.eval(n.index, env)
        return obj.super_get(name, layer_idx)

    def _eval_InSuper(self, n: InSuper, env: _Env):
        try:
            obj, layer_idx = env.lookup("__super_base__")
        except KeyError:
            raise JsonnetError("super used outside object", self.filename, n.line)
        name = self.eval(n.index, env)
        return obj.super_has(name, layer_idx)

    def _eval_ArrayE(self, n: ArrayE, env: _Env):
        return [self.eval(item, env) for item in n.items]

    def _eval_ArrayComp(self, n: ArrayComp, env: _Env):
        seq = self.eval(n.seq, env)
        if not isinstance(seq, list):
            raise JsonnetError("comprehension over non-array", self.filename, n.line)
        out = []
        for item in seq:
            ienv = _Env({n.var: item}, env)
            if all(_truthy(self.eval(c, ienv)) for c in n.conds):
                out.append(self.eval(n.body, ienv))
        return out

    def _eval_ObjectE(self, n: ObjectE, env: _Env):
        obj = JObject([(n, env, self)], self)
        return obj

    def _eval_LocalE(self, n: LocalE, env: _Env):
        vars: Dict[str, Any] = {}
        nenv = _Env(vars, env)
        for name, body in n.binds:
            vars[name] = _Thunk(lambda b=body: self.eval(b, nenv))
        return self.eval(n.body, nenv)

    def _eval_CondE(self, n: CondE, env: _Env):
        if _truthy(self.eval(n.cond, env)):
            return self.eval(n.then, env)
        if n.els is None:
            return None
        return self.eval(n.els, env)

    def binop_plus(self, a, b, line=0):
        if isinstance(a, JObject) and isinstance(b, JObject):
            return JObject(a.layers + b.layers, self)
        if isinstance(a, str) or isinstance(b, str):
            return _coerce_str(a, self) + _coerce_str(b, self)
        if isinstance(a, list) and isinstance(b, list):
            return a + b
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return a + b
        raise JsonnetError(
            f"invalid operands for +: {type(a).__name__}, {type(b).__name__}",
            self.filename, line)

    def _eval_BinOp(self, n: BinOp, env: _Env):
        op = n.op
        if op == "&&":
            return _truthy(self.eval(n.lhs, env)) and _truthy(self.eval(n.rhs, env))
        if op == "||":
            return _truthy(self.eval(n.lhs, env)) or _truthy(self.eval(n.rhs, env))
        a = self.eval(n.lhs, env)
        b = self.eval(n.rhs, env)
        if op == "+":
            return self.binop_plus(a, b, n.line)
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            if b == 0:
                raise JsonnetError("division by zero", self.filename, n.line)
            return a / b
        if op == "%":
            if isinstance(a, str):
                return _format_str(a, b)
            return math.fmod(a, b)
        if op == "==":
            return _equals(a, b, self)
        if op == "!=":
            return not _equals(a, b, self)
        if op == "<":
            return a < b
        if op == ">":
            return a > b
        if op == "<=":
            return a <= b
        if op == ">=":
            return a >= b
        if op == "in":
            if isinstance(b, JObject):
                return b.has_field(a)
            raise JsonnetError("'in' requires object rhs", self.filename, n.line)
        if op == "&":
            return int(a) & int(b)
        if op == "|":
            return int(a) | int(b)
        if op == "^":
            return int(a) ^ int(b)
        if op == "<<":
            return int(a) << int(b)
        if op == ">>":
            return int(a) >> int(b)
        raise JsonnetError(f"unknown operator {op}", self.filename, n.line)

    def _eval_UnOp(self, n: UnOp, env: _Env):
        v = self.eval(n.operand, env)
        if n.op == "-":
            return -v
        if n.op == "+":
            return +v
        if n.op == "!":
            return not _truthy(v)
        if n.op == "~":
            return ~int(v)
        raise JsonnetError(f"unknown unary {n.op}", self.filename, n.line)

    def _eval_Index(self, n: Index, env: _Env):
        target = self.eval(n.target, env)
        idx = self.eval(n.index, env)
        if isinstance(target, JObject):
            return target.get(idx)
        if isinstance(target, dict):   # std library namespace
            if idx not in target:
                raise JsonnetError(f"std has no member {idx!r}", self.filename, n.line)
            return target[idx]
        if isinstance(target, (list, str)):
            if not isinstance(idx, int):
                idx = int(idx)
            return target[idx]
        raise JsonnetError(f"cannot index {type(target).__name__}", self.filename, n.line)

    def _eval_SliceE(self, n: SliceE, env: _Env):
        target = self.eval(n.target, env)
        lo = self.eval(n.lo, env) if n.lo is not None else None
        hi = self.eval(n.hi, env) if n.hi is not None else None
        step = self.eval(n.step, env) if n.step is not None else None
        return target[slice(lo, hi, step)]

    def _eval_Apply(self, n: Apply, env: _Env):
        fn = self.eval(n.fn, env)
        args = [self.eval(a, env) for a in n.args]
        kwargs = {k: self.eval(v, env) for k, v in n.kwargs}
        if isinstance(fn, JFunction):
            return fn.call(args, kwargs, n.line)
        if callable(fn):
            return fn(*args, **kwargs)
        raise JsonnetError("calling a non-function", self.filename, n.line)

    def _eval_FunctionE(self, n: FunctionE, env: _Env):
        return JFunction(n.params, n.body, env, self)

    def _eval_ImportE(self, n: ImportE, env: _Env):
        base_dir = os.path.dirname(self.filename)
        key = (base_dir, n.path, n.raw)
        if key in self._import_cache:
            return self._import_cache[key]
        try:
            if self.import_callback is not None:
                full_path, content = self.import_callback(
                    base_dir + os.sep if base_dir else "", n.path)
            else:
                full_path = (n.path if os.path.isabs(n.path)
                             else os.path.join(base_dir, n.path))
                with open(full_path) as f:
                    content = f.read()
        except OSError as e:
            # keep the documented error contract: callers catch
            # JsonnetError and want jsonnet file/line context
            raise JsonnetError(f"couldn't open import {n.path!r}: {e}",
                               self.filename, n.line)
        if n.raw:
            self._import_cache[key] = content
            return content
        sub = _Interp(self.import_callback, filename=str(full_path))
        sub._import_cache = self._import_cache
        ast = _parse(content, str(full_path))
        result = sub.eval(ast, _Env({}, None))
        self._import_cache[key] = result
        return result

    def _eval_ErrorE(self, n: ErrorE, env: _Env):
        raise JsonnetError(_to_display(self.eval(n.msg, env)), self.filename, n.line)

    def _eval_AssertE(self, n: AssertE, env: _Env):
        if not _truthy(self.eval(n.cond, env)):
            msg = "assertion failed"
            if n.msg is not None:
                msg = _to_display(self.eval(n.msg, env))
            raise JsonnetError(msg, self.filename, n.line)
        return self.eval(n.body, env)

    # -- manifestation -------------------------------------------------------
    def manifest(self, v: Any) -> Any:
        if isinstance(v, JObject):
            v.run_asserts()
            out = {}
            for name in v.field_names(include_hidden=False):
                out[name] = self.manifest(v.get(name))
            return out
        if isinstance(v, list):
            return [self.manifest(x) for x in v]
        if isinstance(v, JFunction):
            raise JsonnetError("cannot manifest a function")
        if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
            # jsonnet prints integral numbers without a decimal point
            return int(v)
        return v


def _equals(a, b, interp: _Interp) -> bool:
    if isinstance(a, JObject) or isinstance(b, JObject):
        if not (isinstance(a, JObject) and isinstance(b, JObject)):
            return False
        return interp.manifest(a) == interp.manifest(b)
    if isinstance(a, list) or isinstance(b, list):
        # recurse: list equality must be deep for nested JObjects
        # (plain `a == b` compares JObject elements by identity)
        if not (isinstance(a, list) and isinstance(b, list)):
            return False
        return (len(a) == len(b)
                and all(_equals(x, y, interp) for x, y in zip(a, b)))
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return a == b


def _coerce_str(v, interp: _Interp) -> str:
    if isinstance(v, str):
        return v
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return _num_str(v)
    return json.dumps(interp.manifest(v))


def _num_str(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def _format_str(fmt: str, val) -> str:
    if isinstance(val, list):
        return fmt % tuple(val)
    if isinstance(val, JObject):
        raise JsonnetError("%% with object mapping not supported")
    return fmt % val


# ---------------------------------------------------------------------------
# std library (the subset the configs use, plus useful extras)
# ---------------------------------------------------------------------------

def _make_std(interp: _Interp) -> Dict[str, Any]:
    def _length(x):
        if isinstance(x, JObject):
            return len(x.field_names(include_hidden=False))
        return len(x)

    def _type(x):
        if x is None:
            return "null"
        if isinstance(x, bool):
            return "boolean"
        if isinstance(x, (int, float)):
            return "number"
        if isinstance(x, str):
            return "string"
        if isinstance(x, list):
            return "array"
        if isinstance(x, JObject):
            return "object"
        if isinstance(x, JFunction) or callable(x):
            return "function"
        return "unknown"

    def _object_has(o, f, inc_hidden=False):
        return o.has_field(f, include_hidden=inc_hidden)

    def _object_fields(o, inc_hidden=False):
        return o.field_names(include_hidden=inc_hidden)

    def _manifest_json(v):
        return json.dumps(interp.manifest(v), indent=4)

    return {
        "length": _length,
        "floor": lambda x: math.floor(x),
        "ceil": lambda x: math.ceil(x),
        "max": lambda a, b: max(a, b),
        "min": lambda a, b: min(a, b),
        "abs": lambda x: abs(x),
        "pow": lambda x, n: x ** n,
        "sqrt": lambda x: math.sqrt(x),
        "mod": lambda a, b: _format_str(a, b) if isinstance(a, str) else math.fmod(a, b),
        "toString": lambda x: _coerce_str(x, interp),
        "join": lambda sep, arr: sep.join(
            arr if all(isinstance(x, str) for x in arr) else
            [_coerce_str(x, interp) for x in arr]) if isinstance(sep, str) else
            [x for i, item in enumerate(arr) for x in (sep if i else []) + item],
        "split": lambda s, c: s.split(c),
        "splitLimit": lambda s, c, m: s.split(c, m),
        "strReplace": lambda s, frm, to: s.replace(frm, to),
        "asciiUpper": lambda s: s.upper(),
        "asciiLower": lambda s: s.lower(),
        "format": _format_str,
        "range": lambda lo, hi: list(range(lo, hi + 1)),
        "makeArray": lambda sz, fn: [
            fn.call([i], {}) if isinstance(fn, JFunction) else fn(i)
            for i in range(sz)],
        "map": lambda fn, arr: [
            fn.call([x], {}) if isinstance(fn, JFunction) else fn(x) for x in arr],
        "filter": lambda fn, arr: [
            x for x in arr
            if (fn.call([x], {}) if isinstance(fn, JFunction) else fn(x))],
        "sort": lambda arr, keyF=None: sorted(
            arr, key=(lambda x: keyF.call([x], {})) if isinstance(keyF, JFunction)
            else keyF),
        "reverse": lambda arr: list(reversed(arr)),
        "member": lambda arr, x: x in arr,
        "count": lambda arr, x: arr.count(x),
        "flattenArrays": lambda arrs: [x for a in arrs for x in a],
        "type": _type,
        "isString": lambda x: isinstance(x, str),
        "isNumber": lambda x: isinstance(x, (int, float)) and not isinstance(x, bool),
        "isBoolean": lambda x: isinstance(x, bool),
        "isArray": lambda x: isinstance(x, list),
        "isObject": lambda x: isinstance(x, JObject),
        "isFunction": lambda x: isinstance(x, JFunction) or callable(x),
        "objectHas": _object_has,
        "objectHasAll": lambda o, f: _object_has(o, f, True),
        "objectFields": _object_fields,
        "objectFieldsAll": lambda o: _object_fields(o, True),
        "manifestJsonEx": lambda v, indent: json.dumps(interp.manifest(v), indent=len(indent)),
        "manifestJson": _manifest_json,
        "extVar": lambda name: (_ for _ in ()).throw(
            JsonnetError(f"extVar {name!r} not provided")),
        "trace": lambda msg, v: v,
        "codepoint": lambda s: ord(s),
        "char": lambda c: chr(c),
        "substr": lambda s, frm, ln: s[frm:frm + ln],
        "startsWith": lambda a, b: a.startswith(b),
        "endsWith": lambda a, b: a.endswith(b),
        "parseInt": lambda s: int(s),
        "parseJson": lambda s: json.loads(s),
    }


# ---------------------------------------------------------------------------
# Public API (mirrors the _jsonnet binding surface used by the reference,
# framework/config.py:64-68)
# ---------------------------------------------------------------------------

_parse_cache: Dict[Tuple[str, str], Node] = {}


def _parse(src: str, filename: str) -> Node:
    key = (filename, src)
    if key not in _parse_cache:
        _parse_cache[key] = _Parser(_lex(src, filename), filename).parse()
        if len(_parse_cache) > 512:
            _parse_cache.clear()
    return _parse_cache[key]


def evaluate_snippet(filename: str, src: str, import_callback=None) -> str:
    """Evaluate a jsonnet snippet and return its JSON manifestation.

    `import_callback(dir, rel) -> (full_path, content)` matches the signature
    the reference passes to `_jsonnet.evaluate_snippet`.
    """
    interp = _Interp(import_callback=import_callback, filename=filename)
    ast = _parse(src, filename)
    value = interp.eval(ast, _Env({}, None))
    return json.dumps(interp.manifest(value), indent=4)


def evaluate_file(path: str, import_callback=None) -> str:
    with open(path) as f:
        src = f.read()
    return evaluate_snippet(str(path), src, import_callback=import_callback)
