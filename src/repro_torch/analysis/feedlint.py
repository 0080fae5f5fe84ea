"""feedlint — AST-based concurrency-invariant analyzer for the port's
core (``repro.analysis.feedlint`` on the port's side).

Six rules, all driven by the comment annotations documented in
repro_torch.analysis.annotations and docs/CONCURRENCY.md:

R1 guarded-field       fields declared ``# guarded-by: <lock>`` (or
                       ``write-guarded-by``) are read/mutated only inside
                       ``with <lock>`` or a ``# requires-lock`` method.
R2 lock-order          every observed nested acquisition (lexical
                       with-in-with plus transitive may-acquire through
                       resolvable calls) must lie inside the declared
                       acquisition order (annotations.LOCK_ORDER plus
                       in-file ``# feedlint: order a -> b``); cycles and
                       re-entrant acquisitions always fail.
R3 blocking-under-lock kernel dispatch, host<->device synchronisation,
                       npz/file I/O, time.sleep and queue puts lexically
                       under a ``with <lock>`` body
                       (locks tagged ``blocking-ok`` — dedicated
                       background serialization locks — are exempt).
R4 epoch-fence         repair_rows/delete_rows/update_lineage call sites
                       outside storage.py must pass ``expect_epoch=``.
R5 listener-under-lock subscriber callbacks (``# fires-listeners``
                       methods, or callables iterated from a
                       ``# listener-registry`` field) never run under a
                       held lock.
R6 obs-under-lock      telemetry publication — histogram ``.observe()``
                       and span ``.emit()`` — never runs under a strict
                       (non-``blocking-ok``) lock; counters and gauges
                       are lock-free and stay legal anywhere.

The analyzer is pure stdlib ``ast`` + ``tokenize``: it never imports the
code it scans.  Exit status 0 means a clean tree.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import re
import sys
import tokenize
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

try:
    from repro_torch.analysis.annotations import LOCK_ORDER
except ImportError:
    # Bare-runner path: run as a file without the package on the path
    # (``python src/repro_torch/analysis/feedlint.py src/repro_torch``),
    # load the stdlib-only annotations module beside it by path.
    import importlib.util as _ilu

    _spec = _ilu.spec_from_file_location(
        "_feedlint_annotations",
        Path(__file__).resolve().parent / "annotations.py")
    _mod = _ilu.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    LOCK_ORDER = _mod.LOCK_ORDER

_RE_LOCK_NAME = re.compile(r"lock-name:\s*([\w.-]+)")
_RE_BLOCKING_OK = re.compile(r"\bblocking-ok\b")
_RE_GUARDED = re.compile(r"(?<![\w-])guarded-by:\s*(\w+)")
_RE_WRITE_GUARDED = re.compile(r"write-guarded-by:\s*(\w+)")
_RE_REQUIRES = re.compile(r"requires-lock:\s*(\w+)")
_RE_FIRES = re.compile(r"\bfires-listeners\b")
_RE_LISTENER_REG = re.compile(r"\blistener-registry\b")
_RE_ALLOW = re.compile(r"feedlint:\s*allow\[([\w,\s-]+)\]")
_RE_ORDER = re.compile(r"feedlint:\s*order\s+([\w.-]+)\s*->\s*([\w.-]+)")

#: methods that mutate their receiver — a call through a guarded field
#: counts as a write to that field.
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "remove", "clear", "add", "discard", "update", "setdefault",
    "sort", "reverse", "merge",
}

#: module-level callables that block (I/O, sleep, a host wait on the
#: device) keyed by the *resolved* module name (import aliases are
#: followed; a dotted module is looked up whole, then by its root).
#: torch.save/load serialise to files; torch.cuda.synchronize waits for
#: every queued kernel.
_BLOCKING_MODULE_CALLS: Dict[str, Set[str]] = {
    "time": {"sleep"},
    "numpy": {"load", "save", "savez", "savez_compressed", "fromfile"},
    "json": {"dump", "load"},
    "os": {"replace", "unlink", "remove", "rename", "makedirs",
           "rmdir", "fsync"},
    "shutil": {"rmtree", "copy", "copy2", "move"},
    "torch": {"save", "load"},
    "torch.cuda": {"synchronize"},
}

#: resolved method calls that block, and what they do: queue puts, the
#: predeployed dispatch (its first call of a key builds the kernels with
#: nvcc; every call uploads, launches and may wait on the device), and a
#: hand kernel's launch (the first one builds and loads its library).
_BLOCKING_METHODS = {
    ("PartitionHolder", "push"): "queue put/close",
    ("PartitionHolder", "close"): "queue put/close",
    ("PredeployCache", "get"): "kernel dispatch",
    ("PredeployCache", "invoke"): "kernel dispatch",
    ("ComputingRunner", "run"): "kernel dispatch",
    ("CudaKernel", "launch"): "kernel launch",
}

#: R4: conditional storage writes that must be epoch-fenced outside
#: storage.py.
_EPOCH_FENCED = {"repair_rows", "delete_rows", "update_lineage"}

#: names never resolved via the unique-method-name fallback (too common
#: across stdlib types to trust).
_FALLBACK_BLOCKLIST = {"join", "get", "run", "start", "stop", "put",
                       "items", "keys", "values", "copy", "index",
                       "count", "split", "strip", "read", "write"}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.msg}"


@dataclasses.dataclass
class ClassInfo:
    name: str
    scan: "Scan"
    node: ast.ClassDef
    bases: List[str] = dataclasses.field(default_factory=list)
    locks: Dict[str, str] = dataclasses.field(default_factory=dict)
    aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    # field -> (lock attr, mode) where mode is "rw" or "w"
    guarded: Dict[str, Tuple[str, str]] = dataclasses.field(
        default_factory=dict)
    listener_fields: Set[str] = dataclasses.field(default_factory=set)
    requires: Dict[str, str] = dataclasses.field(default_factory=dict)
    fires: Set[str] = dataclasses.field(default_factory=set)
    props: Set[str] = dataclasses.field(default_factory=set)
    methods: Dict[str, ast.FunctionDef] = dataclasses.field(
        default_factory=dict)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Scan:
    path: str
    tree: ast.Module
    comments: Dict[int, str]
    comment_only: Set[int] = dataclasses.field(default_factory=set)
    # name bound by a plain ``import`` -> resolved module dotted name
    mod_imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    # name bound by ``from m import n`` -> (module dotted, n)
    from_imports: Dict[str, Tuple[str, str]] = dataclasses.field(
        default_factory=dict)
    classes: Dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    funcs: Dict[str, ast.FunctionDef] = dataclasses.field(
        default_factory=dict)
    mod_locks: Dict[str, str] = dataclasses.field(default_factory=dict)
    mod_guarded: Dict[str, Tuple[str, str]] = dataclasses.field(
        default_factory=dict)
    orders: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    dotted: str = ""


def _collect_comments(text: str) -> Tuple[Dict[int, str], Set[int]]:
    """comment text per line + the lines that are comment-only."""
    out: Dict[int, str] = {}
    own: Set[int] = set()
    lines = text.splitlines(True)
    try:
        for tok in tokenize.generate_tokens(iter(lines).__next__):
            if tok.type == tokenize.COMMENT:
                row, col = tok.start
                out[row] = tok.string
                if lines[row - 1][:col].strip() == "":
                    own.add(row)
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        pass
    return out, own


def _allow_set(comment: Optional[str]) -> Set[str]:
    if not comment:
        return set()
    m = _RE_ALLOW.search(comment)
    if not m:
        return set()
    return {t.strip() for t in m.group(1).split(",") if t.strip()}


def _line_allow(scan: "Scan", line: int) -> Set[str]:
    """Allows on the line itself plus contiguous comment-only lines
    directly above it (block-comment style suppressions)."""
    out = set(_allow_set(scan.comments.get(line)))
    j = line - 1
    while j in scan.comment_only:
        out |= _allow_set(scan.comments.get(j))
        j -= 1
    return out


def _decl_comment(scan: "Scan", line: int) -> str:
    """Declaration-site comment text: the line's own trailing comment
    plus contiguous comment-only lines directly above (for annotations
    that don't fit on the assignment line)."""
    parts = []
    j = line - 1
    while j in scan.comment_only:
        parts.append(scan.comments.get(j, ""))
        j -= 1
    parts.reverse()
    parts.append(scan.comments.get(line, ""))
    return "\n".join(p for p in parts if p)


def _block_allow(scan: "Scan", line: int) -> Set[str]:
    """Allows attached to a def/with header: its own line, comment-only
    lines above, and the leading comment block of its body below."""
    out = _line_allow(scan, line)
    j = line + 1
    while j in scan.comment_only:
        out |= _allow_set(scan.comments.get(j))
        j += 1
    return out


def _ann_name(node: Optional[ast.AST]) -> Optional[str]:
    """Best-effort class name out of an annotation expression."""
    if node is None:
        return None
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        name = node.value.strip().strip("'\"")
        return name.split("[")[0].split(".")[-1] or None
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        base = _ann_name(node.value)
        if base == "Optional":
            return _ann_name(node.slice)
        return None
    return None


def _dotted_of(path: Path) -> str:
    """Module dotted name, rooted at the first ``repro_torch`` path
    component."""
    parts = list(path.with_suffix("").parts)
    if "repro_torch" in parts:
        parts = parts[parts.index("repro_torch"):]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _lock_ctor(value: ast.AST) -> Optional[str]:
    """'lock' | 'condition' if the assigned value constructs one."""
    for node in ast.walk(value):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "threading"):
            if node.func.attr in ("Lock", "RLock"):
                return "lock"
            if node.func.attr == "Condition":
                return "condition"
    return None


def _condition_target(value: ast.AST) -> Optional[str]:
    """The ``X`` in ``threading.Condition(self.X)``, if present."""
    for node in ast.walk(value):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "Condition" and node.args):
            arg = node.args[0]
            if (isinstance(arg, ast.Attribute)
                    and isinstance(arg.value, ast.Name)
                    and arg.value.id == "self"):
                return arg.attr
    return None


def _annotated_guard(ann: ast.AST) -> Optional[Tuple[str, str]]:
    """Parse ``Annotated[T, guarded_by("_lock")]`` declarations."""
    if not (isinstance(ann, ast.Subscript)
            and _ann_name(ann.value) == "Annotated"
            and isinstance(ann.slice, ast.Tuple)):
        return None
    for meta in ann.slice.elts[1:]:
        if (isinstance(meta, ast.Call) and isinstance(meta.func, ast.Name)
                and meta.func.id in ("guarded_by", "write_guarded_by")
                and meta.args and isinstance(meta.args[0], ast.Constant)):
            mode = "w" if meta.func.id == "write_guarded_by" else "rw"
            return str(meta.args[0].value), mode
    return None


class Linter:
    def __init__(self, scans: List[Scan],
                 extra_order: Sequence[Tuple[str, str]] = ()):
        self.scans = scans
        self.findings: List[Finding] = []
        # (outer, inner) -> first observed (path, line)
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.edge_allowed: Set[Tuple[str, str]] = set()
        self.declared: Set[Tuple[str, str]] = set(LOCK_ORDER)
        self.declared.update(extra_order)
        self.classes: Dict[str, Optional[ClassInfo]] = {}
        self.method_index: Dict[str, List[ClassInfo]] = {}
        self.by_dotted: Dict[str, Scan] = {}
        self.blocking_ok: Set[str] = set()
        self._summaries: Dict[int, Set[str]] = {}
        self._in_progress: Set[int] = set()
        self._index()

    # -- registry construction -------------------------------------------

    def _index(self) -> None:
        for scan in self.scans:
            self.by_dotted[scan.dotted] = scan
            self.declared.update(scan.orders)
            for cls in scan.classes.values():
                if cls.name in self.classes:
                    self.classes[cls.name] = None  # ambiguous
                else:
                    self.classes[cls.name] = cls
                for m in cls.methods:
                    self.method_index.setdefault(m, []).append(cls)
        for scan in self.scans:
            for line, comment in scan.comments.items():
                if _RE_LOCK_NAME.search(comment) and _RE_BLOCKING_OK.search(
                        comment):
                    self.blocking_ok.add(_RE_LOCK_NAME.search(comment).group(1))

    # -- small lookups through the (single-inheritance) base chain -------

    def _base_chain(self, cls: ClassInfo) -> List[ClassInfo]:
        chain, seen = [cls], {cls.name}
        cur = cls
        while True:
            nxt = None
            for b in cur.bases:
                cand = self.classes.get(b)
                if cand is not None and cand.name not in seen:
                    nxt = cand
                    break
            if nxt is None:
                return chain
            chain.append(nxt)
            seen.add(nxt.name)
            cur = nxt

    def _cls_lock(self, cls: ClassInfo, attr: str) -> Optional[str]:
        for c in self._base_chain(cls):
            if attr in c.aliases:
                attr = c.aliases[attr]
            if attr in c.locks:
                return c.locks[attr]
        return None

    def _cls_guard(self, cls: ClassInfo,
                   field: str) -> Optional[Tuple[ClassInfo, str, str]]:
        for c in self._base_chain(cls):
            if field in c.guarded:
                lockattr, mode = c.guarded[field]
                return c, lockattr, mode
        return None

    def _cls_method(self, cls: ClassInfo,
                    name: str) -> Optional[Tuple[ClassInfo, ast.FunctionDef]]:
        for c in self._base_chain(cls):
            if name in c.methods:
                return c, c.methods[name]
        return None

    def _cls_attr_type(self, cls: ClassInfo, attr: str) -> Optional[str]:
        for c in self._base_chain(cls):
            if attr in c.attr_types:
                return c.attr_types[attr]
        return None

    def _cls_requires(self, cls: ClassInfo, meth: str) -> Optional[str]:
        for c in self._base_chain(cls):
            if meth in c.requires:
                return c.requires[meth]
        return None

    def _is_listener_field(self, cls: ClassInfo, field: str) -> bool:
        return any(field in c.listener_fields for c in self._base_chain(cls))

    # -- type inference ---------------------------------------------------

    def infer(self, expr: ast.AST, env: Dict[str, object],
              scan: Scan):
        """-> ClassInfo | ("module", dotted) | None."""
        if isinstance(expr, ast.Name):
            v = env.get(expr.id)
            if v is not None:
                return v
            if expr.id in scan.mod_imports:
                return ("module", scan.mod_imports[expr.id])
            fi = scan.from_imports.get(expr.id)
            if fi and f"{fi[0]}.{fi[1]}" in self.by_dotted:
                return ("module", f"{fi[0]}.{fi[1]}")
            return None
        if isinstance(expr, ast.Attribute):
            base = self.infer(expr.value, env, scan)
            if isinstance(base, tuple) and base[0] == "module":
                dotted = f"{base[1]}.{expr.attr}"
                if dotted in self.by_dotted:
                    return ("module", dotted)
                return ("module", dotted)
            if isinstance(base, ClassInfo):
                t = self._cls_attr_type(base, expr.attr)
                if t:
                    return self.classes.get(t)
            return None
        if isinstance(expr, ast.Call):
            target = self.resolve_call(expr, env, scan, None)
            if target and target[0] == "ctor":
                return target[1]
            if target and target[0] == "method":
                owner, fn = target[1], target[2]
                ret = _ann_name(owner.methods[fn].returns)
                if ret:
                    return self.classes.get(ret)
            return None
        if isinstance(expr, ast.Subscript):
            base = self.infer(expr.value, env, scan)
            if isinstance(base, ClassInfo):
                got = self._cls_method(base, "__getitem__")
                if got:
                    ret = _ann_name(got[1].returns)
                    if ret:
                        return self.classes.get(ret)
            return None
        if isinstance(expr, ast.IfExp):
            return (self.infer(expr.body, env, scan)
                    or self.infer(expr.orelse, env, scan))
        if isinstance(expr, ast.BoolOp):
            for v in expr.values:
                got = self.infer(v, env, scan)
                if got is not None:
                    return got
        return None

    def resolve_call(self, call: ast.Call, env: Dict[str, object],
                     scan: Scan, cls: Optional[ClassInfo]):
        """-> ("method", owner ClassInfo, name)
             | ("ctor", ClassInfo)
             | ("func", Scan, name) | None."""
        fn = call.func
        if isinstance(fn, ast.Name):
            target_cls = self.classes.get(fn.id)
            if target_cls is not None and fn.id not in env:
                return ("ctor", target_cls)
            if fn.id in scan.funcs:
                return ("func", scan, fn.id)
            fi = scan.from_imports.get(fn.id)
            if fi:
                src = self.by_dotted.get(fi[0])
                if src and fi[1] in src.funcs:
                    return ("func", src, fi[1])
            return None
        if isinstance(fn, ast.Attribute):
            base = self.infer(fn.value, env, scan)
            if isinstance(base, tuple) and base[0] == "module":
                src = self.by_dotted.get(base[1])
                if src and fn.attr in src.funcs:
                    return ("func", src, fn.attr)
                return None
            if isinstance(base, ClassInfo):
                got = self._cls_method(base, fn.attr)
                if got:
                    return ("method", got[0], fn.attr)
                return None
            # unique-method-name fallback for duck-typed receivers
            if isinstance(fn.value, ast.Constant):
                return None
            name = fn.attr
            if (name.startswith("__") or name in _FALLBACK_BLOCKLIST):
                return None
            owners = self.method_index.get(name, [])
            if len(owners) == 1:
                return ("method", owners[0], name)
        return None

    def _target_fn(self, target) -> Optional[Tuple[Optional[ClassInfo],
                                                   ast.FunctionDef, Scan]]:
        if target is None:
            return None
        if target[0] == "method":
            owner, name = target[1], target[2]
            return owner, owner.methods[name], owner.scan
        if target[0] == "ctor":
            owner = target[1]
            init = owner.methods.get("__init__")
            return (owner, init, owner.scan) if init else None
        if target[0] == "func":
            return None, target[1].funcs[target[2]], target[1]
        return None

    # -- may-acquire summaries -------------------------------------------

    def may_acquire(self, cls: Optional[ClassInfo], fn: ast.FunctionDef,
                    scan: Scan) -> Set[str]:
        key = id(fn)
        if key in self._summaries:
            return self._summaries[key]
        if key in self._in_progress:
            return set()
        self._in_progress.add(key)
        acquired: Set[str] = set()
        env = self._env_for(cls, fn)

        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return
            if isinstance(node, ast.With):
                for item in node.items:
                    g = self._lock_of(item.context_expr, env, scan, cls)
                    if g:
                        acquired.add(g)
            if isinstance(node, ast.Call):
                sub = self._callee_summary(node, env, scan, cls)
                acquired.update(sub)
            if isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Load):
                acquired.update(self._prop_summary(node, env, scan))
            if isinstance(node, ast.Assign) and isinstance(
                    node.targets[0], ast.Name):
                got = self.infer(node.value, env, scan)
                if got is not None:
                    env[node.targets[0].id] = got
            for child in ast.iter_child_nodes(node):
                visit(child)

        visit(fn)
        self._in_progress.discard(key)
        self._summaries[key] = acquired
        return acquired

    def _callee_summary(self, call: ast.Call, env, scan,
                        cls) -> Set[str]:
        target = self.resolve_call(call, env, scan, cls)
        got = self._target_fn(target)
        if not got:
            return set()
        owner, fn, src = got
        if fn is None:
            return set()
        out = set(self.may_acquire(owner, fn, src))
        if owner is not None:
            req = self._cls_requires(owner, fn.name)
            if req:
                g = self._cls_lock(owner, req)
                if g:
                    out.discard(g)  # the caller already holds it
        return out

    def _prop_summary(self, node: ast.Attribute, env, scan) -> Set[str]:
        base = self.infer(node.value, env, scan)
        if not isinstance(base, ClassInfo):
            return set()
        for c in self._base_chain(base):
            if node.attr in c.props:
                return self.may_acquire(c, c.methods[node.attr], c.scan)
        return set()

    # -- lock expression resolution --------------------------------------

    def _lock_of(self, expr: ast.AST, env, scan: Scan,
                 cls: Optional[ClassInfo]) -> Optional[str]:
        if isinstance(expr, ast.Name):
            return scan.mod_locks.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = self.infer(expr.value, env, scan)
            if isinstance(base, ClassInfo):
                return self._cls_lock(base, expr.attr)
        return None

    def _env_for(self, cls: Optional[ClassInfo],
                 fn: ast.FunctionDef,
                 outer: Optional[Dict[str, object]] = None
                 ) -> Dict[str, object]:
        env: Dict[str, object] = dict(outer) if outer else {}
        args = list(fn.args.posonlyargs) + list(fn.args.args) + \
            list(fn.args.kwonlyargs)
        for a in args:
            t = _ann_name(a.annotation)
            if t and self.classes.get(t):
                env[a.arg] = self.classes[t]
            else:
                env.pop(a.arg, None)  # param shadows any closure binding
        if cls is not None and args and args[0].arg == "self":
            env["self"] = cls
        return env

    # -- the main per-function rule pass ---------------------------------

    def check_function(self, cls: Optional[ClassInfo], fn: ast.FunctionDef,
                       scan: Scan,
                       outer_env: Optional[Dict[str, object]] = None) -> None:
        env = self._env_for(cls, fn, outer_env)
        parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(fn):
            for child in ast.iter_child_nodes(parent):
                parents[child] = parent
        held: List[str] = []
        allow_stack: List[Set[str]] = [_block_allow(scan, fn.lineno)]
        listener_vars: Set[str] = set()
        in_init = fn.name in ("__init__", "__new__", "__post_init__")
        nested: List[Tuple[ast.FunctionDef, Dict[str, object]]] = []
        checked_writes: Set[int] = set()

        req = self._cls_requires(cls, fn.name) if cls else None
        req_global = self._cls_lock(cls, req) if (cls and req) else None
        if req_global:
            held.append(req_global)

        def allowed(rule: str, line: int) -> bool:
            if rule in _line_allow(scan, line):
                return True
            return any(rule in s for s in allow_stack)

        def report(rule: str, line: int, msg: str) -> None:
            if not allowed(rule, line):
                self.findings.append(Finding(rule, scan.path, line, msg))

        def note_edges(inner: Set[str], line: int) -> None:
            for h in held:
                for m in inner:
                    if m == h:
                        report("lock-order", line,
                               f"re-entrant acquisition of lock '{h}'")
                        continue
                    self.edges.setdefault((h, m), (scan.path, line))
                    if allowed("lock-order", line):
                        self.edge_allowed.add((h, m))

        def check_field_access(node: ast.Attribute, owner: ClassInfo,
                               field: str) -> None:
            guard = self._cls_guard(owner, field)
            if not guard:
                return
            gcls, lockattr, mode = guard
            is_write = self._is_write(node, parents, checked_writes)
            if mode == "w" and not is_write:
                return
            need = self._cls_lock(gcls, lockattr)
            if need is None or need in held:
                return
            verb = "written" if is_write else "read"
            report("guarded-field", node.lineno,
                   f"field '{field}' ({verb}) is guarded by lock "
                   f"'{need}' which is not held here")

        def check_call(node: ast.Call) -> None:
            # R4 — epoch fencing outside storage.py
            fname = None
            if isinstance(node.func, ast.Attribute):
                fname = node.func.attr
            elif isinstance(node.func, ast.Name):
                fname = node.func.id
            if (fname in _EPOCH_FENCED
                    and Path(scan.path).name != "storage.py"
                    and not any(k.arg == "expect_epoch"
                                for k in node.keywords)):
                report("epoch-fence", node.lineno,
                       f"call to {fname}() outside storage.py must pass "
                       "expect_epoch=")

            target = self.resolve_call(node, env, scan, cls)

            strict_held = [h for h in held if h not in self.blocking_ok]
            if strict_held:
                # R3 — blocking work lexically under a lock
                block = self._blocking_reason(node, target, env, scan)
                if block:
                    report("blocking-under-lock", node.lineno,
                           f"{block} under lock '{strict_held[-1]}'")
                # R6 — telemetry publication under a strict lock: histogram
                # .observe() takes the per-instrument 'metrics' lock and
                # span .emit() can take 'trace-rings' on a thread's first
                # emit; both must run after release (counter .inc() /
                # gauge .set() are lock-free and stay legal anywhere).
                # blocking-ok step locks are exempt (their inward edges to
                # 'metrics'/'trace-rings' are declared in annotations.py).
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("observe", "emit")):
                    report("obs-under-lock", node.lineno,
                           f".{node.func.attr}() publishes telemetry under "
                           f"lock '{strict_held[-1]}'; record under the "
                           "lock, observe/emit after release")
            if held:
                # R5 — listener callbacks under any lock
                if (isinstance(node.func, ast.Name)
                        and node.func.id in listener_vars):
                    report("listener-under-lock", node.lineno,
                           f"listener callback '{node.func.id}' invoked "
                           f"under lock '{held[-1]}'")
                if target and target[0] == "method":
                    owner, name = target[1], target[2]
                    if any(name in c.fires for c in self._base_chain(owner)):
                        report("listener-under-lock", node.lineno,
                               f"{owner.name}.{name}() fires listeners but "
                               f"is called under lock '{held[-1]}'")
                # R2 — transitive acquisitions through the callee
                note_edges(self._callee_summary(node, env, scan, cls),
                           node.lineno)

        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                nested.append((node, dict(env)))
                return
            if isinstance(node, ast.Lambda):
                return
            if isinstance(node, ast.With):
                pushed = 0
                allow_stack.append(_block_allow(scan, node.lineno))
                for item in node.items:
                    g = self._lock_of(item.context_expr, env, scan, cls)
                    visit(item.context_expr)
                    if g:
                        note_edges({g}, node.lineno)
                        held.append(g)
                        pushed += 1
                    if item.optional_vars is not None:
                        visit(item.optional_vars)
                for stmt in node.body:
                    visit(stmt)
                for _ in range(pushed):
                    held.pop()
                allow_stack.pop()
                return
            if isinstance(node, ast.For):
                lv = self._listener_loop_var(node, env, scan)
                if lv:
                    listener_vars.add(lv)
                for child in ast.iter_child_nodes(node):
                    visit(child)
                if lv:
                    listener_vars.discard(lv)
                return
            if isinstance(node, ast.Call):
                check_call(node)
            if isinstance(node, ast.Attribute):
                if held:
                    note_edges(self._prop_summary(node, env, scan),
                               node.lineno)
                if not in_init:
                    base = self.infer(node.value, env, scan)
                    if isinstance(base, ClassInfo):
                        check_field_access(node, base, node.attr)
            if isinstance(node, ast.Name) and not in_init:
                g = scan.mod_guarded.get(node.id)
                if g is not None and isinstance(
                        node.ctx, (ast.Load, ast.Store, ast.Del)):
                    self._check_global_access(node, g, scan, held,
                                              parents, checked_writes,
                                              report)
            if isinstance(node, ast.Assign) and isinstance(
                    node.targets[0], ast.Name):
                got = self.infer(node.value, env, scan)
                if got is not None:
                    env[node.targets[0].id] = got
            for child in ast.iter_child_nodes(node):
                visit(child)

        visit(fn)
        for sub, sub_env in nested:
            self.check_function(cls, sub, scan, sub_env)

    def _check_global_access(self, node: ast.Name,
                             guard: Tuple[str, str], scan: Scan,
                             held: List[str], parents, checked,
                             report) -> None:
        lockvar, mode = guard
        need = scan.mod_locks.get(lockvar)
        if need is None or need in held:
            return
        is_write = self._is_write(node, parents, checked)
        if mode == "w" and not is_write:
            return
        verb = "written" if is_write else "read"
        report("guarded-field", node.lineno,
               f"module global '{node.id}' ({verb}) is guarded by lock "
               f"'{need}' which is not held here")

    @staticmethod
    def _is_write(node: ast.AST, parents: Dict[ast.AST, ast.AST],
                  checked: Set[int]) -> bool:
        ctx = getattr(node, "ctx", None)
        if isinstance(ctx, (ast.Store, ast.Del)):
            return True
        p = parents.get(node)
        if (isinstance(p, ast.Subscript) and p.value is node
                and isinstance(p.ctx, (ast.Store, ast.Del))):
            return True
        if isinstance(p, ast.Attribute) and p.value is node:
            gp = parents.get(p)
            if (isinstance(gp, ast.Call) and gp.func is p
                    and p.attr in _MUTATORS):
                return True
        return False

    def _listener_loop_var(self, node: ast.For, env,
                           scan: Scan) -> Optional[str]:
        if not isinstance(node.target, ast.Name):
            return None
        it = node.iter
        if (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id in ("list", "tuple") and it.args):
            it = it.args[0]
        if isinstance(it, ast.Attribute):
            base = self.infer(it.value, env, scan)
            if isinstance(base, ClassInfo) and self._is_listener_field(
                    base, it.attr):
                return node.target.id
        return None

    def _blocking_reason(self, node: ast.Call, target, env,
                         scan: Scan) -> Optional[str]:
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id == "open":
            return "open() file I/O"
        if isinstance(fn, ast.Attribute):
            base = self.infer(fn.value, env, scan)
            if isinstance(base, tuple) and base[0] == "module":
                mod = base[1]
                root = mod.split(".")[0]
                names = _BLOCKING_MODULE_CALLS.get(
                    mod, _BLOCKING_MODULE_CALLS.get(root, set()))
                if fn.attr in names:
                    return f"{mod}.{fn.attr}() blocking call"
        if target and target[0] == "method":
            owner, name = target[1], target[2]
            for c in self._base_chain(owner):
                kind = _BLOCKING_METHODS.get((c.name, name))
                if kind:
                    return f"{c.name}.{name}() {kind}"
        return None

    # -- drive everything -------------------------------------------------

    def run(self) -> List[Finding]:
        for scan in self.scans:
            for fname, fn in scan.funcs.items():
                self.check_function(None, fn, scan)
            for cls in scan.classes.values():
                for fn in cls.methods.values():
                    self.check_function(cls, fn, scan)
        self._check_lock_graph()
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return self.findings

    def _closure(self, edges: Set[Tuple[str, str]]) -> Set[Tuple[str, str]]:
        adj: Dict[str, Set[str]] = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)
        out: Set[Tuple[str, str]] = set()
        for start in adj:
            stack, seen = [start], set()
            while stack:
                cur = stack.pop()
                for nxt in adj.get(cur, ()):
                    if nxt not in seen:
                        seen.add(nxt)
                        stack.append(nxt)
            out.update((start, x) for x in seen)
        return out

    def _check_lock_graph(self) -> None:
        declared_closed = self._closure(self.declared)
        for (a, b), (path, line) in sorted(self.edges.items()):
            if (a, b) in declared_closed or (a, b) in self.edge_allowed:
                continue
            self.findings.append(Finding(
                "lock-order", path, line,
                f"undeclared nested acquisition: '{a}' -> '{b}' (declare "
                "it in annotations.LOCK_ORDER or a '# feedlint: order' "
                "comment if intended)"))
        # cycle detection over declared + observed
        graph: Dict[str, Set[str]] = {}
        for a, b in set(self.declared) | set(self.edges):
            graph.setdefault(a, set()).add(b)
        state: Dict[str, int] = {}
        cycle: List[str] = []

        def dfs(n: str, trail: List[str]) -> bool:
            state[n] = 1
            for m in sorted(graph.get(n, ())):
                if state.get(m, 0) == 1:
                    cycle.extend(trail[trail.index(n):] + [n, m]
                                 if n in trail else [n, m])
                    return True
                if state.get(m, 0) == 0 and dfs(m, trail + [m]):
                    return True
            state[n] = 2
            return False

        for n in sorted(graph):
            if state.get(n, 0) == 0 and dfs(n, [n]):
                self.findings.append(Finding(
                    "lock-order", "<lock-graph>", 0,
                    "cycle in the lock acquisition graph: "
                    + " -> ".join(cycle)))
                break


# -- file scanning --------------------------------------------------------

def scan_file(path: Path) -> Optional[Scan]:
    try:
        text = path.read_text()
        tree = ast.parse(text, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None
    comments, comment_only = _collect_comments(text)
    scan = Scan(path=str(path), tree=tree, comments=comments,
                comment_only=comment_only, dotted=_dotted_of(path))
    for comment in scan.comments.values():
        m = _RE_ORDER.search(comment)
        if m:
            scan.orders.append((m.group(1), m.group(2)))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                bound = alias.asname or alias.name.split(".")[0]
                scan.mod_imports[bound] = (alias.name if alias.asname
                                           else alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:  # relative import -> anchor at this package
                pkg = scan.dotted.rsplit(".", node.level)[0]
                mod = f"{pkg}.{mod}" if mod else pkg
            for alias in node.names:
                scan.from_imports[alias.asname or alias.name] = (
                    mod, alias.name)
    modbase = Path(path).stem
    for stmt in tree.body:
        if isinstance(stmt, ast.FunctionDef):
            scan.funcs[stmt.name] = stmt
        elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            value = stmt.value
            if value is None or len(targets) != 1 or not isinstance(
                    targets[0], ast.Name):
                continue
            name = targets[0].id
            comment = _decl_comment(scan, stmt.lineno)
            if _lock_ctor(value) == "lock":
                m = _RE_LOCK_NAME.search(comment)
                scan.mod_locks[name] = (
                    m.group(1) if m else f"{modbase}.{name}")
            wm = _RE_WRITE_GUARDED.search(comment)
            gm = _RE_GUARDED.search(comment)
            if wm:
                scan.mod_guarded[name] = (wm.group(1), "w")
            elif gm:
                scan.mod_guarded[name] = (gm.group(1), "rw")
        elif isinstance(stmt, ast.ClassDef):
            scan.classes[stmt.name] = _scan_class(stmt, scan, modbase)
    return scan


def _scan_class(node: ast.ClassDef, scan: Scan, modbase: str) -> ClassInfo:
    cls = ClassInfo(name=node.name, scan=scan, node=node,
                    bases=[b.id for b in node.bases
                           if isinstance(b, ast.Name)])
    for stmt in node.body:
        if isinstance(stmt, ast.FunctionDef):
            cls.methods[stmt.name] = stmt
            if any(isinstance(d, ast.Name) and d.id == "property"
                   for d in stmt.decorator_list):
                cls.props.add(stmt.name)
            comment = _decl_comment(scan, stmt.lineno)
            m = _RE_REQUIRES.search(comment)
            if m:
                cls.requires[stmt.name] = m.group(1)
            if _RE_FIRES.search(comment):
                cls.fires.add(stmt.name)
        elif isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name):
            guard = _annotated_guard(stmt.annotation)
            comment = _decl_comment(scan, stmt.lineno)
            wm = _RE_WRITE_GUARDED.search(comment)
            gm = _RE_GUARDED.search(comment)
            if guard:
                cls.guarded[stmt.target.id] = guard
            elif wm:
                cls.guarded[stmt.target.id] = (wm.group(1), "w")
            elif gm:
                cls.guarded[stmt.target.id] = (gm.group(1), "rw")
            if _RE_LISTENER_REG.search(comment):
                cls.listener_fields.add(stmt.target.id)
    for meth in cls.methods.values():
        _scan_self_assigns(cls, meth, scan, modbase)
    return cls


def _scan_self_assigns(cls: ClassInfo, meth: ast.FunctionDef, scan: Scan,
                       modbase: str) -> None:
    param_ann = {a.arg: _ann_name(a.annotation)
                 for a in (list(meth.args.posonlyargs) + list(meth.args.args)
                           + list(meth.args.kwonlyargs))}
    for node in ast.walk(meth):
        if isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Attribute) and isinstance(
                node.target.value, ast.Name) and \
                node.target.value.id == "self":
            t = _ann_name(node.annotation)
            if t:
                cls.attr_types.setdefault(node.target.attr, t)
            _note_field_decl(cls, node.target.attr,
                             _decl_comment(scan, node.lineno))
            continue
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)):
            continue
        recv = target.value.id
        attr = target.attr
        comment = _decl_comment(scan, node.lineno)
        if recv == "self":
            kind = _lock_ctor(node.value)
            if kind == "lock":
                m = _RE_LOCK_NAME.search(comment)
                cls.locks[attr] = (m.group(1) if m
                                   else f"{modbase}.{cls.name}.{attr}")
            elif kind == "condition":
                wrapped = _condition_target(node.value)
                if wrapped:
                    cls.aliases[attr] = wrapped
                else:
                    m = _RE_LOCK_NAME.search(comment)
                    cls.locks[attr] = (m.group(1) if m
                                       else f"{modbase}.{cls.name}.{attr}")
            _note_field_decl(cls, attr, comment)
            _note_attr_type(cls, attr, node.value, param_ann)
    # cross-object constructor assigns (``handle.intake = IntakeJob(...)``
    # through an annotated param) land on the receiver's class; same-file
    # classes resolve here, cross-file ones via _resolve_pending.
    for node in ast.walk(meth):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Attribute) and \
                isinstance(node.targets[0].value, ast.Name) and \
                node.targets[0].value.id != "self":
            recv = node.targets[0].value.id
            t = param_ann.get(recv)
            tv = _ctor_name(node.value)
            if t and tv:
                other = scan.classes.get(t)
                if other is not None:
                    other.attr_types.setdefault(node.targets[0].attr, tv)
                else:
                    cls.scan.__dict__.setdefault(
                        "_pending_attr", []).append(
                        (t, node.targets[0].attr, tv))


def _ctor_name(value: ast.AST) -> Optional[str]:
    if isinstance(value, ast.Call) and isinstance(value.func, ast.Name):
        return value.func.id
    return None


def _note_field_decl(cls: ClassInfo, attr: str, comment: str) -> None:
    wm = _RE_WRITE_GUARDED.search(comment)
    gm = _RE_GUARDED.search(comment)
    if wm:
        cls.guarded.setdefault(attr, (wm.group(1), "w"))
    elif gm:
        cls.guarded.setdefault(attr, (gm.group(1), "rw"))
    if _RE_LISTENER_REG.search(comment):
        cls.listener_fields.add(attr)


def _note_attr_type(cls: ClassInfo, attr: str, value: ast.AST,
                    param_ann: Dict[str, Optional[str]]) -> None:
    tv = _ctor_name(value)
    if tv:
        cls.attr_types.setdefault(attr, tv)
        return
    if isinstance(value, ast.Name):
        t = param_ann.get(value.id)
        if t:
            cls.attr_types.setdefault(attr, t)
        return
    if isinstance(value, ast.IfExp):
        for side in (value.body, value.orelse):
            _note_attr_type(cls, attr, side, param_ann)
    if isinstance(value, ast.BoolOp):
        for side in value.values:
            _note_attr_type(cls, attr, side, param_ann)


def _resolve_pending(scans: List[Scan]) -> None:
    by_name: Dict[str, ClassInfo] = {}
    for scan in scans:
        for cls in scan.classes.values():
            by_name.setdefault(cls.name, cls)
    for scan in scans:
        for t, attr, tv in scan.__dict__.get("_pending_attr", []):
            other = by_name.get(t)
            if other is not None:
                other.attr_types.setdefault(attr, tv)


def collect_files(paths: Sequence[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(f for f in path.rglob("*.py")
                              if "__pycache__" not in f.parts))
        elif path.suffix == ".py":
            out.append(path)
    return out


def run_paths(paths: Sequence[str],
              extra_order: Sequence[Tuple[str, str]] = ()
              ) -> List[Finding]:
    scans = [s for s in (scan_file(f) for f in collect_files(paths))
             if s is not None]
    _resolve_pending(scans)
    linter = Linter(scans, extra_order=extra_order)
    return linter.run()


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="feedlint",
        description="concurrency-invariant analyzer for the port's "
                    "ingestion core")
    parser.add_argument("paths", nargs="+", help="files or directories")
    parser.add_argument("--debug-graph", action="store_true",
                        help="print the observed lock acquisition edges")
    args = parser.parse_args(argv)
    scans = [s for s in (scan_file(f) for f in collect_files(args.paths))
             if s is not None]
    _resolve_pending(scans)
    linter = Linter(scans)
    findings = linter.run()
    if args.debug_graph:
        locks = sorted({g for s in scans for g in
                        list(s.mod_locks.values())
                        + [v for c in s.classes.values()
                           for v in c.locks.values()]})
        print(f"locks: {', '.join(locks)}")
        for (a, b), (path, line) in sorted(linter.edges.items()):
            print(f"edge: {a} -> {b}  ({path}:{line})")
    for f in findings:
        print(f)
    n = len(findings)
    print(f"feedlint: {n} finding{'s' if n != 1 else ''} "
          f"in {len(scans)} files")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
