"""The six hazard checkers, restated for the port (DESIGN.md §15).

The counterpart of the JAX package's ``analysis/checkers.py``. Each rule
keeps its name and the bug class it encodes; what it pattern-matches is
the port's idiom:

* HOSTSYNC: a host sync in a dispatch hot loop is ``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize`` or a
  stream's or event's ``.synchronize()``, or ``np.asarray``/``float()`` on
  a dispatch result; the hot roots are the reference's (the port has the
  same classes) and the drain boundaries the port's own;
* NARROW: int32 narrowing is also ``.to(torch.int32)``, ``.int()`` and a
  ``dtype=torch.int32`` conversion of an existing array;
* OBSGUARD: as in the reference;
* ARTIFACT: durable writes also through ``torch.save``;
* RECOMPILE: there is no jit; a kernel is one library per ``.cu`` built
  by ``nvcc`` and cached by its source and flags, so a kernel variant (a
  ``-D`` define or a template argument in ``kernels/*/kernel.py``) chosen
  from a value outside a bounded set of literals builds a new library for
  every value;
* PALLASCONST: registered and moot, the port has no Pallas.

The checkers are heuristic, as the reference's: false positives take an
inline ``# analysis: allow[RULE]`` waiver; residual debt lives in the
committed ``analysis_baseline_torch.json`` ratchet.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from repro_torch.analysis.model import Finding, Project, SourceFile
from repro_torch.analysis.registry import rule

__all__ = ["DRAIN_BOUNDARIES", "HOT_ROOTS"]

# --------------------------------------------------------------- helpers

STATIC_ATTRS = {"shape", "ndim", "dtype", "size"}
STATIC_FNS = {"len", "isinstance"}


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _stmt_of(node: ast.AST) -> ast.stmt:
    while not isinstance(node, ast.stmt):
        node = node.parent  # type: ignore[attr-defined]
    return node


def _func_of(node: ast.AST):
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = getattr(cur, "parent", None)
    return None


def _class_of(node: ast.AST):
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = getattr(cur, "parent", None)
    return None


def _is_static_use(name: ast.Name, root: ast.AST) -> bool:
    """True when ``name`` is only used via shape/dtype/len/isinstance —
    i.e. trace-time-static even for traced values."""
    cur: ast.AST = name
    while cur is not root:
        parent = cur.parent  # type: ignore[attr-defined]
        if isinstance(parent, ast.Attribute) and parent.attr in STATIC_ATTRS:
            return True
        if isinstance(parent, ast.Call) and cur is not parent.func:
            fn = _dotted(parent.func)
            if fn in STATIC_FNS:
                return True
        cur = parent
    return False


def _value_refs(root: ast.AST, names: set[str]) -> list[str]:
    """Names from ``names`` referenced at *value* position under ``root``."""
    hits: list[str] = []
    for n in ast.walk(root):
        if (
            isinstance(n, ast.Name)
            and n.id in names
            and not _is_static_use(n, root)
        ):
            hits.append(n.id)
    return hits


def _scoped(sf: SourceFile, fragments: tuple[str, ...]) -> bool:
    return any(f in sf.path for f in fragments)


# ------------------------------------------------------------- RECOMPILE

_HELP_RECOMPILE = """\
Kernel variants built from unbounded values. The port's kernels are one
library per `.cu` source, compiled by `nvcc` at first use and cached
under a name hashed from the source and the flags
(`kernels/_nvcc.py`). A variant chosen at build time (a `-D` define in
the flags, or a template argument in an entry point's name) is a new
library: when its value comes from anything but a bounded set of
literals (a parameter, a shape, a config field), every distinct value
compiles and loads another library, the jit recompile class of the
reference at `nvcc` cost (seconds to minutes each).

Flags, in `kernels/*/kernel.py`, an f-string or `+` concatenation that
builds a `-D` flag or a `<...>` template name from a value that is
neither a literal nor a loop variable over a literal tuple/list, nor a
name the function checks with `in (<literals>)`. Fix by dispatching on
the value at run time (a kernel argument) or by bounding it to a literal
set; waive when the set is proven bounded elsewhere. Today the port has
no build-time variant: every kernel takes its sizes as arguments."""

_KERNEL_SCOPE = ("kernels/",)
# A -D flag, or a template name: an identifier right before "<" (not "<=").
_VARIANT_TEXT = re.compile(r"(^|\s)-D\w*|[A-Za-z_]\w*<(?!=)")


def _literal_seq(node: ast.AST) -> bool:
    return isinstance(node, (ast.Tuple, ast.List, ast.Set)) and all(
        isinstance(e, ast.Constant) for e in node.elts)


def _bounded_names(fn) -> set[str]:
    """Names ``fn`` binds by a loop over literals or tests ``in`` literals."""
    out: set[str] = set()
    if fn is None:
        return out
    for n in ast.walk(fn):
        if isinstance(n, (ast.For, ast.comprehension)) and _literal_seq(n.iter):
            if isinstance(n.target, ast.Name):
                out.add(n.target.id)
        elif isinstance(n, ast.Compare) and isinstance(n.left, ast.Name):
            if any(isinstance(op, ast.In) for op in n.ops) and any(
                    _literal_seq(c) for c in n.comparators):
                out.add(n.left.id)
    return out


def _variant_values(node: ast.AST) -> list[ast.AST] | None:
    """The formatted values of a ``-D``/template string, or None."""
    if isinstance(node, ast.JoinedStr):
        text = "".join(v.value for v in node.values
                       if isinstance(v, ast.Constant) and isinstance(v.value, str))
        if _VARIANT_TEXT.search(text):
            return [v.value for v in node.values if isinstance(v, ast.FormattedValue)]
        return None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        parts, stack = [], [node]
        while stack:
            cur = stack.pop()
            if isinstance(cur, ast.BinOp) and isinstance(cur.op, ast.Add):
                stack += [cur.left, cur.right]
            else:
                parts.append(cur)
        text = "".join(p.value for p in parts
                       if isinstance(p, ast.Constant) and isinstance(p.value, str))
        if _VARIANT_TEXT.search(text):
            return [p for p in parts if not isinstance(p, ast.Constant)]
    return None


@rule("RECOMPILE", _HELP_RECOMPILE)
def check_recompile(project: Project) -> list[Finding]:
    out: list[Finding] = []
    for sf in project.files:
        if not _scoped(sf, _KERNEL_SCOPE):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(getattr(node, "parent", None), (ast.BinOp, ast.JoinedStr)):
                continue  # judged at the outermost expression
            values = _variant_values(node)
            if not values:
                continue
            bounded = _bounded_names(_func_of(node))
            bad = sorted({sf.segment(v) for v in values
                          if not isinstance(v, ast.Constant)
                          and not (isinstance(v, ast.Name) and v.id in bounded)})
            if bad:
                out.append(
                    Finding(
                        "RECOMPILE",
                        sf.path,
                        node.lineno,
                        sf.scope_of(node),
                        f"kernel variant built from unbounded value(s) {bad} — "
                        f"every distinct value compiles a new library; pass it "
                        f"to the kernel at run time or bound it to literals",
                        snippet=sf.segment(node),
                    )
                )
    return out


# -------------------------------------------------------------- HOSTSYNC

_HELP_HOSTSYNC = """\
Host-device synchronization reachable from a serving hot loop. The
in-flight and micro-batch servers overlap host planning with device
scoring (DESIGN.md §11); any `torch.cuda.synchronize()`, a stream's or
event's `.synchronize()`, `.item()`, `.cpu()`, `.tolist()`, `.numpy()`,
or `np.asarray`/`float()` on a dispatch result inside the dispatch path
stalls that overlap and serializes the quantum.

Detection: an intra-package call-graph walk from the hot roots
(InflightServer.step, MicroBatchServer.drain_once, BatchEngine.run_batch,
ShardedEngine.dispatch, ControlPlane.drain_once, ReplicaGroupEngine.dispatch,
...). The port's drain boundaries (_host, lane_result, _to_results) are
allowlisted: results must land on the host *somewhere*; the rule polices
where. Syncs inside `for`/`while` loops anywhere in the tree (e.g. a
training step loop) are also flagged. `.tolist()`/`.cpu()` on a host
numpy array or a CPU tensor match too (the rule sees no types): waive
them with the reason.

Fix by slicing/reducing on-device and deferring the host copy to the
drain boundary. Intentional syncs (profiler timing fences, step-boundary
metrics) get `# analysis: allow[HOSTSYNC]` so the baseline holds only
real debt."""

HOT_ROOTS = {
    ("InflightServer", "step"),
    ("MicroBatchServer", "drain_once"),
    ("BatchEngine", "run_batch"),
    ("ShardedBatchEngine", "run_batch"),
    ("ShardedEngine", "dispatch"),
    ("ControlPlane", "drain_once"),
    ("ReplicaGroupEngine", "dispatch"),
}

DRAIN_BOUNDARIES = {"_host", "lane_result", "_to_results"}

_SYNC_CALLS = {"torch.cuda.synchronize"}
_SYNC_ATTRS = {"item", "cpu", "tolist", "numpy", "synchronize"}
_MATERIALIZE = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_TAINT_SRC = re.compile(r"(traverse|dispatch|run_batch|resume|_fns\[)")


def _module_name(path: str) -> str:
    p = path.replace("\\", "/")
    if "src/" in p:
        p = p.split("src/", 1)[1]
    return p[:-3].replace("/", ".") if p.endswith(".py") else p


def _import_map(sf: SourceFile) -> dict[str, tuple[str, str]]:
    """local name -> (module, original name) for from-imports."""
    mod_parts = _module_name(sf.path).split(".")
    out: dict[str, tuple[str, str]] = {}
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ImportFrom):
            continue
        if node.level:
            base = mod_parts[: -node.level]
            target = ".".join(base + (node.module or "").split("."))
        else:
            target = node.module or ""
        for alias in node.names:
            out[alias.asname or alias.name] = (target, alias.name)
    return out


@dataclass
class _DefIndex:
    """Project-wide (module, class, function) -> def node index."""

    defs: dict[tuple[str, str | None, str], tuple[SourceFile, ast.AST]] = (
        field(default_factory=dict)
    )
    modules: dict[str, SourceFile] = field(default_factory=dict)
    imports: dict[str, dict[str, tuple[str, str]]] = field(
        default_factory=dict
    )


def _index_defs(project: Project) -> _DefIndex:
    ix = _DefIndex()
    for sf in project.files:
        mod = _module_name(sf.path)
        ix.modules[mod] = sf
        ix.imports[mod] = _import_map(sf)
        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ix.defs[(mod, None, node.name)] = (sf, node)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        ix.defs[(mod, node.name, sub.name)] = (sf, sub)
    return ix


def _edges(ix: _DefIndex, mod: str, cls: str | None, fnode) -> list[tuple]:
    """Resolvable callees: self-methods, module functions, from-imports."""
    out = []
    for call in ast.walk(fnode):
        if not isinstance(call, ast.Call):
            continue
        f = call.func
        if (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id == "self"
            and cls is not None
            and (mod, cls, f.attr) in ix.defs
        ):
            out.append((mod, cls, f.attr))
        elif isinstance(f, ast.Name):
            if (mod, None, f.id) in ix.defs:
                out.append((mod, None, f.id))
            else:
                imp = ix.imports.get(mod, {}).get(f.id)
                if imp and (imp[0], None, imp[1]) in ix.defs:
                    out.append((imp[0], None, imp[1]))
    return out


def _taint_sets(sf: SourceFile, fnode) -> tuple[set[str], set[str]]:
    """(tainted data names, tainted callable names) for one function.

    Data taint: locals assigned from dispatch-shaped calls (name matches
    traverse/dispatch/run_batch/resume or a compiled-fn table lookup like
    ``self._mesh_fns[key]``). Callable taint: locals *bound to* such a
    callable; calls through them taint their targets too. Comprehension
    targets iterating a tainted name inherit the taint."""
    data: set[str] = set()
    fns: set[str] = set()
    for _ in range(3):  # tiny fixpoint: assignments are not in SSA order
        for node in ast.walk(fnode):
            if isinstance(node, ast.Assign):
                targets = [
                    t.id for t in node.targets if isinstance(t, ast.Name)
                ]
                for t in node.targets:
                    if isinstance(t, ast.Tuple):
                        targets += [
                            e.id for e in t.elts if isinstance(e, ast.Name)
                        ]
                if not targets:
                    continue
                v = node.value
                if isinstance(v, ast.Call):
                    fsrc = sf.segment(v.func)
                    fname = _dotted(v.func)
                    if _TAINT_SRC.search(fsrc) or (fname in fns):
                        data.update(targets)
                else:
                    if _TAINT_SRC.search(sf.segment(v)):
                        fns.update(targets)
            elif isinstance(
                node, (ast.GeneratorExp, ast.ListComp, ast.SetComp)
            ):
                for gen in node.generators:
                    if isinstance(gen.iter, ast.Name) and gen.iter.id in data:
                        if isinstance(gen.target, ast.Name):
                            data.add(gen.target.id)
    return data, fns


def _in_loop(node: ast.AST) -> bool:
    cur = getattr(node, "parent", None)
    while cur is not None and not isinstance(
        cur, (ast.FunctionDef, ast.AsyncFunctionDef)
    ):
        if isinstance(cur, (ast.For, ast.While)):
            return True
        cur = getattr(cur, "parent", None)
    return False


def _sync_kind(call: ast.Call) -> str | None:
    name = _dotted(call.func)
    if name in _SYNC_CALLS:
        return name
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _SYNC_ATTRS:
        return f".{f.attr}()"
    return None


@rule("HOSTSYNC", _HELP_HOSTSYNC)
def check_hostsync(project: Project) -> list[Finding]:
    ix = _index_defs(project)
    # BFS the call graph from the hot roots.
    work = [
        (key, f"{key[1]}.{key[2]}")
        for key in ix.defs
        if (key[1], key[2]) in HOT_ROOTS
    ]
    seen = {key for key, _ in work}
    reachable: list[tuple[tuple, str]] = []
    while work:
        key, root = work.pop()
        reachable.append((key, root))
        sf, fnode = ix.defs[key]
        for nxt in _edges(ix, key[0], key[1], fnode):
            if nxt not in seen:
                seen.add(nxt)
                work.append((nxt, root))

    out: list[Finding] = []
    flagged: set[int] = set()
    for key, root in reachable:
        mod, cls, name = key
        if name in DRAIN_BOUNDARIES:
            continue
        sf, fnode = ix.defs[key]
        data, _fns = _taint_sets(sf, fnode)
        mat_seen: set[str] = set()
        for call in ast.walk(fnode):
            if not isinstance(call, ast.Call):
                continue
            kind = _sync_kind(call)
            if kind is not None:
                flagged.add(id(call))
                out.append(
                    Finding(
                        "HOSTSYNC",
                        sf.path,
                        call.lineno,
                        sf.scope_of(call),
                        f"`{kind}` in the dispatch hot path (reached from "
                        f"{root}) — stalls host/device overlap; move to a "
                        f"drain boundary or waive if timing-only",
                        snippet=sf.segment(call),
                    )
                )
                continue
            fname = _dotted(call.func)
            if fname in _MATERIALIZE or fname == "float":
                hit = next(
                    (
                        n.id
                        for a in call.args
                        for n in ast.walk(a)
                        if isinstance(n, ast.Name) and n.id in data
                    ),
                    None,
                )
                if hit is not None and hit not in mat_seen:
                    mat_seen.add(hit)  # one finding per materialized result
                    flagged.add(id(call))
                    out.append(
                        Finding(
                            "HOSTSYNC",
                            sf.path,
                            call.lineno,
                            sf.scope_of(call),
                            f"`{fname}` materializes dispatch result "
                            f"`{hit}` on the host (reached from {root}) — "
                            f"slice/reduce on-device, fetch at the drain "
                            f"boundary",
                            snippet=sf.segment(call),
                        )
                    )
    # Syncs inside explicit Python loops anywhere (training loops etc.).
    for sf in project.files:
        for call in ast.walk(sf.tree):
            if not isinstance(call, ast.Call) or id(call) in flagged:
                continue
            kind = _sync_kind(call)
            if kind is None or not _in_loop(call):
                continue
            fn = _func_of(call)
            if fn is not None and fn.name in DRAIN_BOUNDARIES:
                continue
            out.append(
                Finding(
                    "HOSTSYNC",
                    sf.path,
                    call.lineno,
                    sf.scope_of(call),
                    f"`{kind}` inside a Python loop — one device "
                    f"round-trip per iteration; batch the fetch or waive "
                    f"if the sync is the point (step timing)",
                    snippet=sf.segment(call),
                )
            )
    return out


# ---------------------------------------------------------------- NARROW

_HELP_NARROW = """\
Unguarded narrowing casts on bounds/docid/postings-shaped values. The
reference once shipped an int64 -> int32 BoundSum wrap that turned huge bounds negative
and silently disabled safe termination (`bound <= theta` held
everywhere). The repo idiom is `saturate_bounds` (serving/bucketing.py):
clip to INT32_MAX with a RuntimeWarning, raise on negative.

Flags `.astype(np.int32)` / `np.int32(x)`, and torch's `.to(torch.int32)`
/ `.int()` / `.type(torch.int32)` and `torch.as_tensor(x,
dtype=torch.int32)` (a conversion of an existing array, also
`torch.tensor`/`np.asarray`/`np.array` with an int32 dtype), where the
cast source or its assignment target/keyword mentions bound/docid/docs/
posting/budget/maxdoc and the statement carries no clip/minimum/
saturate/checked guard (`torch.clamp` too). `dtype=...int32` allocation kwargs (`zeros`,
`full`, `empty`) are never flagged: fresh buffers don't narrow anything.
Fix with a saturating or checked cast; waive when the value range is
structurally proven elsewhere."""

_NARROW_SCOPE = ("core/", "serving/", "index_io/", "control/")
_WATCH = ("bound", "docid", "doc_id", "docs", "posting", "budget", "maxdoc")
_GUARD = ("clip", "clamp", "minimum", "saturate", "checked", "iinfo")
_INT32 = {"np.int32", "numpy.int32", "jnp.int32", "torch.int32"}
_CONVERTERS = {"torch.as_tensor", "torch.tensor", "torch.asarray", "np.asarray",
               "np.array", "numpy.asarray", "numpy.array"}


def _is_int32(t: ast.AST) -> bool:
    return _dotted(t) in _INT32 or (isinstance(t, ast.Constant) and t.value == "int32")


def _narrow_cast_expr(call: ast.Call) -> ast.AST | None:
    """The narrowed expression, if ``call`` is an int32 cast."""
    f = call.func
    dtypes = [k.value for k in call.keywords if k.arg == "dtype"]
    if isinstance(f, ast.Attribute) and f.attr in ("astype", "to", "type"):
        if any(_is_int32(t) for t in [*call.args, *dtypes]):
            return f.value
        return None
    if isinstance(f, ast.Attribute) and f.attr == "int" and not call.args:
        return f.value
    name = _dotted(f)
    if name in _INT32 and len(call.args) == 1:
        a = call.args[0]
        return None if isinstance(a, ast.Constant) else a
    if name in _CONVERTERS and call.args and any(
            _is_int32(t) for t in [*call.args[1:2], *dtypes]):
        a = call.args[0]
        return None if isinstance(a, ast.Constant) else a
    return None


@rule("NARROW", _HELP_NARROW)
def check_narrow(project: Project) -> list[Finding]:
    out: list[Finding] = []
    for sf in project.files:
        if not _scoped(sf, _NARROW_SCOPE):
            continue
        for call in ast.walk(sf.tree):
            if not isinstance(call, ast.Call):
                continue
            expr = _narrow_cast_expr(call)
            if expr is None:
                continue
            names = sf.segment(expr).lower()
            cur: ast.AST = call
            while not isinstance(cur, ast.stmt):
                parent = cur.parent  # type: ignore[attr-defined]
                if isinstance(parent, ast.keyword) and parent.arg:
                    names += " " + parent.arg.lower()
                cur = parent
            stmt = cur
            if isinstance(stmt, ast.Assign):
                names += " " + " ".join(
                    sf.segment(t).lower() for t in stmt.targets
                )
            elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                names += " " + sf.segment(stmt.target).lower()
            if not any(w in names for w in _WATCH):
                continue
            guard_ctx = sf.segment(stmt).lower() + " " + sf.scope_of(
                call
            ).lower()
            if any(g in guard_ctx for g in _GUARD):
                continue
            out.append(
                Finding(
                    "NARROW",
                    sf.path,
                    call.lineno,
                    sf.scope_of(call),
                    "unguarded int32 narrowing on a bounds/docid-shaped "
                    "value — values past 2^31-1 wrap negative (the BoundSum "
                    "safe-termination bug); use a saturating or checked "
                    "cast",
                    snippet=sf.segment(call),
                )
            )
    return out


# -------------------------------------------------------------- OBSGUARD

_HELP_OBSGUARD = """\
Telemetry calls in serving/control hot paths not dominated by an
`if obs.enabled` (or `prof is not None`) guard. The telemetry's acceptance
bar is <5% instrumentation overhead with obs *enabled* and bitwise-
identical results with obs *disabled*; an unguarded `obs.observe`/
`trace_span` in a drain loop pays dict/format cost per query even when
telemetry is off (NOOP attribute dispatch is cheap, argument
construction is not).

A call counts as guarded when an ancestor `if`/ternary mentions
`.enabled` or `is not None`, or an earlier top-level statement in the
same function is an `if ... enabled`/`is None` early-return. Fix by
hoisting the guard (or giving the helper an early return); waive only
for cold paths that merely live in a serving module."""

_OBS_SCOPE = ("serving/", "control/")
_OBS_METHODS = {
    "count",
    "observe",
    "gauge",
    "trace_begin",
    "trace_span",
    "trace_attr",
    "trace_end",
    "record_dispatch",
    "record_hbm_once",
}
_OBS_RECEIVER = re.compile(r"(^|\.)(obs|prof|profiler|metrics|tracer)$")
_GUARD_TEST = ("enabled", "is not None", "is None")


def _guarded(sf: SourceFile, call: ast.Call) -> bool:
    cur = getattr(call, "parent", None)
    while cur is not None and not isinstance(
        cur, (ast.FunctionDef, ast.AsyncFunctionDef)
    ):
        if isinstance(cur, (ast.If, ast.IfExp)):
            test = sf.segment(cur.test)
            if any(g in test for g in _GUARD_TEST):
                return True
        cur = getattr(cur, "parent", None)
    fn = cur
    if fn is None:
        return False
    # Early-return guard: `if not obs.enabled: return` before this stmt.
    top: ast.AST = call
    while getattr(top, "parent", None) is not fn:
        top = top.parent  # type: ignore[attr-defined]
    for stmt in fn.body:
        if stmt is top:
            break
        if isinstance(stmt, ast.If):
            test = sf.segment(stmt.test)
            has_return = any(
                isinstance(s, ast.Return) for s in ast.walk(stmt)
            )
            if has_return and any(g in test for g in _GUARD_TEST):
                return True
    return False


@rule("OBSGUARD", _HELP_OBSGUARD)
def check_obsguard(project: Project) -> list[Finding]:
    out: list[Finding] = []
    for sf in project.files:
        if not _scoped(sf, _OBS_SCOPE):
            continue
        for call in ast.walk(sf.tree):
            if not isinstance(call, ast.Call):
                continue
            f = call.func
            if not (
                isinstance(f, ast.Attribute) and f.attr in _OBS_METHODS
            ):
                continue
            receiver = _dotted(f.value)
            if receiver is None or not _OBS_RECEIVER.search(receiver):
                continue
            if _guarded(sf, call):
                continue
            out.append(
                Finding(
                    "OBSGUARD",
                    sf.path,
                    call.lineno,
                    sf.scope_of(call),
                    f"`{receiver}.{f.attr}(...)` not dominated by an "
                    f"`if obs.enabled` guard — pays instrumentation cost "
                    f"per call even with telemetry off; hoist the guard "
                    f"or add an early return",
                    snippet=sf.segment(call),
                )
            )
    return out


# -------------------------------------------------------------- ARTIFACT

_HELP_ARTIFACT = """\
Durable writes without the staged-tmp + rename-aside idiom. The repo's
publish discipline (index_io/artifact.py, control/journal.py,
obs/trace.py): build under a unique `*.tmp-*` staging dir, `os.replace`
into place so readers never observe a half-written artifact; append-mode
journals fsync per record so a replay never sees a torn tail.

Flags `open(path, "w"/"a")` / `np.save*` / `torch.save` in
artifact-producing modules
when the enclosing function (or class) neither replaces/renames nor
fsyncs, and the path is not itself a tmp-stage. Fix by writing to
`path + ".tmp"` and `os.replace`-ing; waive for genuinely ephemeral
output (debug dumps, stdout mirrors)."""

_ART_SCOPE = (
    "index_io/",
    "control/",
    "obs/",
    "launch/",
    "train/",
    "serving/",
)
_NP_WRITERS = {
    "np.save",
    "np.savez",
    "np.savez_compressed",
    "np.savetxt",
    "numpy.save",
    "numpy.savez",
    "torch.save",
}


def _write_mode(call: ast.Call) -> str | None:
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    if isinstance(mode, str) and any(c in mode for c in "wax"):
        return mode
    return None


@rule("ARTIFACT", _HELP_ARTIFACT)
def check_artifact(project: Project) -> list[Finding]:
    out: list[Finding] = []
    for sf in project.files:
        if not _scoped(sf, _ART_SCOPE):
            continue
        for call in ast.walk(sf.tree):
            if not isinstance(call, ast.Call):
                continue
            name = _dotted(call.func)
            if name == "open":
                mode = _write_mode(call)
                if mode is None:
                    continue
            elif name in _NP_WRITERS:
                mode = "w"
            else:
                continue
            if not call.args:
                continue
            target = call.args[1] if name == "torch.save" and len(call.args) > 1 else (
                call.args[0])
            path_src = sf.segment(target).lower()
            if "tmp" in path_src or "devnull" in path_src:
                continue  # this *is* the staged write
            fn = _func_of(call)
            ctx = sf.segment(fn) if fn is not None else ""
            cls = _class_of(call)
            cls_src = sf.segment(cls) if cls is not None else sf.text
            if "os.replace" in ctx or "os.rename" in ctx:
                continue
            if "fsync" in ctx or ("a" in mode and "fsync" in cls_src):
                continue
            out.append(
                Finding(
                    "ARTIFACT",
                    sf.path,
                    call.lineno,
                    sf.scope_of(call),
                    f"durable write ({name}, mode={mode!r}) without "
                    f"staged-tmp + os.replace (or fsync for journals) — "
                    f"a crash mid-write publishes a torn file; stage to "
                    f"`*.tmp` and rename into place",
                    snippet=sf.segment(call),
                )
            )
    return out


# ----------------------------------------------------------- PALLASCONST

_HELP_PALLASCONST = """\
Moot in the port, registered so that `explain` covers the reference's six
names. In the reference it flags Python control flow on Pallas tracer
values and `pallas_call` grids/BlockSpecs built from non-static
parameters. The port has no Pallas: its kernels are CUDA C++ whose grids
are computed in C++ from the sizes each launch passes, and plain PyTorch
runs eagerly, so a Python branch on a tensor is a host sync (HOSTSYNC's
business), never a trace hazard. It finds nothing."""


@rule("PALLASCONST", _HELP_PALLASCONST)
def check_pallasconst(project: Project) -> list[Finding]:
    del project
    return []
