"""The contract rules, as AST checkers.

A copy of ``repro/lint/rules.py``: the port imports nothing of ``repro``.

Each rule enforces one of the codebase's concurrency / determinism
contracts (see ROADMAP "Enforced contracts").  A rule is a pure
function ``check(mod: ModuleInfo) -> list[Finding]`` over one parsed
module; scoping (which files a rule applies to) lives in
:mod:`repro_torch.lint.engine`, so the checkers themselves stay testable on
fixture snippets.

All analysis is **intra-procedural** except R005's intra-module call
graph: a sleep hidden behind a helper called from inside a lock is out
of reach.  That is a deliberate trade — the contracts these rules guard
are *local idioms* (charge the thread you spawn, stamp from the model
clock, hold the lock you suffix for), and local analysis keeps every
finding explainable as "this line, this token".
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

# --------------------------------------------------------------------------
# findings + module context
# --------------------------------------------------------------------------


@dataclass
class Finding:
    """One rule violation at an exact source location."""

    rule: str
    file: str  # repo-relative posix path
    line: int
    message: str
    suppressed: bool = False
    reason: str = ""

    def to_dict(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "message": self.message, "suppressed": self.suppressed,
                "reason": self.reason}


@dataclass
class ModuleInfo:
    """One parsed module plus the import-alias maps the rules need."""

    rel: str  # repo-relative posix path
    tree: ast.Module
    source: str
    #: local names bound to the stdlib ``time`` module (incl. aliases
    #: and function-local ``import time as _time``)
    time_names: set = field(default_factory=set)
    #: local name -> ``time`` attr, from ``from time import monotonic``
    time_funcs: dict = field(default_factory=dict)
    #: local names bound to the stdlib ``random`` module
    random_names: set = field(default_factory=set)
    #: local name -> ``random`` attr, from ``from random import random``
    random_funcs: dict = field(default_factory=dict)
    #: local names bound to the ``datetime`` *module*
    datetime_mod_names: set = field(default_factory=set)
    #: local names bound to the ``datetime.datetime`` *class*
    datetime_cls_names: set = field(default_factory=set)

    @classmethod
    def parse(cls, rel: str, source: str) -> "ModuleInfo":
        mod = cls(rel=rel, tree=ast.parse(source), source=source)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.asname or alias.name
                    if alias.name == "time":
                        mod.time_names.add(name)
                    elif alias.name == "random":
                        mod.random_names.add(name)
                    elif alias.name == "datetime":
                        mod.datetime_mod_names.add(name)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                for alias in node.names:
                    name = alias.asname or alias.name
                    if node.module == "time":
                        mod.time_funcs[name] = alias.name
                    elif node.module == "random":
                        mod.random_funcs[name] = alias.name
                    elif node.module == "datetime" \
                            and alias.name == "datetime":
                        mod.datetime_cls_names.add(name)
        return mod


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


# --------------------------------------------------------------------------
# R001 — wall-clock ban
# --------------------------------------------------------------------------

#: ``time`` attrs that read or burn wall time
_TIME_BANNED = {"time", "monotonic", "sleep", "perf_counter",
                "time_ns", "monotonic_ns", "perf_counter_ns",
                "process_time", "process_time_ns"}
#: ``datetime`` / ``datetime.datetime`` attrs that read the wall clock
_DATETIME_BANNED = {"now", "utcnow", "today"}
#: ``random``-module attrs that are NOT the global-stream gamble:
#: explicit (seedable) generator constructors
_RANDOM_OK = {"Random", "SystemRandom"}


def check_r001(mod: ModuleInfo) -> list[Finding]:
    """Wall-clock ban: model time comes from the injected ``Clock``
    (``src/repro_torch/core/clock.py``), determinism from seeded RNGs.  Flags
    ``time.time/monotonic/sleep/...``, ``datetime.now`` (and friends),
    any stdlib ``random`` module-level draw (global RNG stream), and an
    unseeded ``random.Random()``.  ``jax.random`` (keyed) and seeded
    ``random.Random(seed)`` / ``numpy.default_rng(seed)`` instances are
    untouched.  Harness code that genuinely needs a *real* bound goes
    through the sanctioned ``clock.wall_now()`` / ``clock.wall_sleep()``
    helpers instead."""
    out = []

    def hit(node, what, why):
        out.append(Finding("R001", mod.rel, node.lineno,
                           f"wall clock: {what} — {why}"))

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            base, attr = fn.value.id, fn.attr
            if base in mod.time_names and attr in _TIME_BANNED:
                hit(node, f"{base}.{attr}()",
                    "use the injected model Clock (or clock.wall_now/"
                    "wall_sleep for sanctioned harness bounds)")
            elif base in mod.random_names and attr not in _RANDOM_OK:
                hit(node, f"{base}.{attr}()",
                    "global random stream is unseeded; draw from a "
                    "random.Random(seed) instance")
            elif base in mod.random_names and attr == "Random" \
                    and not node.args and not node.keywords:
                hit(node, f"{base}.Random()",
                    "unseeded Random() falls back to OS entropy; "
                    "pass a seed")
            elif (base in mod.datetime_mod_names
                  or base in mod.datetime_cls_names) \
                    and attr in _DATETIME_BANNED:
                hit(node, f"{base}.{attr}()",
                    "wall-clock date; stamp from the model clock")
        elif isinstance(fn, ast.Attribute):
            # datetime.datetime.now()
            chain = _dotted(fn)
            if chain is not None and fn.attr in _DATETIME_BANNED:
                head = chain.rsplit(".", 1)[0]
                parts = head.split(".")
                if parts[0] in mod.datetime_mod_names and \
                        parts[-1] == "datetime":
                    hit(node, f"{chain}()",
                        "wall-clock date; stamp from the model clock")
        elif isinstance(fn, ast.Name):
            if mod.time_funcs.get(fn.id) in _TIME_BANNED:
                hit(node, f"{fn.id}() [time.{mod.time_funcs[fn.id]}]",
                    "use the injected model Clock")
            elif fn.id in mod.random_funcs \
                    and mod.random_funcs[fn.id] not in _RANDOM_OK:
                hit(node, f"{fn.id}() [random.{mod.random_funcs[fn.id]}]",
                    "global random stream is unseeded")
    return out


# --------------------------------------------------------------------------
# R002 — charge-owner propagation across thread/pool boundaries
# --------------------------------------------------------------------------


def _func_scopes(tree: ast.Module):
    """Yield (scope_node, body_nodes) for the module and each function,
    where body_nodes excludes nested function bodies (each nested def is
    its own scope — charge binding is per spawning frame)."""
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
    for scope in scopes:
        own: list[ast.AST] = []
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            n = stack.pop()
            own.append(n)
            if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                stack.extend(ast.iter_child_nodes(n))
        yield scope, own


def _is_bind_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    return (isinstance(fn, ast.Name) and fn.id == "bind_charge_owner") or \
        (isinstance(fn, ast.Attribute) and fn.attr == "bind_charge_owner")


def check_r002(mod: ModuleInfo) -> list[Finding]:
    """Charge-owner propagation: in the transfer stack, every
    ``threading.Thread(target=...)`` and every ``<pool/executor>.submit
    (fn, ...)`` must hand the callee a ``bind_charge_owner``-wrapped
    callable, or ``Clock.charged(owner)`` silently loses the model time
    the spawned thread accrues (the fleet's per-task attribution — and
    the Advisor's refit observations — go quiet-wrong, not loud-wrong).
    Accepted: a direct ``bind_charge_owner(...)`` argument, or a name
    assigned from one in the same function scope."""
    out = []
    for scope, own in _func_scopes(mod.tree):
        bound = {t.id for n in own if isinstance(n, ast.Assign)
                 and _is_bind_call(n.value)
                 for t in n.targets if isinstance(t, ast.Name)}

        def ok(expr) -> bool:
            if expr is None:
                return False
            if _is_bind_call(expr):
                return True
            return isinstance(expr, ast.Name) and expr.id in bound

        for n in own:
            if not isinstance(n, ast.Call):
                continue
            fn = n.func
            name = _dotted(fn) or ""
            if name == "threading.Thread" or name == "Thread":
                target = next((kw.value for kw in n.keywords
                               if kw.arg == "target"), None)
                if target is None and n.args:
                    target = n.args[0]
                if not ok(target):
                    out.append(Finding(
                        "R002", mod.rel, n.lineno,
                        "Thread target not wrapped in bind_charge_owner "
                        "— spawned thread's model time is unattributed"))
            elif isinstance(fn, ast.Attribute) and fn.attr == "submit":
                recv = _dotted(fn.value) or ""
                leaf = recv.rsplit(".", 1)[-1].lower()
                if "pool" not in leaf and "executor" not in leaf:
                    continue  # task submission, not a worker pool
                work = n.args[0] if n.args else None
                if not ok(work):
                    out.append(Finding(
                        "R002", mod.rel, n.lineno,
                        f"{recv}.submit() callable not wrapped in "
                        "bind_charge_owner — pool thread's model time "
                        "is unattributed"))
    return out


# --------------------------------------------------------------------------
# R003 — *_locked discipline
# --------------------------------------------------------------------------

#: calls that burn model/wall time or touch storage — forbidden while
#: holding ``self._lock`` (a sleep under the queue lock stalls every
#: waiter; connector I/O under it inverts the control/data split)
_LOCKED_BODY_BANNED_ATTRS = {"sleep"}
_LOCKED_BODY_BANNED_IO = {"send", "recv", "send_batch", "recv_batch",
                          "listdir"}


def _with_acquires_self_lock(node: ast.With) -> bool:
    for item in node.items:
        name = _dotted(item.context_expr)
        if name in ("self._lock", "self._cv"):
            return True
    return False


def check_r003(mod: ModuleInfo) -> list[Finding]:
    """Lock discipline: a ``*_locked``-suffixed method encodes "caller
    holds ``self._lock``" in its name — so every call to one must sit
    inside a ``with self._lock:`` (or ``self._cv``) block, or inside a
    function itself suffixed ``_locked``.  Conversely, nothing slow may
    run *under* the lock: no ``*.sleep`` and no connector I/O
    (send/recv/batch/listdir) inside a ``with self._lock:`` body."""
    out = []

    funcs = [n for n in ast.walk(mod.tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in funcs:
        caller_locked = fn.name.endswith("_locked")
        # map every node in THIS function (not nested defs) to whether
        # a with-self._lock encloses it
        def visit(nodes, locked):
            for n in nodes:
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                    continue  # nested scope: its calls judged on its own
                inner = locked
                if isinstance(n, ast.With):
                    inner = locked or _with_acquires_self_lock(n)
                if isinstance(n, ast.Call):
                    name = _dotted(n.func) or ""
                    leaf = name.rsplit(".", 1)[-1]
                    if leaf.endswith("_locked") \
                            and not locked and not caller_locked:
                        out.append(Finding(
                            "R003", mod.rel, n.lineno,
                            f"{name}() called without holding "
                            "self._lock (callers of *_locked must hold "
                            "the lock or be *_locked themselves)"))
                    if locked and isinstance(n.func, ast.Attribute):
                        attr = n.func.attr
                        if attr in _LOCKED_BODY_BANNED_ATTRS:
                            out.append(Finding(
                                "R003", mod.rel, n.lineno,
                                f"{name}() inside `with self._lock:` — "
                                "sleeping under the lock stalls every "
                                "waiter"))
                        elif attr in _LOCKED_BODY_BANNED_IO:
                            out.append(Finding(
                                "R003", mod.rel, n.lineno,
                                f"{name}() inside `with self._lock:` — "
                                "connector I/O under the control-plane "
                                "lock"))
                visit(ast.iter_child_nodes(n), inner)

        visit(ast.iter_child_nodes(fn), False)
    return out


# --------------------------------------------------------------------------
# R004 — error taxonomy
# --------------------------------------------------------------------------


def check_r004(mod: ModuleInfo) -> list[Finding]:
    """Error taxonomy (``core/`` only): the health plane charges blame
    by error *type* and ``endpoint_id`` (see ``core/errors.py``), so a
    bare ``raise Exception`` is unroutable and a blind ``except
    Exception: pass`` (or bare ``except:``) eats the signal breakers
    and retry budgets feed on.  Raise/catch the taxonomy types."""
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Raise):
            exc = node.exc
            if isinstance(exc, ast.Call):
                exc = exc.func
            if isinstance(exc, ast.Name) and exc.id == "Exception":
                out.append(Finding(
                    "R004", mod.rel, node.lineno,
                    "bare `raise Exception` — raise a type from the "
                    "core/errors.py taxonomy so blame charging works"))
        elif isinstance(node, ast.ExceptHandler):
            blind = node.type is None or (
                isinstance(node.type, ast.Name)
                and node.type.id in ("Exception", "BaseException"))
            swallows = len(node.body) == 1 \
                and isinstance(node.body[0], ast.Pass)
            if blind and swallows:
                out.append(Finding(
                    "R004", mod.rel, node.lineno,
                    "blind `except Exception: pass` — swallows the "
                    "failure signal the health plane charges blame "
                    "from; catch the taxonomy type (or log + re-raise)"))
    return out


# --------------------------------------------------------------------------
# R005 — publish never blocks
# --------------------------------------------------------------------------

#: blocking primitives forbidden anywhere reachable from publish
_R005_BANNED = {"sleep", "wait", "wait_for", "join", "acquire", "result"}


def check_r005(mod: ModuleInfo) -> list[Finding]:
    """Publish-never-blocks: ``StatusBus.publish`` runs inside the
    manager lock at every queue mutation, so anything reachable from it
    must be O(1) ring work — no sleeps, no ``wait``/``wait_for``/
    ``join``/``acquire``/future-``result``.  (Context-managed bus and
    subscription locks guard constant-time sections and are allowed;
    a *blocking* primitive under them is exactly what this rule
    catches.)  Checked over the intra-module call graph rooted at any
    ``StatusBus.publish`` definition."""
    # collect class methods (reachable via `obj.X(...)`) and module
    # functions (reachable via `X(...)`) separately, so a builtin like
    # `next(iter)` never resolves to a method named ``next``
    methods: dict[str, list[ast.FunctionDef]] = {}
    functions: dict[str, list[ast.FunctionDef]] = {}
    roots: list[ast.FunctionDef] = []
    method_ids: set[int] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    methods.setdefault(item.name, []).append(item)
                    method_ids.add(id(item))
                    if node.name == "StatusBus" and item.name == "publish":
                        roots.append(item)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.FunctionDef) and id(node) not in method_ids:
            functions.setdefault(node.name, []).append(node)
    if not roots:
        return []
    # BFS over simple-name call edges
    seen: set[int] = set()
    frontier = list(roots)
    reachable: list[ast.FunctionDef] = []
    while frontier:
        fn = frontier.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        reachable.append(fn)
        for n in ast.walk(fn):
            if isinstance(n, ast.Call):
                if isinstance(n.func, ast.Attribute):
                    frontier.extend(methods.get(n.func.attr, []))
                    frontier.extend(functions.get(n.func.attr, []))
                elif isinstance(n.func, ast.Name):
                    frontier.extend(functions.get(n.func.id, []))
    out = []
    for fn in reachable:
        for n in ast.walk(fn):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in _R005_BANNED:
                out.append(Finding(
                    "R005", mod.rel, n.lineno,
                    f"`{_dotted(n.func) or n.func.attr}()` reachable "
                    f"from StatusBus.publish (via {fn.name}) — publish "
                    "must never block"))
    return out


# --------------------------------------------------------------------------
# R006 — span discipline
# --------------------------------------------------------------------------


def check_r006(mod: ModuleInfo) -> list[Finding]:
    """Span discipline: a ``*.span(...)`` call (``Tracer.span`` and any
    API shaped like it) may only appear as a ``with`` context
    expression.  A span opened and never exited stays the innermost
    span on its thread forever: every later ``Clock.sleep`` charge on
    that thread lands in the wrong category, silently corrupting the
    ``TaskStats.time_budget()`` decomposition — so the guard must be
    scope-shaped, never a bare call or a stored context manager."""
    with_exprs: set[int] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                with_exprs.add(id(item.context_expr))
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "span" \
                and id(node) not in with_exprs:
            out.append(Finding(
                "R006", mod.rel, node.lineno,
                f"`{_dotted(node.func) or '<expr>.span'}(...)` outside "
                "a `with` — Tracer.span is a context manager ONLY; a "
                "leaked open span miscategorizes every later charge on "
                "its thread"))
    return out


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

#: rule id -> (one-line title, checker)
RULES = {
    "R001": ("wall-clock ban (model Clock only)", check_r001),
    "R002": ("charge-owner propagation across threads/pools", check_r002),
    "R003": ("*_locked lock discipline", check_r003),
    "R004": ("core/ error taxonomy", check_r004),
    "R005": ("StatusBus.publish never blocks", check_r005),
    "R006": ("Tracer.span used as a `with` context manager", check_r006),
}
