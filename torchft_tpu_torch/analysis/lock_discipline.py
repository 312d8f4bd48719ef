"""Pass ``lock-discipline``: no blocking calls while a lock is held, and
no blocking lock acquisition inside signal handlers.

Why this is a *project* invariant and not a style preference: every lock
in this package sits on a path a failure can interrupt — the flight
recorder's signal-handler dump, the PG worker racing ``abort()``, the
metrics registry scraped mid-collective.  A blocking call under a lock
turns "one replica is slow" into "every thread that touches that lock is
wedged", which in a per-step FT protocol is indistinguishable from the
failure the protocol exists to survive.  The flight recorder's
non-blocking signal path (``blocking=False`` everywhere a handler runs)
is the founding example; this pass generalizes the rule.

What counts as *blocking* (deliberately conservative — the goal is zero
false positives on a disciplined tree, extended as new failure classes
appear):

- ``time.sleep``;
- process spawning: ``subprocess.run/call/check_call/check_output/Popen``;
- network ops: ``socket.create_connection``, ``urllib.request.urlopen``,
  ``post_otlp`` (the shared OTLP HTTP leg), ``connect_with_retry``, and
  socket-shaped method calls (``.connect``/``.accept``/``.sendall``);
- RPC round trips: ``.call(...)`` on a ``*client*``/``*rpc*`` receiver;
- collective/work waits: ``.wait(...)`` (except on a condition variable,
  whose ``wait`` *releases* the lock) and the collective submission
  entry points when invoked under a lock.

Lock-ish names: the final path segment ends in ``lock``/``mu``/
``mutex``/``cond`` (covers ``_lock``, ``send_lock``, ``_dump_lock``,
``_cond``, ``r_lock()/w_lock()`` context managers...).

Waivers: a ``# tft-lint: allow(lock-discipline)`` comment on the line
that takes the lock (the ``with`` or ``.acquire`` line) suppresses
findings inside that critical section — for locks whose *purpose* is to
serialize a blocking operation (e.g. the pooled-connection RPC lock,
where callers queueing on the round trip is the contract).
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Set, Tuple

from torchft_tpu_torch.analysis.core import (
    Finding,
    LintPass,
    Project,
    SelftestError,
    dotted,
)

PASS_ID = "lock-discipline"

_LOCKISH = re.compile(r"(?:^|_)(?:lock|mu|mutex|cond)$")
_CONDISH = re.compile(r"(?:^|_)(?:cond|cv|condition)$")

_BLOCKING_DOTTED_SUFFIX: "Tuple[str, ...]" = (
    "time.sleep",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "subprocess.Popen",
    "socket.create_connection",
    "urllib.request.urlopen",
    "urlopen",
    "post_otlp",
    "connect_with_retry",
)
_BLOCKING_METHODS: "Tuple[str, ...]" = ("connect", "accept", "sendall", "wait")
_RPC_METHODS: "Tuple[str, ...]" = ("call",)
_COLLECTIVE_METHODS: "Tuple[str, ...]" = (
    "allreduce",
    "allgather",
    "broadcast",
    "reduce_scatter",
    "alltoall",
)


def _seg(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _is_lockish(name: str) -> bool:
    return bool(name) and bool(_LOCKISH.search(_seg(name)))


def _is_condish(name: str) -> bool:
    return bool(name) and bool(_CONDISH.search(_seg(name)))


def _blocking_reason(call: ast.Call) -> "str | None":
    """Why this call is considered blocking, or None."""
    name = dotted(call.func)
    if not name:
        return None
    for suffix in _BLOCKING_DOTTED_SUFFIX:
        if name == suffix or name.endswith("." + suffix):
            return f"blocking call {suffix}"
    if isinstance(call.func, ast.Attribute):
        meth = call.func.attr
        recv = dotted(call.func.value)
        if meth in _BLOCKING_METHODS:
            # cond.wait() RELEASES the lock — the one legitimate wait
            if meth == "wait" and _is_condish(recv):
                return None
            # thread.join-ish waits on executors are out of scope; sockets
            # and Work handles are the targets
            return f"blocking method .{meth}() on {recv or 'object'}"
        if meth in _RPC_METHODS and re.search(r"client|rpc", recv, re.I):
            return f"RPC round trip .{meth}() on {recv}"
        if meth in _COLLECTIVE_METHODS and recv not in ("", "self"):
            return f"collective .{meth}() submitted under a lock"
    return None


def _has_waiver(project: Project, path: str, lineno: int) -> bool:
    # the pass name is part of the syntax: a waiver written for a
    # different pass (or prose containing "tft-lint: allow") must not
    # silently disable this one
    lines = project.source(path).splitlines()
    if 0 < lineno <= len(lines):
        return f"tft-lint: allow({PASS_ID})" in lines[lineno - 1]
    return False


class _FuncScanner:
    """Scans one function body with a running set of held lock names."""

    def __init__(self, project: Project, path: str, qual: str) -> None:
        self.project = project
        self.path = path
        self.qual = qual
        self.findings: "List[Finding]" = []

    def scan(self, body: "List[ast.stmt]", held: "Set[str]") -> "Set[str]":
        held = set(held)
        for stmt in body:
            held = self._scan_stmt(stmt, held)
        return held

    def _scan_stmt(self, stmt: ast.stmt, held: "Set[str]") -> "Set[str]":
        # nested defs execute later, in their own lock context
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            _ModuleScanner(self.project, self.path, self).visit(stmt)
            return held
        # lock.acquire(...) / lock.release() statements
        call = (
            stmt.value
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            else None
        )
        if call is not None and isinstance(call.func, ast.Attribute):
            recv = dotted(call.func.value)
            if _is_lockish(recv):
                if call.func.attr == "acquire":
                    if not _has_waiver(self.project, self.path, stmt.lineno):
                        held.add(recv)
                    return held
                if call.func.attr == "release":
                    held.discard(recv)
                    return held
        if isinstance(stmt, ast.With):
            lock_names: "Set[str]" = set()
            for item in stmt.items:
                name = dotted(item.context_expr)
                if _is_lockish(name):
                    if not _has_waiver(self.project, self.path, stmt.lineno):
                        lock_names.add(name)
            inner = self.scan(stmt.body, held | lock_names)
            # locks from this with are released at exit; explicit
            # acquire()s made inside survive it
            return (inner - lock_names) | (held & lock_names)
        # Compound statements: each alternative branch scans from the
        # INCOMING held set (feeding one branch's exit into its sibling
        # would flag `else: sleep()` after `if c: lock.acquire()`); exits
        # union conservatively so a conditional acquire stays visible.
        if held:
            for expr in self._stmt_exprs(stmt):
                self._check_expr(expr, held)
        if isinstance(stmt, ast.If):
            body_out = self.scan(stmt.body, held)
            else_out = self.scan(stmt.orelse, held) if stmt.orelse else held
            return body_out | else_out
        if isinstance(stmt, (ast.While, ast.For)):
            body_out = self.scan(stmt.body, held)
            out = held | body_out  # body may run zero times
            if stmt.orelse:
                out |= self.scan(stmt.orelse, out)
            return out
        if isinstance(stmt, ast.Try):
            body_out = self.scan(stmt.body, held)
            out = body_out
            for handler in stmt.handlers:
                # an exception may fire mid-body: handlers see anything
                # from "nothing new acquired" to the body's full exit set
                out |= self.scan(handler.body, held | body_out)
            if stmt.orelse:
                out |= self.scan(stmt.orelse, body_out)
            if stmt.finalbody:
                return self.scan(stmt.finalbody, held | out)
            return out
        if held:
            self._check_expr(stmt, held)
        return held

    @staticmethod
    def _stmt_exprs(stmt: ast.stmt) -> "List[ast.AST]":
        if isinstance(stmt, (ast.If, ast.While)):
            return [stmt.test]
        if isinstance(stmt, ast.For):
            return [stmt.iter]
        return []

    def _check_expr(self, node: ast.AST, held: "Set[str]") -> None:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue  # deferred execution
            if isinstance(sub, ast.Call):
                reason = _blocking_reason(sub)
                if reason:
                    self.findings.append(
                        Finding(
                            pass_id=PASS_ID,
                            code="blocking-under-lock",
                            file=self.project.rel(self.path),
                            line=sub.lineno,
                            symbol=self.qual,
                            message=(
                                f"{reason} while holding "
                                f"{sorted(held)} — move the blocking work "
                                f"outside the critical section"
                            ),
                        )
                    )


class _ModuleScanner(ast.NodeVisitor):
    """Walks a module, running a :class:`_FuncScanner` per function and
    collecting ``signal.signal`` handler registrations."""

    def __init__(
        self, project: Project, path: str, parent: "_FuncScanner | None" = None
    ) -> None:
        self.project = project
        self.path = path
        self.findings: "List[Finding]" = (
            parent.findings if parent is not None else []
        )
        self.handler_names: "Set[str]" = set()
        self._stack: "List[str]" = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:  # noqa: N802
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    def _visit_func(self, node: ast.AST) -> None:
        qual = ".".join(self._stack + [node.name])  # type: ignore[attr-defined]
        scanner = _FuncScanner(self.project, self.path, qual)
        scanner.scan(node.body, set())  # type: ignore[attr-defined]
        self.findings.extend(scanner.findings)
        # still recurse for nested handler registrations / defs' own defs
        self._stack.append(node.name)  # type: ignore[attr-defined]
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                self.visit(child)
            else:
                self._collect_signal_calls(child)
        self._stack.pop()

    visit_FunctionDef = _visit_func  # noqa: N815
    visit_AsyncFunctionDef = _visit_func  # noqa: N815

    def visit_Module(self, node: ast.Module) -> None:  # noqa: N802
        scanner = _FuncScanner(self.project, self.path, "<module>")
        scanner.scan(
            [
                s
                for s in node.body
                if not isinstance(
                    s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
                )
            ],
            set(),
        )
        self.findings.extend(scanner.findings)
        self.generic_visit(node)
        self._collect_signal_calls(node)

    def _collect_signal_calls(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if (
                isinstance(sub, ast.Call)
                and dotted(sub.func).endswith("signal.signal")
                and len(sub.args) >= 2
                and isinstance(sub.args[1], ast.Name)
            ):
                self.handler_names.add(sub.args[1].id)


def _check_signal_handlers(
    project: Project, path: str, tree: ast.Module, handler_names: "Set[str]"
) -> "Iterable[Finding]":
    """Inside a registered signal handler: no ``with <lock>`` and no
    ``.acquire`` without a timeout / ``blocking=False`` — the handler
    runs ON the interrupted thread, which may already hold that lock."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef) or node.name not in handler_names:
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.With):
                for item in sub.items:
                    name = dotted(item.context_expr)
                    if _is_lockish(name):
                        yield Finding(
                            pass_id=PASS_ID,
                            code="blocking-lock-in-signal-handler",
                            file=project.rel(path),
                            line=sub.lineno,
                            symbol=node.name,
                            message=(
                                f"signal handler takes {name} with a "
                                f"blocking `with` — the interrupted thread "
                                f"may hold it (use acquire(timeout=...) and "
                                f"degrade, like flightrecorder's dump "
                                f"blocking=False path)"
                            ),
                        )
            elif (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "acquire"
                and _is_lockish(dotted(sub.func.value))
            ):
                kw = {k.arg for k in sub.keywords}
                nonblocking = "timeout" in kw or any(
                    k.arg == "blocking"
                    and isinstance(k.value, ast.Constant)
                    and k.value.value is False
                    for k in sub.keywords
                ) or (
                    sub.args
                    and isinstance(sub.args[0], ast.Constant)
                    and sub.args[0].value is False
                )
                if not nonblocking:
                    yield Finding(
                        pass_id=PASS_ID,
                        code="blocking-lock-in-signal-handler",
                        file=project.rel(path),
                        line=sub.lineno,
                        symbol=node.name,
                        message=(
                            f"signal handler acquires "
                            f"{dotted(sub.func.value)} without a timeout — "
                            f"self-deadlocks when the interrupted thread "
                            f"holds it"
                        ),
                    )


def run(project: Project) -> "Iterable[Finding]":
    out: "List[Finding]" = []
    for path in project.py_files:
        tree = project.tree(path)
        if tree is None:
            continue
        scanner = _ModuleScanner(project, path)
        scanner.visit(tree)
        out.extend(scanner.findings)
        if scanner.handler_names:
            out.extend(
                _check_signal_handlers(project, path, tree, scanner.handler_names)
            )
    return out


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

_BAD = {
    "blocking-under-lock": """
import time, threading
_lock = threading.Lock()
def f():
    with _lock:
        time.sleep(1)
""",
    "blocking-under-lock-acquire": """
import time, threading
_mu = threading.Lock()
def f():
    _mu.acquire()
    try:
        time.sleep(1)
    finally:
        _mu.release()
""",
    "blocking-rpc": """
def f(self):
    with self._lock:
        self._client.call("quorum", {})
""",
    "blocking-lock-in-signal-handler": """
import signal, threading
_lock = threading.Lock()
def _handler(signum, frame):
    with _lock:
        pass
signal.signal(signal.SIGTERM, _handler)
""",
    # a waiver naming a DIFFERENT pass must not suppress this one
    "wrong-pass-waiver": """
def f(self):
    with self._lock:  # tft-lint: allow(env-hygiene)
        self._client.call("x", {})
""",
}

_GOOD = {
    "sleep-outside": """
import time, threading
_lock = threading.Lock()
def f():
    with _lock:
        x = 1
    time.sleep(x)
""",
    "cond-wait": """
import threading
_cond = threading.Condition()
def f():
    with _cond:
        _cond.wait(timeout=1)
""",
    "waiver": """
import threading
def f(self):
    with self._lock:  # tft-lint: allow(lock-discipline): pooled connection
        self._client.call("x", {})
""",
    "handler-timeout": """
import signal, threading
_lock = threading.Lock()
def _handler(signum, frame):
    if _lock.acquire(timeout=0.1):
        _lock.release()
signal.signal(signal.SIGTERM, _handler)
""",
    "deferred-closure": """
import time, threading
_lock = threading.Lock()
def f():
    with _lock:
        def later():
            time.sleep(1)
        cb = later
    cb()
""",
    "sibling-branch-not-poisoned": """
import time, threading
_lock = threading.Lock()
def f(cond):
    if cond:
        _lock.acquire()
    else:
        time.sleep(1)  # _lock is NOT held on this path
    if cond:
        _lock.release()
""",
    "handler-after-release": """
import time, threading
_lock = threading.Lock()
def f():
    _lock.acquire()
    try:
        pass
    finally:
        _lock.release()
    time.sleep(1)
""",
}


def _run_on_source(src: str) -> "List[Finding]":
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "snippet.py")
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(src)
        return list(run(Project(td, [path])))


def selftest() -> None:
    for name, src in _BAD.items():
        if not _run_on_source(src):
            raise SelftestError(f"{PASS_ID}: bad snippet {name!r} not flagged")
    for name, src in _GOOD.items():
        got = _run_on_source(src)
        if got:
            raise SelftestError(
                f"{PASS_ID}: good snippet {name!r} falsely flagged: "
                f"{[f.render() for f in got]}"
            )


PASS = LintPass(
    id=PASS_ID,
    doc="no blocking calls while holding a lock; no blocking lock "
    "acquisition inside signal handlers",
    run=run,
    selftest=selftest,
)
