"""Pass ``span-vocab``: trace spans stay joinable and post-mortem-visible.

The distributed-tracing layer (utils/tracing.py) is only useful if the
spans the fleet emits share ONE name vocabulary — the diagnose ledger
(``torchft-diagnose --trace``) maps span names to cost categories, and a
free-form name silently falls out of every report.  Two rules:

**Vocabulary.**  Every ``export_span`` call site must name its span from
``manager.PROTOCOL_PHASES`` (parsed from the tree, the same canonical
tuple the flight recorder and the quorum-duration histogram label from),
the ``quorum_round`` root, or the documented prefix families ``quant.*``
(quantized-collective pipeline), ``heal.*`` (checkpoint heal endpoints),
``rpc.*`` (native server spans), and ``serving.*`` (weight-serving tier
publish/fetch/tree-commit) — docs/observability.md "Distributed
tracing".  One level of indirection is resolved: when the name argument
is a parameter of the enclosing function (e.g. ``Manager._record_phase``),
the SAME-MODULE callers' literal arguments are checked instead.

**Flight reach.**  Every traced phase must also reach the flight
recorder: a function that emits a span must reference the recorder
within two same-module call hops (the exact rule fault-coverage applies
to the PG worker and the checkpoint transports) — a trace backend must
never know something the crash-durable post-mortem dump doesn't.

``utils/tracing.py`` itself (the emit implementation) is exempt, as are
test files.  Waiver: ``# tft-lint: allow(span-vocab)`` on the line.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from torchft_tpu_torch.analysis.core import (
    Finding,
    LintPass,
    Project,
    QualnameVisitor,
    SelftestError,
    const_str,
    dotted,
)
from torchft_tpu_torch.analysis.coverage import _module_flight_reach

PASS_ID = "span-vocab"

_MANAGER_FILE = "manager.py"

#: documented span-name prefix families (docs/observability.md)
SPAN_FAMILIES = ("quant.", "heal.", "rpc.", "serving.", "link.",
                 "fragment.")

#: allowed exact names beyond PROTOCOL_PHASES
EXTRA_SPAN_NAMES = ("quorum_round",)

#: files whose span plumbing is the implementation, not a call site
_EXEMPT_SUFFIXES = ("utils/tracing.py",)


def _protocol_phases(project: Project) -> "Optional[Set[str]]":
    """Parse ``PROTOCOL_PHASES`` from the tree's manager.py (None when
    absent — the vocabulary rule then only enforces the families)."""
    path = project.find_file(_MANAGER_FILE)
    if path is None:
        return None
    tree = project.tree(path)
    if tree is None:
        return None
    for node in tree.body:
        value: "Optional[ast.AST]" = None
        if (
            isinstance(node, ast.AnnAssign)
            and isinstance(node.target, ast.Name)
            and node.target.id == "PROTOCOL_PHASES"
        ):
            value = node.value
        elif (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "PROTOCOL_PHASES"
        ):
            value = node.value
        if isinstance(value, (ast.Tuple, ast.List)):
            names = {const_str(e) for e in value.elts}
            return {n for n in names if n is not None}
    return None


def _allowed(name: str, phases: "Optional[Set[str]]") -> bool:
    if phases is not None and name in phases:
        return True
    if name in EXTRA_SPAN_NAMES:
        return True
    return any(
        name.startswith(fam) and len(name) > len(fam) for fam in SPAN_FAMILIES
    )


def _has_waiver(project: Project, path: str, lineno: int) -> bool:
    lines = project.source(path).splitlines()
    if 1 <= lineno <= len(lines):
        return f"tft-lint: allow({PASS_ID})" in lines[lineno - 1]
    return False


def _span_name_arg(node: ast.Call) -> "Optional[ast.AST]":
    for kw in node.keywords:
        if kw.arg == "name":
            return kw.value
    if node.args:
        return node.args[0]
    return None


class _EmitCollector(QualnameVisitor):
    """Collects ``*.export_span(...)`` sites and, per enclosing function,
    the name-parameter indirections plus all same-module calls."""

    def __init__(self) -> None:
        super().__init__()
        # (lineno, qualname, name_node, enclosing_fn, enclosing_params)
        self.emits: "List[Tuple[int, str, Optional[ast.AST], str, Set[str]]]" = []
        # function name -> [(call node, lineno)]
        self.calls: "Dict[str, List[ast.Call]]" = {}
        self._fn_stack: "List[Tuple[str, Set[str]]]" = []

    def _visit_func(self, node: ast.AST) -> None:  # type: ignore[override]
        params = {
            a.arg
            for a in list(node.args.args) + list(node.args.kwonlyargs)  # type: ignore[attr-defined]
        }
        self._fn_stack.append((node.name, params))  # type: ignore[attr-defined]
        self._stack.append(node.name)  # type: ignore[attr-defined]
        self.generic_visit(node)
        self._stack.pop()
        self._fn_stack.pop()

    visit_FunctionDef = _visit_func  # noqa: N815
    visit_AsyncFunctionDef = _visit_func  # noqa: N815

    def visit_Call(self, node: ast.Call) -> None:  # noqa: N802
        leaf = dotted(node.func).rsplit(".", 1)[-1]
        if leaf == "export_span":
            fn, params = self._fn_stack[-1] if self._fn_stack else ("", set())
            self.emits.append(
                (node.lineno, self.qualname, _span_name_arg(node), fn, params)
            )
        else:
            self.calls.setdefault(leaf, []).append(node)
        self.generic_visit(node)


def run(project: Project) -> "Iterable[Finding]":
    out: "List[Finding]" = []
    phases = _protocol_phases(project)

    for path in project.py_files:
        rel = project.rel(path).replace("\\", "/")
        if any(rel.endswith(s) for s in _EXEMPT_SUFFIXES):
            continue
        if "/tests/" in rel or rel.startswith("tests/"):
            continue
        tree = project.tree(path)
        if tree is None:
            continue
        col = _EmitCollector()
        col.visit(tree)
        if not col.emits:
            continue
        reach = _module_flight_reach(tree)

        def flag(lineno: int, code: str, symbol: str, message: str) -> None:
            if _has_waiver(project, path, lineno):
                return
            out.append(
                Finding(
                    pass_id=PASS_ID,
                    code=code,
                    file=project.rel(path),
                    line=lineno,
                    symbol=symbol,
                    message=message,
                )
            )

        emitting_fns: "Set[str]" = set()
        for lineno, qual, name_node, fn, params in col.emits:
            if fn:
                emitting_fns.add(fn)
            name = const_str(name_node)
            if name is not None:
                if not _allowed(name, phases):
                    flag(
                        lineno,
                        "unknown-span-name",
                        name,
                        f"span name {name!r} is not in manager."
                        f"PROTOCOL_PHASES, {EXTRA_SPAN_NAMES}, or the "
                        f"documented {'/'.join(SPAN_FAMILIES)}* families — "
                        f"the diagnose ledger cannot categorize it",
                    )
                continue
            # one level of indirection: name comes from the enclosing
            # function's parameter -> validate same-module callers
            if (
                isinstance(name_node, ast.Name)
                and name_node.id in params
                and fn
            ):
                # callers pass the phase name as the first argument by
                # convention; keyword form is also resolved
                for call in col.calls.get(fn, []):
                    cand: "Optional[ast.AST]" = None
                    for kw in call.keywords:
                        if kw.arg == name_node.id:
                            cand = kw.value
                    if cand is None and call.args:
                        cand = call.args[0]
                    lit = const_str(cand)
                    if lit is None:
                        flag(
                            call.lineno,
                            "non-literal-span-name",
                            fn,
                            f"call to span-emitting {fn}() passes a "
                            f"non-literal span name — the vocabulary "
                            f"cannot be checked statically",
                        )
                    elif not _allowed(lit, phases):
                        flag(
                            call.lineno,
                            "unknown-span-name",
                            lit,
                            f"span name {lit!r} (via {fn}()) is not in "
                            f"manager.PROTOCOL_PHASES, {EXTRA_SPAN_NAMES}, "
                            f"or the documented "
                            f"{'/'.join(SPAN_FAMILIES)}* families",
                        )
                continue
            flag(
                lineno,
                "non-literal-span-name",
                qual,
                "export_span name is neither a literal nor a parameter of "
                "the enclosing function — the vocabulary cannot be checked "
                "statically",
            )

        # flight reach: every span-emitting function must reach the
        # flight recorder within two same-module hops
        for fn in sorted(emitting_fns):
            if fn not in reach:
                lineno = next(
                    (ln for ln, _, _, f, _ in col.emits if f == fn), 1
                )
                flag(
                    lineno,
                    "span-without-flight",
                    fn,
                    f"{fn} emits trace spans but never reaches the flight "
                    f"recorder (no record/start/track reference within two "
                    f"same-module call hops) — a traced phase must stay "
                    f"visible in crash-durable post-mortem dumps too",
                )
    return out


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------


def _run_on_project(files: "Dict[str, str]") -> "List[Finding]":
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tftlint_selftest_") as td:
        os.makedirs(os.path.join(td, "docs"))
        with open(os.path.join(td, "docs", "x.md"), "w", encoding="utf-8") as fh:
            fh.write("")
        paths = []
        for rel, src in files.items():
            path = os.path.join(td, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(src)
            paths.append(path)
        return list(run(Project(td, paths)))


_MANAGER_SRC = 'PROTOCOL_PHASES = ("quorum_rpc", "ring", "commit")\n'

_GOOD_SRC = """
from torchft_tpu_torch.utils import flightrecorder as _flightrec
from torchft_tpu_torch.utils import tracing

def _record_phase(name, dt):
    _flightrec.record(name, kind="phase")
    tracer = tracing.get_tracer()
    if tracer is not None:
        tracer.export_span(name=name, trace_id="t", start_ns=0, end_ns=1)

def step(tracer):
    _record_phase("ring", 0.1)
    _flightrec.record("quant.pipeline")
    tracer.export_span("quant.pipeline", "t", 0, 1)
    tracer.export_span("heal.send", "t", 0, 1)
    tracer.export_span("link.digest", "t", 0, 1)
    tracer.export_span("fragment.hop", "t", 0, 1)
    tracer.export_span("quorum_round", "t", 0, 1)
"""

_BAD_VOCAB_SRC = """
from torchft_tpu_torch.utils import flightrecorder as _flightrec

def emit(tracer):
    _flightrec.record("x")
    tracer.export_span("made_up_phase", "t", 0, 1)
"""

_BAD_INDIRECT_SRC = """
from torchft_tpu_torch.utils import flightrecorder as _flightrec

def _phase(name, tracer):
    _flightrec.record(name)
    tracer.export_span(name=name, trace_id="t", start_ns=0, end_ns=1)

def step(tracer):
    _phase("bogus_phase", tracer)
"""

_BAD_FLIGHT_SRC = """
def emit(tracer):
    tracer.export_span("ring", "t", 0, 1)  # no flight recorder anywhere
"""


def selftest() -> None:
    base = {"pkg/manager.py": _MANAGER_SRC}
    good = _run_on_project({**base, "pkg/good.py": _GOOD_SRC})
    if good:
        raise SelftestError(
            f"{PASS_ID}: clean project falsely flagged: "
            f"{[f.render() for f in good]}"
        )
    cases = {
        "unknown-span-name": {"pkg/bad.py": _BAD_VOCAB_SRC},
        "span-without-flight": {"pkg/bad.py": _BAD_FLIGHT_SRC},
    }
    for code, files in cases.items():
        got = {f.code for f in _run_on_project({**base, **files})}
        if code not in got:
            raise SelftestError(
                f"{PASS_ID}: seeded {code} not caught (got {sorted(got)})"
            )
    got = {f.code for f in _run_on_project({**base, "pkg/bad.py": _BAD_INDIRECT_SRC})}
    if "unknown-span-name" not in got:
        raise SelftestError(
            f"{PASS_ID}: indirect (parameter) span name not resolved to "
            f"its literal caller (got {sorted(got)})"
        )


PASS = LintPass(
    id=PASS_ID,
    doc="trace-span names come from PROTOCOL_PHASES / quant.* / heal.* / "
    "rpc.* / serving.* / link.* / fragment.*; every span-emitting "
    "function also feeds the flight recorder",
    run=run,
    selftest=selftest,
)
