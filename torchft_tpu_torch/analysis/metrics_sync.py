"""Pass ``metrics-sync``: the exported-metrics surface and the
structured-event kinds stay coherent with their registries and docs.

The telemetry layer's contract is "one source of truth": every
instrument is defined in ``utils/metrics.py``'s bottom section and
mirrored in docs/observability.md's table; every event ``kind`` exists
in BOTH ``_LOGGERS`` (utils/logging.py — ``log_event`` rejects unknown
kinds) and ``_SEVERITY`` (utils/otel.py — an unmapped kind silently
exports as INFO, burying errors).  Those invariants only held because
code review remembered them; this pass remembers instead:

- ``non-torchft-metric``: a ``counter()``/``gauge()``/``histogram()``
  (or class-constructor) registration whose name doesn't start with
  ``torchft_`` — the namespace contract with dashboards/alerts;
- ``duplicate-metric``: the same name registered from more than one
  call site (get-or-create makes this *run*, but two definitions drift);
- ``undocumented-metric``: a registered name missing from
  docs/observability.md (the native lighthouse metrics are documented
  there too, but originate in C++ and are out of this pass's scope);
- ``kind-maps-diverged``: ``_LOGGERS`` and ``_SEVERITY`` key sets
  differ;
- ``unknown-event-kind``: a ``log_event("<kind>", ...)`` literal not in
  ``_LOGGERS`` — it would raise ``ValueError`` at runtime, on the
  failure path where it hurts most.
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

PASS_ID = "metrics-sync"

_FACTORIES = ("counter", "gauge", "histogram", "Counter", "Gauge", "Histogram")
_OBSERVABILITY_DOC = "docs/observability.md"
_LOGGING_FILE = "utils/logging.py"
_OTEL_FILE = "utils/otel.py"

# Registrations inside these test/selftest helpers are exempt from the
# namespace + docs rules (they create fixture registries on purpose).
_EXEMPT_NAME_PREFIXES = ("test_", "_selftest")


class _MetricCollector(QualnameVisitor):
    def __init__(self, project: Project, path: str) -> None:
        super().__init__()
        self.project = project
        self.path = path
        self.registrations: "List[Tuple[str, int, str]]" = []  # (name, line, qual)

    def visit_Call(self, node: ast.Call) -> None:  # noqa: N802
        func = dotted(node.func).rsplit(".", 1)[-1]
        if func in _FACTORIES and node.args:
            name = const_str(node.args[0])
            if name is not None and not any(
                part.startswith(_EXEMPT_NAME_PREFIXES)
                for part in self.qualname.split(".")
            ):
                self.registrations.append((name, node.lineno, self.qualname))
        self.generic_visit(node)


def _dict_keys(tree: ast.Module, var_name: str) -> "Optional[Set[str]]":
    """String keys of a module-level ``VAR = {...}`` dict, or None."""
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == var_name
            and isinstance(node.value, ast.Dict)
        ):
            keys: "Set[str]" = set()
            for k in node.value.keys:
                val = const_str(k)
                if val is not None:
                    keys.add(val)
            return keys
    return None


def run(project: Project) -> "Iterable[Finding]":
    out: "List[Finding]" = []
    doc = project.doc_text_for(_OBSERVABILITY_DOC)

    # --- metric registrations ------------------------------------------
    by_name: "Dict[str, List[Tuple[str, int, str]]]" = {}
    for path in project.py_files:
        tree = project.tree(path)
        if tree is None:
            continue
        col = _MetricCollector(project, path)
        col.visit(tree)
        for name, line, qual in col.registrations:
            by_name.setdefault(name, []).append((path, line, qual))

    for name, sites in sorted(by_name.items()):
        path, line, qual = sites[0]
        rel = project.rel(path)
        if not name.startswith("torchft_"):
            out.append(
                Finding(
                    pass_id=PASS_ID,
                    code="non-torchft-metric",
                    file=rel,
                    line=line,
                    symbol=name,
                    message=(
                        f"metric {name!r} breaks the torchft_* namespace "
                        f"contract with dashboards and alert rules"
                    ),
                )
            )
        if len(sites) > 1:
            others = ", ".join(
                f"{project.rel(p)}:{ln}" for p, ln, _ in sites[1:]
            )
            out.append(
                Finding(
                    pass_id=PASS_ID,
                    code="duplicate-metric",
                    file=rel,
                    line=line,
                    symbol=name,
                    message=(
                        f"metric {name!r} registered from {len(sites)} call "
                        f"sites (also {others}) — define once in "
                        f"utils/metrics.py and import"
                    ),
                )
            )
        if doc and name.startswith("torchft_") and name not in doc:
            out.append(
                Finding(
                    pass_id=PASS_ID,
                    code="undocumented-metric",
                    file=rel,
                    line=line,
                    symbol=name,
                    message=(
                        f"metric {name!r} is missing from the "
                        f"{_OBSERVABILITY_DOC} table"
                    ),
                )
            )

    # --- event-kind maps ------------------------------------------------
    loggers_keys: "Optional[Set[str]]" = None
    logging_path = project.find_file(_LOGGING_FILE)
    otel_path = project.find_file(_OTEL_FILE)
    if logging_path is not None and otel_path is not None:
        ltree, otree = project.tree(logging_path), project.tree(otel_path)
        if ltree is not None and otree is not None:
            loggers_keys = _dict_keys(ltree, "_LOGGERS")
            severity_keys = _dict_keys(otree, "_SEVERITY")
            if loggers_keys is not None and severity_keys is not None:
                for missing in sorted(loggers_keys - severity_keys):
                    out.append(
                        Finding(
                            pass_id=PASS_ID,
                            code="kind-maps-diverged",
                            file=project.rel(otel_path),
                            line=1,
                            symbol=missing,
                            message=(
                                f"event kind {missing!r} is in _LOGGERS but "
                                f"not _SEVERITY — it would export at INFO, "
                                f"burying it"
                            ),
                        )
                    )
                for missing in sorted(severity_keys - loggers_keys):
                    out.append(
                        Finding(
                            pass_id=PASS_ID,
                            code="kind-maps-diverged",
                            file=project.rel(logging_path),
                            line=1,
                            symbol=missing,
                            message=(
                                f"event kind {missing!r} is in _SEVERITY but "
                                f"not _LOGGERS — log_event would reject it"
                            ),
                        )
                    )

    # --- log_event call sites -------------------------------------------
    if loggers_keys:
        for path in project.py_files:
            tree = project.tree(path)
            if tree is None:
                continue
            for node in ast.walk(tree):
                if (
                    isinstance(node, ast.Call)
                    and dotted(node.func).rsplit(".", 1)[-1] == "log_event"
                    and node.args
                ):
                    kind = const_str(node.args[0])
                    if kind is not None and kind not in loggers_keys:
                        out.append(
                            Finding(
                                pass_id=PASS_ID,
                                code="unknown-event-kind",
                                file=project.rel(path),
                                line=node.lineno,
                                symbol=kind,
                                message=(
                                    f"log_event kind {kind!r} is not in "
                                    f"_LOGGERS — this call raises ValueError "
                                    f"at runtime"
                                ),
                            )
                        )
    return out


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

_DOC = "| `torchft_good_total` | counter | documented |\n"

_LOGGING_SRC = '_LOGGERS = {"quorum": 1, "error": 2}\n'
_OTEL_SRC = '_SEVERITY = {"quorum": (9, "INFO")}\n'  # "error" missing -> diverged


def _run_on_project(files: "Dict[str, str]", doc: str = _DOC) -> "List[Finding]":
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tftlint_selftest_") as td:
        os.makedirs(os.path.join(td, "docs"))
        with open(
            os.path.join(td, "docs", "observability.md"), "w", encoding="utf-8"
        ) as fh:
            fh.write(doc)
        paths = []
        for rel, src in files.items():
            path = os.path.join(td, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(src)
            paths.append(path)
        return list(run(Project(td, paths)))


def selftest() -> None:
    bad = _run_on_project(
        {
            "pkg/m.py": (
                "from torchft_tpu_torch.utils.metrics import counter\n"
                'A = counter("myapp_oops_total", "bad namespace")\n'
                'B = counter("torchft_dup_total", "dup a")\n'
            ),
            "pkg/n.py": (
                "from torchft_tpu_torch.utils.metrics import counter\n"
                'C = counter("torchft_dup_total", "dup b")\n'
                'D = counter("torchft_undocumented_total", "undocumented")\n'
                "from torchft_tpu_torch.utils.logging import log_event\n"
                'log_event("nonexistent_kind", "boom")\n'
            ),
            "pkg/utils/logging.py": _LOGGING_SRC,
            "pkg/utils/otel.py": _OTEL_SRC,
        }
    )
    codes = {f.code for f in bad}
    expect = {
        "non-torchft-metric",
        "duplicate-metric",
        "undocumented-metric",
        "kind-maps-diverged",
        "unknown-event-kind",
    }
    missing = expect - codes
    if missing:
        raise SelftestError(f"{PASS_ID}: bad project missed codes {missing}")

    got = _run_on_project(
        {
            "pkg/m.py": (
                "from torchft_tpu_torch.utils.metrics import counter\n"
                'A = counter("torchft_good_total", "documented")\n'
                "from torchft_tpu_torch.utils.logging import log_event\n"
                'log_event("quorum", "fine")\n'
            ),
            "pkg/utils/logging.py": _LOGGING_SRC,
            "pkg/utils/otel.py": '_SEVERITY = {"quorum": (9, "INFO"), "error": (17, "ERROR")}\n',
        }
    )
    if got:
        raise SelftestError(
            f"{PASS_ID}: good project falsely flagged: "
            f"{[f.render() for f in got]}"
        )


PASS = LintPass(
    id=PASS_ID,
    doc="metric names are torchft_*, unique, and documented; event kinds "
    "exist in both _LOGGERS and _SEVERITY",
    run=run,
    selftest=selftest,
)
