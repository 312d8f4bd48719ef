"""Pass ``fault-coverage``: the chaos registry and the flight recorder
keep covering the failure surface as it grows.

Two halves:

**Fault sites.**  ``utils/faults.py`` owns ``KNOWN_SITES`` — the typo
guard for ``TORCHFT_FAULTS`` specs — and docs/robustness.md carries the
operator-facing site table.  Every ``faults.check("<site>")`` literal in
the production tree must be a known site (``unknown-fault-site``) and
documented (``undocumented-fault-site``); conversely every known site
must still be consulted somewhere (``unwired-fault-site``) — a site that
no longer fires turns every chaos schedule naming it into a vacuous
pass.  ``train.step`` is exempt from wiring: it is the *user* loop's
opt-in hook by design.

**Flight coverage.**  The flight recorder is only a blackbox if the
paths that wedge actually feed it.  The anchor functions below — the PG
worker loop that executes every collective, and both checkpoint
transports' send/recv entry points — must reference the flight recorder
(``record``/``start``/``track``/``dump`` or a ``FlightOp`` method)
directly or through a same-module helper (call graph followed two
levels).  Removing the instrumentation in a refactor yields
``missing-flight-op``.
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

PASS_ID = "fault-coverage"

_FAULTS_FILE = "utils/faults.py"
_ROBUSTNESS_DOC = "docs/robustness.md"

# Known sites that need no production check-call (user-facing hooks).
_WIRING_EXEMPT = ("train.step",)

# (file suffix, function name) anchors that must feed the recorder.
_FLIGHT_ANCHORS: "Tuple[Tuple[str, str], ...]" = (
    ("parallel/process_group.py", "_worker_loop"),
    ("checkpointing/http_transport.py", "send_checkpoint"),
    ("checkpointing/http_transport.py", "recv_checkpoint"),
    ("checkpointing/pg_transport.py", "send_checkpoint"),
    ("checkpointing/pg_transport.py", "recv_checkpoint"),
    # the shared fragment plane (shared by serving/ and the heal):
    # every raw fragment fetch — serving relay pulls AND striped-heal
    # stripes — plus the striped heal receive must stay
    # post-mortem-visible
    ("checkpointing/fragments.py", "fetch_raw"),
    # the native-vs-python dispatch point of the zero-copy data plane:
    # a fetch that falls back to Python must stay post-mortem-visible
    # (`fragment.native_fallback`)
    ("checkpointing/fragments.py", "_raw_data_plane"),
    ("checkpointing/fragments.py", "fetch_serialized"),
    ("checkpointing/http_transport.py", "recv_checkpoint_striped"),
    ("serving/replica.py", "_pull"),
)

_FLIGHT_CALLS = ("record", "start", "track", "dump", "update", "add_bytes", "finish")


def _known_sites(project: Project) -> "Optional[Set[str]]":
    """Parse KNOWN_SITES from utils/faults.py (None when absent)."""
    path = project.find_file(_FAULTS_FILE)
    if path is None:
        return None
    tree = project.tree(path)
    if tree is None:
        return None
    for node in tree.body:
        if (
            isinstance(node, ast.AnnAssign)
            and isinstance(node.target, ast.Name)
            and node.target.id == "KNOWN_SITES"
        ):
            value = node.value
        elif (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "KNOWN_SITES"
        ):
            value = node.value
        else:
            continue
        if isinstance(value, (ast.Tuple, ast.List)):
            sites = {const_str(e) for e in value.elts}
            return {s for s in sites if s is not None}
    return None


class _CheckCollector(QualnameVisitor):
    """Collects ``*.check("<site>", ...)`` / ``check("<site>")`` calls."""

    def __init__(self, project: Project, path: str) -> None:
        super().__init__()
        self.project = project
        self.path = path
        self.calls: "List[Tuple[str, int, str]]" = []

    def visit_Call(self, node: ast.Call) -> None:  # noqa: N802
        name = dotted(node.func)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "check" and node.args:
            site = const_str(node.args[0])
            # only dotted site strings: filters unrelated .check() APIs
            if site is not None and "." in site:
                self.calls.append((site, node.lineno, self.qualname))
        # deferred wiring: a site handed to a client as its injection
        # hook (e.g. _RpcClient(addr, fault_site="lighthouse.rpc"))
        for kw in node.keywords:
            if kw.arg == "fault_site":
                site = const_str(kw.value)
                if site is not None and "." in site:
                    self.calls.append((site, node.lineno, self.qualname))
        self.generic_visit(node)


def _module_flight_reach(tree: ast.Module) -> "Set[str]":
    """Function names in this module that reference the flight recorder
    directly, or (transitively, two hops) call one that does."""
    direct: "Set[str]" = set()
    calls: "Dict[str, Set[str]]" = {}

    def touches_flight(node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = dotted(sub.func)
                parts = name.split(".")
                if len(parts) >= 2 and parts[-1] in _FLIGHT_CALLS:
                    recv = ".".join(parts[:-1])
                    if "flightrec" in recv or "flight_op" in recv or recv.endswith(
                        "flightrecorder"
                    ):
                        return True
            if isinstance(sub, (ast.Attribute, ast.Name)):
                name = dotted(sub)
                if "flightrec" in name or "FlightOp" in name:
                    return True
        return False

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if touches_flight(node):
                direct.add(node.name)
            called: "Set[str]" = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    called.add(dotted(sub.func).rsplit(".", 1)[-1])
            calls[node.name] = called

    reach = set(direct)
    for _ in range(2):  # two hops of same-module indirection
        reach |= {fn for fn, cs in calls.items() if cs & reach}
    return reach


def run(project: Project) -> "Iterable[Finding]":
    out: "List[Finding]" = []
    known = _known_sites(project)
    robustness = project.doc_text_for(_ROBUSTNESS_DOC)

    # --- fault-site checks ------------------------------------------------
    checked_sites: "Set[str]" = set()
    if known is not None:
        for path in project.py_files:
            tree = project.tree(path)
            if tree is None:
                continue
            col = _CheckCollector(project, path)
            col.visit(tree)
            for site, line, qual in col.calls:
                checked_sites.add(site)
                if site not in known:
                    out.append(
                        Finding(
                            pass_id=PASS_ID,
                            code="unknown-fault-site",
                            file=project.rel(path),
                            line=line,
                            symbol=site,
                            message=(
                                f"fault site {site!r} is not in "
                                f"faults.KNOWN_SITES — register it (and its "
                                f"docs row) or the TORCHFT_FAULTS grammar "
                                f"warns on every spec naming it"
                            ),
                        )
                    )
                elif robustness and site not in robustness:
                    out.append(
                        Finding(
                            pass_id=PASS_ID,
                            code="undocumented-fault-site",
                            file=project.rel(path),
                            line=line,
                            symbol=site,
                            message=(
                                f"fault site {site!r} is missing from the "
                                f"{_ROBUSTNESS_DOC} site table"
                            ),
                        )
                    )
        faults_path = project.find_file(_FAULTS_FILE)
        for site in sorted(known - checked_sites):
            if site in _WIRING_EXEMPT:
                continue
            out.append(
                Finding(
                    pass_id=PASS_ID,
                    code="unwired-fault-site",
                    file=project.rel(faults_path or ""),
                    line=1,
                    symbol=site,
                    message=(
                        f"KNOWN_SITES entry {site!r} has no faults.check() "
                        f"call site left in the tree — chaos schedules "
                        f"naming it silently never fire"
                    ),
                )
            )

    # --- flight-recorder anchors -----------------------------------------
    for suffix, func_name in _FLIGHT_ANCHORS:
        path = project.find_file(suffix)
        if path is None:
            continue  # module absent from the analyzed set
        tree = project.tree(path)
        if tree is None:
            continue
        defs = [
            n
            for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name == func_name
        ]
        if not defs:
            continue  # anchor gone entirely: an API change, not a coverage gap
        reach = _module_flight_reach(tree)
        if func_name not in reach:
            out.append(
                Finding(
                    pass_id=PASS_ID,
                    code="missing-flight-op",
                    file=project.rel(path),
                    line=defs[0].lineno,
                    symbol=func_name,
                    message=(
                        f"{func_name} no longer feeds the flight recorder "
                        f"(no record/start/track reference within two "
                        f"same-module call hops) — the post-mortem loses "
                        f"this path's evidence"
                    ),
                )
            )
    return out


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------


def _run_on_project(files: "Dict[str, str]", robustness: str) -> "List[Finding]":
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tftlint_selftest_") as td:
        os.makedirs(os.path.join(td, "docs"))
        with open(
            os.path.join(td, "docs", "robustness.md"), "w", encoding="utf-8"
        ) as fh:
            fh.write(robustness)
        paths = []
        for rel, src in files.items():
            path = os.path.join(td, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(src)
            paths.append(path)
        return list(run(Project(td, paths)))


_FAULTS_SRC = 'KNOWN_SITES = ("pg.allreduce", "manager.quorum", "train.step")\n'


def selftest() -> None:
    bad = _run_on_project(
        {
            "pkg/utils/faults.py": _FAULTS_SRC,
            "pkg/core.py": (
                "from torchft_tpu_torch.utils import faults\n"
                "def step():\n"
                '    faults.check("pg.allreduce")\n'
                '    faults.check("pg.typo_site")\n'
            ),
            "pkg/parallel/process_group.py": (
                "def _worker_loop(self):\n"
                "    pass  # no flight recorder reference\n"
            ),
        },
        robustness="| `manager.quorum` | documented |\n",
    )
    codes = {f.code for f in bad}
    expect = {
        "unknown-fault-site",
        "undocumented-fault-site",  # pg.allreduce missing from the doc
        "unwired-fault-site",  # manager.quorum never checked
        "missing-flight-op",
    }
    missing = expect - codes
    if missing:
        raise SelftestError(f"{PASS_ID}: bad project missed codes {missing}")

    got = _run_on_project(
        {
            "pkg/utils/faults.py": _FAULTS_SRC,
            "pkg/core.py": (
                "from torchft_tpu_torch.utils import faults\n"
                "def step():\n"
                '    faults.check("pg.allreduce")\n'
                '    faults.check("manager.quorum")\n'
            ),
            "pkg/parallel/process_group.py": (
                "from torchft_tpu_torch.utils import flightrecorder as _flightrec\n"
                "def _finish(op):\n"
                '    _flightrec.record("op")\n'
                "def _worker_loop(self):\n"
                "    _finish(None)\n"
            ),
        },
        robustness="`pg.allreduce` `manager.quorum` `train.step`\n",
    )
    if got:
        raise SelftestError(
            f"{PASS_ID}: good project falsely flagged: "
            f"{[f.render() for f in got]}"
        )


PASS = LintPass(
    id=PASS_ID,
    doc="fault sites are registered+documented+wired; PG collectives and "
    "checkpoint transports feed the flight recorder",
    run=run,
    selftest=selftest,
)
