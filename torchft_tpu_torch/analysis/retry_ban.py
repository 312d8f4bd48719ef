"""Pass ``retry-ban``: no ``time.sleep``-based retry loops outside
``utils/retry.py``.

The package replaced three divergent ad-hoc backoff loops with one reviewable
:class:`RetryPolicy` (exponential backoff, full jitter, hard deadline
budgets, metrics) — on the argument that retry behavior must be one
object, not folklore.  Folklore regrows one `while True: ...sleep()` at
a time; this pass is the herbicide: any ``time.sleep`` lexically inside
a ``while``/``for`` body outside ``utils/retry.py`` is flagged unless
the (file, qualname) pair is on the structural allowlist.

The allowlist is for loops that *pace*, not *retry* — sleeping there is
the behavior, not a recovery policy:

- the launcher's child-poll / restart-backoff supervisor loop
  (``ReplicaGroupLauncher.run``): process supervision with its own
  restart budget semantics, deliberately simple;
- the timeout engine's watchdog heartbeat
  (``_TimeoutManager._run_watchdog``): a fixed-cadence liveness probe —
  routing the watchdog through the machinery it watches would be
  circular;
- the token-bucket rate limiter (``_TokenBucket.consume``): the sleep
  *is* the shaping.

Everything else retries and must say so: ``RetryPolicy.run`` gives the
loop jitter, budgets, ``torchft_retries_total`` accounting, and flight
records that let ``torchft-diagnose`` flag retry storms.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Tuple

from torchft_tpu_torch.analysis.core import (
    Finding,
    LintPass,
    Project,
    SelftestError,
    dotted,
)

PASS_ID = "retry-ban"

_EXEMPT_FILE_SUFFIX = "utils/retry.py"

# (file suffix, qualname) pairs allowed to sleep inside a loop.
_ALLOWLIST: "Tuple[Tuple[str, str], ...]" = (
    ("launcher.py", "ReplicaGroupLauncher.run"),
    ("utils/futures.py", "_TimeoutManager._run_watchdog"),
    ("parallel/process_group.py", "_TokenBucket.consume"),
)


def _allowed(relpath: str, qual: str) -> bool:
    norm = relpath.replace("\\", "/")
    return any(
        norm.endswith(suffix) and qual == q for suffix, q in _ALLOWLIST
    )


class _Visitor(ast.NodeVisitor):
    def __init__(self, project: Project, path: str) -> None:
        self.project = project
        self.path = path
        self.findings: "List[Finding]" = []
        self._qual: "List[str]" = []
        self._loop_depth = 0

    def _visit_scoped(self, node: ast.AST) -> None:
        self._qual.append(node.name)  # type: ignore[attr-defined]
        # a function defined inside a loop runs later: reset loop context
        saved, self._loop_depth = self._loop_depth, 0
        self.generic_visit(node)
        self._loop_depth = saved
        self._qual.pop()

    visit_FunctionDef = _visit_scoped  # noqa: N815
    visit_AsyncFunctionDef = _visit_scoped  # noqa: N815
    visit_ClassDef = _visit_scoped  # noqa: N815

    def _visit_loop(self, node: ast.AST) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_While = _visit_loop  # noqa: N815
    visit_For = _visit_loop  # noqa: N815

    def visit_Call(self, node: ast.Call) -> None:  # noqa: N802
        if self._loop_depth > 0 and dotted(node.func).endswith("time.sleep"):
            qual = ".".join(self._qual)
            rel = self.project.rel(self.path)
            if not _allowed(rel, qual):
                self.findings.append(
                    Finding(
                        pass_id=PASS_ID,
                        code="sleep-in-loop",
                        file=rel,
                        line=node.lineno,
                        symbol=qual,
                        message=(
                            "time.sleep inside a loop outside utils/retry.py "
                            "— use RetryPolicy.run (jitter, deadline budgets, "
                            "torchft_retries_total accounting) or add a "
                            "pacing-loop allowlist entry with a reason"
                        ),
                    )
                )
        self.generic_visit(node)


def run(project: Project) -> "Iterable[Finding]":
    out: "List[Finding]" = []
    for path in project.py_files:
        if path.replace("\\", "/").endswith(_EXEMPT_FILE_SUFFIX):
            continue
        tree = project.tree(path)
        if tree is None:
            continue
        visitor = _Visitor(project, path)
        visitor.visit(tree)
        out.extend(visitor.findings)
    return out


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

_BAD = {
    "while-retry": """
import time
def fetch():
    while True:
        try:
            return do()
        except ConnectionError:
            time.sleep(0.5)
""",
    "for-retry": """
import time
def fetch():
    for attempt in range(5):
        time.sleep(2 ** attempt)
""",
}

_GOOD = {
    "single-sleep": "import time\ndef pace():\n    time.sleep(0.1)\n",
    "policy": (
        "from torchft_tpu_torch.utils.retry import RetryPolicy\n"
        "def fetch():\n"
        "    return RetryPolicy(name='x').run(lambda b: do())\n"
    ),
    "sleep-in-nested-def-outside-loop": """
import time
def outer():
    for i in range(3):
        def cb():
            time.sleep(1)  # runs later, not a loop retry
        register(cb)
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
    doc="no time.sleep retry loops outside utils/retry.py (pacing loops "
    "allowlisted: launcher supervisor, watchdog, rate limiter)",
    run=run,
    selftest=selftest,
)
