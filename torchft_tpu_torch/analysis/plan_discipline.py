"""Pass ``plan-discipline``: peer-communication structure is built only
by the plan layer and its bless-listed executors.

The point of the Plan IR (:mod:`torchft_tpu_torch.analysis.plan_ir`) is that
"who talks to whom" is *data* with checkable invariants — reduction
hierarchies, serving trees, stripe assignments.  That property dies the
day a fourth subsystem quietly derives its own peer list from a roster
slice or re-implements the round-robin fragment layout: the verifier
never sees that plan, and the next plan synthesizer can not
replace math it does not know exists.

This pass freezes the perimeter: calling a PLAN PRIMITIVE — the
constructors every communication structure flows through
(``synthesize_plan`` / ``parse_topology`` / ``resolve_topology``,
``serving_plan``, ``fragment_slots`` / ``split_chunks`` /
``fragment_into_map``, ``stripe_roster`` / ``stripe_source_cohort``,
``reference_serving_plan``) — is allowed only in the IR/adapter layer
and the bless-listed modules that execute or transport plans today.
Anything else is a new peer-structure author and must either go through
the plan layer or argue its way onto the bless list in review.  The
baseline ships empty: nothing is grandfathered.
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

PASS_ID = "plan-discipline"

#: Call names (last dotted segment) that build peer-communication
#: structure.  Definitions do not match — only calls.
PLAN_PRIMITIVES = frozenset(
    {
        "synthesize_plan",
        "parse_topology",
        "resolve_topology",
        "serving_plan",
        "fragment_slots",
        "split_chunks",
        "fragment_into_map",
        "stripe_roster",
        "stripe_source_cohort",
        "reference_serving_plan",
    }
)

#: Modules allowed to call plan primitives: the plan layer itself, the
#: planners' home modules, and the executors/transports that consume a
#: plan.  Growing this list is a review decision, not a default.
_BLESSED: "Tuple[str, ...]" = (
    "analysis/plan_ir.py",
    "analysis/plan_verify.py",
    "ops/topology.py",
    "ops/collectives.py",
    "parallel/process_group.py",
    "serving/client.py",
    "serving/replica.py",
    "checkpointing/fragments.py",
    "checkpointing/serialization.py",
    "checkpointing/http_transport.py",
    "manager.py",
)


def _blessed(relpath: str) -> bool:
    norm = relpath.replace("\\", "/")
    return any(norm.endswith(suffix) for suffix in _BLESSED)


class _Visitor(ast.NodeVisitor):
    def __init__(self, project: Project, path: str) -> None:
        self.project = project
        self.path = path
        self.findings: "List[Finding]" = []
        self._qual: "List[str]" = []

    def _visit_scoped(self, node: ast.AST) -> None:
        self._qual.append(node.name)  # type: ignore[attr-defined]
        self.generic_visit(node)
        self._qual.pop()

    visit_FunctionDef = _visit_scoped  # noqa: N815
    visit_AsyncFunctionDef = _visit_scoped  # noqa: N815
    visit_ClassDef = _visit_scoped  # noqa: N815

    def visit_Call(self, node: ast.Call) -> None:  # noqa: N802
        name = dotted(node.func)
        last = name.rsplit(".", 1)[-1] if name else ""
        if last in PLAN_PRIMITIVES:
            self.findings.append(
                Finding(
                    pass_id=PASS_ID,
                    code="plan-primitive-outside-plan-layer",
                    file=self.project.rel(self.path),
                    line=node.lineno,
                    symbol=".".join(self._qual),
                    message=(
                        f"{last}() builds peer-communication structure "
                        f"outside the plan layer — route it through "
                        f"analysis/plan_ir.py (so tft-verify sees the "
                        f"plan) or bless this module in plan_discipline "
                        f"with a review reason"
                    ),
                )
            )
        self.generic_visit(node)


def run(project: Project) -> "Iterable[Finding]":
    out: "List[Finding]" = []
    for path in project.py_files:
        if _blessed(project.rel(path)):
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

_BAD_SRC = """
from torchft_tpu_torch.ops import topology

def my_private_schedule(world):
    topo = topology.parse_topology("hosts:2", world)
    return topology.synthesize_plan(topo, 0)
"""

_BAD_METHOD_SRC = """
def adopt(client):
    return client.serving_plan()
"""

_GOOD_SIMILAR_SRC = """
def make_plan(world):
    # not a plan primitive: local helper with an unrelated name
    return build_schedule(world)
"""

_GOOD_DEF_SRC = """
def synthesize_plan(topo, rank):
    # defining (e.g. stubbing) is not calling
    return None
"""


def _run_on(rel: str, src: str) -> "List[Finding]":
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(src)
        return list(run(Project(td, [path])))


def selftest() -> None:
    if not _run_on("pkg/rogue.py", _BAD_SRC):
        raise SelftestError(
            f"{PASS_ID}: unblessed synthesize_plan call not flagged"
        )
    if not _run_on("pkg/rogue.py", _BAD_METHOD_SRC):
        raise SelftestError(
            f"{PASS_ID}: unblessed serving_plan() method call not flagged"
        )
    if _run_on("ops/collectives.py", _BAD_SRC):
        raise SelftestError(
            f"{PASS_ID}: bless-listed executor falsely flagged"
        )
    for name, src in (
        ("similar-name", _GOOD_SIMILAR_SRC),
        ("def-not-call", _GOOD_DEF_SRC),
    ):
        got = _run_on("pkg/ok.py", src)
        if got:
            raise SelftestError(
                f"{PASS_ID}: good snippet {name!r} falsely flagged: "
                f"{[f.render() for f in got]}"
            )


PASS = LintPass(
    id=PASS_ID,
    doc="plan primitives (synthesize_plan, serving_plan, fragment "
    "layout, stripe roster) called only from the plan layer and "
    "bless-listed executors — peer structure stays verifiable data",
    run=run,
    selftest=selftest,
)
