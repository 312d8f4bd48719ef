"""Pass ``metrics-cardinality``: per-replica/per-peer metric labels must
come from a bounded set.

Fleet scale broke the "one label child per replica" habit: a
``.labels(replica=<incarnation id>)`` call mints a new series per
restart and per fleet member, growing the registry (and every scrape)
without bound under churn — exactly the regime the lighthouse's worst-K
straggler tier exists for (docs/observability.md, "metric
cardinality").  The native lighthouse enforces its side by construction
(``straggler_topk``); this pass remembers the rule for the Python
registry:

- ``unbounded-entity-label``: a ``.labels(...)`` call whose label KEY is
  per-entity (``replica``, ``replica_id``, ``peer``, ``rank``, ...) and
  whose VALUE is not visibly bounded.  Bounded means: a string literal;
  the Manager's documented ``_metric_replica_id`` (the stable bare id —
  one value per process for the life of the job, restart-proof); or
  ``str()``/f-string-free wrapping of those.  Anything dynamic (a loop
  variable, an incarnation id, a peer address) must instead go through a
  top-K/aggregated summary tier — or carry an explicit
  ``# tft-lint: allow(metrics-cardinality)`` waiver arguing why the
  value set is bounded.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from torchft_tpu_torch.analysis.core import (
    Finding,
    LintPass,
    Project,
    QualnameVisitor,
    SelftestError,
    dotted,
)

PASS_ID = "metrics-cardinality"

# Label keys that name a fleet entity: values must be bounded.
PER_ENTITY_KEYS = frozenset(
    {"replica", "replica_id", "peer", "peer_rank", "rank", "host", "worker"}
)

# Dotted-name suffixes that ARE the bounded tier: the Manager's stable
# bare replica id (one value per process; the ":uuid" incarnation suffix
# is stripped precisely so restarts reuse the series).
_BOUNDED_NAME_SUFFIXES = ("_metric_replica_id",)

# Method-name suffixes whose RETURN VALUE is the bounded tier: the
# link-registry's ``peer_topk_label`` folds every peer beyond the
# worst-K into a literal "other", so the label set is K+1 values by
# construction (utils/linkstats.py) — the Python mirror of the native
# lighthouse's straggler_topk tier.
_TOPK_LABEL_SUFFIXES = ("topk_label",)


def _is_bounded_value(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return True
    name = dotted(node)
    if name and any(
        name.split(".")[-1] == suffix or name.endswith(suffix)
        for suffix in _BOUNDED_NAME_SUFFIXES
    ):
        return True
    # the top-K folding tier: <registry>.peer_topk_label(<anything>) is
    # bounded regardless of its argument — folding is the whole point
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if any(
            node.func.attr.endswith(suffix) for suffix in _TOPK_LABEL_SUFFIXES
        ):
            return True
    # str(<bounded>) / int(<bounded>) wrappers
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in ("str", "int")
        and len(node.args) == 1
    ):
        return _is_bounded_value(node.args[0])
    return False


def _has_waiver(project: Project, path: str, lineno: int) -> bool:
    lines = project.source(path).splitlines()
    if 1 <= lineno <= len(lines):
        return f"tft-lint: allow({PASS_ID})" in lines[lineno - 1]
    return False


class _Visitor(QualnameVisitor):
    def __init__(self, project: Project, path: str) -> None:
        super().__init__()
        self.project = project
        self.path = path
        self.findings: "List[Finding]" = []

    def visit_Call(self, node: ast.Call) -> None:  # noqa: N802
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "labels":
            in_test = any(
                part.startswith(("test_", "_selftest"))
                for part in self.qualname.split(".")
            )
            for kw in node.keywords:
                if kw.arg in PER_ENTITY_KEYS and not in_test:
                    if not _is_bounded_value(kw.value) and not _has_waiver(
                        self.project, self.path, node.lineno
                    ):
                        self.findings.append(
                            Finding(
                                pass_id=PASS_ID,
                                code="unbounded-entity-label",
                                file=self.project.rel(self.path),
                                line=node.lineno,
                                symbol=self.qualname,
                                message=(
                                    f"label {kw.arg}= fed from "
                                    f"{ast.dump(kw.value)[:60]}: per-entity "
                                    "metric labels must come from a bounded "
                                    "set (literal, _metric_replica_id, or a "
                                    "top-K summary tier) — unbounded series "
                                    "growth under fleet churn"
                                ),
                            )
                        )
        self.generic_visit(node)


def run(project: Project) -> "Iterable[Finding]":
    for path in project.py_files:
        rel = project.rel(path).replace("\\", "/")
        if rel.startswith("tests/") or "/tests/" in rel:
            continue  # fixture registries in tests are out of scope
        tree = project.tree(path)
        if tree is None:
            continue
        visitor = _Visitor(project, path)
        visitor.visit(tree)
        yield from visitor.findings


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

_BAD = {
    # the fleet-churn failure mode: a per-incarnation id becomes a label
    "dynamic-replica-label": """
from torchft_tpu_torch.utils.metrics import counter
M = counter("torchft_x_total", "d")
def observe(replica_id):
    M.labels(replica=replica_id).inc()
""",
    # per-peer labels in a loop: one series per fleet member
    "per-peer-loop": """
from torchft_tpu_torch.utils.metrics import gauge
G = gauge("torchft_peer_lag", "d")
def export(peers):
    for p in peers:
        G.labels(peer=p.addr).set(p.lag)
""",
    # an incarnation id dressed as str() is still unbounded
    "str-wrapped-dynamic": """
from torchft_tpu_torch.utils.metrics import counter
M = counter("torchft_y_total", "d")
def observe(self):
    M.labels(rank=str(self._group_rank_of_the_day())).inc()
""",
    # a lookalike method name is NOT the folding tier
    "fake-topk-method": """
from torchft_tpu_torch.utils.metrics import gauge
G = gauge("torchft_peer_x", "d")
def export(reg, host):
    G.labels(peer=reg.peer_label(host)).set(1.0)
""",
}

_GOOD = {
    # the documented bounded tier: the stable bare replica id
    "metric-replica-id": """
from torchft_tpu_torch.utils.metrics import counter
M = counter("torchft_x_total", "d")
class Manager:
    def observe(self):
        M.labels(replica_id=self._metric_replica_id).inc()
""",
    # literals are a bounded set by construction
    "literal-label": """
from torchft_tpu_torch.utils.metrics import gauge
G = gauge("torchft_worst", "d")
def export():
    G.labels(replica="worst").set(1.0)
""",
    # non-entity keys (phase, transport, ...) are out of scope
    "non-entity-key": """
from torchft_tpu_torch.utils.metrics import histogram
H = histogram("torchft_dur", "d")
def observe(phase):
    H.labels(phase=phase).observe(1.0)
""",
    # the top-K folding tier bounds its own output (K+1 label values)
    "topk-label-tier": """
from torchft_tpu_torch.utils.metrics import counter
M = counter("torchft_peer_wait_total", "d")
def observe(reg, host):
    M.labels(peer=reg.peer_topk_label(host)).inc()
""",
    # an argued waiver is honored
    "waived": """
from torchft_tpu_torch.utils.metrics import counter
M = counter("torchft_z_total", "d")
def observe(site):
    M.labels(rank=site).inc()  # tft-lint: allow(metrics-cardinality)
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
    doc="per-replica/per-peer metric label values must come from a "
    "bounded or top-K-aggregated set (fleet churn must not grow the "
    "registry)",
    run=run,
    selftest=selftest,
)
