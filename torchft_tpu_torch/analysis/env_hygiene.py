"""Pass ``env-hygiene``: every environment knob goes through
``utils/env.py``, is ``TORCHFT_*``-named, and is documented.

The failure mode this kills: PR N adds ``os.environ.get("TORCHFT_FOO")``
deep in a transport, nothing documents it, and six months later a
production run depends on a knob no operator can discover and whose
garbage-value behavior (crash? silent default?) nobody decided.  The
shared helpers (``env_str``/``env_int``/``env_float``/``env_bool``)
decide the garbage policy once; this pass makes them the only door:

- ``direct-env-read``: ``os.environ[...]`` / ``os.environ.get`` /
  ``os.getenv`` reads anywhere outside ``utils/env.py``.  Writes
  (``os.environ["X"] = ...`` for child-env propagation) are allowed.
- ``non-torchft-knob``: a helper read of a name that is neither
  ``TORCHFT_*`` nor a known external (``OTEL_*`` standard vars, the
  scheduler identity vars RANK/WORLD_SIZE/..., the CUDA toolkit's
  CUDA_HOME and the cache's XDG_CACHE_HOME).
- ``undocumented-knob``: a ``TORCHFT_*`` helper read whose name appears
  nowhere in the docs corpus (README.md + docs/*.md) — the knob tables
  in docs/observability.md, docs/robustness.md, and
  docs/static_analysis.md are the expected homes.

Helper first-arguments are resolved through module-level string
constants (``env_str(SOME_CONST)``); dynamic names are skipped — the
pass polices the declarative form, which is also the greppable one.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Tuple

from torchft_tpu_torch.analysis.core import (
    Finding,
    LintPass,
    Project,
    QualnameVisitor,
    SelftestError,
    const_str,
    dotted,
    module_str_constants,
)

PASS_ID = "env-hygiene"

_HELPERS = ("env_str", "env_int", "env_float", "env_bool")

# Non-TORCHFT names the helpers may legitimately read: OTEL standard
# exporter config, scheduler-injected identity, and the CUDA toolkit and
# cache locations the kernel build reads (_kernels.py).
_EXTERNAL_PREFIXES: "Tuple[str, ...]" = ("OTEL_",)
_EXTERNAL_NAMES: "Tuple[str, ...]" = (
    "RANK",
    "WORLD_SIZE",
    "JOB_ID",
    "LOGLEVEL",
    "REPLICA_GROUP_ID",
    "NUM_REPLICA_GROUPS",
    "CUDA_HOME",
    "XDG_CACHE_HOME",
)

# The helper module itself is the one sanctioned direct reader.
_EXEMPT_FILE_SUFFIX = "utils/env.py"


def _is_env_read(node: ast.AST) -> "str | None":
    """Describe a direct env read at this node, or None.

    Matches ``os.environ[...]`` loads, ``os.environ.get(...)``,
    ``os.environ.setdefault(...)`` (read-or-write counts: the read leg
    decides behavior), and ``os.getenv(...)``.
    """
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        if dotted(node.value).endswith("os.environ"):
            return "os.environ[...]"
    if isinstance(node, ast.Call):
        name = dotted(node.func)
        if name.endswith("os.environ.get") or name.endswith("os.environ.setdefault"):
            return name[name.index("os.") :]
        if name.endswith("os.getenv"):
            return "os.getenv"
    return None


class _Visitor(QualnameVisitor):
    def __init__(self, project: Project, path: str, consts: "dict") -> None:
        super().__init__()
        self.project = project
        self.path = path
        self.consts = consts
        self.findings: "List[Finding]" = []
        self.torchft_knobs: "List[Tuple[str, int, str]]" = []  # (name, line, qual)

    def _resolve(self, arg: "ast.AST | None") -> "str | None":
        val = const_str(arg)
        if val is not None:
            return val
        if isinstance(arg, ast.Name):
            return self.consts.get(arg.id)
        return None

    def visit_Subscript(self, node: ast.Subscript) -> None:  # noqa: N802
        kind = _is_env_read(node)
        if kind:
            self._flag_direct(node, kind)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:  # noqa: N802
        kind = _is_env_read(node)
        if kind:
            self._flag_direct(node, kind)
        func = dotted(node.func)
        if func.rsplit(".", 1)[-1] in _HELPERS and node.args:
            name = self._resolve(node.args[0])
            if name is not None:
                self._check_knob(name, node.lineno)
        self.generic_visit(node)

    def _flag_direct(self, node: ast.AST, kind: str) -> None:
        self.findings.append(
            Finding(
                pass_id=PASS_ID,
                code="direct-env-read",
                file=self.project.rel(self.path),
                line=node.lineno,
                symbol=self.qualname,
                message=(
                    f"{kind} read outside utils/env.py — use "
                    f"env_str/env_int/env_float/env_bool so garbage values "
                    f"warn-and-default and the knob is lintable"
                ),
            )
        )

    def _check_knob(self, name: str, line: int) -> None:
        if name.startswith("TORCHFT_"):
            self.torchft_knobs.append((name, line, self.qualname))
            return
        if name.startswith(_EXTERNAL_PREFIXES) or name in _EXTERNAL_NAMES:
            return
        self.findings.append(
            Finding(
                pass_id=PASS_ID,
                code="non-torchft-knob",
                file=self.project.rel(self.path),
                line=line,
                symbol=name,
                message=(
                    f"env knob {name!r} is neither TORCHFT_*-prefixed nor a "
                    f"known external var — namespace it or add it to the "
                    f"pass's external allowlist with a reason"
                ),
            )
        )


def run(project: Project) -> "Iterable[Finding]":
    out: "List[Finding]" = []
    docs = project.docs_text()
    for path in project.py_files:
        if path.replace("\\", "/").endswith(_EXEMPT_FILE_SUFFIX):
            continue
        tree = project.tree(path)
        if tree is None:
            continue
        visitor = _Visitor(project, path, module_str_constants(tree))
        visitor.visit(tree)
        out.extend(visitor.findings)
        for name, line, qual in visitor.torchft_knobs:
            if name not in docs:
                out.append(
                    Finding(
                        pass_id=PASS_ID,
                        code="undocumented-knob",
                        file=project.rel(path),
                        line=line,
                        symbol=name,
                        message=(
                            f"env knob {name!r} is read here but appears in "
                            f"no docs table (README.md / docs/*.md) — add it "
                            f"to the env-knob table"
                        ),
                    )
                )
    return out


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

_BAD = {
    "direct-read": 'import os\nx = os.environ.get("TORCHFT_FOO", "1")\n',
    "direct-subscript": 'import os\nx = os.environ["TORCHFT_FOO"]\n',
    "getenv": 'import os\nx = os.getenv("TORCHFT_FOO")\n',
    "non-torchft": (
        "from torchft_tpu_torch.utils.env import env_str\n"
        'x = env_str("MY_RANDOM_KNOB")\n'
    ),
    "undocumented": (
        "from torchft_tpu_torch.utils.env import env_int\n"
        'x = env_int("TORCHFT_UNDOCUMENTED_THING", 1)\n'
    ),
}

_GOOD = {
    "write-allowed": 'import os\nos.environ["TORCHFT_FOO"] = "1"\n',
    "helper-documented": (
        "from torchft_tpu_torch.utils.env import env_int\n"
        'x = env_int("TORCHFT_DOCUMENTED_THING", 1)\n'
    ),
    "external-allowlisted": (
        "from torchft_tpu_torch.utils.env import env_str\n"
        'x = env_str("OTEL_EXPORTER_OTLP_ENDPOINT")\n'
    ),
    "const-resolution": (
        "from torchft_tpu_torch.utils.env import env_str\n"
        'KNOB = "TORCHFT_DOCUMENTED_THING"\n'
        "x = env_str(KNOB)\n"
    ),
}


def _run_on_source(src: str) -> "List[Finding]":
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        os.makedirs(os.path.join(td, "docs"))
        with open(os.path.join(td, "docs", "knobs.md"), "w", encoding="utf-8") as fh:
            fh.write("| `TORCHFT_DOCUMENTED_THING` | a documented knob |\n")
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
    doc="env reads go through utils/env.py helpers, are TORCHFT_*-named "
    "(or allowlisted externals), and appear in the docs knob tables",
    run=run,
    selftest=selftest,
)
