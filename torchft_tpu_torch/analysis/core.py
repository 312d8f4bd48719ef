"""Shared machinery for the tft-lint passes: findings, the project
model, baselines, and the runner.

Design constraints (mirrors the rest of the package): stdlib only — the
passes are ``ast`` walkers, not plugins to an external linter, so the
suite runs anywhere the package imports, including CI images with no
dev-tooling layer.

A **pass** is an object with ``id``/``doc``, a ``run(project)`` returning
:class:`Finding` objects, and a ``selftest()`` that runs the pass over
embedded bad/good snippets — the suite distrusts itself first
(``tft-lint --selftest``; tier-1 runs it via tests/test_torch_lint.py).

**Baselines** grandfather pre-existing findings: one fingerprint per
line in ``torchft_tpu_torch/analysis/baselines/<pass>.txt``.  Fingerprints are
line-number-free (pass id, code, file, symbol, message hash) so an
unrelated edit above a grandfathered finding doesn't churn the file.
The shipped baselines are **empty** — every finding the passes surface
was fixed in the PR that introduced them — and the intent is they stay
that way: ``--write-baseline`` exists for incremental adoption of future
passes, not as an escape hatch.
"""

from __future__ import annotations

import ast
import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "Project",
    "LintPass",
    "SelftestError",
    "load_baseline",
    "write_baseline",
    "run_passes",
]


@dataclass(frozen=True)
class Finding:
    """One violation of a project invariant."""

    pass_id: str
    code: str  # stable short slug, e.g. "sleep-under-lock"
    file: str  # path relative to the project root
    line: int
    message: str
    symbol: str = ""  # enclosing qualname / metric name / env knob

    def fingerprint(self) -> str:
        """Line-number-free identity used by baseline files."""
        digest = hashlib.sha256(self.message.encode()).hexdigest()[:8]
        return f"{self.pass_id}:{self.code}:{self.file}:{self.symbol}:{digest}"

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.file}:{self.line}: {self.pass_id}/{self.code}{sym}: {self.message}"


class Project:
    """The analyzed tree: parsed sources plus the docs corpus.

    ``root`` is the directory that holds the docs (``README.md``,
    ``docs/*.md``); source files are the ``.py`` files under the target
    paths.  Parse failures surface as findings (code ``parse-error``)
    rather than exceptions so one broken file doesn't hide every other
    result.
    """

    def __init__(self, root: str, py_files: "Sequence[str]") -> None:
        self.root = os.path.abspath(root)
        self.py_files = sorted(os.path.abspath(f) for f in py_files)
        self._asts: "Dict[str, Optional[ast.Module]]" = {}
        self._sources: "Dict[str, str]" = {}
        self._docs: "Optional[str]" = None
        self.parse_errors: "List[Finding]" = []

    @classmethod
    def from_paths(cls, paths: "Sequence[str]", root: "Optional[str]" = None) -> "Project":
        """Build from files and/or directories (recursed for ``.py``).
        The root (docs anchor) is auto-detected by walking up from the
        first path to a directory containing ``docs`` or ``README.md``."""
        files: "List[str]" = []
        for p in paths:
            if os.path.isdir(p):
                for dirpath, dirnames, filenames in os.walk(p):
                    dirnames[:] = [
                        d for d in dirnames
                        if d not in ("__pycache__", ".git", "baselines")
                    ]
                    files.extend(
                        os.path.join(dirpath, f)
                        for f in filenames
                        if f.endswith(".py")
                    )
            elif p.endswith(".py"):
                files.append(p)
        if root is None:
            probe = os.path.abspath(paths[0] if paths else os.getcwd())
            if os.path.isfile(probe):
                probe = os.path.dirname(probe)
            root = probe
            while True:
                if os.path.isdir(os.path.join(root, "docs")) or os.path.isfile(
                    os.path.join(root, "README.md")
                ):
                    break
                parent = os.path.dirname(root)
                if parent == root:
                    root = probe  # no docs anywhere above: degrade quietly
                    break
                root = parent
        return cls(root, files)

    # -- accessors ---------------------------------------------------------

    def rel(self, path: str) -> str:
        try:
            return os.path.relpath(path, self.root)
        except ValueError:
            return path

    def source(self, path: str) -> str:
        if path not in self._sources:
            with open(path, encoding="utf-8") as fh:
                self._sources[path] = fh.read()
        return self._sources[path]

    def tree(self, path: str) -> "Optional[ast.Module]":
        """Parsed AST, or None (a ``parse-error`` finding is recorded)."""
        if path not in self._asts:
            try:
                self._asts[path] = ast.parse(self.source(path), filename=path)
            except (SyntaxError, OSError, UnicodeDecodeError) as e:
                self._asts[path] = None
                self.parse_errors.append(
                    Finding(
                        pass_id="core",
                        code="parse-error",
                        file=self.rel(path),
                        line=getattr(e, "lineno", 0) or 0,
                        message=f"could not parse: {e}",
                    )
                )
        return self._asts[path]

    def find_file(self, suffix: str) -> "Optional[str]":
        """The analyzed file whose normalized path ends with ``suffix``."""
        norm = suffix.replace("\\", "/")
        for f in self.py_files:
            if f.replace("\\", "/").endswith(norm):
                return f
        return None

    def docs_text(self) -> str:
        """README.md + docs/*.md concatenated (the knob/metric/fault-site
        tables live there); empty when the project has no docs."""
        if self._docs is None:
            chunks: "List[str]" = []
            for cand in [os.path.join(self.root, "README.md")]:
                if os.path.isfile(cand):
                    with open(cand, encoding="utf-8") as fh:
                        chunks.append(fh.read())
            docdir = os.path.join(self.root, "docs")
            if os.path.isdir(docdir):
                for name in sorted(os.listdir(docdir)):
                    if name.endswith(".md"):
                        with open(os.path.join(docdir, name), encoding="utf-8") as fh:
                            chunks.append(fh.read())
            self._docs = "\n".join(chunks)
        return self._docs

    def doc_text_for(self, relpath: str) -> str:
        """One specific doc file's text ('' when absent)."""
        cand = os.path.join(self.root, relpath)
        if os.path.isfile(cand):
            with open(cand, encoding="utf-8") as fh:
                return fh.read()
        return ""


class SelftestError(AssertionError):
    """A pass failed its own selftest — the suite's results are void."""


@dataclass
class LintPass:
    """One registered pass.  ``run`` yields findings over a Project;
    ``selftest`` raises :class:`SelftestError` on miss."""

    id: str
    doc: str
    run: "object" = None  # Callable[[Project], Iterable[Finding]]
    selftest: "object" = None  # Callable[[], None]


# ---------------------------------------------------------------------------
# AST helpers shared by the passes
# ---------------------------------------------------------------------------


def dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression ('' when not name-like):
    ``os.environ.get`` -> "os.environ.get", ``self._lock`` -> "self._lock"."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        return dotted(node.func)
    return ""


def const_str(node: "Optional[ast.AST]") -> "Optional[str]":
    """The value of a string-constant expression, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def module_str_constants(tree: ast.Module) -> "Dict[str, str]":
    """Module-level ``NAME = "literal"`` assignments (one level, no
    reassignment tracking) — lets passes resolve ``env_str(SOME_CONST)``."""
    out: "Dict[str, str]" = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            val = const_str(node.value)
            if isinstance(tgt, ast.Name) and val is not None:
                out[tgt.id] = val
    return out


class QualnameVisitor(ast.NodeVisitor):
    """Base visitor that tracks the enclosing class/function qualname."""

    def __init__(self) -> None:
        self._stack: "List[str]" = []

    @property
    def qualname(self) -> str:
        return ".".join(self._stack)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:  # noqa: N802
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    def _visit_func(self, node: ast.AST) -> None:
        self._stack.append(node.name)  # type: ignore[attr-defined]
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_func  # noqa: N815
    visit_AsyncFunctionDef = _visit_func  # noqa: N815


# ---------------------------------------------------------------------------
# baselines + runner
# ---------------------------------------------------------------------------


def default_baseline_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baselines")


def load_baseline(pass_id: str, baseline_dir: "Optional[str]" = None) -> "frozenset[str]":
    path = os.path.join(baseline_dir or default_baseline_dir(), f"{pass_id}.txt")
    if not os.path.isfile(path):
        return frozenset()
    with open(path, encoding="utf-8") as fh:
        return frozenset(
            line.strip()
            for line in fh
            if line.strip() and not line.lstrip().startswith("#")
        )


def write_baseline(
    pass_id: str, findings: "Iterable[Finding]", baseline_dir: "Optional[str]" = None
) -> str:
    bdir = baseline_dir or default_baseline_dir()
    os.makedirs(bdir, exist_ok=True)
    path = os.path.join(bdir, f"{pass_id}.txt")
    lines = sorted({f.fingerprint() for f in findings})
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(
            f"# Grandfathered findings for the {pass_id!r} pass.\n"
            f"# One fingerprint per line; regenerate with tft-lint --write-baseline.\n"
            f"# Target state: empty.\n"
        )
        for line in lines:
            fh.write(line + "\n")
    return path


@dataclass
class PassResult:
    lint_pass: LintPass
    findings: "List[Finding]" = field(default_factory=list)  # non-baselined
    baselined: int = 0


def run_passes(
    passes: "Sequence[LintPass]",
    project: Project,
    baseline_dir: "Optional[str]" = None,
) -> "List[PassResult]":
    results: "List[PassResult]" = []
    for lp in passes:
        found = list(lp.run(project))  # type: ignore[operator]
        base = load_baseline(lp.id, baseline_dir)
        fresh = [f for f in found if f.fingerprint() not in base]
        results.append(
            PassResult(lp, findings=fresh, baselined=len(found) - len(fresh))
        )
    if project.parse_errors:
        results.insert(
            0,
            PassResult(
                LintPass(id="core", doc="source files must parse"),
                findings=list(project.parse_errors),
            ),
        )
    return results
