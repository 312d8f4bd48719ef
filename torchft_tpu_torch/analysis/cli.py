"""tft-torch-lint command line: run the project-invariant passes.

Exit codes: 0 clean (or everything baselined), 1 findings, 2 usage /
selftest failure.  ``python -m torchft_tpu_torch.analysis torchft_tpu_torch/``
is the CI form; the console script ``tft-torch-lint`` is the same entry
point.  Its output is tft-lint's, line for line.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

from torchft_tpu_torch.analysis import PASSES
from torchft_tpu_torch.analysis.core import (
    Project,
    SelftestError,
    run_passes,
    write_baseline,
)


def _select_passes(names: "Optional[str]") -> "List":
    if not names:
        return list(PASSES)
    wanted = [n.strip() for n in names.split(",") if n.strip()]
    by_id = {p.id: p for p in PASSES}
    unknown = [n for n in wanted if n not in by_id]
    if unknown:
        raise SystemExit(
            f"tft-lint: unknown pass(es) {unknown}; available: {sorted(by_id)}"
        )
    return [by_id[n] for n in wanted]


def main(argv: "Optional[Sequence[str]]" = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tft-torch-lint",
        description=(
            "torchft_tpu_torch project-invariant static analysis: lock "
            "discipline, env-knob hygiene, metrics/event sync, retry-loop "
            "ban, fault-site + flight-recorder coverage.  See "
            "docs/static_analysis.md."
        ),
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=["torchft_tpu_torch"],
        help="files/directories to analyze (default: torchft_tpu_torch)",
    )
    parser.add_argument(
        "--passes",
        help="comma-separated pass ids to run (default: all)",
    )
    parser.add_argument(
        "--list-passes", action="store_true", help="list passes and exit"
    )
    parser.add_argument(
        "--baseline-dir",
        default=None,
        help="directory of <pass>.txt fingerprint files "
        "(default: torchft_tpu_torch/analysis/baselines/)",
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="grandfather current findings into the baseline files and exit 0",
    )
    parser.add_argument(
        "--selftest",
        action="store_true",
        help="run every pass's embedded selftest (bad snippets flagged, "
        "good snippets clean) and exit",
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable findings"
    )
    args = parser.parse_args(argv)

    if args.list_passes:
        for p in PASSES:
            print(f"{p.id:18s} {p.doc}")
        return 0

    passes = _select_passes(args.passes)

    if args.selftest:
        failed = 0
        for p in passes:
            try:
                p.selftest()  # type: ignore[operator]
                print(f"selftest {p.id}: ok")
            except SelftestError as e:
                failed += 1
                print(f"selftest {p.id}: FAIL — {e}", file=sys.stderr)
        return 2 if failed else 0

    project = Project.from_paths(args.paths)
    if not project.py_files:
        print(f"tft-lint: no .py files under {args.paths}", file=sys.stderr)
        return 2

    if args.write_baseline:
        # grandfather the FULL finding set, pre-filter — writing only the
        # fresh findings would erase previously grandfathered fingerprints
        # on a re-run
        for p in passes:
            found = list(p.run(project))  # type: ignore[operator]
            path = write_baseline(p.id, found, baseline_dir=args.baseline_dir)
            print(f"wrote {len(found)} fingerprint(s) to {path}")
        return 0

    results = run_passes(passes, project, baseline_dir=args.baseline_dir)

    total = 0
    if args.json:
        doc = {
            "files": len(project.py_files),
            "passes": {
                res.lint_pass.id: {
                    "findings": [
                        {
                            "code": f.code,
                            "file": f.file,
                            "line": f.line,
                            "symbol": f.symbol,
                            "message": f.message,
                            "fingerprint": f.fingerprint(),
                        }
                        for f in res.findings
                    ],
                    "baselined": res.baselined,
                }
                for res in results
            },
        }
        total = sum(len(r.findings) for r in results)
        print(json.dumps(doc, indent=2))
    else:
        for res in results:
            for f in sorted(res.findings, key=lambda f: (f.file, f.line)):
                print(f.render())
            total += len(res.findings)
        baselined = sum(r.baselined for r in results)
        summary = (
            f"tft-lint: {total} finding(s) across {len(results)} pass(es), "
            f"{len(project.py_files)} file(s)"
        )
        if baselined:
            summary += f" ({baselined} baselined)"
        print(summary)
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())
