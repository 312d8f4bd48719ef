"""Wall times of single ``chip_smoke.py`` phases, tree against tree, on one card.

    python3 tools/phase_walls.py --phase pp_path \\
        --tree P=_parent --tree C=. --order P,C,C,P --out build/phase_walls

Each run is a fresh ``python3`` process in the root of its tree: it builds
that tree's kernels, then calls that tree's ``chip_smoke.<phase>()`` with
its defaults, as ``chip_smoke.main`` does, and reports the call's wall.
Around each run this script reads the CPU seconds of the processes the run
waited for (the run and every child it reaped) and the host's CPU time by
kind from ``/proc/stat`` (user, system, idle, steal), so a slower run can be
told apart as more work or as a busier host.

``--listener-reverted SRC DST`` first copies the tree ``SRC`` to ``DST``
with the coordinator hand-off undone: process 0 closes the socket its
harness bound and its ``TCPStore`` binds the port itself, as a store did
before the hand-off.  ``DST`` is then a tree like any other.

Each run's output goes to ``<out>/<tree>_<i>.log``; one JSON line a run,
then one a tree (the median wall), go to stdout and ``<out>/walls.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import statistics
import subprocess
import sys
import time

_RUN = """
import json, sys, time
sys.path.insert(0, ".")
import chip_smoke
from torchft_tpu_torch import _kernels
_kernels.build()
phase = getattr(chip_smoke, sys.argv[1])
t0 = time.perf_counter()
phase()
print("PHASE_WALL " + json.dumps({"wall_s": time.perf_counter() - t0}), flush=True)
"""

#: the line of ``torchft_tpu_torch/parallel/multihost.py`` that hands process
#: 0's listener to its store, and what ``--listener-reverted`` puts there
_HANDOFF = "master_listen_fd=None if listener is None else listener.detach(),"
_REVERTED = "master_listen_fd=listener and listener.close(),  # binds the port itself"


def listener_reverted(src: str, dst: str) -> None:
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        ".git", "build", "_parent", "_checkout", "_variant*", "__pycache__"))
    path = os.path.join(dst, "torchft_tpu_torch", "parallel", "multihost.py")
    with open(path) as f:
        text = f.read()
    assert text.count(_HANDOFF) == 1, f"{path}: no single hand-off line to revert"
    with open(path, "w") as f:
        f.write(text.replace(_HANDOFF, _REVERTED))


def host_cpu() -> dict:
    """The host's CPU seconds by kind since boot (``/proc/stat``)."""
    with open("/proc/stat") as f:
        fields = [int(v) for v in f.readline().split()[1:]]
    hz = os.sysconf("SC_CLK_TCK")
    names = ("user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal")
    return {n: v / hz for n, v in zip(names, fields)}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(name: str, root: str, phase: str, log_path: str, timeout: float) -> dict:
    cpu0, ru0, t0 = host_cpu(), resource.getrusage(resource.RUSAGE_CHILDREN), time.monotonic()
    with open(log_path, "w") as log:
        proc = subprocess.run([sys.executable, "-c", _RUN, phase],
                              cwd=root, stdout=log, stderr=subprocess.STDOUT, timeout=timeout)
    total = time.monotonic() - t0
    cpu1, ru1 = host_cpu(), resource.getrusage(resource.RUSAGE_CHILDREN)
    wall = None
    with open(log_path) as f:
        for line in f:
            if line.startswith("PHASE_WALL "):
                wall = json.loads(line[len("PHASE_WALL "):])["wall_s"]
    host = {k: cpu1[k] - cpu0[k] for k in ("user", "system", "idle", "steal")}
    return {"tree": name, "phase": phase, "rc": proc.returncode, "wall_s": wall,
            "process_s": total,
            "cpu_s": (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime),
            "host_s": host}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phase", required=True, help="a chip_smoke function, e.g. pp_path")
    p.add_argument("--tree", action="append", default=[],
                   help="NAME=DIR, a tree to run the phase of")
    p.add_argument("--order", required=True, help="tree names, comma-separated, in run order")
    p.add_argument("--listener-reverted", nargs=2, metavar=("SRC", "DST"))
    p.add_argument("--out", default="build/phase_walls")
    p.add_argument("--timeout", type=float, default=1200.0, help="seconds a run may take")
    args = p.parse_args(argv)

    if args.listener_reverted:
        listener_reverted(*args.listener_reverted)
    trees = {name: os.path.abspath(root)
             for name, _, root in (spec.partition("=") for spec in args.tree)}
    os.makedirs(args.out, exist_ok=True)
    print(f"card: {card()}", flush=True)
    rows, failed = [], False
    with open(os.path.join(args.out, "walls.jsonl"), "a") as out:
        for i, name in enumerate(args.order.split(",")):
            row = run(name, trees[name], args.phase,
                      os.path.join(args.out, f"{name}_{i}.log"), args.timeout)
            row["order"] = i
            rows.append(row)
            failed |= row["rc"] != 0 or row["wall_s"] is None
            print(json.dumps(row), flush=True)
            out.write(json.dumps(row) + "\n")
        for name in trees:
            walls = [r["wall_s"] for r in rows if r["tree"] == name and r["wall_s"] is not None]
            if walls:
                summary = {"tree": name, "phase": args.phase, "walls_s": walls,
                           "median_wall_s": statistics.median(walls)}
                print(json.dumps(summary), flush=True)
                out.write(json.dumps(summary) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
