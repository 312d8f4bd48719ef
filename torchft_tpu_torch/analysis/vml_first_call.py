"""Reproduce the first-call rounding of MKL's vector math under CPU load.

``python -m torchft_tpu_torch.analysis.vml_first_call [--processes 90]``
starts two busy 8-thread matmul loops, then fresh processes a few at a
time.  Each process runs on two torch threads: one MKL matmul, then the
attention twins' forward and dK/dV (kernels A and B's plain versions),
each called four times, then ``torch.exp`` four times on a score-shaped
tensor.  A process whose first call differs from its last is counted
against that function.  The twins take their exponentials from
:mod:`torchft_tpu_torch.ops.softmax_math` and should count 0; the
``torch.exp`` control counts the processes in which the first call into
MKL's vector math rounded one thread's share differently.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

_BUSY = """
import time, torch
torch.set_num_threads(8)
a = torch.randn(2000, 2000)
t0 = time.time()
while time.time() - t0 < {secs}:
    a @ a
"""

_CHILD = """
import json, sys
import numpy as np
import torch
from torchft_tpu_torch.ops import flash_attention as fa

torch.set_num_threads({threads})
rng = np.random.default_rng(5)
q, k, v, do = (torch.from_numpy(rng.standard_normal((8, 128, 64)).astype(np.float32))
               for _ in range(4))
s = torch.matmul(q, k.transpose(1, 2)) * 0.125
s = s - s.amax(-1, keepdim=True)

def fwd():
    return fa.flash_fwd_plain(q, k, v, 0.125, True)

def bwd():
    o, lse = fa.flash_fwd_plain(q, k, v, 0.125, True)
    return fa.flash_bwd_kv_plain(q, k, v, do, lse, (do * o).sum(-1), 0.125, True)

def control():
    return (torch.exp(s),)

out = {{}}
for name, f in (("flash_fwd_plain", fwd), ("flash_bwd_kv_plain", bwd),
                ("torch.exp", control)):
    first, *rest = [f() for _ in range(4)]
    out[name] = max(float((a - b).abs().max()) for a, b in zip(first, rest[-1]))
print(json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int, default=90)
    ap.add_argument("--parallel", type=int, default=3)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args(argv)
    busy = [subprocess.Popen([sys.executable, "-c", _BUSY.format(secs=3600)])
            for _ in range(2)]
    counts: "dict[str, int]" = {}
    worst: "dict[str, float]" = {}
    t0 = time.time()
    try:
        time.sleep(2.0)
        done = 0
        while done < args.processes:
            n = min(args.parallel, args.processes - done)
            children = [
                subprocess.Popen(
                    [sys.executable, "-c", _CHILD.format(threads=args.threads)],
                    stdout=subprocess.PIPE, text=True)
                for _ in range(n)
            ]
            for c in children:
                out, _ = c.communicate()
                if c.returncode != 0:
                    raise RuntimeError(f"a child process exited with {c.returncode}")
                for name, err in json.loads(out.strip().splitlines()[-1]).items():
                    counts[name] = counts.get(name, 0) + (err > 0)
                    worst[name] = max(worst.get(name, 0.0), err)
            done += n
    finally:
        for b in busy:
            b.kill()
            b.wait()
    print(json.dumps({
        "processes": args.processes, "threads": args.threads,
        "first_call_differs": counts, "worst_abs_diff": worst,
        "seconds": time.time() - t0,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
