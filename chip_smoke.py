#!/usr/bin/env python3
"""Drive the PyTorch port (torchft_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), then the build of
   every CUDA kernel of the main path from ``torchft_tpu_torch/csrc``
   (one nvcc per source, all at once) into ``build/kernels``.
2. Kernel check: flash-attention kernels A (forward), B (dK, dV) and C (dQ)
   against their plain PyTorch twins on the same inputs — at the flagship's
   attention shapes (B=8, T=1024, 6 query heads over 3 KV heads expanded,
   D=256, bf16, causal), a small non-causal case, and offset cases where
   queries precede keys.  Times each kernel, its twin and the library
   yardstick (``scaled_dot_product_attention``, timed here only; the port
   never calls it), and computes each kernel's bound from the shapes.
3. Main path: a native lighthouse and two replica groups as threads on the
   card, each with a Manager, a ProcessGroupTCP, DistributedDataParallel and
   an OptimizerWrapper around AdamW, train the flagship transformer
   (d_model 1536, 16 layers, 6/3 heads of 256, d_ff 4096, vocab 32000,
   T=1024, B=8, bf16 compute, f32 parameters, flash attention) for three
   steps; one group then shuts down, restarts from a fresh init, heals over
   PGTransport and both train two more steps.  Every survivor step must
   commit, losses must be finite, the two groups must end bitwise equal,
   and every kernel must have launched (its twin never).

The last two lines are the kernels' JSON record and the device JSON.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


_print_lock = threading.Lock()


def log(msg: str) -> None:
    with _print_lock:  # replica groups log from their own threads
        print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def live_pairs(tq: int, tk: int, causal: bool, q_off: int = 0, k_off: int = 0) -> int:
    """(query, key) pairs the causal mask leaves live at these offsets."""
    if not causal:
        return tq * tk
    return sum(
        max(0, min(tk, q_off + i - k_off + 1)) for i in range(tq)
    )


def bound(ops: float, nbytes: float) -> "tuple[float, str]":
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def norm_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their twins
# ---------------------------------------------------------------------------


def check_kernels() -> "dict":
    import torch
    import torch.nn.functional as F

    from torchft_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g, dtype=torch.bfloat16)

    # flagship attention: B=8, T=1024, H=6 (3 KV heads expanded), D=256
    b, t, h, hkv, d = 8, 1024, 6, 3, 256
    q = randn(b, t, h, d)
    k = randn(b, t, hkv, d)
    v = randn(b, t, hkv, d)
    do = randn(b, t, h, d)
    k, v = fa._expand_gqa(k, v, h)
    q3, k3, v3, do3 = (fa._to3(x) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    bh = b * h

    o, lse = fa.flash_fwd(q3, k3, v3, scale, True)
    o_ref, lse_ref = fa.flash_fwd_plain(q3, k3, v3, scale, True)
    delta = (do3.float() * o.float()).sum(-1)
    dk, dv = fa.flash_bwd_kv(q3, k3, v3, do3, lse, delta, scale, True)
    dk_ref, dv_ref = fa.flash_bwd_kv_plain(q3, k3, v3, do3, lse, delta, scale, True)
    dq = fa.flash_bwd_q(q3, k3, v3, do3, lse, delta, scale, True)
    dq_ref = fa.flash_bwd_q_plain(q3, k3, v3, do3, lse, delta, scale, True)
    torch.cuda.synchronize()

    # Tolerances.  O is bf16: its rounding is 2^-9 relative, and the kernel
    # rounds p to bf16 against the running row max where the twin uses the
    # final one, so atol = rtol = 2e-2.  lse is f32 in both: only the order
    # of the f32 sums differs, so atol 1e-3.  dQ, dK, dV are bf16 sums of
    # up to 1024 bf16-rounded products: max error over max magnitude 2e-2.
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    errs = {
        "O": norm_err(o, o_ref), "lse": float((lse - lse_ref).abs().max()),
        "dQ": norm_err(dq, dq_ref), "dK": norm_err(dk, dk_ref),
        "dV": norm_err(dv, dv_ref),
    }
    for name in ("dQ", "dK", "dV"):
        assert errs[name] < 2e-2, (name, errs[name])
    assert all(torch.isfinite(x.float()).all() for x in (o, dq, dk, dv))
    log(f"kernel check, flagship shapes [BH={bh}, T={t}, D={d}] bf16 causal: "
        + ", ".join(f"{k_}={v_:.3e}" for k_, v_ in errs.items())
        + " (normalized max error; lse absolute)")
    max_abs = {
        "flash_fwd": float((o.float() - o_ref.float()).abs().max()),
        "flash_bwd_kv": max(
            float((dk.float() - dk_ref.float()).abs().max()),
            float((dv.float() - dv_ref.float()).abs().max()),
        ),
        "flash_bwd_q": float((dq.float() - dq_ref.float()).abs().max()),
    }

    # small non-causal case at another head dim
    qs, ks, vs, dos = (randn(4, 256, 64) for _ in range(4))
    o_s, lse_s = fa.flash_fwd(qs, ks, vs, 0.125, False)
    o_sr, lse_sr = fa.flash_fwd_plain(qs, ks, vs, 0.125, False)
    torch.testing.assert_close(o_s.float(), o_sr.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse_s, lse_sr, atol=1e-3, rtol=0)
    dl_s = (dos.float() * o_s.float()).sum(-1)
    args = (qs, ks, vs, dos, lse_s, dl_s, 0.125, False)
    assert norm_err(fa.flash_bwd_q(*args), fa.flash_bwd_q_plain(*args)) < 2e-2
    for a_, b_ in zip(fa.flash_bwd_kv(*args), fa.flash_bwd_kv_plain(*args)):
        assert norm_err(a_, b_) < 2e-2
    log("kernel check, [BH=4, T=256, D=64] bf16 non-causal: ok")

    # offsets: keys start at 64 (rows 0..63 see nothing), then at T (q
    # precedes every k: O must be exactly 0 and so must every gradient)
    qo, ko, vo, doo = (randn(4, 256, 256) for _ in range(4))
    for k_off in (64, 256):
        o_o, lse_o = fa.flash_fwd(qo, ko, vo, scale, True, 0, k_off)
        o_or, _ = fa.flash_fwd_plain(qo, ko, vo, scale, True, 0, k_off)
        rows = min(k_off, 256)
        assert torch.count_nonzero(o_o[:, :rows]) == 0
        assert bool((lse_o[:, :rows] < -1e20).all())
        torch.testing.assert_close(o_o.float(), o_or.float(), atol=2e-2, rtol=2e-2)
        dl_o = (doo.float() * o_o.float()).sum(-1)
        args = (qo, ko, vo, doo, lse_o, dl_o, scale, True, 0, k_off)
        dq_o = fa.flash_bwd_q(*args)
        dk_o, dv_o = fa.flash_bwd_kv(*args)
        assert torch.count_nonzero(dq_o[:, :rows]) == 0
        if k_off == 256:
            assert torch.count_nonzero(dk_o) == torch.count_nonzero(dv_o) == 0
        else:
            assert norm_err(dq_o, fa.flash_bwd_q_plain(*args)) < 2e-2
    log("kernel check, offsets (k_off=64, k_off=T): masked rows exactly 0, ok")

    # f32 is not a kernel type: the wrapper must raise, not fall back
    try:
        fa.flash_fwd(qs.float(), ks.float(), vs.float(), 0.125, False)
        raise AssertionError("flash_fwd accepted f32 CUDA tensors")
    except TypeError:
        log("kernel check, f32 CUDA tensors: raise TypeError (bf16 kernels)")

    # timings at the flagship shapes
    times = {
        "flash_fwd": (
            cuda_ms(lambda: fa.flash_fwd(q3, k3, v3, scale, True), 20),
            cuda_ms(lambda: fa.flash_fwd_plain(q3, k3, v3, scale, True), 3, 1),
        ),
        "flash_bwd_kv": (
            cuda_ms(lambda: fa.flash_bwd_kv(q3, k3, v3, do3, lse, delta, scale, True), 20),
            cuda_ms(lambda: fa.flash_bwd_kv_plain(q3, k3, v3, do3, lse, delta, scale, True), 3, 1),
        ),
        "flash_bwd_q": (
            cuda_ms(lambda: fa.flash_bwd_q(q3, k3, v3, do3, lse, delta, scale, True), 20),
            cuda_ms(lambda: fa.flash_bwd_q_plain(q3, k3, v3, do3, lse, delta, scale, True), 3, 1),
        ),
    }
    # library yardstick: SDPA forward, and its backward (dQ, dK and dV in
    # one call), on the same expanded [B, H, T, D] inputs
    lib_fwd = lib_bwd = None
    try:
        ql, kl, vl = (x.view(b, h, t, d).clone().requires_grad_() for x in (q3, k3, v3))
        dol = do3.view(b, h, t, d)
        lib_fwd = cuda_ms(
            lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True), 20
        )
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        lib_bwd = cuda_ms(
            lambda: torch.autograd.grad(out, (ql, kl, vl), dol, retain_graph=True), 20
        )
        del out, ql, kl, vl
    except Exception as e:  # noqa: BLE001 - a yardstick only
        log(f"library yardstick unavailable: {e!r}")
    log(f"library yardstick (scaled_dot_product_attention, not used by the "
        f"port): forward {lib_fwd} ms, backward {lib_bwd} ms")

    pairs = live_pairs(t, t, True) * bh
    elem = bh * t * d * 2  # one [BH, T, D] bf16 tensor
    stat = bh * t * 4  # one [BH, T] f32 vector
    bounds = {
        "flash_fwd": bound(4 * d * pairs, 4 * elem + stat),
        "flash_bwd_kv": bound(8 * d * pairs, 6 * elem + 2 * stat),
        "flash_bwd_q": bound(6 * d * pairs, 5 * elem + 2 * stat),
    }
    library = {"flash_fwd": lib_fwd, "flash_bwd_kv": lib_bwd, "flash_bwd_q": lib_bwd}
    for name, (ms, plain_ms) in times.items():
        log(f"  {name}: {ms:.4f} ms (plain twin {plain_ms:.4f} ms, bound "
            f"{bounds[name][0]:.4f} ms by {bounds[name][1]}, library "
            f"{library[name]} ms)")
    return {
        "max_abs": max_abs, "times": times, "bounds": bounds, "library": library,
    }


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def main_path(cfg=None, batch: int = 8, seq: int = 1024, device: str = "cuda") -> "dict":
    """Phase 3 at the flagship config; ``cfg``/``batch``/``seq``/``device``
    let a CPU rehearsal drive the same code at a tiny size."""
    import torch

    from torchft_tpu_torch import (
        DistributedDataParallel,
        Manager,
        OptimizerWrapper,
        PGTransport,
        ProcessGroupTCP,
        module_grads,
    )
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.models import transformer as tf

    if cfg is None:
        cfg = tf.TransformerConfig(
            vocab_size=32000, d_model=1536, n_heads=6, n_kv_heads=3, d_ff=4096,
            n_layers=16, max_seq_len=1024, dtype=torch.bfloat16,
            param_dtype=torch.float32, remat=False, attn_impl="flash",
        )
    total_steps, kill_at = 5, 3
    on_card = device == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    grad_step = tf.make_grad_step(cfg)
    # One card holds both replica groups: their forward/backward passes take
    # turns (the card would serialize them anyway), so the activations of
    # only one group are live at a time.
    compute = threading.Lock()

    def group(gid: int, seed: int, stop_at: int) -> dict:
        model = tf.init_params(torch.Generator().manual_seed(seed), cfg, device)
        opt = torch.optim.AdamW(
            model.parameters(), lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
            weight_decay=0.1,
        )

        def state_dict():
            return {"model": model.state_dict(), "optim": opt.state_dict()}

        def load_state_dict(sd):
            model.load_state_dict(sd["model"])
            opt.load_state_dict(sd["optim"])

        pg = ProcessGroupTCP(timeout=600.0)
        holder = {}
        manager = Manager(
            pg=pg, min_replica_size=1,
            load_state_dict=load_state_dict, state_dict=state_dict,
            lighthouse_addr=lighthouse.address(), replica_id=f"group{gid}",
            group_rank=0, group_world_size=1,
            checkpoint_transport=PGTransport(
                pg, timeout=600.0,
                state_dict_fn=lambda: holder["m"]._manager_state_dict(),
            ),
            use_async_quorum=False, timeout=600.0, quorum_timeout=600.0,
        )
        holder["m"] = manager
        optim = OptimizerWrapper(manager, opt)
        ddp = DistributedDataParallel(manager)
        steps = []
        try:
            while manager.current_step() < stop_at:
                step = manager.current_step()
                tokens = torch.randint(
                    0, cfg.vocab_size, (batch, seq),
                    generator=torch.Generator().manual_seed(1000 * gid + step),
                ).to(device)
                phases0 = manager.phase_times()
                t0 = time.perf_counter()
                optim.zero_grad()  # quorum (and heal, for a rejoiner)
                t1 = time.perf_counter()
                with compute:
                    loss, _ = grad_step(model, tokens)
                    sync()
                t2 = time.perf_counter()
                avg = ddp.allreduce_gradients(module_grads(model)).wait(timeout=600)
                committed = optim.step(model, avg)
                sync()
                t3 = time.perf_counter()
                phases = manager.phase_times()
                steps.append({
                    "group": gid, "step": step, "loss": float(loss),
                    "committed": committed, "step_ms": (t3 - t0) * 1e3,
                    "quorum_ms": (t1 - t0) * 1e3, "compute_ms": (t2 - t1) * 1e3,
                    "sync_ms": (t3 - t2) * 1e3,
                    "phases_ms": {
                        k: (phases.get(k, 0.0) - phases0.get(k, 0.0)) * 1e3
                        for k in phases
                        if phases.get(k, 0.0) - phases0.get(k, 0.0) > 0
                    },
                })
                log(f"  step {json.dumps(steps[-1])}")
            params = {
                n: p.detach().clone() for n, p in model.named_parameters()
            } if stop_at == total_steps else None
            return {
                "steps": steps, "phases": manager.phase_times(),
                "final_step": manager.current_step(), "params": params,
            }
        finally:
            manager.shutdown()

    lighthouse = LighthouseServer(
        min_replicas=2, join_timeout_ms=100, heartbeat_timeout_ms=5000
    )
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    # no `with`: on a failure, do not wait for a group blocked in a quorum
    ex = ThreadPoolExecutor(max_workers=3)
    try:
        survivor_f = ex.submit(group, 0, 0, total_steps)
        first = ex.submit(group, 1, 0, kill_at).result(timeout=1800)
        log(f"group1 shut down after step {first['final_step']}; "
            "restarting it from a fresh init")
        if on_card:
            torch.cuda.empty_cache()
        rejoiner = ex.submit(group, 1, 12345, total_steps).result(timeout=1800)
        survivor = survivor_f.result(timeout=1800)
    finally:
        ex.shutdown(wait=False)
        lighthouse.shutdown()
    wall = time.perf_counter() - t_start
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    losses = [s["loss"] for r in (survivor, first, rejoiner) for s in r["steps"]]
    assert all(math.isfinite(x) for x in losses), losses
    assert len(survivor["steps"]) == total_steps
    assert all(s["committed"] for s in survivor["steps"]), "survivor step failed"
    assert first["final_step"] == kill_at
    assert len(rejoiner["steps"]) == total_steps - kill_at
    assert rejoiner["final_step"] == survivor["final_step"] == total_steps
    assert rejoiner["phases"].get("heal_recv", 0.0) > 0.0, "rejoiner did not heal"
    assert survivor["phases"].get("heal_send", 0.0) > 0.0
    mismatched = [
        n for n, p in survivor["params"].items()
        if not torch.equal(p, rejoiner["params"][n])
    ]
    assert not mismatched, f"groups differ after heal: {mismatched[:5]}"
    log(f"main path: {total_steps} survivor steps all committed; rejoiner "
        f"healed and the two groups' {len(survivor['params'])} parameters "
        "are bitwise equal")
    step_ms = [s["step_ms"] for s in survivor["steps"]]
    summary = {
        "median_step_ms": statistics.median(step_ms),
        "median_compute_ms": statistics.median(
            s["compute_ms"] for s in survivor["steps"]
        ),
        "tokens_per_s_per_group": batch * seq / (statistics.median(step_ms) / 1e3),
        "survivor_phases_ms": {k: v * 1e3 for k, v in survivor["phases"].items()},
        "rejoiner_phases_ms": {k: v * 1e3 for k, v in rejoiner["phases"].items()},
        "peak_memory_gb": peak_gb,
        "wall_s": wall,
        "losses": losses,
    }
    return summary


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from torchft_tpu_torch import _kernels
        from torchft_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "root of a checkout", file=sys.stderr)
        return 1

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    build_s = _kernels.build()
    log(f"kernels built in {build_s:.1f} s")
    for name, out in _kernels.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")

    kernels = check_kernels()
    torch.cuda.empty_cache()

    counters = (fa.flash_fwd, fa.flash_bwd_kv, fa.flash_bwd_q)
    twins = (fa.flash_fwd_plain, fa.flash_bwd_kv_plain, fa.flash_bwd_q_plain)
    for fn in counters:
        fn.launches = 0
    for fn in twins:
        fn.calls = 0
    summary = main_path()
    launches = {fn.__name__: fn.launches for fn in counters}
    twin_calls = {fn.__name__: fn.calls for fn in twins}
    log(f"main path launches {launches}, plain twin calls {twin_calls}")
    assert all(n > 0 for n in launches.values()), launches
    assert all(n == 0 for n in twin_calls.values()), twin_calls
    log(f"main path on {card}: " + json.dumps(summary))

    sources = {
        "flash_fwd": ("torchft_tpu_torch/csrc/flash_fwd.cu",
                      "torchft_tpu/ops/flash_attention.py:67"),
        "flash_bwd_kv": ("torchft_tpu_torch/csrc/flash_bwd_kv.cu",
                         "torchft_tpu/ops/flash_attention.py:208"),
        "flash_bwd_q": ("torchft_tpu_torch/csrc/flash_bwd_q.cu",
                        "torchft_tpu/ops/flash_attention.py:254"),
    }
    record = {"kernels": [
        {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": kernels["max_abs"][name],
            "ms": kernels["times"][name][0],
            "plain_ms": kernels["times"][name][1],
            "bound_ms": kernels["bounds"][name][0],
            "bound_by": kernels["bounds"][name][1],
            "library_ms": kernels["library"][name],
        }
        for name, (src, rep) in sources.items()
    ]}
    log(f"card: {card}")
    log(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # the servers were shut down above; a failed phase may leave a thread
    # blocked in a quorum, which must not hold the exit
    os._exit(code)
