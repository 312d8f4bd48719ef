"""Context parallelism across four processes, as on four cards.

Four spawned processes form a cp = 4 inner mesh through
``initialize_multihost`` over a TCPStore and run ring attention on their
chunks: over gloo on the CPU (the rehearsal, which runs here), and over
NCCL on four cards, one each (``cuda``-marked; on the card:
``python3 -m pytest tests/test_torch_cp_processes.py -m cuda -q`` on a
machine with four cards).  This file imports no JAX, so that the spawned
processes, which import it, start quickly.
"""

import multiprocessing as mp
import queue

import numpy as np
import pytest
import torch

from torchft_tpu_torch.parallel import device_mesh as tdm
from torchft_tpu_torch.parallel import multihost


def _rank(rank, addr, backend, shape, inputs, results):
    """One of four spawned processes: the inner mesh ``shape`` from
    ``initialize_multihost`` (gloo on the CPU, NCCL with a card each), ring
    attention over its cp axis on its chunk (flash route) and its
    gradients, and a psum over every axis; the results go to the parent on
    ``results``."""
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.ops import ring_attention as tra

    try:
        dev = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        address, listener = addr  # rank 0 gets the socket the parent bound
        world = multihost.initialize_multihost(
            address, 4, rank, timeout=120.0, listener=listener)
        assert world.backend == backend, world.backend
        mesh = tdm.ft_init_device_mesh(None, shape, groups=world, device=dev).mesh
        q, k, v, w = (torch.from_numpy(x) for x in inputs)
        chunk, cp = mesh.axis_index("cp"), mesh.axis_size("cp")
        tl = q.shape[1] // cp
        sl = slice(chunk * tl, (chunk + 1) * tl)
        ins = [x[:, sl].to(dev, dtype).requires_grad_() for x in (q, k, v)]
        out = tra.ring_attention(*ins, mesh)
        (out.float() * w[:, sl].to(dev)).sum().backward()
        total = torch.tensor([rank + 1.0], device=dev)
        mesh.psum_([total])
        # numpy arrays, pickled by value: a tensor on a multiprocessing
        # queue is shared through a file descriptor that dies with its process
        results.put((rank, chunk, out.detach().float().cpu().numpy(),
                     [x.grad.float().cpu().numpy() for x in ins],
                     total.item(), mesh.axis("cp").transport(dev),
                     fa.flash_fwd.launches, fa.flash_bwd_q.offset_launches))
    except BaseException:  # noqa: BLE001 - reported to the parent
        import traceback

        results.put((rank, traceback.format_exc()))
        raise


@pytest.mark.parametrize("backend,shape", [
    ("gloo", {"cp": 4}),
    pytest.param("nccl", {"cp": 4}, marks=pytest.mark.cuda),
    pytest.param("nccl", {"dp": 2, "cp": 2}, marks=pytest.mark.cuda),
], ids=["gloo-cp4", "nccl-cp4", "nccl-dp2-cp2"])
def test_ring_attention_across_four_processes(backend, shape):
    """Four spawned processes, the in-group groups built by
    ``initialize_multihost`` over a TCPStore: gloo on the CPU (the
    rehearsal), NCCL on four cards, one each (CUDA tensors go to NCCL as
    they are; A, B and C run at ring offsets; cp = 2 is the ring whose send
    and receive go to one peer).  Every dp row computes the whole
    sequence.  Held to the port's plain dense attention in f32:
    ``atol=2e-5`` on the CPU; on the card the kernels' bf16 bound of
    chip_smoke.py (max error over max magnitude 2e-2)."""
    if backend == "nccl":
        if torch.cuda.device_count() < 4:
            pytest.skip("needs four CUDA cards")
        from torchft_tpu_torch import _kernels

        _kernels.build()  # once, before the four processes load it
    from torchft_tpu_torch.ops import ring_attention as tra

    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 512, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 512, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 512, 2, 64)).astype(np.float32)
    w = rng.standard_normal(q.shape).astype(np.float32) / q.size
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    addr, listener = multihost.coordinator_listener()
    procs = [ctx.Process(target=_rank, args=(r, (addr, listener if r == 0 else None), backend,
                                             shape, (q, k, v, w), results),
                         daemon=True) for r in range(4)]
    for p in procs:
        p.start()
    listener.close()  # rank 0 holds its own copy
    got = {}
    try:
        while len(got) < 4:
            try:
                msg = results.get(timeout=2.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                assert not dead, f"a process died: {dead}"
                continue
            assert len(msg) > 2, f"rank {msg[0]} failed:\n{msg[1]}"
            got[msg[0]] = msg[1:]
        for p in procs:
            p.join(60.0)
            assert p.exitcode == 0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ref = tra.dense_attention(tq, tk, tv, causal=True)
    (ref * torch.from_numpy(w)).sum().backward()
    cp = shape["cp"]
    rows = [sorted((got[r] for r in range(4) if r // cp == row), key=lambda m: m[0])
            for row in range(4 // cp)]
    for row in rows[1:]:  # every dp row computed the same chunks
        for a, b in zip(row, rows[0]):
            assert a[0] == b[0] and np.array_equal(a[1], b[1])
    out = torch.from_numpy(np.concatenate([m[1] for m in rows[0]], axis=1))
    grads = [torch.from_numpy(np.concatenate([m[2][i] for m in rows[0]], axis=1))
             for i in range(3)]
    for r in range(4):
        assert got[r][3] == 10.0  # 1 + 2 + 3 + 4
    if backend == "gloo":
        torch.testing.assert_close(out, ref.detach(), atol=2e-5, rtol=1e-5)
        for a, b in zip(grads, (tq.grad, tk.grad, tv.grad)):
            torch.testing.assert_close(a / b.abs().max(), b / b.abs().max(), atol=2e-5, rtol=0)
        return
    assert all(got[r][4] == "nccl" for r in range(4))  # no host staging
    assert all(got[r][5] > 0 and got[r][6] > 0 for r in range(4))  # kernels, at offsets
    for a, b in [(out, ref.detach())] + list(zip(grads, (tq.grad, tk.grad, tv.grad))):
        assert float((a - b).abs().max() / b.abs().max()) < 2e-2
