"""bf16 tensors through every op of the port's TCP process group.

The JAX package's ``ProcessGroupTCP`` moves ``ml_dtypes`` bf16 arrays
through every op.  The port carries a bf16 tensor as its 16-bit patterns
(never converted) in the ops that only move data, and widens it exactly to
f32 in the reducing ones.  At world 2 each op's result must be bitwise
equal to the JAX group's on the same bits.
"""

from concurrent.futures import ThreadPoolExecutor

import ml_dtypes
import numpy as np
import pytest
import torch

from torchft_tpu.coordination import StoreServer as JaxStore
from torchft_tpu.parallel.process_group import ProcessGroupTCP as JaxPG
from torchft_tpu_torch.coordination import StoreServer
from torchft_tpu_torch.parallel.process_group import (
    REDUCE_AVG,
    REDUCE_SUM,
    ProcessGroupDummy,
    ProcessGroupTCP,
)

WORLD = 2
BF16 = np.dtype(ml_dtypes.bfloat16)


def _bits(rank, i=0, shape=(6, 5)):
    rng = np.random.default_rng(10 * rank + i)
    return (rng.standard_normal(shape) * 3).astype(BF16).view(np.uint16)


def _jax_arr(rank, i=0, shape=(6, 5)):
    return _bits(rank, i, shape).view(BF16)


def _tensor(rank, i=0, shape=(6, 5)):
    return torch.from_numpy(_bits(rank, i, shape).view(np.int16)).view(torch.bfloat16)


def _out_bits(x):
    if isinstance(x, list):
        return [_out_bits(a) for a in x]
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.view(torch.int16).numpy().view(np.uint16)
    assert x.dtype == BF16, x.dtype
    return np.asarray(x).view(np.uint16)


OPS = {
    "broadcast": lambda pg, r, a: pg.broadcast(a(r), root=1).wait(),
    "allgather": lambda pg, r, a: pg.allgather(a(r)).wait(),
    "reduce_scatter_sum": lambda pg, r, a: pg.reduce_scatter(a(r), REDUCE_SUM).wait(),
    "reduce_scatter_avg": lambda pg, r, a: pg.reduce_scatter(a(r), REDUCE_AVG).wait(),
    "alltoall": lambda pg, r, a: pg.alltoall([a(r, 0), a(r, 1)]).wait(),
    "sendrecv": lambda pg, r, a: pg.sendrecv(a(r), dst=1 - r, src=1 - r, tag=3).wait(),
    "send_recv": lambda pg, r, a: (
        pg.send(a(r), dst=1, tag=4).wait() if r == 0 else pg.recv(src=0, tag=4).wait()
    ),
}


def _run(pg_cls, store, op, arr):
    pgs = [pg_cls(timeout=20.0) for _ in range(WORLD)]
    with ThreadPoolExecutor(max_workers=WORLD) as ex:
        list(ex.map(
            lambda r: pgs[r].configure(f"{store.address()}/bf16", f"r{r}", r, WORLD),
            range(WORLD),
        ))
        try:
            return list(ex.map(lambda r: OPS[op](pgs[r], r, arr), range(WORLD)))
        finally:
            for pg in pgs:
                pg.shutdown()


@pytest.mark.parametrize("op", sorted(OPS))
def test_bf16_op_is_bitwise_equal_to_the_jax_group(op):
    jstore, tstore = JaxStore(), StoreServer()
    try:
        want = _run(JaxPG, jstore, op, _jax_arr)
        got = _run(ProcessGroupTCP, tstore, op, _tensor)
    finally:
        jstore.shutdown()
        tstore.shutdown()
    for r in range(WORLD):
        if want[r] is None:  # the send side
            assert got[r] is None
            continue
        w, g = _out_bits(want[r]), _out_bits(got[r])
        if isinstance(w, list):
            assert len(w) == len(g)
            for a, b in zip(w, g):
                np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_array_equal(g, w)


def test_bf16_passes_the_world_one_group():
    t = _tensor(0)
    dummy = ProcessGroupDummy()
    for out in (dummy.broadcast(t).wait(), dummy.allgather(t).wait()[0],
                dummy.reduce_scatter(t).wait(), dummy.alltoall([t]).wait()[0]):
        assert out.dtype == torch.bfloat16
        assert torch.equal(out.view(torch.int16), t.view(torch.int16))
