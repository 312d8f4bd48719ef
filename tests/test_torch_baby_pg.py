"""The port's subprocess-isolated process group against the references.

Counterpart of tests/test_baby_pg.py for ``torchft_tpu_torch``: ops run in
a spawned worker, a worker crash surfaces as a clean error in the parent,
reconfigure restarts the worker, and the parent always survives.  Beyond
the JAX package's cases, the port's Baby PG must return what the port's
``ProcessGroupTCP`` returns for the same inputs, bit for bit (bf16 leaves
included, on both sides of the 1 MiB shared-memory threshold), and what
the JAX package's Baby PG returns on the same seeded numpy inputs; and it
must leave no segment in ``/dev/shm``.

A worker is a spawned Python that imports torch (~3 s here), so the
configured pairs are shared across cases (module fixtures), and the cases
that break a pair run in order on one pair of their own.
"""

import glob
import multiprocessing as mp
import os
import signal
import time
from concurrent.futures import ThreadPoolExecutor

import ml_dtypes
import numpy as np
import pytest
import torch

from torchft_tpu_torch.coordination import StoreServer
from torchft_tpu_torch.multiprocessing import _MonitoredPipe
from torchft_tpu_torch.ops.collectives import allreduce_quantized
from torchft_tpu_torch.parallel import process_group as pg_mod
from torchft_tpu_torch.parallel.process_group import (
    REDUCE_SUM,
    ProcessGroupBabyTCP,
    ProcessGroupTCP,
)
from torchft_tpu_torch.utils.bufpool import POOL

#: each case's own time limit: a wedged worker fails the case, not the run
LIMIT_S = 120


@pytest.fixture(autouse=True)
def _time_limit():
    def expired(signum, frame):
        raise TimeoutError(f"case ran past its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _configure(pgs, store, prefix):
    with ThreadPoolExecutor(max_workers=len(pgs)) as ex:
        futs = [
            ex.submit(
                pgs[r].configure, f"{store.address()}/{prefix}", f"rank{r}", r,
                len(pgs),
            )
            for r in range(len(pgs))
        ]
        for f in futs:
            f.result(timeout=120)
    return pgs


def _both(fn):
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = [ex.submit(fn, r) for r in range(2)]
        return [f.result(timeout=120) for f in futs]


def _own_segments(pgs=None):
    """This process's Baby segments in /dev/shm (other test processes run
    their own beside it), or only those of ``pgs``."""
    names = glob.glob(f"/dev/shm/{pg_mod._shm_owner_prefix(os.getpid())}*")
    if pgs is None:
        return names
    return [n for n in names if any(f"_i{pg._token}_" in n or f"_o{pg._token}_" in n
                                    for pg in pgs)]


@pytest.fixture(scope="module")
def store():
    server = StoreServer()
    yield server
    server.shutdown()


@pytest.fixture(scope="module")
def baby(store):
    pgs = _configure([ProcessGroupBabyTCP(timeout=30.0) for _ in range(2)],
                     store, "baby")
    yield pgs
    for pg in pgs:
        pg.shutdown()
    assert _own_segments(pgs) == []


@pytest.fixture(scope="module")
def tcp(store):
    pgs = _configure([ProcessGroupTCP(timeout=30.0) for _ in range(2)],
                     store, "tcp")
    yield pgs
    for pg in pgs:
        pg.shutdown()


class TestMonitoredPipe:
    def test_roundtrip_timeout_exception_and_eof(self):
        a, b = mp.Pipe()
        pa, pb = _MonitoredPipe(a), _MonitoredPipe(b)
        pa.send({"x": 1})
        assert pb.recv(timeout=5) == {"x": 1}
        with pytest.raises(TimeoutError):
            pb.recv(timeout=0.2)
        pa.send(ValueError("shipped"))
        with pytest.raises(ValueError, match="shipped"):
            pb.recv(timeout=5)
        pa.close()
        with pytest.raises(EOFError):
            pb.recv(timeout=5)


def test_configure_failure_propagates_root_cause():
    pg = ProcessGroupBabyTCP(timeout=2.0)
    # unreachable store: the worker's configure error must surface in the
    # parent with the real cause, not a generic protocol error
    with pytest.raises(Exception) as exc_info:
        pg.configure("127.0.0.1:1/none", "rank0", 0, 2)
    # the worker's own error, naming the store it could not reach (not
    # the parent giving up on the pipe)
    assert not isinstance(exc_info.value, AssertionError)
    assert "127.0.0.1:1" in str(exc_info.value)
    assert "pipe recv" not in str(exc_info.value)
    assert pg.worker_pid() is None
    pg.shutdown()


def test_allreduce_and_broadcast(baby):
    res = _both(lambda r: baby[r].allreduce(
        [np.full(4, float(r + 1), np.float32)]).wait(timeout=30))
    for got in res:
        np.testing.assert_array_equal(got[0], np.full(4, 3.0, np.float32))
    res = _both(lambda r: baby[r].broadcast(
        np.arange(4, dtype=np.float32) if r == 0 else np.zeros(4, np.float32),
        root=0).wait(timeout=30))
    for got in res:
        np.testing.assert_array_equal(got, np.arange(4, dtype=np.float32))


def test_pipelined_ops_preserve_order(baby):
    # two collectives without a wait in between: the worker enqueues them
    # in pipe order, so the ranks' streams match
    def run(r):
        w1 = baby[r].allreduce([np.full(4, 1.0 + r, np.float32)])
        w2 = baby[r].allreduce([np.full(2, 10.0 * (1 + r), np.float32)])
        return w1.wait(timeout=30), w2.wait(timeout=30)

    for r1, r2 in _both(run):
        np.testing.assert_array_equal(r1[0], np.full(4, 3.0, np.float32))
        np.testing.assert_array_equal(r2[0], np.full(2, 30.0, np.float32))


@pytest.mark.parametrize("sizes", [(2 * 1024 * 1024,), (16, 512 * 1024)],
                         ids=["large", "mixed"])
def test_shm_leaves_are_correct_and_segments_are_reused(baby, sizes):
    """Leaves of 1 MiB or more cross as shared-memory segments, the rest
    pickled; results match the direct math exactly.  A segment goes back
    to the PG's pool once its result is dropped (the next op of its size
    writes warm pages), and never while the caller holds the result."""
    def run(scale):
        data = [[np.full(n, scale * (1.0 + r), np.float32) for n in sizes]
                for r in range(2)]
        return _both(lambda r: baby[r].allreduce(data[r], "sum").wait(timeout=60))

    before = baby[0].stats["shm_in_bytes"]
    held = run(1.0)
    assert baby[0].stats["shm_in_bytes"] - before == sizes[-1] * 4
    named = set(_own_segments(baby))
    again = run(2.0)  # the first results are still held: new segments
    assert set(_own_segments(baby)) > named
    for got, more in zip(held, again):
        for g, h, n in zip(got, more, sizes):
            np.testing.assert_array_equal(g, np.full(n, 3.0, np.float32))
            np.testing.assert_array_equal(h, np.full(n, 6.0, np.float32))
    del held, again, got, more, g, h
    named = set(_own_segments(baby))
    run(3.0)  # every segment is free again: none is made
    assert set(_own_segments(baby)) == named


@pytest.mark.parametrize("derive", ["reshape", "from_numpy", "bf16"])
def test_a_view_of_a_result_keeps_its_segment_out_of_the_pool(baby, derive):
    """Only the caller's last view of a result gives its segment back:
    a reshape of it, a tensor made by ``torch.from_numpy``, or a view of a
    bf16 result keeps the segment held, and the next op of its size stages
    into a new one; once the view goes, the segment is reused."""
    import gc

    n = 1 << 20

    def leaf(r, scale):
        if derive == "bf16":
            return torch.full((n,), scale * (1.0 + r), dtype=torch.bfloat16)
        return np.full(n, scale * (1.0 + r), np.float32)

    def run(scale):
        return _both(lambda r: baby[r].allreduce([leaf(r, scale)], "sum")
                     .wait(timeout=60)[0])

    views = {
        "reshape": lambda x: x.reshape(2, -1)[1],
        "from_numpy": lambda x: torch.from_numpy(x[1:]),
        "bf16": lambda x: x.view(2, -1)[1],
    }[derive]
    def value(k):
        return np.asarray(k.float() if isinstance(k, torch.Tensor) else k)

    run(1.0)  # the size's segments exist and are free
    gc.collect()
    kept = [views(x) for x in run(2.0)]
    gc.collect()
    held = [set(pg._held) for pg in baby]
    assert all(held)  # each PG holds the segment behind its view
    run(3.0)  # must stage into other segments than the held ones
    gc.collect()
    for k in kept:
        assert np.all(value(k) == 6.0)
    for pg, h in zip(baby, held):
        assert h <= set(pg._held)
    named = set(_own_segments(baby))
    del kept, k
    gc.collect()
    run(4.0)  # every segment is free again: none is made
    assert set(_own_segments(baby)) == named


def test_backpressure_bounds_inflight_ops(baby):
    """max_active_work caps queued ops; submissions past the cap wait and
    everything still completes in order."""
    for pg in baby:
        pg._max_active_work = 2
    try:
        def run(r):
            works = [
                baby[r].allreduce([np.full(1024, float(i), np.float32)], "sum")
                for i in range(8)
            ]
            return [w.wait(timeout=60)[0][0] for w in works]

        for vals in _both(run):
            assert vals == [2.0 * i for i in range(8)]
    finally:
        for pg in baby:
            pg._max_active_work = 16


def test_quantized_allreduce_over_baby(baby):
    """The int8 quantized allreduce composes with the subprocess-isolated
    backend: packed wire buffers cross as pickles or segments, and the
    collective's pool recycling takes no shared-memory view (the pool
    keeps only arrays that own their memory)."""
    data = [np.full(60_000, 1.0 + r, dtype=np.float32) for r in range(2)]
    expected = np.full(60_000, 3.0, dtype=np.float32)
    for _round in range(2):
        # a wrongly recycled buffer of round one would corrupt round two
        res = _both(lambda r: allreduce_quantized(
            [data[r]], REDUCE_SUM, baby[r]).wait(timeout=60))
        for (got,) in res:
            assert np.abs(got - expected).max() / 3.0 < 0.05
        np.testing.assert_array_equal(res[0][0], res[1][0])
    # a result mapped from a segment is refused by the pool
    big = _both(lambda r: baby[r].allreduce(
        [np.ones(1 << 19, np.float32)], "sum").wait(timeout=60))
    held = POOL._held
    POOL.give(big[0][0])
    assert POOL._held == held


# -- bitwise against the port's ProcessGroupTCP and the JAX package's Baby --

_N = {"small": 1000, "large": (1 << 20) + 8}  # elements: a bf16 leaf of
# 1000 pickles, one of 2^20 + 8 (2 MiB + 16 B) crosses through /dev/shm


def _inputs(rank: int, size: str):
    rng = np.random.default_rng(100 + rank)
    n = _N[size]
    f32 = rng.standard_normal(n).astype(np.float32)
    b16 = rng.standard_normal(n).astype(np.float32).astype(ml_dtypes.bfloat16)
    return f32, b16


def _port_leaves(rank, size):
    f32, b16 = _inputs(rank, size)
    bits = torch.from_numpy(b16.view(np.int16).copy()).view(torch.bfloat16)
    return [torch.from_numpy(f32.copy()), bits]


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        assert x.device.type == "cpu"
        return x.view(torch.int16).numpy().copy()
    return np.asarray(x).view(np.uint8).copy()


def _bf16_case(baby, tcp, size):
    """allreduce (sum) and broadcast of an f32 and a bf16 leaf through
    both PGs: (baby results, tcp results), each as (type, dtype, bits)."""
    out = {}
    for name, pgs in (("baby", baby), ("tcp", tcp)):
        red = _both(lambda r: pgs[r].allreduce(_port_leaves(r, size), "sum")
                    .wait(timeout=60))
        bc = _both(lambda r: pgs[r].broadcast(_port_leaves(r, size)[1], root=1)
                   .wait(timeout=60))
        out[name] = [
            [(type(x).__name__, str(x.dtype), _bits(x)) for x in red[r] + [bc[r]]]
            for r in range(2)
        ]
    return out["baby"], out["tcp"]


def _same(a, b) -> bool:
    return all(
        ta == tb and da == db and np.array_equal(xa, xb)
        for ra, rb in zip(a, b) for (ta, da, xa), (tb, db, xb) in zip(ra, rb)
    )


@pytest.mark.parametrize("size", ["small", "large"])
def test_bitwise_equal_to_process_group_tcp(baby, tcp, size):
    got, want = _bf16_case(baby, tcp, size)
    assert [[t for t, _, _ in r] for r in got] == [
        ["ndarray", "Tensor", "Tensor"]] * 2
    assert [[d for _, d, _ in r] for r in got] == [
        ["float32", "torch.bfloat16", "torch.bfloat16"]] * 2
    assert _same(got, want)


def test_control_a_ref_without_the_bf16_mark_fails_the_bf16_case(
        baby, tcp, monkeypatch):
    """Planted fault: staging drops the bf16 mark from a leaf's ref, which
    then names only the storage dtype (uint16), as the JAX package's
    ``_ShmRef`` does; the worker reduces the bit patterns as integers."""
    monkeypatch.setattr(pg_mod, "_shm_mark", lambda a: False)
    got, want = _bf16_case(baby, tcp, "large")
    assert not _same(got, want)


@pytest.fixture(scope="module")
def jax_baby(store):
    from torchft_tpu.parallel.process_group import (
        ProcessGroupBabyTCP as JaxBaby,
    )

    pgs = _configure([JaxBaby(timeout=60.0) for _ in range(2)], store,
                     "jaxbaby")
    yield pgs
    for pg in pgs:
        pg.shutdown()


@pytest.mark.parametrize("size", ["small", "large"])
def test_bitwise_equal_to_the_jax_baby_on_numpy_inputs(baby, jax_baby, size):
    port = _both(lambda r: baby[r].allreduce(
        list(_inputs(r, size)), "sum").wait(timeout=60))
    ref = _both(lambda r: jax_baby[r].allreduce(
        list(_inputs(r, size)), "sum").wait(timeout=60))
    for p, j in zip(port, ref):
        assert np.asarray(p[0]).dtype == j[0].dtype == np.float32
        np.testing.assert_array_equal(p[0].view(np.uint32), j[0].view(np.uint32))
        # numpy bf16 in: the port reduces the ml_dtypes leaf as numpy does
        # in the JAX package (no torch tensor involved), bit for bit
        assert j[1].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(
            np.asarray(p[1]).view(np.uint16), j[1].view(np.uint16))


def test_wire_gbps_env_reaches_baby_worker(store, baby, monkeypatch):
    """TORCHFT_WIRE_GBPS must shape the worker's sends: the worker builds
    its inner ProcessGroupTCP in the spawned process, which inherits the
    env.  An 8 MB allreduce at 10 MB/s paces 4 MB past the 4 MB burst,
    0.4 s; the unshaped pair moves it well under that floor."""
    monkeypatch.setenv("TORCHFT_WIRE_GBPS", "0.01")
    shaped = _configure([ProcessGroupBabyTCP(timeout=60.0) for _ in range(2)],
                        store, "shaped")
    data = np.ones(2 << 20, dtype=np.float32)  # 8 MB

    def timed(pgs):
        def run(r):
            t0 = time.monotonic()
            pgs[r].allreduce([data.copy()], "sum").wait(timeout=60)
            return time.monotonic() - t0
        return min(_both(run))

    try:
        slow = timed(shaped)
    finally:
        for pg in shaped:
            pg.shutdown()
    fast = timed(baby)  # configured before the env was set
    assert slow >= 0.3, slow
    assert fast < slow / 2, (fast, slow)


# -- the cases that break a pair, in order on a pair of their own ----------


@pytest.fixture(scope="module")
def victims(store):
    pgs = _configure([ProcessGroupBabyTCP(timeout=30.0) for _ in range(2)],
                     store, "victims")
    yield pgs
    for pg in pgs:
        pg.shutdown()


def _healthy(pgs, store, prefix):
    """Reconfigure a pair that an earlier case left broken (the cases can
    also run apart, on separate test processes)."""
    if any(pg.errored() is not None or pg.worker_pid() is None for pg in pgs):
        _configure(pgs, store, prefix)


def test_worker_crash_is_isolated(store, victims):
    # kill rank 1's worker out from under it while rank 0's op waits on
    # it: the parents see clean errors (the pipe's EOF, the peer's reset)
    _healthy(victims, store, "victims1")
    w0 = victims[0].allreduce([np.zeros(2, np.float32)])
    os.kill(victims[1].worker_pid(), 9)
    w1 = victims[1].allreduce([np.zeros(2, np.float32)])
    errs = 0
    for w in (w0, w1):
        try:
            w.wait(timeout=30)
        except Exception:  # noqa: BLE001 - counted
            errs += 1
    assert errs == 2
    assert victims[1].errored() is not None


def test_abort_then_reconfigure(store, victims):
    for pg in victims:
        pg.abort()
    assert all(pg.errored() is not None for pg in victims)
    with pytest.raises(Exception):
        victims[0].allreduce([np.zeros(1)]).wait(timeout=5)
    _configure(victims, store, "victims2")
    assert all(pg.errored() is None for pg in victims)
    for got in _both(lambda r: victims[r].allreduce(
            [np.ones(2, np.float32)]).wait(timeout=30)):
        np.testing.assert_array_equal(got[0], np.full(2, 2.0, np.float32))


def test_live_reconfigure_keeps_results_and_leaves_no_segment(store, victims):
    """A reconfigure over a healthy pair (the quorum-change path): the
    stale readers latch no error, a shared-memory result the caller still
    holds stays readable, and /dev/shm holds none of the old worker's
    segments."""
    _healthy(victims, store, "victims2b")
    held = _both(lambda r: victims[r].allreduce(
        [torch.full((1 << 19,), 1.0 + r)], "sum").wait(timeout=30))
    _configure(victims, store, "victims3")
    time.sleep(0.3)  # the old readers wake on their closed pipes
    assert all(pg.errored() is None for pg in victims)
    assert _own_segments(victims) == []
    for got in held:
        np.testing.assert_array_equal(got[0], np.full(1 << 19, 3.0, np.float32))
    for got in _both(lambda r: victims[r].allreduce(
            [np.ones(2, np.float32)]).wait(timeout=30)):
        np.testing.assert_array_equal(got[0], np.full(2, 2.0, np.float32))


def test_a_dead_owners_segments_are_swept(store):
    """Segments staged by a process that died mid-op (a SIGKILLed
    trainer) are unlinked by the next Baby PG that configures."""
    import subprocess
    import sys

    code = (
        "import time; from torchft_tpu_torch.parallel import process_group as p; "
        "s = p._Seg.create(4096, __import__('os').getpid(), 'iX'); "
        "print(s.name, flush=True); time.sleep(60)"
    )
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            text=True, cwd=os.path.dirname(os.path.dirname(
                                os.path.abspath(__file__))))
    try:
        name = proc.stdout.readline().strip()
        assert os.path.exists(f"/dev/shm/{name}")
        proc.kill()
        proc.wait(timeout=10)
        assert os.path.exists(f"/dev/shm/{name}")
        assert pg_mod._shm_sweep_dead() >= 1
        assert not os.path.exists(f"/dev/shm/{name}")
    finally:
        proc.kill()


def test_the_sweep_leaves_other_pid_namespaces_alone():
    """/dev/shm may be shared with processes of another pid namespace,
    where a pid that is not alive here names a live process: the sweep
    unlinks only the segments of its own namespace."""
    other = f"tftb_{pg_mod._PID_NS}1_{2 ** 22 + 7}_iX_{os.getpid()}"
    fd = os.open(f"/dev/shm/{other}", os.O_CREAT | os.O_RDWR, 0o600)
    os.close(fd)
    try:
        assert pg_mod._PID_NS
        pg_mod._shm_sweep_dead()
        assert os.path.exists(f"/dev/shm/{other}")
    finally:
        os.unlink(f"/dev/shm/{other}")


def test_staging_past_free_shm_fails_before_writing(monkeypatch):
    """A full tmpfs does not fail the segment's creation: the write past
    its capacity raises SIGBUS.  Staging reads the free space first."""
    class _Full:
        f_bavail, f_frsize, f_blocks = 10, 4096, 100

    monkeypatch.setattr(os, "statvfs", lambda path: _Full())
    pg = ProcessGroupBabyTCP()
    created = []
    with pytest.raises(RuntimeError, match="/dev/shm"):
        pg._stage([torch.zeros(1 << 18), np.zeros(1 << 20, np.float32)], created,
                  "test")
    assert created == [] and _own_segments([pg]) == []


def test_a_finished_works_timeout_does_not_pin_its_result():
    """A Work's timeout timer is cancelled when the op resolves, but waits
    in the timer heap behind earlier deadlines: it must not keep the
    result (a collective's arrays, or the segment behind them) alive."""
    import gc
    import weakref
    from concurrent.futures import Future

    from torchft_tpu_torch.utils.futures import future_timeout

    class Result:
        pass

    ahead = future_timeout(Future(), 300)  # an earlier deadline stays pending
    src = Future()
    mirrored = future_timeout(src, 600)
    res = Result()
    alive = weakref.ref(res)
    src.set_result(res)
    assert mirrored.result() is res
    del res, mirrored, src
    gc.collect()
    assert alive() is None
    assert not ahead.done()
