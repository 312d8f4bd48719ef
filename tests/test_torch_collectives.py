"""The port's quantized collectives against the JAX package's, bit for bit.

Each case builds one process group of ``world`` thread-ranks in each
package, feeds both the same numpy inputs (made from a seed), and requires
the same outputs bit for bit and the same ``wire_bytes``.  The port takes
CPU tensors; the JAX side numpy arrays, or ``jnp`` arrays on its device
path.

The device path is the capture that runs kernel D before the host copy.  On
the CPU the port runs D's plain twin, and the JAX package its Pallas kernel
in interpret mode, whose scales XLA computes as ``absmax * f32(1/127)``
instead of IEEE ``absmax / 127`` (tests/test_torch_pallas_quant.py pins
that).  So that this file tests the pipeline and not that rewrite, the
JAX side's quantizer is replaced here, for the device cases only, by the
IEEE rule written in numpy.

The two quantized golden fixtures replay through the port as
tests/test_golden_fixtures.py replays them through the JAX package; they
are read, never written.
"""

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.coordination import StoreServer as JaxStore
from torchft_tpu.ops import collectives as jcoll
from torchft_tpu.ops import pallas_quant as jpq
from torchft_tpu.parallel.process_group import ProcessGroupTCP as JaxPG
from torchft_tpu_torch.coordination import StoreServer
from torchft_tpu_torch.ops import collectives as tcoll
from torchft_tpu_torch.ops import pallas_quant as tpq
from torchft_tpu_torch.parallel.process_group import (
    REDUCE_AVG,
    REDUCE_SUM,
    ProcessGroupTCP,
)

FIXTURES = Path(__file__).parent / "fixtures"


def _parallel(world, fn):
    with ThreadPoolExecutor(max_workers=world) as ex:
        futures = [ex.submit(fn, r) for r in range(world)]
        return [f.result(timeout=60) for f in futures]


@pytest.fixture(scope="module")
def stores():
    port, jax_ = StoreServer(), JaxStore()
    yield port, jax_
    port.shutdown()
    jax_.shutdown()


_groups = {}


def _group(stores, pkg, world):
    """One configured process group of ``world`` ranks per package, reused
    across the cases of this module (a collective leaves it reusable)."""
    key = (pkg, world)
    if key not in _groups:
        cls, store = (ProcessGroupTCP, stores[0]) if pkg == "port" else (JaxPG, stores[1])
        pgs = [cls(timeout=20.0) for _ in range(world)]
        prefix = f"{pkg}_{world}"
        _parallel(world, lambda r: pgs[r].configure(
            f"{store.address()}/{prefix}", f"rank{r}", r, world))
        _groups[key] = pgs
    return _groups[key]


@pytest.fixture(scope="module", autouse=True)
def _shutdown_groups():
    yield
    for pgs in _groups.values():
        for pg in pgs:
            pg.shutdown()
    _groups.clear()


def _ieee_quantize(mat):
    """Kernel D's rule in numpy (IEEE division, round half to even)."""
    x = np.asarray(mat, dtype=np.float32)
    absmax = np.abs(x).max(axis=1)
    scales = np.where(absmax > 0, absmax / np.float32(127.0), 1.0).astype(np.float32)
    q = np.clip(np.rint(x / scales[:, None]), -127, 127).astype(np.int8)
    return jnp.asarray(scales), jnp.asarray(q)


def _inputs(world, shapes, seed, dtypes=None):
    rng = np.random.default_rng(seed)
    dtypes = dtypes or [np.float32] * len(shapes)
    return [
        [(rng.standard_normal(s) * (1 + r)).astype(np.float32) for s in shapes]
        for r in range(world)
    ], dtypes


def _to_port(a, dt):
    t = torch.from_numpy(a.copy())
    return t.to(torch.bfloat16) if dt == "bf16" else t


def _to_jax(a, dt, device):
    if dt == "bf16":
        import ml_dtypes

        a = a.astype(ml_dtypes.bfloat16)
    return jnp.asarray(a) if device else a


def _bits(x):
    a = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, dtype=np.float32)
    return np.ascontiguousarray(a).view(np.int32)


CASES = {
    # name: (world, topology, device, op, shapes, dtypes, wire, chunk_rows)
    "w2_flat_host_sum": (2, None, False, REDUCE_SUM, [(6, 256)], None, "int8", None),
    "w3_flat_host_avg_chunked": (3, None, False, REDUCE_AVG, [(40, 2048)], None, "int8", 4),
    "w2_flat_device_avg": (2, None, True, REDUCE_AVG, [(6, 256), (7,), (3, 5)], None, "int8", None),
    "w3_flat_device_sum_chunked": (3, None, True, REDUCE_SUM, [(40, 2048)], None, "int8", 4),
    "w4_hosts2_host_avg": (4, "hosts:2", False, REDUCE_AVG, [(6, 256)], None, "int8", None),
    "w4_hosts2_device_sum_chunked": (4, "hosts:2", True, REDUCE_SUM, [(24, 2048)], None, "int8", 4),
    "w2_flat_host_fp8_avg": (2, None, False, REDUCE_AVG, [(6, 256)], None, "fp8_e4m3", None),
    "w3_flat_host_mixed_bf16": (3, None, False, REDUCE_AVG, [(4, 300), (9,), (2, 3, 4)], ["bf16", np.float32, "bf16"], "int8", None),
    # the numpy codec (no native library): fp8 through torch's
    # float8_e4m3fn on the port's side, ml_dtypes on the JAX side
    "w2_flat_numpy_codec_fp8_avg": (2, None, False, REDUCE_AVG, [(6, 256)], None, "fp8_e4m3", None),
    "w3_flat_numpy_codec_int8_sum": (3, None, False, REDUCE_SUM, [(6, 256)], None, "int8", None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_allreduce_quantized_matches_jax(name, stores, monkeypatch):
    world, topo, device, op, shapes, dtypes, wire, chunk_rows = CASES[name]
    if chunk_rows:
        monkeypatch.setenv("TORCHFT_QUANT_CHUNK_ROWS", str(chunk_rows))
    if "numpy_codec" in name:
        monkeypatch.setenv("TORCHFT_NO_NATIVE_QUANT", "1")
    if device:
        monkeypatch.setattr(jpq, "fused_quantize_into_int8", _ieee_quantize)
    data, dts = _inputs(world, shapes, seed=len(name), dtypes=dtypes)
    tpgs, jpgs = _group(stores, "port", world), _group(stores, "jax", world)
    twin_calls = tpq.quantize_int8_plain.calls

    def port(r):
        w = tcoll.allreduce_quantized(
            [_to_port(a, dt) for a, dt in zip(data[r], dts)], op, tpgs[r],
            device_quantize=device, wire_dtype=wire, topology=topo,
        )
        return w.wait(timeout=30), w

    def jax_(r):
        w = jcoll.allreduce_quantized(
            [_to_jax(a, dt, device) for a, dt in zip(data[r], dts)], op, jpgs[r],
            device_quantize=device, wire_dtype=wire, topology=topo,
        )
        return w.wait(timeout=30), w

    got, want = _parallel(world, port), _parallel(world, jax_)
    for r in range(world):
        (tout, tw), (jout, jw) = got[r], want[r]
        assert tw.wire_bytes == jw.wire_bytes
        assert tw.unquantized_wire_bytes == jw.unquantized_wire_bytes
        assert tw.device_quantized == jw.device_quantized == device
        assert tw.quant_stats["n_chunks"] == jw.quant_stats["n_chunks"]
        if chunk_rows:
            assert tw.quant_stats["n_chunks"] > 1
        for t, j, dt in zip(tout, jout, dts):
            assert isinstance(t, torch.Tensor) and tuple(t.shape) == j.shape
            assert t.dtype == (torch.bfloat16 if dt == "bf16" else torch.float32)
            np.testing.assert_array_equal(_bits(t), _bits(j))
    # the device cases ran kernel D's twin once per rank, the host cases never
    assert tpq.quantize_int8_plain.calls - twin_calls == (world if device else 0)


@pytest.mark.parametrize("world,op", [(2, REDUCE_SUM), (3, REDUCE_AVG)])
def test_reduce_scatter_quantized_matches_jax(world, op, stores):
    rng = np.random.default_rng(world)
    data = [(rng.standard_normal((6 * world, 33)) * (r + 1)).astype(np.float32) for r in range(world)]
    tpgs, jpgs = _group(stores, "port", world), _group(stores, "jax", world)

    def port(r):
        w = tcoll.reduce_scatter_quantized(torch.from_numpy(data[r]), op, tpgs[r])
        return w.wait(timeout=30), w.wire_bytes

    def jax_(r):
        w = jcoll.reduce_scatter_quantized(data[r], op, jpgs[r])
        return w.wait(timeout=30), w.wire_bytes

    for (t, tb), (j, jb) in zip(_parallel(world, port), _parallel(world, jax_)):
        assert tb == jb
        assert isinstance(t, torch.Tensor) and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(_bits(t), _bits(j))


def _replay(stores, world, seed, topology, rounds=3, shape=(6, 256)):
    """The golden procedure of tests/test_golden_fixtures.py, through the
    port: ``rounds`` int8 AVG syncs of seeded pseudograds, each followed by
    a mocked outer step ``params -= 0.1 * avg``."""
    rng = np.random.default_rng(seed)
    grads = [
        [rng.standard_normal(shape).astype(np.float32) for _ in range(rounds)]
        for _ in range(world)
    ]
    pgs = _group(stores, "port", world)
    params = [torch.zeros(shape) for _ in range(world)]

    def run(r):
        out = []
        for rnd in range(rounds):
            work = tcoll.allreduce_quantized(
                [torch.from_numpy(grads[r][rnd].copy())], REDUCE_AVG, pgs[r],
                topology=topology,
            )
            (avg,) = work.wait(timeout=30)
            params[r] -= torch.tensor(0.1, dtype=torch.float32) * avg
            out.append(params[r].numpy().copy())
        return out

    results = _parallel(world, run)
    for rnd in range(rounds):
        for r in range(1, world):
            np.testing.assert_array_equal(results[0][rnd], results[r][rnd])
    return [
        {
            "round": rnd,
            "first_row": [float(x) for x in results[0][rnd][0]],
            "sum": float(np.float64(results[0][rnd].sum(dtype=np.float64))),
            "abs_sum": float(np.float64(np.abs(results[0][rnd]).sum(dtype=np.float64))),
        }
        for rnd in range(rounds)
    ]


@pytest.mark.parametrize("fixture,world,seed,topology", [
    ("quantized_sync_int8.json", 2, 1234, None),
    ("quantized_sync_int8_hier.json", 4, 4321, "hosts:2"),
])
def test_quantized_golden_fixture_replays(fixture, world, seed, topology, stores):
    golden = json.loads((FIXTURES / fixture).read_text())
    assert golden["seed"] == seed and golden["wire"] == "int8"
    history = _replay(stores, world, seed, topology)
    assert history == golden["history"]


@pytest.mark.cuda
def test_device_capture_on_a_side_stream_matches_the_twin(stores):
    """Kernel D on the card, launched from a non-default stream while the
    codec pool copies on its own streams: the result must equal, bit for
    bit, the same pipeline run through D's twin on CPU copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    world = 2
    pgs = _group(stores, "port", world)
    rng = np.random.default_rng(5)
    data = [rng.standard_normal((300, 2048)).astype(np.float32) for _ in range(world)]

    def run(r, on_card):
        if not on_card:
            x = torch.from_numpy(data[r])
            return tcoll.allreduce_quantized(
                [x], REDUCE_AVG, pgs[r], device_quantize=True
            ).wait(timeout=30)[0]
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            # produced on the side stream, so only the event orders the
            # pool's copies after the kernel
            x = torch.from_numpy(data[r]).cuda(non_blocking=True) * 1.0
            work = tcoll.allreduce_quantized([x], REDUCE_AVG, pgs[r])
        assert work.device_quantized
        return work.wait(timeout=30)[0]

    launches = tpq.quantize_int8.launches
    on_card = _parallel(world, lambda r: run(r, True))
    assert tpq.quantize_int8.launches - launches == world
    on_cpu = _parallel(world, lambda r: run(r, False))
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_array_equal(_bits(a), _bits(b))
