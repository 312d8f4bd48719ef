"""The whole slice on the CPU: FT-DDP of the tiny transformer in both
packages, live heal over the port's PGTransport, and live heal over its
default HTTPTransport (striped across two sources; the two heal golden
fixtures replayed with torch tensors in place of numpy arrays).

Each replica group is a thread with its own Manager, ProcessGroupTCP and
optimizer wrapper on one native lighthouse (the threads-as-replicas harness
of tests/test_manager_integ.py).  The JAX leg and the port leg start from
the same JAX-initialised weights, read the same token batches and use the
same AdamW hyper-parameters (``weight_decay`` passed on both sides: optax
and torch default it differently); their final parameters must agree to
1e-5 relative to each leaf's largest magnitude.  The heal leg kills one
group, restarts it from a different init, and must end bitwise equal.
"""

import collections
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchft_tpu.coordination import LighthouseServer as JaxLighthouse
from torchft_tpu.manager import Manager as JaxManager
from torchft_tpu.models import transformer as jtf
from torchft_tpu.optim import OptimizerWrapper as JaxOptimizerWrapper
from torchft_tpu.parallel.process_group import ProcessGroupTCP as JaxPG
from torchft_tpu_torch import (
    DistributedDataParallel,
    Manager,
    OptimizerWrapper,
    PGTransport,
    ProcessGroupTCP,
    module_grads,
)
from torchft_tpu_torch import convert
from torchft_tpu_torch.coordination import LighthouseServer, StoreServer
from torchft_tpu_torch.models import transformer as ttf
from torchft_tpu_torch.utils.pytree import tree_flatten, tree_unflatten

SHAPE = dict(
    vocab_size=512, d_model=128, n_heads=4, n_kv_heads=2, d_ff=384,
    n_layers=2, max_seq_len=128, attn_impl="dense", remat=False,
)
# eps well above the default 1e-8: the two frameworks' gradients differ by
# f32 noise (~1e-8 absolute, ~1.5e-6 of each leaf's largest gradient), and
# Adam turns such a difference on a near-zero gradient element into an
# update difference of up to lr when eps is that small
LR, WD, EPS = 1e-3, 0.1, 1e-4
JCFG = jtf.TransformerConfig(dtype=jnp.float32, **SHAPE)
TCFG = ttf.TransformerConfig(dtype=torch.float32, **SHAPE)


def _tokens(replica: int, step: int) -> np.ndarray:
    rng = np.random.default_rng(1000 * replica + step)
    return rng.integers(0, 512, (2, 128)).astype(np.int32)


@pytest.fixture(scope="module")
def tree():
    params = jtf.init_params(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(np.asarray, params)


def _run(replicas, fn):
    with ThreadPoolExecutor(max_workers=len(replicas)) as ex:
        futures = [ex.submit(fn, r) for r in replicas]
        return [f.result(timeout=120) for f in futures]


def _port_group(replica, lighthouse_addr, model, min_replica_size, transport="pg"):
    """One port replica group: returns (manager, optimizer wrapper, ddp).
    ``transport="pg"`` heals over PGTransport; ``None`` leaves the Manager
    its default transport."""
    opt = torch.optim.AdamW(
        model.parameters(), lr=LR, betas=(0.9, 0.999), eps=EPS, weight_decay=WD
    )

    def state_dict():
        return {"model": model.state_dict(), "optim": opt.state_dict()}

    def load_state_dict(sd):
        model.load_state_dict(sd["model"])
        opt.load_state_dict(sd["optim"])

    pg = ProcessGroupTCP(timeout=20.0)
    holder = {}
    manager = Manager(
        pg=pg,
        min_replica_size=min_replica_size,
        load_state_dict=load_state_dict,
        state_dict=state_dict,
        lighthouse_addr=lighthouse_addr,
        replica_id=f"port_{replica}",
        group_rank=0,
        group_world_size=1,
        checkpoint_transport=PGTransport(
            pg, timeout=20.0,
            state_dict_fn=lambda: holder["m"]._manager_state_dict(),
        ) if transport == "pg" else None,
        timeout=20.0,
        quorum_timeout=20.0,
    )
    holder["m"] = manager
    return manager, OptimizerWrapper(manager, opt), DistributedDataParallel(manager)


def _port_step(model, manager, optim, ddp, tokens):
    optim.zero_grad()
    loss, _ = ttf.make_grad_step(TCFG)(model, torch.from_numpy(tokens).long())
    assert torch.isfinite(loss)
    avg = ddp.allreduce_gradients(module_grads(model)).wait(timeout=30)
    return optim.step(model, avg)


def test_ft_ddp_matches_jax(tree):
    jgrad = jtf.make_grad_step(JCFG)
    steps = 3

    def jax_replica(replica):
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        manager = JaxManager(
            pg=JaxPG(timeout=20.0), min_replica_size=2,
            load_state_dict=lambda sd: None, state_dict=lambda: {},
            lighthouse_addr=jlh.address(), replica_id=f"jax_{replica}",
            group_rank=0, group_world_size=1, timeout=20.0, quorum_timeout=20.0,
        )
        opt = JaxOptimizerWrapper(
            manager, optax.adamw(LR, b1=0.9, b2=0.999, eps=EPS, weight_decay=WD)
        )
        opt_state = opt.init(params)
        try:
            while manager.current_step() < steps:
                opt.begin_step()
                _, grads = jgrad(params, jnp.asarray(_tokens(replica, manager.current_step())))
                avg = manager.allreduce(grads).wait(timeout=30)
                params, opt_state, ok = opt.step(params, avg, opt_state)
                assert ok
        finally:
            manager.shutdown()
        return jax.tree_util.tree_map(np.asarray, params)

    def port_replica(replica):
        model = convert.params_from_jax(tree, TCFG, device="cpu")
        manager, optim, ddp = _port_group(replica, tlh.address(), model, 2)
        try:
            while manager.current_step() < steps:
                assert _port_step(
                    model, manager, optim, ddp, _tokens(replica, manager.current_step())
                )
        finally:
            manager.shutdown()
        return convert.params_to_jax(model, TCFG)

    jlh = JaxLighthouse(min_replicas=2, join_timeout_ms=100, heartbeat_timeout_ms=1000)
    tlh = LighthouseServer(min_replicas=2, join_timeout_ms=100, heartbeat_timeout_ms=1000)
    try:
        jax_out = _run([0, 1], jax_replica)
        port_out = _run([0, 1], port_replica)
    finally:
        jlh.shutdown()
        tlh.shutdown()
    for out in (jax_out, port_out):  # each leg's replicas agree bitwise
        for a, b in zip(jax.tree_util.tree_leaves(out[0]), jax.tree_util.tree_leaves(out[1])):
            np.testing.assert_array_equal(a, b)
    moved = False
    for a, b, init in zip(
        jax.tree_util.tree_leaves(port_out[0]),
        jax.tree_util.tree_leaves(jax_out[0]),
        jax.tree_util.tree_leaves(tree),
    ):
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-5)
        moved |= not np.array_equal(a, init)
    assert moved


def test_kill_and_rejoin_heals_bitwise_over_pg_transport(tree):
    steps, kill_after = 4, 2
    killed = threading.Event()

    def replica_loop(replica):
        attempt = 0
        while True:
            if attempt == 0:
                model = convert.params_from_jax(tree, TCFG, device="cpu")
            else:  # a restart: fresh weights the heal must overwrite
                model = ttf.init_params(torch.Generator().manual_seed(99), TCFG, "cpu")
            manager, optim, ddp = _port_group(replica, lh.address(), model, 1)
            try:
                while manager.current_step() < steps:
                    step = manager.current_step()
                    if replica == 1 and step == kill_after and not killed.is_set():
                        killed.set()
                        break  # the group dies here and restarts
                    assert _port_step(model, manager, optim, ddp, _tokens(replica, step))
                else:
                    return attempt, {
                        k: v.clone() for k, v in model.state_dict().items()
                    }, manager.state_dict()
            finally:
                manager.shutdown()
            attempt += 1

    lh = LighthouseServer(min_replicas=2, join_timeout_ms=100, heartbeat_timeout_ms=1000)
    try:
        (a0, sd0, ms0), (a1, sd1, ms1) = _run([0, 1], replica_loop)
    finally:
        lh.shutdown()
    assert (a0, a1) == (0, 1)
    assert ms0["step"] == ms1["step"] == steps
    for name in sd0:
        assert torch.equal(sd0[name], sd1[name]), name


def test_pg_transport_heals_in_place_into_adamw_state():
    def group(seed):
        model = ttf.init_params(torch.Generator().manual_seed(seed), TCFG, "cpu")
        opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
        tokens = torch.from_numpy(_tokens(seed, 0)).long()
        ttf.make_grad_step(TCFG)(model, tokens)
        opt.step()
        return model, opt

    (m0, o0), (m1, o1) = group(0), group(1)
    state = lambda m, o: {"model": m.state_dict(), "optim": o.state_dict()}  # noqa: E731
    store = StoreServer()
    pgs = [ProcessGroupTCP(timeout=20.0) for _ in range(2)]
    try:
        _run([0, 1], lambda r: pgs[r].configure(f"{store.address()}/heal", f"r{r}", r, 2))
        recv_into = state(m1, o1)
        targets = tree_flatten(recv_into)[0]
        send = PGTransport(pgs[0], timeout=20.0)
        recv = PGTransport(pgs[1], timeout=20.0, state_dict_fn=lambda: recv_into)
        out = _run(
            [0, 1],
            lambda r: send.send_checkpoint([1], 7, state(m0, o0), 20.0)
            if r == 0
            else recv.recv_checkpoint(0, "<n/a>", 7, 20.0),
        )[1]
    finally:
        for pg in pgs:
            pg.shutdown()
        store.shutdown()
    got, want = tree_flatten(out)[0], tree_flatten(state(m0, o0))[0]
    assert len(got) == len(want) == len(targets)
    for g, w, t in zip(got, want, targets):
        if isinstance(w, torch.Tensor):
            assert g is t  # received into the live tensor
            assert torch.equal(g, w)
        else:
            assert g == w
    assert torch.equal(m1.embed, m0.embed)  # the model itself was written
    assert torch.equal(
        o1.state[o1.param_groups[0]["params"][0]]["exp_avg"],
        o0.state[o0.param_groups[0]["params"][0]]["exp_avg"],
    )


def test_flatten_order_matches_jax():
    tree = {
        "b": [1, (2, None, 3)],
        "a": {10: 4, 2: 5},
        "c": collections.OrderedDict([("z", 6), ("y", 7)]),
    }
    leaves, skeleton = tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree) == [5, 4, 1, 2, 3, 6, 7]
    assert tree_unflatten(skeleton, leaves) == tree


def test_shut_down_manager_frees_the_training_state():
    """An idle process-group worker must not pin its last op: that op's
    future reaches, through its callbacks, the Manager and every tensor
    its state closures hold.  After shutdown, one cyclic collection frees
    them (on the card, a restarted group's gigabytes)."""
    import gc
    import weakref

    lh = LighthouseServer(min_replicas=1, join_timeout_ms=100)

    def run():
        state = torch.zeros(1000)
        pg = ProcessGroupTCP(timeout=10.0)
        box = {}
        m = Manager(
            pg=pg, min_replica_size=1, load_state_dict=lambda sd: None,
            state_dict=lambda: {"t": state}, lighthouse_addr=lh.address(),
            replica_id="frees", group_rank=0, group_world_size=1,
            checkpoint_transport=PGTransport(
                pg, timeout=10.0,
                state_dict_fn=lambda: box["m"]._manager_state_dict(),
            ),
            use_async_quorum=False, timeout=10.0, quorum_timeout=10.0,
        )
        box["m"] = m
        try:
            m.start_quorum()
            m.allreduce({"g": torch.ones(10)}, should_quantize=True).wait(10)
            m.allreduce({"g": torch.ones(10)}).wait(10)
            assert m.should_commit()
        finally:
            m.shutdown()
        return weakref.ref(state), weakref.ref(m)

    try:
        state_ref, manager_ref = run()
        gc.collect()
        assert manager_ref() is None and state_ref() is None
    finally:
        lh.shutdown()


def test_serialization_round_trips_tensors_and_receives_in_place():
    from torchft_tpu_torch.checkpointing import serialization as ser

    state = {
        "w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "h": torch.tensor([1.5, -2.0], dtype=torch.bfloat16),
        "step": torch.tensor(3.0),
        "np": np.arange(4, dtype=np.int64),
        "meta": {"lr": 0.1, "tags": ("a", None)},
    }
    out = ser.deserialize(ser.serialize(state))
    assert out["meta"] == state["meta"]
    np.testing.assert_array_equal(out["np"], state["np"])
    for key in ("w", "h", "step"):
        assert isinstance(out[key], torch.Tensor)
        assert out[key].dtype == state[key].dtype
        assert out[key].shape == state[key].shape
        assert torch.equal(out[key], state[key])
    # receive in place: slots of the flattened state map to live tensors
    live = {k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else v
            for k, v in state.items()}
    leaves = tree_flatten(live)[0]
    into = {i: x for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)}
    import io

    skeleton, got, n = ser.deserialize_from(io.BytesIO(ser.serialize(state)), into=into)
    for i, target in into.items():
        assert got[i] is target
    assert torch.equal(live["w"], state["w"]) and torch.equal(live["h"], state["h"])


# ---------------------------------------------------------------------------
# heal over the default HTTPTransport
# ---------------------------------------------------------------------------


def test_manager_without_a_transport_builds_http_transport():
    from torchft_tpu_torch import HTTPTransport

    lh = LighthouseServer(min_replicas=1, join_timeout_ms=100)
    m = Manager(
        pg=ProcessGroupTCP(timeout=10.0), min_replica_size=1,
        load_state_dict=lambda sd: None, state_dict=lambda: {},
        lighthouse_addr=lh.address(), replica_id="default_transport",
        group_rank=0, group_world_size=1, timeout=7.0,
    )
    try:
        t = m._checkpoint_transport
        assert isinstance(t, HTTPTransport) and t.supports_striped_heal is True
        assert t._lock_timeout == 7.0
        assert t.metadata().startswith("http://")
    finally:
        m.shutdown()
        lh.shutdown()


def test_three_groups_kill_and_rejoin_heal_striped_from_two_sources(tree):
    """Group 2 dies after step 2 and restarts from a different init; the
    lighthouse waits for all three groups, so the rejoiner heals from both
    survivors over the default transport, and all three end bitwise equal,
    AdamW state included."""
    steps, kill_after = 4, 2
    killed = threading.Event()

    def replica_loop(replica):
        attempt = 0
        while True:
            if attempt == 0:
                model = convert.params_from_jax(tree, TCFG, device="cpu")
            else:
                model = ttf.init_params(torch.Generator().manual_seed(99), TCFG, "cpu")
            manager, optim, ddp = _port_group(replica, lh.address(), model, 2, transport=None)
            try:
                while manager.current_step() < steps:
                    step = manager.current_step()
                    if replica == 2 and step == kill_after and not killed.is_set():
                        killed.set()
                        break
                    assert _port_step(model, manager, optim, ddp, _tokens(replica, step))
                else:
                    opt = optim.optimizer
                    adam = [
                        {k: v.clone() for k, v in opt.state[p].items()}
                        for p in opt.param_groups[0]["params"]
                    ]
                    return attempt, {
                        k: v.clone() for k, v in model.state_dict().items()
                    }, adam, manager.heal_info()
            finally:
                manager.shutdown()
            attempt += 1

    lh = LighthouseServer(min_replicas=3, join_timeout_ms=100, heartbeat_timeout_ms=1000)
    try:
        out = _run([0, 1, 2], replica_loop)
    finally:
        lh.shutdown()
    assert [o[0] for o in out] == [0, 0, 1]
    info = out[2][3]
    assert info["sources"] == 2 and info["mode"] == "delta"
    assert info["changed"] == info["fragments"]  # a fresh init shares nothing
    assert set(info["phases"]) == {"heal_manifest", "heal_diff", "heal_wire", "heal_decode"}
    for _, sd, adam, _ in out[1:]:
        for name in sd:
            assert torch.equal(sd[name], out[0][1][name]), name
        for got, want in zip(adam, out[0][2]):
            for k in want:
                assert torch.equal(got[k], want[k]), k


FIXTURES = __import__("pathlib").Path(__file__).parent / "fixtures"


def _golden_manager(name, replica_id, lighthouse_addr, load_state_dict, state_dict):
    return Manager(
        pg=ProcessGroupTCP(timeout=10.0), min_replica_size=2,
        load_state_dict=load_state_dict, state_dict=state_dict,
        lighthouse_addr=lighthouse_addr, replica_id=f"{name}_{replica_id}",
        group_rank=0, group_world_size=1, use_async_quorum=False,
        timeout=20.0, quorum_timeout=20.0,
    )


def _recovery_replica(replica_id, lighthouse_addr):
    """tests/test_golden_fixtures.py's failure-recovery replica, on torch
    tensors: momentum SGD, killed by the chaos layer and healed live."""
    from torchft_tpu_torch.utils import faults
    from torchft_tpu_torch.utils.faults import InjectedFault

    history = []
    for _attempt in range(3):
        params = {"w": torch.zeros(4)}
        momentum = {"w": torch.zeros(4)}

        def load_state_dict(sd):
            params["w"] = sd["params"]["w"].clone()
            momentum["w"] = sd["momentum"]["w"].clone()

        def state_dict():
            return {"params": {"w": params["w"].clone()},
                    "momentum": {"w": momentum["w"].clone()}}

        manager = _golden_manager("golden_fr", replica_id, lighthouse_addr,
                                  load_state_dict, state_dict)
        try:
            while manager.current_step() < 5:
                step = manager.current_step()
                faults.check("train.step", replica=f"golden_fr_{replica_id}", step=step)
                manager.start_quorum()
                grads = {"w": torch.full((4,), float(step + 1)) * (1.0 + 0.5 * replica_id)}
                avg = manager.allreduce(grads).wait(timeout=30)
                if manager.should_commit():
                    momentum["w"] = 0.9 * momentum["w"] + avg["w"]
                    params["w"] = params["w"] - 0.1 * momentum["w"]
                    history.append({
                        "step": manager.current_step(),
                        "w": [float(x) for x in params["w"]],
                        "momentum": [float(x) for x in momentum["w"]],
                    })
            return history
        except InjectedFault:
            continue
        finally:
            manager.shutdown()
    raise RuntimeError(f"replica {replica_id} exhausted attempts")


def _delta_heal_replica(replica_id, lighthouse_addr):
    """tests/test_golden_fixtures.py's delta-heal replica, on torch
    tensors: a transient crash keeps the parameters but tears one leaf,
    and the rejoin fetches only the fragments whose digest moved."""
    from torchft_tpu_torch.utils import faults
    from torchft_tpu_torch.utils.faults import InjectedFault

    params = {f"w{i}": torch.zeros(16) for i in range(6)}
    history = []
    for _attempt in range(3):

        def load_state_dict(sd):
            for k in params:
                params[k] = sd["params"][k].clone()

        def state_dict():
            return {"params": {k: v.clone() for k, v in params.items()}}

        manager = _golden_manager("golden_dh", replica_id, lighthouse_addr,
                                  load_state_dict, state_dict)
        try:
            while manager.current_step() < 5:
                step = manager.current_step()
                faults.check("train.step", replica=f"golden_dh_{replica_id}", step=step)
                manager.start_quorum()
                grads = {k: torch.full((16,), float(step + 1) * (i + 1))
                         for i, k in enumerate(params)}
                avg = manager.allreduce(grads).wait(timeout=30)
                if manager.should_commit():
                    for k in params:
                        params[k] = params[k] - torch.tensor(0.1) * avg[k]
                    history.append({
                        "step": manager.current_step(),
                        "sums": {k: float(params[k].double().sum()) for k in params},
                    })
            return history
        except InjectedFault:
            params["w3"] = torch.zeros(16)
            continue
        finally:
            manager.shutdown()
    raise RuntimeError(f"replica {replica_id} exhausted attempts")


@pytest.mark.parametrize("fixture", ["failure_recovery", "delta_heal"])
def test_heal_golden_fixture_replays_on_the_default_transport(fixture):
    import json

    from torchft_tpu_torch.utils import faults
    from torchft_tpu_torch.utils import metrics as tmetrics
    from torchft_tpu_torch.utils.faults import FaultRule

    prefix, fn = {
        "failure_recovery": ("golden_fr", _recovery_replica),
        "delta_heal": ("golden_dh", _delta_heal_replica),
    }[fixture]
    golden = json.loads((FIXTURES / f"{fixture}.json").read_text())
    faults.FAULTS.configure([FaultRule(
        site="train.step", replica=f"{prefix}_1", step=golden["kill_step"],
    )])
    delta_before = tmetrics.HEAL_WIRE_BYTES.labels(mode="delta").get()
    lh = LighthouseServer(min_replicas=2, join_timeout_ms=100, heartbeat_timeout_ms=1000)
    try:
        histories = _run([0, 1], lambda r: fn(r, lh.address()))
        assert faults.FAULTS.injected() == 1
    finally:
        faults.FAULTS.configure([])
        lh.shutdown()
    assert {f"replica_{i}": h for i, h in enumerate(histories)} == golden["history"]
    if fixture == "delta_heal":
        assert int(tmetrics.HEAL_CHANGED_FRAGMENTS.get()) == golden["changed_fragments"] == 3
        delta_bytes = tmetrics.HEAL_WIRE_BYTES.labels(mode="delta").get() - delta_before
        assert 0 < delta_bytes < 6 * 16 * 4 + 2048
