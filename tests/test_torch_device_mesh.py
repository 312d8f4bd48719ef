"""The port's in-group mesh against the JAX package's, on the CPU.

``ManagedDeviceMesh`` is held to the JAX object: the batch slices under
shrink and grow, dp-only slicing under a committed layout, and the store
prefixes its layout listener re-forms the cross-group process groups under.
``MeshAxis``'s shift and all-to-all are held to ``jax.lax.ppermute`` and
``jax.lax.all_to_all`` in a ``shard_map`` over the same number of CPU
devices, bit for bit.  The mesh itself is built by every thread rank over
raw gloo groups (``ft_init_device_mesh`` over ``local_worlds``, and over a
``TCPStore`` through ``initialize_multihost``), and two replica groups of
two cp ranks each train under their Managers, ending bitwise equal: the
Manager's ``group_world_size > 1`` path (the store handoff to the group's
Manager server, the per-rank cross-group ring).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from torchft_tpu.parallel import device_mesh as jdm
from torchft_tpu.parallel import layout as jlayout
from torchft_tpu_torch.parallel import device_mesh as tdm
from torchft_tpu_torch.parallel import layout as tlayout
from torchft_tpu_torch.parallel import multihost
from torchft_tpu_torch.parallel.axis import InnerMesh, MeshAxis


class _StubManager:
    """The replica dimension's live values, settable between calls."""

    def __init__(self, n, rank):
        self.n, self.rank = n, rank

    def num_participants(self):
        return self.n

    def participating_rank(self):
        return self.rank

    def is_participating(self):
        return self.rank is not None

    def replica_id(self):
        return f"stub_{self.rank}"


def _meshes(manager):
    jmesh = jdm.ManagedDeviceMesh(manager, Mesh(np.array(jax.devices()[:1]), ("cp",)))
    tmesh = tdm.ManagedDeviceMesh(manager, InnerMesh([MeshAxis("cp", None, 0, 1)]))
    return jmesh, tmesh


@pytest.mark.parametrize("batch", [1, 7, 32, 33])
def test_global_batch_slice_matches_jax_under_shrink_and_grow(batch):
    manager = _StubManager(1, 0)
    jmesh, tmesh = _meshes(manager)
    for world in (1, 3, 5, 8, 2, 40, 1):  # grow, shrink, grow past the batch
        manager.n = world
        for rank in list(range(world)) + [None]:
            manager.rank = rank
            assert tmesh.global_batch_slice(batch) == jmesh.global_batch_slice(batch)
        slices = []
        for rank in range(world):
            manager.rank = rank
            slices.append(tmesh.global_batch_slice(batch))
        assert sum(e - s for s, e in slices) == batch
    manager.rank = None
    assert tmesh.global_batch_slice(batch) == (0, 0)


class _RecordingPG:
    def __init__(self):
        self.calls = []

    def configure(self, *args):
        self.calls.append(args)


@pytest.mark.parametrize("key", [(2, 2, 1), (3, 2, 1), (1, 2, 2)])
def test_layout_slices_and_listener_prefixes_match_jax(key):
    dp, shard, pp = key
    world = dp * shard * pp
    manager = _StubManager(world, 0)
    jmesh, tmesh = _meshes(manager)
    recorded = {}
    for side, mesh, mod in (("jax", jmesh, jlayout), ("port", tmesh, tlayout)):
        ctrl = mod.LayoutController(mod.LayoutConstraints())
        ctrl.state.active = mod.Layout(dp, shard, pp, 3)
        row, col = _RecordingPG(), _RecordingPG()
        mesh.attach_layout(ctrl, row_pg=row, col_pg=col)
        for rank in range(world):
            manager.rank = rank
            mesh._on_layout_commit(
                mod.Layout(dp, shard, pp, 3),
                {"rank": rank, "store_address": "127.0.0.1:29500/prefix"},
            )
        manager.rank = None
        mesh._on_layout_commit(mod.Layout(dp, shard, pp, 3), {"rank": None})
        slices = []
        for rank in range(world):
            manager.rank = rank
            slices.append(mesh.global_batch_slice(24))
        recorded[side] = (row.calls, col.calls, slices, mesh.layout().key())
    assert recorded["port"] == recorded["jax"]
    row_calls = recorded["port"][0]
    assert row_calls[0][0].startswith("127.0.0.1:29500/prefix/torchft/layout/3/row/")


def test_shape_and_axis_names_match_jax():
    manager = _StubManager(3, 1)
    jmesh = jdm.ManagedDeviceMesh(
        manager, Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "cp")))
    fake = _FakeGroup()
    tmesh = tdm.ManagedDeviceMesh(
        manager, InnerMesh([MeshAxis("dp", fake, 1, 2), MeshAxis("cp", fake, 0, 2)]))
    assert tmesh.axis_names == jmesh.axis_names
    assert tmesh.shape() == jmesh.shape()
    assert tmesh.num_participants() == 3 and tmesh.replica_rank() == 1


class _FakeGroup:
    def name(self):
        return "gloo"


def test_ft_init_device_mesh_builds_row_major_axes_over_thread_ranks():
    worlds = multihost.local_worlds(4)

    def rank(r):
        fmesh = tdm.ft_init_device_mesh(None, {"dp": 2, "cp": 2}, groups=worlds[r],
                                        device="cpu")
        mesh = fmesh.mesh
        coords = (mesh.axis_index("dp"), mesh.axis_index("cp"))
        x = torch.tensor([float(r), 1.0])
        mesh.axis("cp").psum_([x])  # over the cp line only
        y = torch.tensor([float(r)])
        mesh.psum_([y])  # over every axis
        return coords, mesh.shape, x.tolist(), y.item()

    out = multihost.run_ranks(rank, 4, timeout=60.0)
    for r, (coords, shape, x, y) in enumerate(out):
        assert coords == tuple(int(c) for c in np.unravel_index(r, (2, 2)))
        assert shape == {"dp": 2, "cp": 2}
        line = [r - r % 2, r - r % 2 + 1]  # the ranks sharing r's dp index
        assert x == [float(sum(line)), 2.0]
        assert y == 6.0


def test_ft_init_device_mesh_refuses_what_it_cannot_build():
    """An axis the port does not know is refused; fsdp, tp, pp and ep
    build their groups like any other axis."""
    worlds = multihost.local_worlds(2)
    with pytest.raises(ValueError, match="unknown inner axis 'sp'"):
        tdm.ft_init_device_mesh(None, {"sp": 2}, groups=worlds[0], device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tdm.ft_init_device_mesh(None, {"cp": 4}, groups=worlds[0], device="cpu")
    one = tdm.ft_init_device_mesh(None, {"dp": 1, "tp": 1}, device="cpu")
    assert one.mesh.shape == {"dp": 1, "tp": 1} and one.mesh.size == 1

    for axis in ("fsdp", "pp", "ep"):
        worlds = multihost.local_worlds(2)

        def rank(r, axis=axis):
            mesh = tdm.ft_init_device_mesh(None, {axis: 2}, groups=worlds[r], device="cpu").mesh
            x = torch.tensor([r + 1.0])
            mesh.axis(axis).psum_([x])
            return mesh.axis_index(axis), x.item()

        assert multihost.run_ranks(rank, 2, timeout=60.0) == [(0, 3.0), (1, 3.0)], axis


def test_shift_and_all_to_all_match_jax_bitwise():
    """ppermute by one and the tiled all-to-all over 4 ranks, on bf16 and
    f32 blocks; bf16 crosses as its 16-bit pattern."""
    n = 4
    rng = np.random.default_rng(3)
    glob = rng.standard_normal((n * 2, 8)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:n]), ("cp",))

    def body(x):
        shifted = jax.lax.ppermute(x, "cp", [(i, (i + 1) % n) for i in range(n)])
        a2a = jax.lax.all_to_all(x, "cp", split_axis=1, concat_axis=0, tiled=True)
        return shifted, a2a

    j_shift, j_a2a = jax.shard_map(
        body, mesh=mesh, in_specs=P("cp"), out_specs=(P("cp"), P("cp")))(jnp.asarray(glob))
    j_a2a = np.asarray(j_a2a).reshape(n, -1, 8 // n)
    bits = torch.from_numpy(rng.integers(-2**15, 2**15, (2, 8), dtype=np.int16))
    worlds = multihost.local_worlds(n)

    def rank(r):
        axis = MeshAxis("cp", worlds[r].new_group("cp", range(n)), r, n)
        x = torch.from_numpy(glob[2 * r:2 * r + 2])
        bf = (bits + r).view(torch.bfloat16)  # NaN and subnormal patterns too
        shifted, bf_back = axis.shift([x, bf])
        return shifted, bf_back.view(torch.int16), axis.all_to_all_raw(x, 1, 0)

    out = multihost.run_ranks(rank, n, timeout=60.0)
    for r, (shifted, bf_bits, a2a) in enumerate(out):
        np.testing.assert_array_equal(shifted.numpy(), np.asarray(j_shift)[2 * r:2 * r + 2])
        assert torch.equal(bf_bits, bits + (r - 1) % n)
        np.testing.assert_array_equal(a2a.numpy(), j_a2a[r])


def test_all_gather_and_reduce_scatter_match_jax_bitwise():
    """``MeshAxis.all_gather`` against ``jax.lax.all_gather(tiled=True)``
    and ``reduce_scatter`` against ``jax.lax.psum_scatter(tiled=True)``
    over 4 ranks, several tensors of one call along their own dims; bf16
    crosses the gather as its 16-bit pattern, and the reduce-scatter of a
    bf16 tensor sums in f32 and rounds once."""
    n = 4
    rng = np.random.default_rng(4)
    a = rng.standard_normal((n * 2, 6)).astype(np.float32)
    b = rng.standard_normal((n * 3, n * 4)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:n]), ("fsdp",))

    def body(xa, xb):
        return (jax.lax.all_gather(xa, "fsdp", axis=0, tiled=True),
                jax.lax.psum_scatter(xb, "fsdp", scatter_dimension=1, tiled=True))

    j_gather, j_rs = jax.shard_map(
        body, mesh=mesh, in_specs=(P("fsdp"), P("fsdp")),
        out_specs=(P("fsdp"), P("fsdp")))(jnp.asarray(a), jnp.asarray(b))
    j_gather = np.asarray(j_gather).reshape(n, n * 2, 6)
    j_rs = np.asarray(j_rs).reshape(n, 3, 4)
    bits = torch.from_numpy(rng.integers(-2**15, 2**15, (3, 2), dtype=np.int16))
    worlds = multihost.local_worlds(n)

    def rank(r):
        axis = MeshAxis("fsdp", worlds[r].new_group("fsdp", range(n)), r, n)
        bf = (bits + r).view(torch.bfloat16)
        got_a, got_bf = axis.all_gather([torch.from_numpy(a[2 * r:2 * r + 2]), bf], [0, 1])
        (got_b,) = axis.reduce_scatter([torch.from_numpy(b[3 * r:3 * r + 3])], [1])
        halves = torch.full((2, n), 0.5 + r, dtype=torch.bfloat16)
        (got_h,) = axis.reduce_scatter([halves], [1])
        return got_a, got_bf.view(torch.int16), got_b, got_h, dict(axis.stats)

    out = multihost.run_ranks(rank, n, timeout=60.0)
    for r, (got_a, got_bf, got_b, got_h, stats) in enumerate(out):
        np.testing.assert_array_equal(got_a.numpy(), j_gather[r])
        assert torch.equal(got_bf, torch.cat([bits + i for i in range(n)], dim=1))
        np.testing.assert_array_equal(got_b.numpy(), j_rs[r])
        # 0.5 + 1.5 + 2.5 + 3.5 = 8, exact in bf16 only once summed in f32
        assert got_h.dtype == torch.bfloat16 and torch.equal(
            got_h, torch.full((2, 1), 8.0, dtype=torch.bfloat16))
        # bytes sent: the shards to 3 peers; the f32 blocks for 3 peers
        assert stats["all_gather_bytes"] == 3 * (2 * 6 * 4 + 3 * 2 * 2)
        assert stats["reduce_scatter_bytes"] == 3 * (3 * 4 * 4 + 2 * 1 * 4)


def test_initialize_multihost_over_a_tcp_store():
    # rank 0's store serves on the socket bound here
    address, listener = multihost.coordinator_listener()

    def rank(r):
        world = multihost.initialize_multihost(
            address, 2, r, timeout=30.0, listener=listener if r == 0 else None)
        assert world.backend == "gloo" and world.size == 2
        fmesh = tdm.ft_init_device_mesh(None, {"cp": 2}, groups=world, device="cpu")
        x = torch.tensor([r + 1.0])
        fmesh.mesh.psum_([x])
        return x.item()

    assert multihost.run_ranks(rank, 2, timeout=60.0) == [3.0, 3.0]


@pytest.mark.parametrize("failing", [{1: 1}, {0: 1, 3: 2}])
def test_a_gloo_group_whose_handshake_fails_on_a_rank_is_built_again(monkeypatch, failing):
    """Gloo's full-mesh handshake failed on one rank of a loaded host
    ("Connection closed by peer" from a peer that did not fail): every rank
    of the group then builds it again, and the group works.  ``failing``
    maps a rank to how many of its constructions raise."""
    real = multihost.dist.ProcessGroupGloo
    left = dict(failing)
    built = []
    lock = threading.Lock()

    def flaky(store, rank, size, timeout):
        with lock:
            fail = left.get(rank, 0) > 0
            if fail:
                left[rank] -= 1
        built.append(rank)
        if fail:
            raise RuntimeError("Gloo connectFullMesh failed with ... Connection closed by peer")
        return real(store, rank, size, timeout)

    monkeypatch.setattr(multihost.dist, "ProcessGroupGloo", flaky)
    worlds = multihost.local_worlds(4, timeout=3.0)

    def rank(r):
        group = worlds[r].new_group("dp", range(4))
        axis = MeshAxis("dp", group, r, 4)
        x = torch.tensor([r + 1.0])
        axis.psum_([x])
        return x.item()

    assert multihost.run_ranks(rank, 4, timeout=60.0) == [10.0] * 4
    assert len(built) == 4 * (1 + max(failing.values()))


def test_a_gloo_group_that_never_builds_raises_on_every_rank(monkeypatch):
    def broken(store, rank, size, timeout):
        raise RuntimeError("Gloo connectFullMesh failed")

    monkeypatch.setattr(multihost.dist, "ProcessGroupGloo", broken)
    worlds = multihost.local_worlds(2, timeout=3.0)
    errors = []

    def rank(r):
        try:
            worlds[r].new_group("dp", range(2))
        except RuntimeError as e:
            errors.append(str(e))

    multihost.run_ranks(rank, 2, timeout=60.0)
    assert len(errors) == 2
    assert all(f"failed {multihost.GLOO_CONNECT_ATTEMPTS} times" in e for e in errors)


def test_host_sharded_array_returns_this_ranks_shard():
    glob = np.arange(24, dtype=np.float32).reshape(4, 6)
    idx = (slice(2, 4), slice(0, 3))
    shard = multihost.host_sharded_array(glob.shape, idx, lambda i: glob[i])
    np.testing.assert_array_equal(shard.numpy(), glob[2:4, 0:3])
    with pytest.raises(ValueError, match="expected"):
        multihost.host_sharded_array(glob.shape, idx, lambda i: glob)


def test_two_groups_of_two_cp_ranks_train_bitwise_equal_under_managers():
    """Two replica groups x cp = 2 thread ranks, each rank with its own
    Manager (group_rank = its cp rank, group_world_size = 2) that finds its
    group's Manager server through the group's store; ring attention over
    the cp axis, the in-group gradient sum, the FT allreduce between the
    groups' same-rank members, AdamW; three committed steps leave all four
    ranks' parameters and AdamW state bitwise equal."""
    from torchft_tpu_torch import (
        DistributedDataParallel,
        Manager,
        OptimizerWrapper,
        ProcessGroupTCP,
        module_grads,
    )
    from torchft_tpu_torch.coordination import LighthouseServer, StoreServer
    from torchft_tpu_torch.models import transformer as tf

    cfg = tf.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        n_layers=2, max_seq_len=256, dtype=torch.float32, remat=False,
        attn_impl="ring",
    )
    lighthouse = LighthouseServer(min_replicas=2, join_timeout_ms=100,
                                  heartbeat_timeout_ms=5000)
    stores = [StoreServer() for _ in range(2)]
    worlds = [multihost.local_worlds(2) for _ in range(2)]

    def run(gid, r):
        model = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        manager = Manager(
            pg=ProcessGroupTCP(timeout=30.0), min_replica_size=2,
            load_state_dict=lambda sd: None, state_dict=lambda: {},
            lighthouse_addr=lighthouse.address(), replica_id=f"cp{gid}",
            group_rank=r, group_world_size=2, store_addr=stores[gid].address(),
            use_async_quorum=False, timeout=30.0, quorum_timeout=30.0,
            init_sync=False,
        )
        try:
            fmesh = tdm.ft_init_device_mesh(manager, {"cp": 2}, groups=worlds[gid][r],
                                            device="cpu")
            grad_step = tf.make_grad_step(cfg, fmesh.mesh)
            optim = OptimizerWrapper(manager, opt)
            ddp = DistributedDataParallel(manager)
            losses = []
            while manager.current_step() < 3:
                optim.zero_grad()
                step = manager.current_step()
                tokens = torch.randint(0, 256, (2, 256), generator=torch.Generator()
                                       .manual_seed(100 * gid + step))
                loss, _ = grad_step(model, tokens)
                avg = ddp.allreduce_gradients(module_grads(model)).wait(timeout=30)
                assert optim.step(model, avg)
                losses.append(float(loss))
            state = {n: p.detach().clone() for n, p in model.named_parameters()}
            for n, p in model.named_parameters():
                for k, v in opt.state[p].items():
                    state[f"{n}/{k}"] = v.clone()
            return manager.current_step(), losses, state, fmesh.num_participants()
        finally:
            manager.shutdown()

    results = {}

    def group(gid):
        results[gid] = multihost.run_ranks(lambda r: run(gid, r), 2, timeout=90.0)

    threads = [threading.Thread(target=group, args=(g,), daemon=True) for g in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        lighthouse.shutdown()
        for s in stores:
            s.shutdown()
    assert sorted(results) == [0, 1]
    ranks = [res for g in (0, 1) for res in results[g]]
    ref = ranks[0][2]
    for final_step, losses, state, participants in ranks:
        assert final_step == 3 and participants == 2
        assert all(np.isfinite(losses))
        assert state.keys() == ref.keys()
        assert all(torch.equal(state[k], ref[k]) for k in ref)
    # the groups trained on different tokens; a group's ranks agree
    assert results[0][0][1] == results[0][1][1] != results[1][0][1]

