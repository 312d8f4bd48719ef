"""chip_smoke.py on the CPU: its main path at a tiny size (the rehearsal a
chip run should follow), and its refusal to report a result without a card
or outside a checkout."""

import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import chip_smoke
from torchft_tpu_torch.models import transformer as tf
from torchft_tpu_torch.ops import flash_attention as fa
from torchft_tpu_torch.ops import pallas_quant as pq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_path_rehearsal_on_cpu():
    cfg = tf.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        n_layers=1, max_seq_len=128, dtype=torch.float32, remat=False,
        attn_impl="flash",
    )
    before = fa.flash_fwd_plain.calls
    summary = chip_smoke.main_path(cfg, batch=1, seq=128, device="cpu")
    assert summary["rejoiner_phases_ms"]["heal_recv"] > 0
    assert summary["survivor_phases_ms"]["heal_send"] > 0
    assert len(summary["losses"]) == 10  # 5 + 3 + 2 group-steps
    assert all(x == x for x in summary["losses"])
    # on CPU tensors the wrappers take the twins: 10 group-steps x 1 layer
    assert fa.flash_fwd_plain.calls - before == 10


def test_diloco_path_rehearsal_on_cpu():
    """The DiLoCo phase at a tiny f32 size: 2 layers in 2 fragments (one
    block each, big enough that int8 beats f32 on the wire by the phase's
    3.5x), sync_every=4, a kill after outer step 2 and a rejoin.  The
    path asserts the heal, each synced fragment and every fragment's
    backup and outer state bitwise equal across the groups; the device
    capture runs kernel D's twin here."""
    cfg = tf.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        n_layers=2, max_seq_len=128, dtype=torch.float32, remat=False,
        attn_impl="flash",
    )
    calls = pq.quantize_int8_plain.calls
    summary = chip_smoke.diloco_path(
        cfg, batch=1, seq=128, device="cpu", n_fragments=2, sync_every=4,
        total_syncs=4, kill_at=2, device_quantize=True,
    )
    assert summary["heal_recv_ms"] > 0
    assert [s["fragment"] for s in summary["syncs"]] == [0, 1, 0, 1]
    # 4 survivor syncs + 2 of the first group1 + 2 of the rejoiner
    assert pq.quantize_int8_plain.calls - calls == 8
    assert all(x == x for x in summary["losses"])


def test_cp_path_rehearsal_on_cpu():
    """Phase 10 at a tiny f32 size through the same spawn code: four
    processes (two groups x cp = 2), a lighthouse here, a Manager per
    process; the path itself asserts three commits everywhere, the ring
    against the one-device model and Ulysses at step 0, each planted fault
    caught, and all four processes' parameters and AdamW state bitwise
    equal."""
    cfg = tf.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        n_layers=2, max_seq_len=256, dtype=torch.float32, remat=False,
        attn_impl="ring",
    )
    summary = chip_smoke.cp_path(cfg, batch=1, seq=256, device="cpu", timeout=120.0)
    assert summary["processes"] == 4
    assert len(summary["steps"]) == chip_smoke.CP_STEPS * 4  # steps x 4 processes
    # T_local = 128: a layer's forward shifts one K and one V chunk of
    # 128 x 1 head x 32 f32 (16 KiB each); its backward shifts K, V and
    # their f32 gradient accumulators, then the accumulators home: 8
    # chunks a layer, 2 layers
    assert summary["exchange_bytes_per_step"] == 2 * 8 * 16384
    # f32 on the CPU: ring, Ulysses and the one-device model agree with
    # the f32 dense model to rounding
    checks = summary["checks"]
    assert checks["ring_loss_rel_err"] < 1e-5 and checks["ulysses_loss_rel_err"] < 1e-5
    # the remat "dots" step: the values of full remat, and the ring bytes of
    # the step without remat (full remat sends the forward's again)
    dots = checks["remat_dots"]
    assert dots["failed"] == [] and dots["bitwise"]
    assert dots["dots_exchange_bytes"] == summary["exchange_bytes_per_step"]
    assert dots["full_exchange_bytes"] > dots["dots_exchange_bytes"]
    for key in ("one_device_to_f32", "ring_to_f32", "ulysses_to_f32",
                "ring_to_one_device", "ulysses_to_ring"):
        assert checks[key]["err"] < 1e-5, (key, checks[key])
    assert checks["failed"] == []
    # each planted fault fails both of the ring's gradient checks (the path
    # itself asserts one)
    controls = checks["controls"]
    assert sorted(controls) == sorted(chip_smoke.CP_CONTROLS)
    for kind, c in controls.items():
        assert set(chip_smoke.CP_RING_GRAD_CHECKS) <= set(c["failed"]), (kind, c)
    # kernels run as their twins in the children on CPU tensors
    assert summary["launches"] == {"flash_fwd": 0, "flash_bwd_kv": 0, "flash_bwd_q": 0}
    assert summary["launches_by_process"] == {
        f"g{g}r{r}": summary["launches"] for g in range(2) for r in range(2)}
    assert all(n > 0 for n in summary["twin_calls"].values())


def test_cp_path_fails_when_a_child_fails():
    """A child's exception reaches the parent, which kills the rest: a
    sequence of 255 tokens does not split over cp = 2."""
    cfg = tf.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        n_layers=1, max_seq_len=256, dtype=torch.float32, remat=False,
        attn_impl="ring",
    )
    with pytest.raises(RuntimeError, match="do not split over"):
        chip_smoke.cp_path(cfg, batch=1, seq=255, device="cpu", timeout=60.0)


def test_hsdp_path_rehearsal_on_cpu():
    """Phase 11 at a tiny f32 size through the same spawn code: eight
    processes (two groups x fsdp 2 x tp 2), a Manager per process, 1 KV
    head that tp = 2 does not divide (the flagship's case); group 1 is
    SIGKILLed after its second commit, restarted, and heals rank by rank.
    The path itself asserts ``HSDP_STEPS`` commits everywhere, the heal at
    the survivors' step, the step-0 checks and the planted fault caught,
    and rank r of both groups bitwise equal."""
    cfg = tf.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        n_layers=2, max_seq_len=128, dtype=torch.float32, remat=True,
        attn_impl="flash",
    )
    summary = chip_smoke.hsdp_path(cfg, batch=4, seq=128, device="cpu", timeout=120.0)
    assert summary["processes"] == 8
    # group 0: every step x 4 ranks; the restarted group 1: from the
    # kill's step on, x 4
    steps, kill = chip_smoke.HSDP_STEPS, chip_smoke.HSDP_KILL_AFTER
    assert len(summary["steps"]) == 4 * steps + 4 * (steps - kill)
    assert summary["params_per_rank"] == sum(
        p.numel() for p in tf.Transformer(cfg, "cpu").parameters()
        if p.dim() > 1) // 4 + (2 * 2 + 1) * 64
    heals = summary["heals"]
    assert sorted(heals) == [f"g1r{r}" for r in range(4)]
    assert all(h["step"] == chip_smoke.HSDP_KILL_AFTER and h["wire_bytes"] > 0
               for h in heals.values())
    # f32 on the CPU: the sharded model and the one-device model agree
    # with the f32 dense model to rounding; the control is off by half
    checks = summary["checks"]
    assert checks["failed"] == [] and checks["loss_rel_err"] < 1e-5
    for key in ("one_device_to_f32", "sharded_to_f32", "sharded_to_one_device"):
        assert checks[key]["err"] < 1e-5, (key, checks[key])
    control = checks["controls"]["reduce_scatter_averaged"]
    assert set(chip_smoke.HSDP_GRAD_CHECKS) <= set(control["failed"])
    assert abs(control["sharded_to_one_device"]["err"] - 0.5) < 1e-4
    # every step moved bytes on both axes: fsdp gathers and reduce-scatters,
    # tp psums (and the KV weights' gather)
    moved = summary["bytes_per_step"]
    assert moved["fsdp"]["all_gather"] > 0 and moved["fsdp"]["reduce_scatter"] > 0
    assert moved["tp"]["psum"] > 0 and moved["tp"]["all_gather"] > 0
    # kernels run as their twins in the children on CPU tensors
    assert summary["launches"] == {"flash_fwd": 0, "flash_bwd_kv": 0, "flash_bwd_q": 0}
    # every process's training steps are counted, the killed ones' too
    assert sorted(summary["launches_by_process"]) == sorted(
        [f"g{g}r{r}" for g in range(2) for r in range(4)]
        + [f"g1r{r}_killed" for r in range(4)])
    assert all(n > 0 for n in summary["twin_calls"].values())


def _run(args, cwd, env):
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120,
    )


def test_refuses_without_a_card_and_outside_a_checkout(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run([os.path.join(REPO, "chip_smoke.py")], REPO, env)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    # alone in a directory it must fail even where a card answers: the port
    # is not importable there (the card is faked for this check)
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env.pop("PYTHONPATH", None)
    out = _run(
        ["-c", "import sys, torch; torch.cuda.is_available = lambda: True; "
         "import chip_smoke; sys.exit(chip_smoke.main())"],
        tmp_path, env,
    )
    assert out.returncode != 0 and "not importable" in out.stderr


def test_heal_path_rehearsal_on_cpu():
    """The heal phase at a tiny size: three groups on the Manager's default
    HTTPTransport, a kill after step 3 and a striped heal from the two
    survivors; the path asserts commits, two sources, bitwise equal groups
    and no rejected plan."""
    cfg = tf.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        n_layers=1, max_seq_len=128, dtype=torch.float32, remat=False,
        attn_impl="flash",
    )
    before = fa.flash_fwd_plain.calls
    summary = chip_smoke.heal_path(cfg, batch=1, seq=128, device="cpu")
    heal = summary["heal"]
    assert heal["sources"] == 2 and heal["at_step"] == 3
    assert heal["wire_bytes"] > 0 and heal["changed"] == heal["fragments"]
    assert set(heal["phases_ms"]) == set(chip_smoke.HEAL_PHASES)
    assert summary["plan_verify"]["stripe/accept"] >= 1
    assert summary["data_plane"] == "native"
    assert {"host_copy", "serialize", "sha256_hashlib", "bytes"} <= set(summary["encode"])
    # 2 survivors x 5 + 3 before the kill + 2 after it
    assert len(summary["losses"]) == 15
    assert fa.flash_fwd_plain.calls - before == 15


def _tiny():
    return tf.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        n_layers=1, max_seq_len=128, dtype=torch.float32, remat=False,
        attn_impl="flash",
    )


def test_cold_restore_path_rehearsal_on_cpu():
    """The cold-restore phase at a tiny size: two groups spill every step
    to a temporary store, stop together after step 4, and two fresh groups
    restore step 4 from both disks bitwise (the path asserts it) and train
    step 5; the store directory is gone afterwards."""
    before = fa.flash_fwd_plain.calls
    summary = chip_smoke.cold_restore_path(_tiny(), batch=1, seq=128, device="cpu")
    assert summary["steps"] == 4 and len(summary["losses"]) == 2
    assert summary["disk_bytes"] > 0
    assert [f["version"] for f in summary["final_spill"]] == [4, 4]
    for r in summary["restores"]:
        assert r["restore"]["version"] == 4 and r["restore"]["disks"] == 2
        assert r["sources"] == 2 and r["wire_bytes"] > 0
        assert {"heal_wire", "heal_decode"} <= set(r["phases"])
    assert all("snapshot_s" in s and s["version"] == s["at_step"]
               for s in summary["spills"] if s["at_step"])
    # 2 groups x 4 steps, then 2 x 1 after the restore
    assert fa.flash_fwd_plain.calls - before == 10
    assert "TORCHFT_STORE_DIR" not in os.environ


def test_reshard_path_rehearsal_on_cpu():
    """The reshard phase at a tiny size: four groups bootstrap to (2, 2, 1),
    group 3 stops before step 3, and the survivors switch to (1, 3, 1) at
    one step with shards equal to the reference vector (the path asserts
    both); the shrink moves a third and a sixth of the state."""
    summary = chip_smoke.reshard_path(_tiny(), batch=1, seq=128, device="cpu")
    total = summary["sharded_bytes"]
    fetched = sorted(sw["fetched_bytes"] for sw in summary["switch"].values())
    # each leaf splits on its own, so a sixth and a third to a few elements
    assert fetched[0] == 0
    assert abs(fetched[1] - total / 6) <= 64 and abs(fetched[2] - total / 3) <= 64
    assert all(sw["layout"] == (1, 3, 1) for sw in summary["switch"].values())
    assert summary["switch_step"] == 4
    assert len(summary["losses"]) == 3 * 6 + 3


def test_moe_serve_path_rehearsal_on_cpu():
    """The MoE serving phase at a tiny f32 size: two groups train a 2-layer,
    4-expert MoE transformer for 5 steps; group 0 publishes every committed
    step into a root-then-leaf relay chain; the root dies once the leaf
    serves v3.  The path asserts that every fetched version's parameters
    and eval logits equal group 0's record bitwise, that the last version
    was fetched, that the leaf failed over, and that the groups end equal."""
    import dataclasses

    cfg = dataclasses.replace(_tiny(), n_layers=2, n_experts=4, remat=True)
    before = fa.flash_fwd_plain.calls
    summary = chip_smoke.moe_serve_path(cfg, batch=1, seq=128, device="cpu",
                                        failover_s=0.2)
    fetches = summary["fetches"]
    assert len(fetches) >= 3 and fetches[-1]["version"] == 5
    assert fetches[0]["mode"] == "whole" and {f["mode"] for f in fetches[1:]} == {"delta"}
    assert summary["relay_failovers"] >= 1
    assert len(summary["losses"]) == 10
    assert len(summary["aux"]) == 5 and all(a > 0 for a in summary["aux"])
    assert all(len(d) == 2 and all(0 <= x <= 1 for x in d) for d in summary["dropped"])
    assert set(summary["publishes"]) >= {1, 2, 3}
    # 2 groups x 5 steps x 2 layers, each a forward and its recompute; the
    # eval forwards of group 0's records and the client's fetches on top
    assert fa.flash_fwd_plain.calls - before >= 2 * 5 * 2 * 2 + 2 * (5 + 3)
    assert "TORCHFT_SERVING_FAILOVER_S" not in os.environ


#: the phases ``chip_smoke.py`` runs, in order (its docstring numbers them)
PHASES = (
    "Device", "Kernel check", "Main path", "Heal path", "Quantization kernels",
    "DiLoCo path", "Cold restore", "Reshard", "MoE serving", "Context parallelism",
    "HSDP", "Pipeline and expert parallelism", "Supervised fleet", "Transport bench",
    "Example", "Invariants",
)


def test_the_phase_list_and_the_pp_summary_keys_are_pinned():
    """The script's phases 1-16 in order, ``main`` driving the paths'
    functions in that order, and the keys of phase 12's summary that
    ``log_pp`` and ``main`` read; phase 13's constants and trainer entry;
    phase 16's depth and steps."""
    import inspect
    import re

    doc = chip_smoke.__doc__
    found = [m.group(1) for m in re.finditer(r"^ ?(\d+)\. ", doc, re.M)]
    assert found == [str(i) for i in range(1, len(PHASES) + 1)]
    for i, name in enumerate(PHASES, 1):
        assert re.search(rf"^ ?{i}\. {name}", doc, re.M), name
    src = inspect.getsource(chip_smoke.main)
    paths = re.findall(r"= drive\(\s*(\w+)[,)]", src)
    assert paths == ["main_path", "heal_path", "diloco_path", "cold_restore_path",
                     "reshard_path", "moe_serve_path", "cp_path", "hsdp_path", "pp_path",
                     "fleet_path", "transport_path", "example_path", "invariants_path"]
    # phases 12's and 13's launches join the kernels' record
    assert "pp_launches, fl_launches))" in src
    assert (chip_smoke.FLEET_STEPS, chip_smoke.FLEET_WORKER_KILL_STEP,
            chip_smoke.FLEET_LEADER_KILL_AFTER, chip_smoke.FLEET_TRAINER_KILL_AFTER) == (
                10, 3, 4, 6)
    assert chip_smoke.FLEET_TRAINER == "import chip_smoke; chip_smoke.fleet_member()"
    assert "log_fleet(card, fsum" in src
    assert chip_smoke.PP_INNER == {"pp": 2, "ep": 2} and chip_smoke.PP_MICROBATCHES == 4
    assert chip_smoke.moe_config().n_layers == 2 and chip_smoke.moe_config().d_model == 1536
    assert (chip_smoke.INVARIANT_LAYERS, chip_smoke.INVARIANT_STEPS,
            chip_smoke.INVARIANT_KILL_AFTER) == (2, 4, 2)
    # phase 16's launches join the kernels' record too
    assert "+ i_launches.get(name, 0)," in src


def test_pp_path_rehearsal_on_cpu():
    """Phase 12 at a tiny f32 size through the same spawn code: eight
    processes (two groups x pp 2 x ep 2), a 2-layer 4-expert MoE model in 4
    microbatches; group 1 is SIGKILLed after its second commit, restarted,
    and heals rank by rank.  The path itself asserts ``PP_STEPS`` commits
    everywhere, the heal at the survivors' step, the step-0 checks (f32 here: the pp x
    ep model and the one-device model agree to rounding), both planted
    faults caught, and rank r of both groups bitwise equal."""
    cfg = tf.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        n_layers=2, max_seq_len=128, dtype=torch.float32, remat=True,
        attn_impl="flash", n_experts=4, moe_top_k=2, moe_capacity_factor=1.25,
    )
    summary = chip_smoke.pp_path(cfg, batch=8, seq=128, device="cpu", timeout=150.0)
    assert summary["processes"] == 8 and summary["bubble"] == 0.2
    steps, kill = chip_smoke.PP_STEPS, chip_smoke.PP_KILL_AFTER
    assert len(summary["steps"]) == 4 * steps + 4 * (steps - kill)
    # a rank: its stage's block (4 of 8 expert matrices each: 2 of 4
    # experts) beside the whole embedding and final norm
    block = sum(p.numel() for n, p in tf.Transformer(cfg, "cpu").named_parameters()
                if n.startswith("blocks.0."))
    experts = 3 * 4 * 64 * 128
    assert set(summary["params_per_rank"].values()) == {
        block - experts // 2 + 256 * 64 + 64}
    heals = summary["heals"]
    assert sorted(heals) == [f"g1r{r}" for r in range(4)]
    assert all(h["step"] == chip_smoke.PP_KILL_AFTER and h["wire_bytes"] > 0
               for h in heals.values())
    checks = summary["checks"]
    assert checks["failed"] == [] and checks["loss_rel_err"] < 1e-5
    assert checks["routing_margin"]["share"] <= chip_smoke.PP_TIE_SHARE
    for key in ("one_device_to_f32", "sharded_to_f32", "sharded_to_one_device"):
        assert checks[key]["err"] < 1e-5, (key, checks[key])
    assert sorted(checks["controls"]) == sorted(chip_smoke.PP_CONTROLS)
    for kind, c in checks["controls"].items():
        assert set(chip_smoke.PP_GRAD_CHECKS) <= set(c["failed"]), (kind, c)
    # every step moved bytes on both axes: the pp hops and the ep dispatch
    for moved in summary["bytes_per_step"].values():
        assert moved["pp"]["hop"] > 0 and moved["pp"]["psum"] > 0
        assert moved["ep"]["reduce_scatter"] > 0 and moved["ep"]["all_gather"] > 0
    assert set(summary["median_ms"]) == {
        "step_ms", "fwd_bwd_ms", "compute_ms", "pp_hop_ms", "pp_psum_ms",
        "ep_dispatch_ms", "ep_psum_ms", "ring_ms", "quorum_ms"}
    # kernels run as their twins in the children on CPU tensors
    assert summary["launches"] == {"flash_fwd": 0, "flash_bwd_kv": 0, "flash_bwd_q": 0}
    assert sorted(summary["launches_by_process"]) == sorted(
        [f"g{g}r{r}" for g in range(2) for r in range(4)]
        + [f"g1r{r}_killed" for r in range(4)])
    assert all(n > 0 for n in summary["twin_calls"].values())


def test_transport_and_example_paths_rehearsal_on_cpu():
    """Phases 14 and 15 at a tiny size on the CPU: both transport legs at 2
    MiB (each received leaf checked bitwise by the bench), and
    examples/torch/train_ddp.py run as a user runs it, for two steps."""
    t = chip_smoke.transport_path(gb=2 / 1024, device="cpu")
    assert t["http"]["bytes"] == t["pg"]["bytes"] == 2 << 20
    chip_smoke.log_transport("cpu", t)
    e = chip_smoke.example_path(steps=2, device="cpu")
    assert e["last_line"] == "done: 2 replica groups, 2 committed steps each on cpu"


def _stale_address_rank_follows(foreign_resets: bool) -> None:
    """A group's rank 1 built while the store still publishes the killed
    incarnation's server address, held by another process's listener;
    that listener then either closes (``foreign_resets`` False: the rank's
    connects are refused) or stays and resets every connection it gets.
    Rank 0 then starts; both ranks' quorum must succeed, rank 1 on rank 0's
    server under rank 0's replica id."""
    import socket
    import struct
    import threading

    from torchft_tpu_torch import Manager
    from torchft_tpu_torch.coordination import LighthouseServer, StoreClient, StoreServer
    from torchft_tpu_torch.parallel.process_group import ProcessGroupDummy

    lighthouse = LighthouseServer(min_replicas=1, join_timeout_ms=100)
    store = StoreServer()
    sc = StoreClient(store.address())
    foreign = socket.create_server(("127.0.0.1", 0))
    stale = f"127.0.0.1:{foreign.getsockname()[1]}"
    sc.set("replica_id", "grp:killed-incarnation")
    sc.set("manager_addr", stale)
    managers = []
    stop = threading.Event()

    def reset_every_connection():
        foreign.settimeout(0.1)
        while not stop.is_set():
            try:
                conn, _ = foreign.accept()
            except OSError:
                continue
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
            conn.close()

    def manager(rank):
        m = Manager(
            pg=ProcessGroupDummy(), min_replica_size=1, load_state_dict=lambda sd: None,
            state_dict=lambda: {}, lighthouse_addr=lighthouse.address(), replica_id="grp",
            group_rank=rank, group_world_size=2, store_addr=store.address(),
            connect_timeout=3.0, timeout=30.0, quorum_timeout=30.0,
            use_async_quorum=False,
        )
        managers.append(m)
        return m

    def quorum(m):
        m.start_quorum()
        m.wait_quorum()
        return m.errored()

    try:
        rank1 = manager(1)
        assert rank1._client.address() == stale  # the probe took the listener
        if foreign_resets:
            threading.Thread(target=reset_every_connection, daemon=True).start()
        else:
            foreign.close()
        rank0 = manager(0)
        with ThreadPoolExecutor(max_workers=2) as ex:
            errors = [f.result(timeout=60) for f in [ex.submit(quorum, m) for m in (rank0, rank1)]]
        assert errors == [None, None], errors
        assert rank1._client.address() == rank0._manager_server.address()
        assert rank1.replica_id() == rank0.replica_id() != "grp:killed-incarnation"
    finally:
        stop.set()
        for m in managers:
            m.shutdown(wait=False)
        foreign.close()
        sc.close()
        store.shutdown()
        lighthouse.shutdown()


def test_a_rank_wired_to_a_reused_stale_address_follows_its_group_server():
    """A restarted group's non-zero rank reads the killed incarnation's
    server address from the group's store before the new rank 0 republishes
    it; on a busy host another process's listener can hold that port, so
    the construction probe takes it.  Once that listener is gone the rank's
    quorum RPC met refused connections for its whole connect budget (the
    pp x ep rehearsal's failure under load); now its client re-reads the
    store on a refusal, follows the new server, and takes its replica id."""
    _stale_address_rank_follows(foreign_resets=False)


def test_a_rank_whose_stale_address_resets_its_connections_follows_its_group_server():
    """As above, but the other process's listener stays and resets the
    rank's connections (a port churner's socket closing with connections in
    its backlog: the HSDP rehearsal's quorum failure beside one).  The
    client re-reads the store after a broken connection too, before its
    one re-send."""
    _stale_address_rank_follows(foreign_resets=True)


def _group_of_two(lighthouse, store, connect_timeout=3.0):
    """Rank 0 then rank 1 of one replica group's Managers."""
    from torchft_tpu_torch import Manager
    from torchft_tpu_torch.parallel.process_group import ProcessGroupDummy

    return [Manager(
        pg=ProcessGroupDummy(), min_replica_size=1, load_state_dict=lambda sd: None,
        state_dict=lambda: {}, lighthouse_addr=lighthouse.address(), replica_id="grp",
        group_rank=rank, group_world_size=2, store_addr=store.address(),
        connect_timeout=connect_timeout, timeout=30.0, quorum_timeout=30.0,
        use_async_quorum=False) for rank in range(2)]


def _manager_server_answers(addr):
    """Whether a ManagerServer answers an RPC at ``addr``: a reply, or the
    server's error for it.  Once it has stopped, another process of a busy
    host may listen on its freed port: that one accepts a connection but
    answers nothing."""
    from torchft_tpu_torch.coordination import ManagerClient, RpcError

    client = ManagerClient(addr, connect_timeout=1.0)
    try:
        client._checkpoint_metadata(0, timeout=1.0)
    except RpcError:
        return True
    except (ConnectionError, TimeoutError):
        return False
    finally:
        client.close()
    return True


@pytest.mark.parametrize("rank1_leaves", [True, False])
def test_rank0_keeps_the_group_server_until_every_rank_has_left(rank1_leaves):
    """The pp x ep rehearsal's failure under the whole suite's load: the
    restarted group's rank 2 lost its last ``should_commit`` reply
    ("connection closed by peer") because rank 0, its own decision in hand,
    had finished and stopped the group's ManagerServer; rank 2 abstained
    from the committed step and its next quorum met refused connections.
    Now rank 0's shutdown keeps the server until every rank has left, or
    for ``connect_timeout`` when one never does."""
    import threading
    import time

    from torchft_tpu_torch.coordination import LighthouseServer, StoreServer

    lighthouse = LighthouseServer(min_replicas=1, join_timeout_ms=100)
    store = StoreServer()
    rank0, rank1 = _group_of_two(lighthouse, store)
    addr = rank0._manager_server.address()
    t0 = time.monotonic()
    leaving = threading.Thread(target=rank0.shutdown)
    try:
        leaving.start()
        time.sleep(1.0)
        assert leaving.is_alive() and _manager_server_answers(addr)
        if rank1_leaves:
            rank1.shutdown()
        leaving.join(timeout=10)
        assert not leaving.is_alive()
        waited = time.monotonic() - t0
        assert waited < 2.5 if rank1_leaves else 3.0 <= waited < 6.0, waited
        assert not _manager_server_answers(addr)
    finally:
        if not rank1_leaves:
            rank1.shutdown(wait=False)
        store.shutdown()
        lighthouse.shutdown()


def test_a_failed_killed_group_run_reports_every_process_and_its_whole_log():
    """When a process of phase 11's or 12's orchestration fails, the error
    names every process's state at that moment and carries each one's whole
    output, not a tail."""
    with pytest.raises(RuntimeError) as info:
        chip_smoke.killed_group_run("demo", _demo_worker, 2, 1, (), timeout=60.0)
    text = str(info.value)
    assert "demo path process g0r1 failed" in text and "rank 1 gives up" in text
    assert "----- process states at the failure -----" in text
    for gid in range(2):
        for rank in range(2):
            name = f"demo_g{gid}r{rank}_life0"
            assert f"----- {name} -----" in text
            # every line the process wrote, the first as the last
            assert all(f"{name} line {i}" in text for i in range(200)), name


def _demo_worker(gid, rank, life, args, park, results, log_path):
    """A process of :func:`test_a_failed_killed_group_run_reports_every_process_and_its_whole_log`:
    writes 200 lines; group 0's rank 1 fails once all four logs hold theirs,
    the others wait."""
    import glob
    import time as _time

    chip_smoke._log_to(log_path)
    for i in range(200):
        print(f"demo_g{gid}r{rank}_life{life} line {i}", flush=True)
    if (gid, rank) == (0, 1):
        logs = os.path.join(os.path.dirname(log_path), "*.log")
        deadline = _time.monotonic() + 50
        while _time.monotonic() < deadline and sum(
                open(f).read().count("\n") >= 200 for f in glob.glob(logs)) < 4:
            _time.sleep(0.05)
        results.put(("error", gid, rank, "rank 1 gives up"))
        return
    _time.sleep(60)


def test_invariants_path_rehearsal_on_cpu():
    """Phase 16 on the CPU: the lint and its selftest, the verifier in full
    and its counterexample through the port's diagnose, all as subprocesses
    over this tree; the vocabularies against a summary and the lock-checked
    run's own spans; and that run at a tiny f32 width on ``device="cpu"``
    (kernel twins), every step committed, no lock-order cycle, the
    lock-check gate as it was before."""
    from torchft_tpu_torch.utils import lockcheck

    was = lockcheck.enabled()
    summaries = [{"survivor_phases_ms": {"quorum_rpc": 1.0, "ring": 2.0},
                  "steps": [{"phases_ms": {"heal_wire": 1.0, "commit": 0.5}}]}]
    isum = chip_smoke.invariants_path(summaries, [], cfg=_tiny(), batch=1, seq=128,
                                      device="cpu")
    assert lockcheck.enabled() == was
    assert isum["lint"]["summary"].startswith("tft-lint: 0 finding(s) across 9 pass(es)")
    assert isum["lint_selftest"]["passes"] == 9
    scen = isum["verify"]["scenarios"]
    assert {"steady", "churn", "votes", "resize", "election", "restore", "plan"} <= set(scen)
    assert scen["steady"] == {"states": 39, "transitions": 50, "goals": 5}
    assert isum["verify"]["mutations_caught"] == 14 + 11
    ce = isum["counterexample"]
    assert ce["invariant"] == "heal-source-max-step" and ce["failure_phase"] == "heal_recv"
    assert ce["culprit"] == ce["replica"]
    lc = isum["lockcheck"]
    assert lc["cycles"] == [] and lc["steps"] == 4
    assert len(lc["step_ms"]["group0"]) == 4 and len(lc["step_ms"]["group1_healed"]) == 2
    voc = isum["vocabulary"]
    assert {"quorum_rpc", "ring", "heal_wire", "commit", "heal_recv"} <= set(voc["phases_seen"])
    assert voc["spans"] > 0 and "quorum_round" in voc["span_names"]
    assert voc["metrics"] > 0


def test_invariants_path_rejects_a_phase_outside_the_vocabulary():
    """A summary phase the Manager does not declare fails phase 16's check
    (the helper it uses), as does a recorded-phase set that drifts."""
    names = chip_smoke.summary_phase_names(
        [{"x": {"phases_ms": {"ring": 1.0, "made_up": 2.0}}}, {"phases": {"commit": 1}}])
    assert names == {"ring", "made_up", "commit"}
    from torchft_tpu_torch.manager import PROTOCOL_PHASES

    assert chip_smoke.recorded_phase_names() == set(PROTOCOL_PHASES)
    assert not names <= set(PROTOCOL_PHASES)
