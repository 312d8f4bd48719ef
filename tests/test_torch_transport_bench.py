"""The port's checkpoint-transport bench (``checkpointing/transport_bench.py``)
at a few MB on the CPU: both legs over the port's ``HTTPTransport`` and
``PGTransport``, every received tensor bitwise equal to the one sent."""

import pytest
import torch

from torchft_tpu_torch.checkpointing import transport_bench as tb

MB = 1 << 20


def test_state_dict_is_seeded_f32_tensors_on_the_device():
    a = tb.make_state_dict(3 * MB, "cpu", leaf_mb=1)
    b = tb.make_state_dict(3 * MB, "cpu", leaf_mb=1)
    assert sorted(a) == ["layer_0", "layer_1", "layer_2"]
    assert all(t.dtype == torch.float32 and t.numel() * 4 == MB for t in a.values())
    assert all(torch.equal(a[k], b[k]) for k in a)
    # under one leaf's size: one leaf of the whole size
    (small,) = tb.make_state_dict(4096, "cpu").values()
    assert small.numel() == 1024


@pytest.mark.parametrize("leg", ["http", "pg"])
def test_leg_receives_every_tensor_bitwise(leg, monkeypatch):
    sent, received = [], []
    check = tb.check_received

    def spy(state, got):
        check(state, got)
        sent.append(state)
        received.append({k: torch.as_tensor(v).clone() for k, v in got.items()})

    monkeypatch.setattr(tb, "check_received", spy)
    gb = 4 * MB / 1024**3
    r = tb.bench_http(gb, chunks=2, device="cpu") if leg == "http" else tb.bench_pg(gb, "cpu")
    assert r["bytes"] == 4 * MB and r["gbps"] > 0 and r["inplace_gbps"] > 0
    # a cold receive, an in-place receive and the live target it filled
    assert len(received) == 3
    for state, got in zip(sent, received):
        for k, t in state.items():
            assert torch.equal(got[k].view(torch.int32), t.view(torch.int32))


def test_a_flipped_bit_is_caught():
    state = tb.make_state_dict(4096, "cpu")
    bad = {k: v.clone() for k, v in state.items()}
    bad["layer_0"].view(torch.int32)[7] ^= 1
    tb.check_received(state, {k: v.clone() for k, v in state.items()})
    with pytest.raises(AssertionError, match="layer_0"):
        tb.check_received(state, bad)
    with pytest.raises(AssertionError, match="keys"):
        tb.check_received(state, {})


def test_cli_runs_both_legs_on_the_cpu_and_defaults_to_the_card(capsys):
    assert tb.main(["--gb", str(2 * MB / 1024**3), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("http ") and "\npg " in out and "GiB/s" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tb.main(["--gb", "0.001"])
