"""The port's package root: what it exports, the telemetry it installs at
import (``TORCHFT_USE_OTEL``, ``TORCHFT_METRICS_PORT``), and
``PureDistributedDataParallel``.

The install check runs in a fresh process with the env set before the
import, as the JAX package's tests/test_otel.py and tests/test_metrics.py
drive theirs: the OTLP log, metric and trace exporters are installed and
deliver to a collector, and the scrape server starts once (a Manager built
afterwards starts no second one).
"""

import json
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import torch

import torchft_tpu
import torchft_tpu_torch
from torchft_tpu.coordination import LighthouseServer as JaxLighthouse
from torchft_tpu.ddp import PureDistributedDataParallel as JaxPureDDP
from torchft_tpu.manager import Manager as JaxManager
from torchft_tpu.parallel.process_group import ProcessGroupTCP as JaxPG
from torchft_tpu_torch import (
    DistributedDataParallel,
    PureDistributedDataParallel,
)
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.parallel.process_group import ProcessGroupTCP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_root_exports_what_the_jax_package_exports():
    assert set(torchft_tpu.__all__) <= set(torchft_tpu_torch.__all__)
    for name in torchft_tpu_torch.__all__:
        assert getattr(torchft_tpu_torch, name) is not None
    assert torchft_tpu_torch.Optimizer is torchft_tpu_torch.OptimizerWrapper
    from torchft_tpu_torch.parallel.process_group import ProcessGroupBaby

    assert issubclass(torchft_tpu_torch.ProcessGroupBabyTCP, ProcessGroupBaby)
    assert torchft_tpu_torch.ProcessGroupBabyTCP.PG_CLASS is ProcessGroupTCP


class _Collector(BaseHTTPRequestHandler):
    paths: "list[str]" = []

    def do_POST(self):  # noqa: N802 - http.server API
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        type(self).paths.append(self.path)
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *args):
        pass


_PROBE = r"""
import json, sys, time
import torchft_tpu_torch
from torchft_tpu_torch.utils import logging as tlog, metrics, tracing
from torchft_tpu_torch.utils.otel import OTLPHTTPExporter
logs = [e for e in tlog._registered if isinstance(e, OTLPHTTPExporter)]
tracer = tracing.get_tracer()
server = metrics._env_server
tlog.log_event("commit", "env-installed", step=1)
tracer.export_span("probe", tracing.new_trace_id(), time.time_ns(), time.time_ns())
ok = [logs[0].flush(timeout=10.0), metrics._env_metrics_exporter.flush(),
      tracer.exporter.flush(timeout=10.0)]
# a Manager built after the import starts no second scrape server
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.parallel.process_group import ProcessGroupDummy
lh = LighthouseServer(min_replicas=1)
m = Manager(pg=ProcessGroupDummy(), min_replica_size=1, load_state_dict=lambda s: None,
            state_dict=lambda: {}, lighthouse_addr=lh.address(), replica_id="probe",
            group_rank=0, group_world_size=1)
same = metrics._env_server is server
m.shutdown(); lh.shutdown()
print(json.dumps({"logs": len(logs), "metrics": metrics._env_metrics_exporter is not None,
                  "traces": tracer is not None and tracer.exporter is not None,
                  "server_port": server.port if server else None,
                  "same_server": same, "flushed": ok}))
"""


def test_the_env_installs_the_three_exporters_and_one_scrape_server():
    _Collector.paths = []
    collector = ThreadingHTTPServer(("127.0.0.1", 0), _Collector)
    threading.Thread(target=collector.serve_forever, daemon=True).start()
    import socket

    # the scrape server's port stays bound here, not listening, until the
    # child is done: no other process can take it, and the child's server
    # (SO_REUSEADDR) binds it beside this socket
    reserved = socket.socket()
    reserved.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    reserved.bind(("127.0.0.1", 0))
    port = reserved.getsockname()[1]
    env = dict(os.environ, TORCHFT_USE_OTEL="1", TORCHFT_METRICS_PORT=str(port),
               OTEL_EXPORTER_OTLP_ENDPOINT=f"http://127.0.0.1:{collector.server_port}",
               CUDA_VISIBLE_DEVICES="")
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
    finally:
        collector.shutdown()
        reserved.close()
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["logs"] == 1 and doc["metrics"] and doc["traces"]
    assert doc["flushed"] == [True, True, True]
    assert doc["server_port"] == port and doc["same_server"]
    assert {"/v1/logs", "/v1/metrics", "/v1/traces"} <= set(_Collector.paths)


def test_without_the_env_nothing_is_installed():
    env = {k: v for k, v in os.environ.items()
           if k not in ("TORCHFT_USE_OTEL", "TORCHFT_METRICS_PORT",
                        "TORCHFT_TRACE_FILE")}
    code = ("import json, torchft_tpu_torch\n"
            "from torchft_tpu_torch.utils import logging as l, metrics, tracing\n"
            "from torchft_tpu_torch.utils.otel import OTLPHTTPExporter\n"
            "print(json.dumps([any(isinstance(e, OTLPHTTPExporter) for e in l._registered),"
            " metrics._env_metrics_exporter is not None, tracing.get_tracer() is not None,"
            " metrics._env_server is not None]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [False] * 4


def _grads(replica: int) -> dict:
    rng = np.random.default_rng(40 + replica)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "e": rng.standard_normal((3, 4)).astype(np.float32)}


def _fleet(lh, make_manager, step_fn):
    def replica(r):
        manager = make_manager(r, lh.address())
        try:
            manager.start_quorum()
            out = step_fn(manager, r)
            assert manager.should_commit()
            return out
        finally:
            manager.shutdown()

    with ThreadPoolExecutor(max_workers=2) as ex:
        return [f.result(timeout=120) for f in [ex.submit(replica, r) for r in range(2)]]


def test_pure_ddp_averages_as_the_jax_one_and_as_ddp():
    def jax_manager(r, addr):
        return JaxManager(pg=JaxPG(timeout=20.0), min_replica_size=2,
                          load_state_dict=lambda sd: None, state_dict=lambda: {},
                          lighthouse_addr=addr, replica_id=f"jpure_{r}", group_rank=0,
                          group_world_size=1, use_async_quorum=False, timeout=20.0,
                          quorum_timeout=20.0)

    def port_manager(r, addr):
        return Manager(pg=ProcessGroupTCP(timeout=20.0), min_replica_size=2,
                       load_state_dict=lambda sd: None, state_dict=lambda: {},
                       lighthouse_addr=addr, replica_id=f"tpure_{r}", group_rank=0,
                       group_world_size=1, use_async_quorum=False, timeout=20.0,
                       quorum_timeout=20.0)

    def tensors(r):
        return {k: torch.from_numpy(v) for k, v in _grads(r).items()}

    jlh = JaxLighthouse(min_replicas=2, join_timeout_ms=100)
    tlh = LighthouseServer(min_replicas=2, join_timeout_ms=100)
    try:
        ref = _fleet(jlh, jax_manager, lambda m, r: jax.tree_util.tree_map(
            np.asarray, JaxPureDDP(m).allreduce_gradients(_grads(r))))
        pure = _fleet(tlh, port_manager, lambda m, r: PureDistributedDataParallel(
            m).allreduce_gradients(tensors(r)))
        fused = _fleet(tlh, port_manager, lambda m, r: DistributedDataParallel(
            m).allreduce_gradients(tensors(r)).wait(timeout=30))
    finally:
        jlh.shutdown()
        tlh.shutdown()
    want = {k: (_grads(0)[k] + _grads(1)[k]) / np.float32(2) for k in _grads(0)}
    for r in range(2):
        assert set(pure[r]) == set(want)
        for k in want:
            assert isinstance(pure[r][k], torch.Tensor)
            got = pure[r][k].numpy()
            np.testing.assert_array_equal(got, ref[r][k])
            np.testing.assert_array_equal(got, fused[r][k].numpy())
            np.testing.assert_allclose(got, want[k], rtol=1e-6)
