"""The port's deployable entry point (``service/server_main.py``) against
the reference's: the same layered configuration (file < ``FLUID_*``
environment < flags) on the same inputs, the same rejection of unknown
keys, ``config/config.json`` loading unchanged, the same wiring to a
store node, and ``python -m fluidframework_tpu_torch.service.server_main
--device cpu`` as users run it: it prints its ``listening`` line, serves
a writer's frame and ``/metrics``, exits 0 on SIGTERM, and has imported
neither ``jax`` nor anything of ``fluidframework_tpu``.
"""

import json
import os
import signal
import subprocess
import sys
from urllib.request import urlopen

import pytest
import torch

from fluidframework_tpu.service import server_main as ref_main
from fluidframework_tpu_torch.drivers.network_driver import (
    NetworkFluidService,
)
from fluidframework_tpu_torch.protocol.opframe import OpFrame
from fluidframework_tpu_torch.service import server_main as port_main
from fluidframework_tpu_torch.service import store_server as port_store
from fluidframework_tpu_torch.service.pipeline import PipelineFluidService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "config.json")


def test_defaults_match_the_reference():
    assert port_main.DEFAULTS == ref_main.DEFAULTS


@pytest.mark.parametrize("env,overrides", [
    ({}, None),
    ({"FLUID_PARTITIONS": "8"}, None),
    ({"FLUID_PARTITIONS": "8", "FLUID_DEVICE_BACKEND": "no",
      "FLUID_TENANTS": '{"t": "k"}', "FLUID_STORE_HOST": "node"},
     {"port": 1234}),
])
def test_config_layering(tmp_path, env, overrides):
    p = tmp_path / "config.json"
    p.write_text(json.dumps({"port": 9999, "partitions": 2}))
    cfg = port_main.load_config(str(p), env=env, overrides=overrides)
    assert cfg == ref_main.load_config(str(p), env=env, overrides=overrides)
    assert cfg["port"] == (overrides or {}).get("port", 9999)
    assert cfg["partitions"] == int(env.get("FLUID_PARTITIONS", 2))
    assert cfg["device_capacity"] == 128  # defaults fill the rest


def test_config_rejects_unknown_keys(tmp_path):
    p = tmp_path / "config.json"
    p.write_text(json.dumps({"prot": 1}))
    for mod in (port_main, ref_main):
        with pytest.raises(ValueError, match="prot"):
            mod.load_config(str(p), env={})


def test_repo_config_file_is_valid():
    cfg = port_main.load_config(CONFIG, env={})
    assert set(cfg) == set(port_main.DEFAULTS)
    assert cfg == ref_main.load_config(CONFIG, env={})


def test_build_server_wires_the_deployment(monkeypatch):
    """``build_server`` passes the configuration and the device through,
    puts the log and blobs on the store node when ``store_host`` is set,
    and without a card its default device raises."""
    node = port_store.StoreServer(port=0, n_partitions=4).serve_background()
    try:
        cfg = port_main.load_config(CONFIG, env={}, overrides={
            "host": "127.0.0.1", "port": 0, "store_host": node.host,
            "store_port": node.port, "tenants": {"t": "k"}})
        srv = port_main.build_server(cfg, device_torch="cpu")
        svc = srv.service
        assert isinstance(svc, PipelineFluidService)
        assert isinstance(svc.log, port_store.RemotePartitionedLog)
        assert isinstance(svc.store._backend, port_store.RemoteBlobBackend)
        assert svc.device.fleet.device.type == "cpu"
        assert svc.device_flush_min_rows == cfg["device_flush_min_rows"]
        assert svc.log.n_partitions == node.n_partitions
        assert srv.tenants.validate(
            "t", "d", srv.tenants.mint("t", "d", "k"))
    finally:
        node.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main.build_server(port_main.load_config(CONFIG, env={}))


_CHILD = """
import atexit, json, runpy, sys
def _report():
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == "fluidframework_tpu"
                 or m.startswith("fluidframework_tpu."))
    print(json.dumps({"event": "exit", "forbidden": bad}), flush=True)
atexit.register(_report)
sys.argv = ["server_main"] + sys.argv[1:]
runpy.run_module("fluidframework_tpu_torch.service.server_main",
                 run_name="__main__", alter_sys=True)
"""


def test_server_main_process_serves_and_stops():
    """The entry point as users run it (``-m`` through ``runpy``, which
    lets the child report its own ``sys.modules`` at exit): the repo's
    config on an ephemeral port with ``--device cpu``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD, "--config", CONFIG, "--port", "0",
         "--host", "127.0.0.1", "--device", "cpu"],
        stdout=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        info = json.loads(proc.stdout.readline())
        assert info["event"] == "listening" and info["port"] > 0
        cli = NetworkFluidService("127.0.0.1", info["port"])
        c = cli.connect("dep")
        k = 4
        origs = [c.conn_no * (1 << 14) + 1 + j for j in range(k)]
        c.submit_frame(OpFrame.build("s", ["ins"] * k, list(range(k)),
                                     origs, list("deploy"[:k]), csn0=1,
                                     ref=c.join_seq))
        assert c.wait_for(lambda cc: any(
            m.client_id == cc.client_id and m.client_sequence_number == k
            for m in cc.inbox), 30)
        c.disconnect()
        assert cli.get_channel_text("dep", "s") == "depl"
        with urlopen(f"http://127.0.0.1:{info['port']}/metrics",
                     timeout=60) as r:
            assert r.status == 200 and b"# TYPE" in r.read()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        tail = [json.loads(ln) for ln in proc.stdout.read().splitlines()
                if ln.startswith("{")]
        assert tail and tail[-1] == {"event": "exit", "forbidden": []}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)


def test_smoke_client_against_the_port_server():
    """The port's deployment smoke (``service/smoke_client.py``) against
    ``server_main --device cpu``: two networked ``SharedString`` clients
    converge and the server's device-backed REST read serves their text."""
    from fluidframework_tpu_torch.service import smoke_client

    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.server_main",
         "--config", CONFIG, "--port", "0", "--host", "127.0.0.1",
         "--device", "cpu"],
        stdout=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        info = json.loads(proc.stdout.readline())
        assert smoke_client.run("127.0.0.1", info["port"], device="cpu") == 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)
