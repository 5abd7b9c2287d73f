"""Deployable service entrypoint — the routerlicious runner analog.

Reference: ``server/routerlicious/src/alfred/runner.ts`` started from
``Dockerfile`` with layered nconf configuration
(``server/routerlicious/config/config.json`` overridden by environment
variables). Here the same shape: JSON config file < environment
(``FLUID_``-prefixed) < CLI flags, starting the socket front door
(``FluidNetworkServer``) over the partitioned-lambda pipeline with the
device-apply stage (TpuDeliLambda) active.

Counterpart of ``fluidframework_tpu/service/server_main.py``, with the same
keys and the same layering; ``config/config.json`` loads unchanged. The
device stage runs on the CUDA card by default: ``--device cpu`` (or
``build_server(cfg, device_torch="cpu")``) runs its plain PyTorch versions
on the CPU instead, and without a card the default raises rather than fall
back.

Run directly: ``python -m fluidframework_tpu_torch.service.server_main
[--config config/config.json] [--port N] [--host H] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import Any, Dict

DEFAULTS: Dict[str, Any] = {
    # The reference config.json keys this deployment consumes, renamed to
    # one flat namespace (layered lookup keeps the nconf override order).
    "port": 7070,
    "host": "0.0.0.0",
    "partitions": 4,
    "checkpoint_every": 10,
    "messages_per_trace": 0,  # alfred op-trace sampling (config.json:58)
    "device_backend": True,
    "device_capacity": 128,
    "device_max_capacity": 1 << 16,
    "device_sharded_overflow": False,
    # Deployed front doors boxcar device flushes (sub-threshold rows ride
    # the server's 50ms idle flush) — per-submit flushes put a device
    # dispatch on every client op.
    "device_flush_min_rows": 64,
    "tenants": {},  # tenant id -> shared key (riddler table); {} = open
    # Out-of-proc durability (service/store_server.py): when store_host
    # is set, blobs + partition logs live on the external data node and
    # THIS process becomes disposable (kill/replace semantics).
    "store_host": "",
    "store_port": 7071,
}


def load_config(path: str | None = None, env: Dict[str, str] | None = None,
                overrides: Dict[str, Any] | None = None) -> Dict[str, Any]:
    """Layered config: DEFAULTS < JSON file < FLUID_* env < overrides."""
    cfg = dict(DEFAULTS)
    if path:
        with open(path) as f:
            file_cfg = json.load(f)
        unknown = set(file_cfg) - set(DEFAULTS)
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        cfg.update(file_cfg)
    env = os.environ if env is None else env
    for key, default in DEFAULTS.items():
        env_key = "FLUID_" + key.upper()
        if env_key not in env:
            continue
        raw = env[env_key]
        if isinstance(default, bool):
            cfg[key] = raw.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            cfg[key] = int(raw)
        elif isinstance(default, dict):
            cfg[key] = json.loads(raw)
        else:
            cfg[key] = raw
    cfg.update(overrides or {})
    return cfg


def build_server(cfg: Dict[str, Any], device_torch: str = "cuda"):
    """Construct (but do not start) the configured network server, its
    device stage on ``device_torch``."""
    from fluidframework_tpu_torch.service.network_server import (
        FluidNetworkServer,
        TenantManager,
    )
    from fluidframework_tpu_torch.service.pipeline import PipelineFluidService

    log = store = None
    if cfg["store_host"]:
        from fluidframework_tpu_torch.service.store_server import (
            RemoteBlobBackend,
            RemotePartitionedLog,
        )
        from fluidframework_tpu_torch.service.summary_store import SummaryStore

        log = RemotePartitionedLog(cfg["store_host"], cfg["store_port"])
        store = SummaryStore(
            backend=RemoteBlobBackend(cfg["store_host"], cfg["store_port"])
        )
    service = PipelineFluidService(
        n_partitions=cfg["partitions"],
        checkpoint_every=cfg["checkpoint_every"],
        messages_per_trace=cfg["messages_per_trace"],
        device_backend=cfg["device_backend"],
        device_capacity=cfg["device_capacity"],
        device_max_capacity=cfg["device_max_capacity"],
        device_sharded_overflow=cfg["device_sharded_overflow"],
        device_flush_min_rows=cfg["device_flush_min_rows"],
        device_torch=device_torch,
        log=log,
        store=store,
    )
    tenants = None
    if cfg["tenants"]:
        tenants = TenantManager()
        for tenant, key in cfg["tenants"].items():
            tenants.register(tenant, key)
    return FluidNetworkServer(
        service=service, host=cfg["host"], port=cfg["port"], tenants=tenants
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", help="JSON config file (layered under env)")
    ap.add_argument("--port", type=int, help="override port")
    ap.add_argument("--host", help="override bind host")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device stage (default cuda)")
    args = ap.parse_args(argv)
    overrides = {
        k: v
        for k, v in (("port", args.port), ("host", args.host))
        if v is not None
    }
    cfg = load_config(args.config, overrides=overrides)
    srv = build_server(cfg, device_torch=args.device)
    srv.start()
    print(
        json.dumps(
            {"event": "listening", "host": cfg["host"], "port": srv.port}
        ),
        flush=True,
    )
    stop = {"flag": False}

    def _sig(_s, _f):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    try:
        while not stop["flag"]:
            time.sleep(0.2)
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
