"""Deployment smoke client: two networked clients converge on a string
channel against a running server, then a device-backed REST read confirms
the service serves merge state from its own replica. Exits 0 on success.

The port's deployment smoke (counterpart of
``fluidframework_tpu/service/smoke_client.py``), against a running port
server: ``FLUID_SMOKE_HOST=... FLUID_SMOKE_PORT=...
python -m fluidframework_tpu_torch.service.smoke_client``. The two clients'
``SharedString`` replicas live on the card (``run(..., device="cpu")``
keeps them on the host).
"""

from __future__ import annotations

import os
import sys
import time
from urllib.error import HTTPError


def run(host: str, port: int, timeout: float = 30.0, device="cuda") -> int:
    from fluidframework_tpu_torch.drivers.network_driver import NetworkFluidService
    from fluidframework_tpu_torch.models.shared_string import SharedString
    from fluidframework_tpu_torch.runtime.container import ContainerRuntime

    deadline = time.monotonic() + timeout
    last_err: Exception | None = None
    while time.monotonic() < deadline:
        try:
            svc_a = NetworkFluidService(host, port)
            break
        except OSError as e:  # server not up yet
            last_err = e
            time.sleep(0.5)
    else:
        print(f"smoke: server unreachable: {last_err}", flush=True)
        return 1

    svc_b = NetworkFluidService(host, port)
    a = ContainerRuntime(svc_a, "smoke",
                         channels=(SharedString("t", device=device),))
    b = ContainerRuntime(svc_b, "smoke",
                         channels=(SharedString("t", device=device),))
    a.get_channel("t").insert_text(0, "smoke")
    a.flush()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        a.process_incoming()
        b.process_incoming()
        if b.get_channel("t").get_text() == "smoke":
            break
        time.sleep(0.05)
    b.get_channel("t").insert_text(5, " test")
    b.flush()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        a.process_incoming()
        b.process_incoming()
        if a.get_channel("t").get_text() == "smoke test":
            break
        time.sleep(0.05)
    want = a.get_channel("t").get_text()
    ok = want == b.get_channel("t").get_text() == "smoke test"
    device_ok = True
    try:
        served = NetworkFluidService(host, port).get_channel_text("smoke", "t")
        device_ok = served == want
    except HTTPError as e:
        if e.code == 501:  # device backend disabled by config: excused
            print("smoke: device backend disabled (501)", flush=True)
        else:
            print(f"smoke: device read failed: {e}", flush=True)
            device_ok = False
    a.disconnect()
    b.disconnect()
    if ok and device_ok:
        print("smoke: converged + device-served OK", flush=True)
        return 0
    print(f"smoke: FAILED (text={want!r}, device_ok={device_ok})", flush=True)
    return 1


def main() -> int:
    host = os.environ.get("FLUID_SMOKE_HOST", "127.0.0.1")
    port = int(os.environ.get("FLUID_SMOKE_PORT", "7070"))
    return run(host, port)


if __name__ == "__main__":
    sys.exit(main())
