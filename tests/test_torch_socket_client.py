"""The client of ``chip_smoke.py`` phase 6 (``socket_client``) keeps the
server's overload contract, as the container runtime does: a frame nacked
with a throttle is sent again, with the same client sequence numbers, once
its retry-after has passed; a connect or read answered 503 is retried after
its Retry-After; any other nack fails the run.

Driven here against the port's ``FluidNetworkServer`` over
``PipelineFluidService(device_torch="cpu")`` with an admission controller
that throttles the first offer of every frame and an overload controller
that refuses the first connection, so every path is taken a known number
of times.
"""

import json
from urllib.error import HTTPError

import pytest

import chip_smoke
from fluidframework_tpu_torch.service import admission
from fluidframework_tpu_torch.service.network_server import FluidNetworkServer
from fluidframework_tpu_torch.service.pipeline import PipelineFluidService


class _ThrottleFirstOffers(admission.AdmissionController):
    """Throttles each document's odd-numbered writes (the first offer of
    each frame, when every frame is offered twice) with a 10 ms
    retry-after and admits the even ones."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def decide(self, tenant, doc_id, n_ops=1, tier=admission.Tier.NORMAL):
        n = self.calls[doc_id] = self.calls.get(doc_id, 0) + 1
        if n % 2:
            self.denied += 1
            return admission.AdmissionDecision(False, 10.0, "doc_budget")
        return admission.AdmissionDecision(True)


class _RefuseFirstConnection(admission.OverloadController):
    def __init__(self):
        super().__init__()
        self.asked = 0

    def refuse_connections(self):
        self.asked += 1
        return self.asked == 1 or super().refuse_connections()


def test_throttled_frames_are_resent_and_a_refused_connect_retried(tmp_path):
    n, k, bursts = 3, 4, 2
    svc = PipelineFluidService(
        n_partitions=1, device_torch="cpu",
        admission=_ThrottleFirstOffers(), overload=_RefuseFirstConnection())
    srv = FluidNetworkServer(service=svc, host="127.0.0.1", port=0)
    srv.start()
    out = tmp_path / "client.json"
    try:
        docs = [f"s{i}" for i in range(n)]
        rc = chip_smoke.socket_client(
            ["127.0.0.1", str(srv.port), str(n), str(k), str(bursts),
             ",".join(docs), "2", str(out)])
    finally:
        srv.stop()
    assert rc == 0
    rec = json.loads(out.read_text())
    assert rec["throttle_nacks"] == n * (bursts + 1)
    assert rec["throttle_nacks_timed"] == n * bursts
    assert rec["nack_reasons"] == ["admission throttled (doc_budget)"]
    assert rec["connects_refused"] == 1 and srv.connections_refused == 1
    assert rec["reads_shed"] == 0
    assert svc.admission.denied == n * (bursts + 1)
    want = "".join(chip_smoke.ALPHABET[o % 26]
                   for o in range((bursts + 1) * k, 0, -1))
    assert rec["read_texts"] == {d: want for d in docs}


def _raising(errors):
    calls = []

    def fn():
        calls.append(1)
        if errors:
            raise errors.pop(0)
        return "done"
    return fn, calls


def test_after_503_retries_a_shed_read_and_a_refused_connect():
    counts = {"r": 0}
    shed = HTTPError("http://x/", 503, "Service Unavailable",
                     {"Retry-After": "0"}, None)
    refused = ConnectionError(
        "websocket upgrade failed: b'HTTP/1.1 503 Service Unavailable'")
    fn, calls = _raising([shed, refused])
    assert chip_smoke._after_503(fn, counts, "r", float("inf")) == "done"
    assert counts == {"r": 2} and len(calls) == 3


@pytest.mark.parametrize("error", [
    HTTPError("http://x/", 404, "Not Found", {}, None),
    ConnectionError("server closed during handshake"),
])
def test_after_503_raises_anything_else(error):
    counts = {"r": 0}
    fn, calls = _raising([error])
    with pytest.raises(type(error)):
        chip_smoke._after_503(fn, counts, "r", float("inf"))
    assert counts == {"r": 0} and len(calls) == 1


def test_after_503_raises_past_its_deadline():
    counts = {"r": 0}
    fn, _calls = _raising([HTTPError("http://x/", 503, "Service Unavailable",
                                     {"Retry-After": "0"}, None)])
    with pytest.raises(HTTPError):
        chip_smoke._after_503(fn, counts, "r", 0.0)
    assert counts == {"r": 0}
