"""Parity: the port's ``LoadRunner`` against the reference's under
service-side chaos (seeded faults at the store append, the queue send and
the device pump's dispatch) through each package's
``PipelineFluidService``: tests/test_load.py's chaos scenarios, run as
tests/test_torch_load.py runs the others (same profile, seed, tokens and
clock on both packages; reports equal in every field but the wall
time)."""

from dataclasses import replace

import pytest

from fluidframework_tpu_torch.testing import load as port_load
from test_torch_load import (  # noqa: F401 (an autouse fixture)
    _clean_fault_registries,
    pipeline,
    run_both,
)


def test_load_16_client_chaos_smoke(monkeypatch):
    profile = port_load.CHAOS_SMOKE_PROFILE
    report = run_both(monkeypatch, pipeline(2), profile)
    assert report.converged, f"divergence: {report}"
    assert report.ops_submitted == profile.total_ops
    assert report.chaos_injected > 0, "profile expected service faults"


@pytest.mark.slow
def test_load_chaos_toward_reference_profile(monkeypatch):
    profile = port_load.CHAOS_STRESS_PROFILE
    report = run_both(monkeypatch, pipeline(4), profile)
    assert report.converged, f"divergence: {report}"
    assert report.ops_submitted == profile.total_ops
    assert report.chaos_injected > 0
    assert report.faults_injected > 0


def full_smoke_profile():
    """tests/test_load.py's CI-sized full-stack chaos shape."""
    return replace(
        port_load.CHAOS_SMOKE_PROFILE, doc_id="chaos-full-smoke",
        tree_weight=0.25, summary_interval=60, gc_every=120, total_ops=600,
    )


def test_load_full_stack_chaos_smoke(monkeypatch):
    report = run_both(monkeypatch, pipeline(2), full_smoke_profile())
    assert report.converged, f"divergence: {report}"
    assert report.chaos_injected > 0
    assert report.summaries > 0, "summarizer never ran under chaos"
    assert report.gc_runs > 0
    assert report.tree_ingest, "no tree ingest buckets captured"


@pytest.mark.slow
def test_load_chaos_stress_full_stack(monkeypatch):
    profile = port_load.CHAOS_STRESS_FULL_PROFILE
    report = run_both(monkeypatch, pipeline(4), profile)
    assert report.converged, f"divergence: {report}"
    assert report.ops_submitted == profile.total_ops
    assert report.chaos_injected > 0
    assert report.summaries > 0
    assert report.gc_runs > 0
    assert report.tree_ingest
