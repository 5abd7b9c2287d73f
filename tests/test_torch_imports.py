"""The port's import boundary and device defaults.

The port (``fluidframework_tpu_torch``) and ``chip_smoke.py`` must never
load ``jax`` or anything of the reference package ``fluidframework_tpu`` —
not even its jax-free modules. The check runs in a subprocess because this
test process has jax loaded already (tests/conftest.py imports it).
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "fluidframework_tpu_torch")


def _port_modules():
    mods = []
    for root, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "fluidframework_tpu"
            or name.startswith("fluidframework_tpu."))


def test_port_modules_and_chip_smoke_load_no_jax():
    mods = _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'fluidframework_tpu' or "
        "m.startswith('fluidframework_tpu.'))\n"
        "print(len(" + repr(mods) + "), bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "fluidframework_tpu_torch.service.fleet_service" in mods
    assert "fluidframework_tpu_torch.parallel.fleet" in mods
    assert "fluidframework_tpu_torch.ops.encode" in mods


@pytest.mark.parametrize("path", sorted(
    [os.path.join(root, f) for root, _d, files in os.walk(PKG)
     for f in files if f.endswith(".py")]
    + [os.path.join(REPO, "chip_smoke.py")]
))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert not _forbidden(n), f"{path}:{node.lineno} imports {n}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from fluidframework_tpu_torch.interop import (
        service_from_reference_arrays,
        state_from_numpy,
    )
    from fluidframework_tpu_torch.ops.segment_state import (
        make_batched_state,
        make_state,
    )
    from fluidframework_tpu_torch.parallel.fleet import DocFleet
    from fluidframework_tpu_torch.service.fleet_service import (
        TpuFleetService,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TpuFleetService(4, capacity=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        DocFleet(4, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        DocFleet(4, 8, kernel="plain")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batched_state(2, 8, -3)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_state(8, -3)
    t = np.zeros((15, 2, 8), np.int32)
    s = np.zeros((2, 8), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy(t, s)
    with pytest.raises(RuntimeError, match="CUDA"):
        service_from_reference_arrays(
            t, s, np.zeros((2, 2), np.int32), np.zeros((2, 93, 3), np.int32),
            np.zeros(2, np.int64),
        )
    # Asked for by name, the CPU path runs.
    assert TpuFleetService(4, capacity=8, device="cpu").tables.device.type \
        == "cpu"
    assert DocFleet(4, 8, device="cpu").pools[8].tables.device.type == "cpu"


def test_wrappers_never_fall_back_off_the_cpu():
    """Tensors that are not on the CPU go to the CUDA kernel or raise; the
    plain version is taken for CPU tensors only."""
    from fluidframework_tpu_torch.ops import apply_kernel as K1
    from fluidframework_tpu_torch.ops import compact_kernel as K2

    t = torch.zeros((15, 2, 8), dtype=torch.int32, device="meta")
    s = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    ops = torch.zeros((2, 1, 10), dtype=torch.int32, device="meta")
    before = (K1.apply_ops_packed.launches, K2.compact_packed.launches,
              K2.apply_compact_packed.launches)
    with pytest.raises(ValueError, match="CUDA"):
        K1.apply_ops_packed(t, s, ops)
    with pytest.raises(ValueError, match="CUDA"):
        K2.compact_packed(t, s)
    with pytest.raises(ValueError, match="CUDA"):
        K2.apply_compact_packed(t, s, ops)
    assert before == (K1.apply_ops_packed.launches,
                      K2.compact_packed.launches,
                      K2.apply_compact_packed.launches)


def test_kernel_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    from fluidframework_tpu_torch.ops import _cuda

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "build"))
    real_exists = os.path.exists
    monkeypatch.setattr(
        _cuda.os.path, "exists",
        lambda p: False if str(p).endswith("nvcc") else real_exists(p),
    )
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.build()
