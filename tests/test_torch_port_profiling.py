"""The port's profiling utilities (``scrubvae_torch/utils/profiling.py``)
on the CPU: the JAX package's ``StepTimer`` (the port has none), ``trace``
writing a Chrome trace, ``debug_nans`` raising on a NaN planted in the forward and in the
backward pass and leaving no state behind, and ``device_memory_stats``
empty without a GPU."""

import json
import time

import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from scrubvae_tpu.utils.profiling import StepTimer as JaxStepTimer
from scrubvae_torch.utils import profiling


@pytest.mark.parametrize("cls", [JaxStepTimer], ids=["jax"])
def test_step_timer(cls):
    timer = cls()
    assert abs(timer.elapsed) < 1e-3 and timer.rate() == 0.0
    timer.start()
    timer.tick()
    timer.tick(3)
    time.sleep(0.02)
    assert timer.steps == 4
    assert 0.02 <= timer.elapsed < 5.0
    assert 0 < timer.rate() <= 4 / 0.02
    assert timer.rate(per=512) == pytest.approx(512 * timer.rate(), rel=0.5)
    timer.start()
    assert timer.steps == 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "build" / "trace")) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert path == str(tmp_path / "build" / "trace" / "trace.json")
    assert any("mm" in str(e.get("name", "")) for e in events)


def _state():
    return torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled(), _get_current_dispatch_mode()


@pytest.mark.filterwarnings("ignore:Error detected in SqrtBackward0")
def test_debug_nans_raises_forward_and_backward_and_restores_state():
    before = _state()
    x = torch.tensor([1.0, 0.0])
    with pytest.raises(FloatingPointError, match="aten.sub"):
        with profiling.debug_nans():
            torch.log(x) - torch.log(x)  # -inf - -inf
    assert _state() == before
    # the forward pass is clean, its backward makes a NaN: d sqrt(x)/dx at 0 times 0
    w = torch.tensor([0.0, 4.0], requires_grad=True)
    with pytest.raises(FloatingPointError, match="produced a NaN"):
        with profiling.debug_nans():
            y = (torch.sqrt(w) * torch.tensor([0.0, 1.0])).sum()
            assert torch.isfinite(y)
            y.backward()
    assert _state() == before
    # off, or outside the block, nothing is raised
    w.grad = None
    with profiling.debug_nans(False):
        (torch.sqrt(w) * torch.tensor([0.0, 1.0])).sum().backward()
    assert torch.isnan(w.grad[0]) and _state() == before
    assert torch.isnan(torch.log(x) - torch.log(x))[1]
    # a clean block runs through
    with profiling.debug_nans():
        z = torch.tensor([2.0], requires_grad=True)
        (z * z).sum().backward()
    assert float(z.grad) == 4.0 and _state() == before


def test_device_memory_stats_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}
