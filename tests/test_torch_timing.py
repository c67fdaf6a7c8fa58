"""``launch/timing.py``'s ``Timer.kernel_ms`` on the CPU, with the profiler
replaced by one whose traces keep a set number of kernel records: a round
that keeps fewer records than calls is traced again, the median is taken
over every duration kept, and the count stays exact (no tolerance)."""
import statistics
from types import SimpleNamespace

import pytest
import torch

from repro_torch.launch.timing import Timer

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class _Profile:
    """A stand-in for ``torch.profiler.profile``: round r keeps
    ``kept[r]`` records of the named kernel (durations 100r + i µs), beside
    a flush kernel and a CPU op of the same name."""

    round = 0

    def __init__(self, kept, activities=None):
        self.kept = kept

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        type(self).round += 1
        return False

    def events(self):
        r = type(self).round - 1
        evs = [SimpleNamespace(name="flash_fwd_wgmma<80, 80>",
                               device_type=CUDA, device_time=100.0 * r + i)
               for i in range(self.kept[r])]
        evs.append(SimpleNamespace(name="vectorized_elementwise_kernel",
                                   device_type=CUDA, device_time=1e6))
        evs.append(SimpleNamespace(name="flash_fwd_wgmma", device_type=CPU,
                                   device_time=1e6))
        return evs


@pytest.fixture
def traced(monkeypatch):
    """Install a profile whose rounds keep the given record counts."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)

    def install(kept):
        _Profile.round = 0
        monkeypatch.setattr(torch.profiler, "profile",
                            lambda activities=None: _Profile(kept))
        return Timer("cpu")
    return install


@pytest.mark.parametrize("kept,rounds_used", [
    ([20], 1), ([9, 20], 2), ([9, 0, 3, 8], 4)])
def test_kernel_ms_traces_again_until_it_keeps_iters(traced, kept,
                                                    rounds_used):
    timer = traced(kept)
    calls = []
    ms = timer.kernel_ms(lambda: calls.append(1), ("flash_fwd_kernel",
                                                   "flash_fwd_wgmma"))
    us = [100.0 * r + i for r in range(rounds_used) for i in range(kept[r])]
    assert ms == statistics.median(us) / 1e3
    assert timer.retraced == rounds_used - 1
    assert len(calls) == 3 + 20 * rounds_used      # warmup, then rounds


def test_kernel_ms_raises_when_every_round_drops(traced):
    timer = traced([3] * 5)
    with pytest.raises(RuntimeError, match="15 kernels named .* in 5 traced "
                                           "rounds of 20 calls"):
        timer.kernel_ms(lambda: None, ("flash_fwd_wgmma",))
    assert timer.retraced == 4
