"""How the port times a kernel on the card: one method, used by
``chip_smoke.py`` and ``launch/flash_ab.py`` alike.

``Timer(dev)(fn)`` is the median device time of one call in ms: CUDA
events around each launch, L2 flushed before each (the serving path finds
each layer's K/V cold).  The events also see the card wait for the host,
where a call's host side outlasts the flush before it.
``Timer.host_us(fn)`` is the host's time to issue one call, in µs.
``Timer.kernel_ms(fn, entries)`` is the median duration of the named
kernel alone, from ``torch.profiler``'s device trace, L2 flushed before
each call: what the events would read if the host were never late.  A
trace may keep fewer kernel records than there were calls (one H100 run
kept 9 of 20), so the traced round repeats until it has kept as many
durations as calls.
"""
from __future__ import annotations

import statistics
import time

import torch


class Timer:
    """Median device time of one call, with L2 flushed before each launch
    (the serving path finds each layer's K/V cold)."""

    def __init__(self, dev):
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        self.retraced = 0

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def kernel_ms(self, fn, entries, iters: int = 20, warmup: int = 3,
                  rounds: int = 5) -> float:
        """Median device duration in ms of the one kernel a call of ``fn``
        launches whose name holds one of ``entries``, L2 flushed before
        each call: traced rounds of ``iters`` calls, at most ``rounds`` of
        them, until the traces have kept ``iters`` durations.  Each round
        after the first adds one to ``self.retraced``."""
        from torch.profiler import ProfilerActivity, profile

        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        us = []
        for r in range(rounds):
            self.retraced += r > 0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            us += [ev.device_time if hasattr(ev, "device_time")
                   else ev.cuda_time for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and any(e in ev.name for e in entries)]
            if len(us) >= iters:
                return statistics.median(us) / 1e3
        raise RuntimeError(f"kernel_ms: {len(us)} kernels named {entries} "
                           f"in {rounds} traced rounds of {iters} calls")

    @staticmethod
    def host_us(fn, calls: int = 200) -> float:
        """Mean host time to issue one call, in µs: ``calls`` calls back to
        back with no synchronisation between them (far fewer launches than
        the card's queue holds, so the host never waits for the card)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6
