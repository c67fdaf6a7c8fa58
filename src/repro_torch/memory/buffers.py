"""Phase-agnostic GPU buffer model: resident params + transient ring buffer.

Paper §5.2 Figure 7: device memory is split into (i) resident parameters
(small — norms, or all attention weights during decode when memory permits)
and (ii) a transient parameter/KV staging buffer whose slots are released as
soon as a module finishes.  Prefill runs a ring of expert/param prefetches
overlapped with compute and offloads each layer's KV immediately, so at most
two layers of KV are device-resident.

The same class gates a REAL transfer path: ``NodeEngine`` meters its
pipelined device→host KV staging (``stage_appends``) through a RingBuffer
— every in-flight blob reserves a slot, draining releases it, and a stage
that would overflow the capacity falls back to a synchronous drain (the
stall the plan optimizer sizes ``ring_buffer_bytes`` against).  The
timing model (``prefetch``) additionally drives the plan optimizer and
the cluster simulator; on TPU the same slot discipline would drive async
device_put round-robins.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Slot:
    name: str
    nbytes: int
    ready_t: float = 0.0      # simulated time the transfer completes


class RingBuffer:
    """Fixed-capacity staging buffer with FIFO slot reuse."""

    def __init__(self, capacity_bytes: int, bw_bytes_per_s: float):
        self.capacity = capacity_bytes
        self.bw = bw_bytes_per_s
        self.slots: Deque[Slot] = deque()
        self.used = 0
        self.clock = 0.0
        self.stalls = 0.0

    def prefetch(self, name: str, nbytes: int, now: float) -> float:
        """Schedule a host->device transfer; returns completion time.
        Blocks (advances clock) if the buffer is full — that stall is the
        signal the plan optimizer uses to size the buffer."""
        while self.used + nbytes > self.capacity and self.slots:
            old = self.slots.popleft()
            if old.ready_t > now:
                self.stalls += old.ready_t - now
                now = old.ready_t
            self.used -= old.nbytes
        start = max(now, self.clock)
        done = start + nbytes / self.bw
        self.clock = done
        self.slots.append(Slot(name, nbytes, done))
        self.used += nbytes
        return done

    def release(self, name: str):
        for s in list(self.slots):
            if s.name == name:
                self.slots.remove(s)
                self.used -= s.nbytes
                return

    # -- occupancy gate (live backpressure for staged transfers) -----------
    def can_fit(self, nbytes: int) -> bool:
        """Would a reservation of ``nbytes`` fit right now?  A blob larger
        than the whole buffer never fits — callers must fall back to a
        synchronous (stage-and-drain) transfer for it."""
        return self.used + nbytes <= self.capacity

    def reserve(self, name: str, nbytes: int):
        """Claim ``nbytes`` of staging space without the timing model —
        the live engine's accounting for an in-flight async copy.  Pair
        with ``release(name)`` when the transfer is drained."""
        self.slots.append(Slot(name, nbytes))
        self.used += nbytes

    def reset(self):
        """Drop every reservation (failed-node teardown: the in-flight
        blobs it metered were abandoned, not drained, so their space must
        not stay claimed forever)."""
        self.slots.clear()
        self.used = 0


@dataclasses.dataclass
class DeviceMemoryPlan:
    """Byte budget split for one phase (prefill or decode)."""
    hbm_bytes: int
    resident_param_bytes: int
    ring_buffer_bytes: int
    kv_pool_bytes: int
    workspace_bytes: int

    @property
    def ok(self) -> bool:
        return (self.resident_param_bytes + self.ring_buffer_bytes
                + self.kv_pool_bytes + self.workspace_bytes) <= self.hbm_bytes

    def kv_pages(self, page_bytes: int) -> int:
        return max(self.kv_pool_bytes // max(page_bytes, 1), 0)


def plan_phase_memory(hbm_bytes: int, param_bytes_resident: int,
                      ring_bytes: int, workspace_bytes: int,
                      page_bytes: int) -> DeviceMemoryPlan:
    """Everything not claimed by params/ring/workspace becomes KV pool —
    the paper's 'reconfigure sizes at phase swap' in one function."""
    kv = hbm_bytes - param_bytes_resident - ring_bytes - workspace_bytes
    return DeviceMemoryPlan(hbm_bytes, param_bytes_resident, ring_bytes,
                            max(kv, 0), workspace_bytes)
