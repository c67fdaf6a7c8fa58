"""Formal execution-backend contract for the coroutine runtime.

The scheduler is generic over "engines": anything that exposes the slot
protocol below can host sequence coroutines.  Historically the contract
was implicit (whatever ``CoroutineScheduler`` happened to call); this
module makes it a ``typing.Protocol`` so

* the real mini-engine (``runtime/engine.py``) and the virtual-clock
  cluster simulator (``runtime/cluster.py``) *declare* conformance
  (module-level ``validate_backend(cls)`` at import time), and
* ``CoroutineScheduler`` *checks* conformance at construction
  (``validate_backend(instance)``), so a backend missing one protocol
  member fails loudly with the member's name instead of mid-batch with
  an ``AttributeError``.

Contract summary (see each engine for semantics):

========================  ==================================================
member                    role
========================  ==================================================
``node_id``               stable id the scheduler routes events by
``max_active``            device slot count (refill / admission ceiling)
``num_devices``           devices per node (PARTITION group sizing)
``host_store``            paged host KV store — single source of truth
``allocator``             two-page lazy page allocator
``stats``                 ``PrimitiveStats`` (yield/combine/... accounting)
``clock()``               node time (wall clock or virtual clock)
``idle_tick()``           called when a tick finds no runnable work
``acquire_slot(co)``      bind a coroutine to a free device slot (or None)
``free_slot(co)``         release the coroutine's slot
``extract_slot(co)``      device state -> host arrays (YIELD checkpoint)
``install_slot(co, sl)``  host arrays -> device slot (COMBINE resume)
``reconfigure_partition`` re-lower decode over a device group (PARTITION)
``decode_page(act, P)``   decode up to P tokens for the active batch
``sync_appends(act)``     flush freshly decoded KV to the host store
                          (blocking: stage + drain in one call)
``stage_appends(act)``    issue the dirty-window KV gather and start the
                          async device→host copy; snapshot per-slot
                          [synced, length) metadata at issue time
``drain_appends()``       land staged blobs in the host store.  Accepts
                          ``keep_newest=n`` to leave the n most recently
                          staged blobs in flight (the SYNC_DRAIN handler
                          keeps 1 so it rides behind the next megastep);
                          every consumer of host-store state (evict,
                          migrate, failure recovery) must force a full
                          drain first
``prefill(cos)``          prefill INIT coroutines, checkpoint, leave INACTIVE
``stage_restore(co)``     issue an async host→device restore for a
                          suspended sequence through the ring buffer (the
                          h2d mirror of ``stage_appends``): the copy rides
                          behind the next decode page so a later COMBINE
                          installs without PCIe wait.  Returns True when
                          the restore is staged (already-staged counts),
                          False when it cannot be (no host state / ring
                          full — the backpressure counter increments)
``take_restore(id)``      consume a staged restore for COMBINE: returns
                          the host slices (staleness-checked against the
                          current host state — a checkpoint that advanced
                          since staging invalidates the prefetch) or the
                          synchronously-restored slices when nothing
                          usable was staged; None only without host state
``discard_restore(id)``   drop one staged restore + release its ring
                          reservation (MIGRATE: the state changes nodes)
``discard_restores()``    drop every staged restore (NODE_FAILURE: the
                          target devices are gone)
``heartbeat()``           emit this round's ``Heartbeat`` (or None when the
                          node is dead / its beat is suppressed) — the
                          scheduler feeds it to the ``HealthMonitor`` every
                          round (§5.6); the beat carries the cumulative
                          progress counters below for the
                          ``ProgressTracker``'s straggler detection
``transfer(kind, fn)``    run one risky host transfer (stage/drain/install/
                          migrate) through the fault injector + bounded
                          exponential-backoff retry envelope; raises
                          ``TransferDeadLetter`` after the retry budget
``faults``                per-node ``NodeFaults`` view (None = no injection)
``retry_policy``          ``RetryPolicy`` governing ``transfer``
``transfer_stats``        dict: retries / timeouts / dead_letters counters
``dead_lettered``         flag the scheduler polls after every dispatch to
                          escalate a dead-lettered node to NODE_FAILURE
``decode_steps``          cumulative decode steps run (heartbeat progress)
``tokens_out``            cumulative effective tokens emitted — per-node
                          EWMA throughput = Δtokens_out / Δclock()
========================  ==================================================
"""
from __future__ import annotations

from typing import (Any, Dict, List, Optional, Protocol, Sequence,
                    runtime_checkable)

PROTOCOL_METHODS = (
    "clock", "idle_tick", "acquire_slot", "free_slot", "extract_slot",
    "install_slot", "reconfigure_partition", "decode_page", "sync_appends",
    "stage_appends", "drain_appends", "prefill", "heartbeat", "transfer",
    "stage_restore", "take_restore", "discard_restore", "discard_restores",
)
PROTOCOL_ATTRS = (
    "node_id", "max_active", "num_devices", "host_store", "allocator",
    "stats", "faults", "retry_policy", "transfer_stats", "dead_lettered",
    "decode_steps", "tokens_out",
)


@runtime_checkable
class ExecutionBackend(Protocol):
    """The slot protocol every engine must implement (see module doc)."""

    node_id: int
    max_active: int
    num_devices: int
    host_store: Any
    allocator: Any
    stats: Any
    faults: Any
    retry_policy: Any
    transfer_stats: Dict[str, int]
    dead_lettered: bool
    decode_steps: int
    tokens_out: float

    def clock(self) -> float: ...

    def idle_tick(self) -> None: ...

    def acquire_slot(self, co) -> Optional[int]: ...

    def free_slot(self, co) -> None: ...

    def extract_slot(self, co) -> Dict[str, Any]: ...

    def install_slot(self, co, slices: Dict[str, Any]) -> None: ...

    def reconfigure_partition(self, co, group: List[int]) -> None: ...

    def decode_page(self, active: Sequence, P: int) -> None: ...

    def sync_appends(self, active: Sequence) -> None: ...

    def stage_appends(self, active: Sequence) -> None: ...

    def drain_appends(self, keep_newest: int = 0) -> None: ...

    def prefill(self, cos: Sequence) -> None: ...

    def stage_restore(self, co) -> bool: ...

    def take_restore(self, seq_id: int) -> Optional[Dict[str, Any]]: ...

    def discard_restore(self, seq_id: int) -> None: ...

    def discard_restores(self) -> None: ...

    def heartbeat(self) -> Optional[Any]: ...

    def transfer(self, kind: str, fn: Any) -> Any: ...


def validate_backend(backend):
    """Check `backend` against the ExecutionBackend contract.

    Accepts an instance (methods + data attributes checked — what the
    scheduler does at construction) or a class (methods only: the data
    members are created per-instance in ``__init__``, which is how the
    engines declare conformance at import time).  Returns the argument so
    it composes, raises ``TypeError`` naming every missing member.
    """
    is_cls = isinstance(backend, type)
    name = backend.__name__ if is_cls else type(backend).__name__
    missing = [m for m in PROTOCOL_METHODS
               if not callable(getattr(backend, m, None))]
    if not is_cls:
        missing += [a for a in PROTOCOL_ATTRS if not hasattr(backend, a)]
    if missing:
        raise TypeError(
            f"{name} does not implement ExecutionBackend: "
            f"missing {', '.join(missing)}")
    return backend
