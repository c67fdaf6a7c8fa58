"""Deterministic fault injection + transfer retry/backoff (§5.6 substrate).

Chaos engineering for the batch runtime: a ``FaultPlan`` is a *seeded,
replayable* schedule of faults keyed to scheduler rounds (ticks), never to
wall time — the exact same chaos run can be replayed from its seed, which
is what makes "bitwise-identical tokens under injected failures" a testable
property instead of a hope.  The scheduler threads per-node ``NodeFaults``
views onto each engine (``engine.faults``, part of the formal
``ExecutionBackend`` contract) and advances them at the start of every
round; engines consult the view at their event boundaries:

=====================  ====================================================
fault kind             honored at
=====================  ====================================================
``node_death``         ``heartbeat()`` turns unhealthy; ``decode_page`` /
                       ``prefill`` no-op; ``acquire_slot`` refuses — the
                       node is a zombie until the health monitor declares
                       it dead and NODE_FAILURE recovers its sequences
``stale_heartbeat``    ``heartbeat()`` returns None for ``duration`` ticks
                       (a network blip; >= ``dead_after`` consecutive
                       ticks triggers a spurious-but-safe failover)
``transfer_fail``      the next ``count`` guarded transfers of the matching
                       kind raise ``TransferError`` (retried with backoff)
``transfer_timeout``   same, raising ``TransferTimeout``
``straggler``          engine runs ``factor`` x slower for ``duration``
                       ticks.  SimEngine inflates its virtual clock; the
                       real engine cannot actually slow down, so it scales
                       its heartbeat ``tokens_out`` credit down by the
                       factor instead — either way the node's progress
                       rate drops by ``factor`` and the scheduler's
                       ``ProgressTracker`` sees the straggler.  Heartbeats
                       still ARRIVE: a straggler is slow, never dead, and
                       must raise NODE_SLOW, not NODE_FAILURE
``oom``                allocator exhaustion for ``duration`` ticks:
                       ``acquire_slot`` refuses admissions AND the
                       page-boundary extension alloc fails mid-flight —
                       the scheduler's governor preempts the affected
                       sequences (checkpoint → host → free pages) and
                       re-admits them through COMBINE when the fault
                       clears, with bitwise-identical tokens
=====================  ====================================================

Transfer retry envelope
-----------------------
``guarded_transfer`` is the single retry/timeout/dead-letter funnel every
engine routes its risky host transfers through (``ExecutionBackend.
transfer``): stage/drain d2h KV copies, ``install_slot`` scatters, and
``prim.migrate`` blob moves.  A failed attempt retries with bounded
exponential backoff (``RetryPolicy``); after ``max_attempts`` the transfer
is *dead-lettered* — the engine's ``dead_lettered`` flag is raised and
``TransferDeadLetter`` propagates so the caller can drop the lost blob,
and the scheduler escalates the node to NODE_FAILURE (§5.6 recovery)
immediately after the dispatching handler returns.  Every retry, timeout
and dead-letter is counted in ``engine.transfer_stats``.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, List, Optional, Sequence

FAULT_KINDS = ("node_death", "stale_heartbeat", "transfer_fail",
               "transfer_timeout", "straggler", "oom")
TRANSFER_KINDS = ("stage", "drain", "install", "migrate", "restore", "any")


class TransferError(RuntimeError):
    """A guarded host transfer failed (injected or real)."""


class TransferTimeout(TransferError):
    """A guarded host transfer exceeded its timeout budget."""


class TransferDeadLetter(TransferError):
    """A transfer exhausted its retry budget; the owning node must be
    escalated to NODE_FAILURE (the scheduler does this on seeing the
    engine's ``dead_lettered`` flag)."""

    def __init__(self, node: int, kind: str, attempts: int):
        super().__init__(
            f"transfer '{kind}' on node {node} dead-lettered after "
            f"{attempts} attempts")
        self.node = node
        self.kind = kind
        self.attempts = attempts


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.  ``at_tick`` is the scheduler round it arms."""
    kind: str
    node: int
    at_tick: int
    count: int = 1            # consecutive transfer faults to inject
    duration: int = 1         # ticks a windowed fault stays open
    factor: float = 4.0       # straggler slowdown multiplier
    transfer_kind: str = "any"   # stage | drain | install | migrate | any

    def __post_init__(self):
        assert self.kind in FAULT_KINDS, self.kind
        assert self.transfer_kind in TRANSFER_KINDS, self.transfer_kind


class NodeFaults:
    """Live per-node fault state, advanced by the scheduler each round.

    Deterministic: faults arm strictly by tick, transfer faults are
    consumed in schedule order, and nothing reads a clock."""

    def __init__(self, faults: Sequence[Fault] = ()):
        self._pending: List[Fault] = sorted(faults, key=lambda f: f.at_tick)
        self.armed: List[Fault] = []
        self.tick = -1
        self.dead = False
        self._stale_until = -1
        self._strag_until = -1
        self._strag_factor = 1.0
        self._oom_until = -1
        # [kind, transfer_kind, remaining] entries, consumed FIFO
        self._transfer: List[List] = []

    def advance(self, tick: int) -> None:
        """Arm every fault scheduled at or before ``tick`` (event boundary
        hook — the scheduler calls this once per round per node)."""
        self.tick = tick
        while self._pending and self._pending[0].at_tick <= tick:
            f = self._pending.pop(0)
            self.armed.append(f)
            until = tick + max(f.duration, 1)
            if f.kind == "node_death":
                self.dead = True
            elif f.kind == "stale_heartbeat":
                self._stale_until = max(self._stale_until, until)
            elif f.kind == "straggler":
                self._strag_until = max(self._strag_until, until)
                self._strag_factor = f.factor
            elif f.kind == "oom":
                self._oom_until = max(self._oom_until, until)
            else:   # transfer_fail / transfer_timeout
                self._transfer.append([f.kind, f.transfer_kind, f.count])

    # ---- queries engines consult at their event boundaries ---------------
    def heartbeat_suppressed(self) -> bool:
        return self.tick < self._stale_until

    def straggler_factor(self) -> float:
        return self._strag_factor if self.tick < self._strag_until else 1.0

    def oom_active(self) -> bool:
        return self.tick < self._oom_until

    def take_transfer_fault(self, kind: str) -> Optional[TransferError]:
        """Consume one armed transfer fault matching ``kind`` (or None).
        Called once per transfer *attempt*, so ``count`` is the number of
        consecutive failing attempts the fault injects."""
        for ent in self._transfer:
            fk, tk, rem = ent
            if rem > 0 and tk in ("any", kind):
                ent[2] -= 1
                if fk == "transfer_timeout":
                    return TransferTimeout(
                        f"injected timeout on '{kind}' transfer")
                return TransferError(f"injected failure on '{kind}' transfer")
        self._transfer = [e for e in self._transfer if e[2] > 0]
        return None


class FaultPlan:
    """A replayable schedule of faults.  Build explicitly from ``Fault``
    entries, or seed a random chaos matrix with ``FaultPlan.random`` —
    either way ``node_view`` hands each engine its deterministic slice."""

    def __init__(self, faults: Sequence[Fault] = (),
                 seed: Optional[int] = None):
        self.faults = sorted(faults, key=lambda f: (f.at_tick, f.node,
                                                    f.kind))
        self.seed = seed

    @classmethod
    def random(cls, seed: int, *, nodes: int, horizon: int = 24,
               n_faults: int = 4, kinds: Sequence[str] = FAULT_KINDS,
               max_deaths: Optional[int] = None) -> "FaultPlan":
        """Seeded chaos matrix: ``n_faults`` faults over ``horizon`` ticks.
        At most ``max_deaths`` (default: nodes - 1) distinct nodes die so a
        chaos run always keeps at least one survivor to recover onto."""
        rng = random.Random(seed)
        if max_deaths is None:
            max_deaths = max(nodes - 1, 0)
        killed: set = set()
        faults = []
        for _ in range(n_faults):
            kind = rng.choice(list(kinds))
            node = rng.randrange(nodes)
            if kind == "node_death":
                if node not in killed and len(killed) >= max_deaths:
                    kind = "straggler"      # keep a survivor
                else:
                    killed.add(node)
            faults.append(Fault(
                kind=kind, node=node, at_tick=rng.randrange(1, horizon),
                count=rng.randint(1, 3), duration=rng.randint(1, 4),
                factor=rng.choice([2.0, 4.0, 8.0]),
                transfer_kind=rng.choice(["any", "drain", "install"])))
        return cls(faults, seed=seed)

    @classmethod
    def straggler(cls, node: int, *, at_tick: int = 1, factor: float = 4.0,
                  duration: int = 10**9) -> "FaultPlan":
        """One persistently slow node (default: slow forever) — the
        canonical straggler-mitigation scenario."""
        return cls([Fault(kind="straggler", node=node, at_tick=at_tick,
                          factor=factor, duration=duration)])

    def node_view(self, node: int) -> NodeFaults:
        return NodeFaults([f for f in self.faults if f.node == node])

    def describe(self) -> str:
        return "\n".join(
            f"t={f.at_tick:>3} node={f.node} {f.kind}"
            + (f" x{f.count} ({f.transfer_kind})"
               if f.kind.startswith("transfer") else "")
            + (f" for {f.duration} ticks" if f.kind in
               ("stale_heartbeat", "straggler", "oom") else "")
            for f in self.faults)

    def __len__(self):
        return len(self.faults)


# ---------------------------------------------------------------------------
# retry / timeout / dead-letter envelope for guarded transfers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-exponential-backoff retry envelope for host transfers.

    ``timeout_s`` bounds one attempt: an *injected* ``transfer_timeout``
    fault exercises the retry path, while a real attempt that completes
    but overruns the budget is counted in ``transfer_stats['timeouts']``
    (its result is still valid — a synchronous copy cannot be abandoned
    mid-flight without threads, so slow-but-complete is accounting, not
    data loss)."""
    max_attempts: int = 4
    base_backoff_s: float = 2e-3
    max_backoff_s: float = 0.05
    timeout_s: float = 30.0

    def backoff(self, attempt: int) -> float:
        return min(self.base_backoff_s * (2 ** attempt), self.max_backoff_s)


def guarded_transfer(engine, kind: str, fn: Callable,
                     on_backoff: Optional[Callable[[float], None]] = None):
    """Run one host transfer under ``engine``'s fault injector + retry
    policy.  Returns ``fn()``'s result; raises ``TransferDeadLetter`` (and
    raises the engine's ``dead_lettered`` flag, which the scheduler
    escalates to NODE_FAILURE) after ``max_attempts`` failed attempts.

    Engine contract: ``retry_policy`` (RetryPolicy), ``transfer_stats``
    (dict with retries/timeouts/dead_letters), optional ``faults``
    (NodeFaults).  ``on_backoff`` defaults to ``time.sleep`` — virtual-
    clock engines pass their own (advance vclock instead of sleeping)."""
    pol = engine.retry_policy
    faults = getattr(engine, "faults", None)
    stats = engine.transfer_stats
    wait = on_backoff or time.sleep
    last: Optional[BaseException] = None
    for attempt in range(pol.max_attempts):
        exc = faults.take_transfer_fault(kind) if faults is not None else None
        if exc is None:
            t0 = time.perf_counter()
            try:
                out = fn()
            except TransferError as e:      # a real transfer failure
                exc = e
            else:
                if time.perf_counter() - t0 > pol.timeout_s:
                    stats["timeouts"] += 1      # slow-but-complete
                return out
        if isinstance(exc, TransferTimeout):
            stats["timeouts"] += 1
        last = exc
        stats["retries"] += 1
        if attempt + 1 < pol.max_attempts:
            wait(pol.backoff(attempt))
    stats["dead_letters"] += 1
    engine.dead_lettered = True
    raise TransferDeadLetter(engine.node_id, kind, pol.max_attempts) from last
