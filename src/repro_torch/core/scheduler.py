"""Event-driven coroutine scheduler: Algorithm 2 + §5.3 dynamic sequence
management, driven by a real event loop.

The scheduler is generic over execution backends implementing the formal
slot protocol (``core/backend.py``).  Both the real mini-engine
(runtime/engine.py — actually executes a JAX model on CPU) and the cluster
simulator (runtime/cluster.py — virtual clocks from the §5.4 performance
model) plug in here, so the scheduling logic benchmarked at 128 GPUs is the
same code that decodes real tokens in the examples.

Event loop
----------
Every phase is a handler registered on a pluggable ``SchedulerPolicy``
table keyed by ``EventKind``; ``step()`` seeds one round of per-node work
and then drains ``self.queue`` in EventKind priority order
(SYNC < SYNC_DRAIN < SEQ_DONE < SEQ_PREEMPT < PAGE_BOUNDARY <
MODULE_READY < REFILL < LONG_TAIL < NODE_SLOW < MIGRATE < NODE_FAILURE <
NODE_DRAIN).  Decode
completion *enqueues* its
follow-up phases instead of inline-calling them, so custom policies can
reorder, drop or wrap any phase, and cluster-sim / real-engine runs share
one code path.  Per decode *page* (P tokens, §5.3) the default policy
dispatches:

  REFILL(tick)   — pre-decode ON_REFILL_NODE, then enqueue MODULE_READY
  MODULE_READY   — decode one page; enqueue SYNC/SYNC_DRAIN/SEQ_DONE/
                   PAGE_BOUNDARY/REFILL/LONG_TAIL for the node
  SYNC           — start the page's KV gather + async device→host copy
                   (``stage_appends``; host = source of truth)
  SYNC_DRAIN     — land in-flight KV blobs, keeping the newest staged
                   (this page's) in flight so its PCIe copy rides behind
                   the NEXT page's megastep — the two-stage pipeline that
                   hides the sync transfer (§5.2/§5.3 overlap)
  SEQ_DONE       — YIELD finished sequences, release pages (forces a full
                   drain first: eviction consumes host-store state)
  SEQ_PREEMPT    — memory-pressure governor: occupancy crossed the
                   allocator's high watermark — checkpoint least-progress
                   sequences to host, freeing device pages until
                   occupancy drains under the low watermark; they
                   re-admit via COMBINE as the watermark budget re-opens
  PAGE_BOUNDARY  — extend page allocation or YIELD (most-progress-first);
                   an injected ``FaultPlan.oom`` fails the extension
                   alloc itself and preempts through the same path
  REFILL         — COMBINE waiting sequences into the active batch,
                   capped by the governor's watermark admission budget;
                   prefetches h2d restores through the ring buffer
  LONG_TAIL      — PARTITION stragglers over idle devices
  NODE_SLOW      — straggler mitigation: shed a deficit-proportional
                   fraction of a persistently slow (but alive) node's
                   sequences to fast survivors (checkpoint + MIGRATE,
                   the NODE_DRAIN machinery applied partially)
  MIGRATE        — rebalance suspended sequences across nodes (FIFO;
                   ``prim.migrate`` drains the source engine first)
  NODE_FAILURE   — §5.6 recovery: land the failed node's in-flight blobs,
                   migrate checkpointed sequences to the least-loaded
                   survivor, recompute the rest
  NODE_DRAIN     — elastic scale-down: YIELD (fresh checkpoint) + MIGRATE
                   every live sequence to a survivor, then retire the
                   node — the zero-recompute handoff a graceful drain
                   gets that a failure cannot

Health-driven recovery (§5.6)
-----------------------------
Each round starts by arming the engines' injected fault views
(``FaultPlan`` ticks are scheduler rounds — chaos runs replay from a
seed) and collecting one ``heartbeat()`` per engine into the
``HealthMonitor``; ``dead_after`` consecutive missed beats enqueue
NODE_FAILURE from inside the loop — no external monitor process.  A
transfer that dead-letters out of its retry budget (``engine.
dead_lettered``) escalates the node to NODE_FAILURE *inline*,
immediately after the dispatch that tripped it, so a node with a corrupt
slot never decodes another page.  ``policy.recovery_choice`` hooks the
migrate-vs-recompute cost model into the failure handler.

Straggler mitigation (detect → shed → hedge)
--------------------------------------------
Heartbeats also carry cumulative progress counters; a ``ProgressTracker``
turns them into per-node EWMA throughput on each node's own clock.  A
node below ``slow_fraction`` x the fleet median for ``slow_rounds``
consecutive rounds raises NODE_SLOW (never NODE_FAILURE — its beats
still arrive).  ``default_node_slow`` sheds a deficit-proportional
fraction of its sequences to the fastest underloaded survivors
(``policy.shed_choice`` can veto per sequence); a node still flagged
``hedge_deadline_s`` later gets every remaining resident sequence
*hedged* — a speculative clone launched on a fast node, pinned to the
original's token-addressable seed so it reproduces the stream bitwise.
First finisher wins (the result always surfaces under the ORIGINAL
seq_id); the loser is cancelled and retired.

Stream-first results
--------------------
``stream()`` / ``events()`` yield typed records (``TokenBlockEvent`` /
``SeqFinishedEvent`` / ``PrimitiveEvent``) as pages complete; ``run()`` is
a thin wrapper that drains the stream and returns the BCT report.  The
report carries ``status`` = ``"completed" | "exhausted"`` so callers can
detect batches truncated by ``max_ticks``.

Page-block contract (fused decode): ``engine.decode_page`` executes the
whole page as one fused device program capped at ``min(P, max remaining)``
steps (the on-device done mask absorbs mid-page finishes — that cap IS the
early page exit) and applies the returned ``(P, max_active)`` token block
to the coroutines before returning.  The page-boundary handlers therefore
see fully updated coroutine state; ``stage_appends`` issues the block's
KV as one batched gather + async host copy per page, and the next round's
``SYNC_DRAIN`` lands it after the following megastep has been dispatched.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Type, Union)

from repro_torch.core import primitives as prim
from repro_torch.core.backend import validate_backend
from repro_torch.core.coroutine import Phase, SequenceCoroutine, Status
from repro_torch.core.events import (Event, EventKind, EventQueue, HealthEvent,
                               PrimitiveEvent, RuntimeRecord,
                               SeqFinishedEvent, TokenBlockEvent)
from repro_torch.runtime.failure import HealthMonitor, ProgressTracker
from repro_torch.runtime.faults import FaultPlan, TransferDeadLetter
from repro_torch.sampling.params import SamplingParams, derive_fork_seed

logger = logging.getLogger(__name__)

_TICK = "tick"      # payload marking the round-seeding REFILL event


@dataclasses.dataclass
class SchedulerConfig:
    page_size: int = 64              # P — decode tokens between checks
    refill_threshold: float = 0.75   # refill when active < thr * slots
    longtail_active: int = 2         # ON_LONG_TAIL when active <= this
    longtail_min_remaining: int = 64
    migrate_imbalance: int = 2       # min queue difference to migrate
    max_partition_group: int = 8
    # ---- straggler mitigation (detect -> shed -> hedge) ------------------
    mitigate_stragglers: bool = True
    slow_fraction: float = 0.5       # flag below this x fleet-median EWMA
    slow_rounds: int = 3             # K consecutive deficient rounds
    slow_cooldown: int = 10          # rounds before a shed node re-flags
    slow_recover_fraction: float = 0.8   # hysteresis: unflag above this
    slow_ewma_alpha: float = 0.5
    max_shed_fraction: float = 0.75  # cap on the shed fraction
    hedge_deadline_s: float = 5.0    # slow-node clock wait before hedging
    # ---- memory-pressure governor (OOM-safe admission/eviction) ----------
    govern_memory: bool = True       # watermark-driven preempt / re-admit
    high_watermark: Optional[float] = None   # None = keep the allocators'
    low_watermark: Optional[float] = None    # own watermark pair
    preempt_min_active: int = 1      # never preempt the node below this
    restore_stage_depth: int = 4     # h2d restores prefetched per round


# ---------------------------------------------------------------------------
# default policy handlers — each is handler(sched, event) and free to push
# follow-up events; replace any of them via SchedulerPolicy to customize
# ---------------------------------------------------------------------------


def _admit_budget(sched: "CoroutineScheduler", eng) -> int:
    """Sequences the governor lets this node admit right now: the page
    headroom under the allocator's high watermark, two pages per admission
    (the §5.2 reservation).  Admission stops BEFORE the pool saturates —
    the watermark gap is what the governor preempts into — instead of at
    exhaustion, which is what ungoverned ``can_admit`` would do.

    Ungoverned pools (``allocator.governed`` False — a modelling artifact,
    not a configured byte budget) keep the legacy unbounded admission."""
    alloc = eng.allocator
    if not sched.cfg.govern_memory or not getattr(alloc, "governed", True):
        return eng.max_active
    headroom = int(alloc.high_watermark * alloc.total) - alloc.used
    return max(headroom // 2, 0)


def _restore_drained(sched: "CoroutineScheduler", eng, co) -> bool:
    """Admission gate for spilled sequences under the governor: admit
    when the sequence needs no h2d restore, or its staged restore has
    drained (a decode page overlapped the copy).  A spilled sequence
    with no prefetch in flight is staged NOW and deferred one round —
    the stage/drain discipline that turns the evict→re-admit round trip
    from a synchronous PCIe stall into a hidden transfer.  If the ring
    cannot take the prefetch at all, admit synchronously rather than
    starve."""
    ready = getattr(eng, "restore_ready", None)
    stage = getattr(eng, "stage_restore", None)
    if (not callable(ready) or not callable(stage)
            or sched.cfg.restore_stage_depth <= 0):
        return True
    if not eng.host_store.has(co.seq_id):
        return True
    if ready(co.seq_id):
        return True
    return not stage(co)    # staged/in flight -> defer; ring full -> sync


def _refill_node(sched: "CoroutineScheduler", node: int, eng) -> None:
    """COMBINE suspended sequences, then prefill INITs into free slots.
    Both admission paths are capped by the governor's watermark budget."""
    budget = _admit_budget(sched, eng)
    waiting = sched.pending(node, Status.INACTIVE)
    if waiting and budget > 0:
        waiting.sort(key=lambda c: c.submitted_t)     # FIFO fairness
        # no hard re-admission gate: the watermark budget IS the
        # hysteresis — preemption drains occupancy to the LOW watermark,
        # so the budget re-opens a whole high-low band of admissions at
        # once instead of oscillating one-in-one-out at the boundary
        if _governing(sched, eng):
            # spilled sequences wait for their staged restore to drain
            # behind live decode work; an idle node bootstraps by letting
            # the FIRST spill through synchronously — there is nothing to
            # overlap yet — and the rest hide behind its decode
            have_active = bool(sched.pending(node, Status.ACTIVE))
            kept = []
            for co in waiting:
                if not have_active:
                    kept.append(co)
                    have_active = True
                elif _restore_drained(sched, eng, co):
                    kept.append(co)
            waiting = kept
        admitted = prim.combine(waiting[:budget], eng)
        budget -= len(admitted)
        for co in admitted:
            if co.seq_id in sched._preempted:
                sched._preempted.discard(co.seq_id)
                sched.gov_restores += 1
                sched.emit(PrimitiveEvent(co.seq_id, node,
                                          primitive="combine",
                                          detail="restore"))
            else:
                sched.emit(PrimitiveEvent(co.seq_id, node,
                                          primitive="combine"))
    inits = sched.pending(node, Status.INIT)
    if inits:
        free_slots = min(
            eng.max_active - len(sched.pending(node, Status.ACTIVE)),
            budget)
        if free_slots > 0:
            batch = inits[:free_slots]
            # keep fork groups whole across the cut: siblings must prefill
            # in one batch so the engine runs the group's prompt forward
            # once and binds every sibling to the lead's span pages
            if len(batch) < len(inits) and batch[-1].fork_group is not None:
                g = batch[-1].fork_group
                for co in inits[len(batch):]:
                    if co.fork_group != g:
                        break
                    batch.append(co)
            eng.prefill(batch)          # leaves them INACTIVE on host
            for co in batch:            # prefill emits the first token
                sched.emit_token_block(co, 0)
                if co.prefix_hit_tokens:
                    # PREFIX_HIT-aware refill: these prompt tokens were
                    # served from the prefix index, not the model forward
                    sched.emit(PrimitiveEvent(co.seq_id, node,
                                              primitive="prefix_hit",
                                              detail=co.prefix_hit_tokens))
            for co in prim.combine(batch, eng, handoff=True):
                sched.emit(PrimitiveEvent(co.seq_id, node,
                                          primitive="combine",
                                          detail="prefill"))


def _governing(sched: "CoroutineScheduler", eng) -> bool:
    """True when the memory-pressure governor steers this engine: the
    feature is on AND the pool is a real configured budget (ungoverned
    soft pools keep legacy scheduling untouched)."""
    return (sched.cfg.govern_memory
            and getattr(eng.allocator, "governed", True))


def _stage_restores(sched: "CoroutineScheduler", node: int, eng) -> None:
    """Prefetch host→device restores for the node's next admission
    candidates through the ring buffer (the h2d mirror of the d2h sync
    pipeline): ``stage_restore`` issues the async ``device_put`` now, it
    rides behind the upcoming decode page, and the later COMBINE's
    ``take_restore`` installs without waiting on PCIe.  Same stage/drain
    discipline as ``stage_appends``: a restore only stages when the ring
    has room, so prefetch can never starve the sync pipeline."""
    stage = getattr(eng, "stage_restore", None)
    if not callable(stage) or sched.cfg.restore_stage_depth <= 0:
        return
    # no watermark gate here: a staged restore lands in the h2d ring, not
    # the page pool, so the ring's byte budget is the backpressure — and
    # a tight pool (above the high mark most rounds) is exactly when the
    # next admission's restore must already be in flight to be hidden
    waiting = sched.pending(node, Status.INACTIVE)
    waiting.sort(key=lambda c: c.submitted_t)     # the refill order
    staged = 0
    for co in waiting:
        if staged >= sched.cfg.restore_stage_depth:
            break
        if eng.host_store.has(co.seq_id) and stage(co):
            staged += 1


def default_refill(sched: "CoroutineScheduler", ev: Event) -> None:
    """ON_REFILL_NODE (Alg. 2 lines 7-11).  The round-seeding variant
    (payload ``"tick"``) polls the allocator's watermark pair (enqueueing
    SEQ_PREEMPT when occupancy crossed the high watermark — it dispatches
    before this node's MODULE_READY decode), refills only when decode
    under-fills the node, prefetches h2d restores for the next refill's
    candidates, and then enqueues the node's MODULE_READY decode work;
    the post-decode variant refills unconditionally."""
    eng = sched.engine(ev.node)
    if eng is None:
        return
    if ev.payload == _TICK:
        if _governing(sched, eng) and eng.allocator.above_high():
            sched.queue.push(EventKind.SEQ_PREEMPT, ev.node)
        n_active = len(sched.pending(ev.node, Status.ACTIVE))
        if n_active < sched.cfg.refill_threshold * eng.max_active:
            _refill_node(sched, ev.node, eng)
        _stage_restores(sched, ev.node, eng)
        sched.queue.push(EventKind.MODULE_READY, ev.node)
    else:
        _refill_node(sched, ev.node, eng)


def default_module_ready(sched: "CoroutineScheduler", ev: Event) -> None:
    """Decode one page on the node, then ENQUEUE the page-boundary phases
    (sync -> evict -> extend -> refill -> longtail) instead of inline-
    calling them — the queue's priority order sequences them."""
    eng = sched.engine(ev.node)
    if eng is None:
        return
    active = sched.pending(ev.node, Status.ACTIVE)
    if not active:
        eng.drain_appends()     # idle node: land any leftover pipeline
        eng.idle_tick()
        return
    before = {c.seq_id: len(c.generated) for c in active}
    eng.decode_page(active, sched.cfg.page_size)
    for co in active:
        sched.emit_token_block(co, before[co.seq_id])
    for kind in (EventKind.SYNC, EventKind.SYNC_DRAIN, EventKind.SEQ_DONE,
                 EventKind.PAGE_BOUNDARY, EventKind.REFILL,
                 EventKind.LONG_TAIL):
        sched.queue.push(kind, ev.node)


def default_sync(sched: "CoroutineScheduler", ev: Event) -> None:
    """(i) Sync — start the page's KV gather + async host copy (§5.3 i).
    The blob lands at a later SYNC_DRAIN (pipelined behind the next
    megastep); the host store stays the single source of truth because
    every consumer of it drains first."""
    eng = sched.engine(ev.node)
    if eng is None:
        return
    active = sched.pending(ev.node, Status.ACTIVE)
    if active:
        eng.stage_appends(active)


def default_sync_drain(sched: "CoroutineScheduler", ev: Event) -> None:
    """Land in-flight KV blobs, keeping the just-staged page in flight —
    its device→host copy overlaps the next megastep and is drained by the
    NEXT round's SYNC_DRAIN (or force-drained by any host-store
    consumer).  Priority-ordered before SEQ_DONE/MIGRATE/NODE_FAILURE so
    a queued drain can never be outrun by a queued consumer."""
    eng = sched.engine(ev.node)
    if eng is None:
        return
    eng.drain_appends(keep_newest=1)


def default_seq_done(sched: "CoroutineScheduler", ev: Event) -> None:
    """(ii) Eviction — finished sequences release device + host pages.
    Dropping host-store state consumes it: land every in-flight blob
    first so a staged window can never resurrect an evicted sequence.

    Also sweeps per-request deadlines (graceful degradation: a sequence
    past ``sampling.deadline_s`` finishes with whatever it has,
    ``finish_reason="deadline"``) and resolves hedge races — a finishing
    clone surfaces through its ORIGINAL's seq_id; a finishing original
    cancels its clone (first finisher wins)."""
    eng = sched.engine(ev.node)
    if eng is None:
        return
    sched._check_deadlines(ev.node)
    finished = [co for co in sched.pending(ev.node, Status.ACTIVE)
                if co.remaining == 0]
    if not finished:
        return
    eng.drain_appends()
    for co in finished:
        if co.done:
            continue        # resolved as a hedge loser earlier this loop
        eng.allocator.free_seq(co.seq_id)
        eng.free_slot(co)
        co.slot = None
        eng.host_store.drop(co.seq_id)
        co.finish()
        winner = sched._resolve_hedge(co)
        if winner is not None:
            sched.emit(SeqFinishedEvent(winner.seq_id, winner.node,
                                        finish_reason=winner.finish_reason,
                                        n_generated=len(winner.generated),
                                        sct_s=winner.sct()))


def default_seq_preempt(sched: "CoroutineScheduler", ev: Event) -> None:
    """Memory-pressure governor (SEQ_PREEMPT): device-page occupancy
    crossed the allocator's high watermark — checkpoint sequences to the
    host store (YIELD) and free their device pages until occupancy drains
    under the LOW watermark.

    Draining the whole high→low band (not just back under high) is the
    hysteresis: the next refill's watermark budget re-opens a band of
    admissions at once, instead of oscillating one-in-one-out at the
    high-watermark boundary every round.  Victim order is LEAST progress
    first (deterministic tie-break by seq_id) — the inverse of the §5.3
    page-exhaustion eviction: a sequence near completion will free its
    pages on its own shortly, while the youngest would hold device pages
    longest.  Preempted sequences re-admit through the ordinary COMBINE
    refill as budget re-opens.  ``policy.preempt_choice`` can veto
    individual victims, mirroring ``recovery_choice`` / ``shed_choice``."""
    eng = sched.engine(ev.node)
    if eng is None or not _governing(sched, eng):
        return
    alloc = eng.allocator
    if not alloc.above_high():
        return
    active = sched.pending(ev.node, Status.ACTIVE)
    n_active = len(active)
    if n_active <= sched.cfg.preempt_min_active:
        return
    drained = False
    choose = sched.policy.preempt_choice
    for co in sorted(active, key=lambda c: (c.length, c.seq_id)):
        if alloc.below_low():
            break       # drained the whole high→low band
        if n_active <= sched.cfg.preempt_min_active:
            break
        if co.done or co.status != Status.ACTIVE:
            continue
        if choose is not None and choose(sched, co, eng) != "preempt":
            continue
        if not drained:
            eng.drain_appends()     # checkpoints consume host-store state
            drained = True
        sched._preempt(co, eng, "preempt")
        n_active -= 1


def default_page_boundary(sched: "CoroutineScheduler", ev: Event) -> None:
    """(iii) Extension — two-page reservation; evict most-progress-first.

    An injected ``FaultPlan.oom`` makes the page-extension alloc itself
    fail mid-decode (not just admission), and recovers through the one
    event-loop path: the sequence is preempted (checkpoint → host store
    → free pages) exactly like a watermark preemption and re-admits via
    COMBINE when pressure clears.  Token output is bitwise-unchanged:
    preemption is pure rescheduling.  REAL pool exhaustion is tolerated
    as a soft budget here — sustained pressure is the governor's job
    (watermark SEQ_PREEMPT keeps occupancy below the high mark before
    extension ever fails), so a transient failed extension must not
    thrash the batch with preempt/re-admit churn."""
    eng = sched.engine(ev.node)
    if eng is None:
        return
    active = sched.pending(ev.node, Status.ACTIVE)
    lengths = {c.seq_id: c.length for c in active}
    for victim_id in eng.allocator.ensure_two_pages(lengths):
        co = sched.cos[victim_id]
        if co.status == Status.ACTIVE:
            prim.yield_(co, eng)
            sched.log.append(f"yield(evict) seq={victim_id}")
            sched.emit(PrimitiveEvent(victim_id, ev.node, primitive="yield",
                                      detail="evict"))
    faults = getattr(eng, "faults", None)
    oom = faults is not None and faults.oom_active()
    drained = False
    for co in active:
        if not co.done and co.status == Status.ACTIVE:
            got = None if oom else eng.allocator.alloc(co.seq_id, 1)
            if got is not None or not oom:
                # real exhaustion: soft budget — the governor's watermark
                # preemption owns sustained pressure
                continue
            eng.oom_rejections = getattr(eng, "oom_rejections", 0) + 1
            if not drained:
                eng.drain_appends()
                drained = True
            sched._preempt(co, eng, "oom")


def default_long_tail(sched: "CoroutineScheduler", ev: Event) -> None:
    """ON_LONG_TAIL (Alg. 2 lines 12-14) -> PARTITION one straggler.

    Only THIS node's live sequences count: a busy neighbour node must not
    suppress PARTITION for a node already down to stragglers."""
    eng = sched.engine(ev.node)
    if eng is None:
        return
    cfg = sched.cfg
    live = [c for c in sched.cos.values()
            if c.node == ev.node and not c.done]
    active = [c for c in live if c.status == Status.ACTIVE]
    others = [c for c in live if c.status != Status.ACTIVE]
    if (len(active) <= cfg.longtail_active and not others and active
            and max(c.remaining for c in active) >= cfg.longtail_min_remaining
            and not any(c.partition_group for c in active)):
        # wait for yield (checkpoint), then PARTITION over idle devices
        group = list(range(min(eng.num_devices, cfg.max_partition_group)))
        for co in sorted(active, key=lambda c: -c.remaining):
            prim.yield_(co, eng)
            prim.partition(co, eng, group)
            sched.log.append(f"partition seq={co.seq_id} group={len(group)}")
            sched.emit(PrimitiveEvent(co.seq_id, ev.node,
                                      primitive="partition", detail=group))
            prim.combine([co], eng, handoff=True)
            break


def default_migrate(sched: "CoroutineScheduler", ev: Event) -> None:
    """Opportunistic load balancing: move one suspended sequence from the
    most- to the least-loaded node (FIFO)."""
    if len(sched.engines) < 2:
        return
    nids = [e.node_id for e in sched.engines]
    loads = {n: len(sched.pending(n, Status.INACTIVE))
             + len(sched.pending(n, Status.INIT)) for n in nids}
    hi = max(nids, key=loads.__getitem__)
    lo = min(nids, key=loads.__getitem__)
    if loads[hi] - loads[lo] >= sched.cfg.migrate_imbalance:
        movable = (sched.pending(hi, Status.INACTIVE)
                   or sched.pending(hi, Status.INIT))
        if movable:
            co = movable[0]
            try:
                prim.migrate(co, sched.engine(hi), sched.engine(lo))
            except TransferDeadLetter:
                # the blob never moved (host stores are consistent); the
                # post-dispatch dead-letter sweep escalates node `hi`
                sched.log.append(f"migrate dead-letter seq={co.seq_id}")
                return
            sched.log.append(f"migrate seq={co.seq_id} {hi}->{lo}")
            sched.emit(PrimitiveEvent(co.seq_id, lo, primitive="migrate",
                                      detail=(hi, lo)))


def default_node_slow(sched: "CoroutineScheduler", ev: Event) -> None:
    """Straggler shedding: a live node fell below ``slow_fraction`` x the
    fleet-median throughput for ``slow_rounds`` rounds (ProgressTracker).
    Checkpoint (YIELD) and MIGRATE a fraction of its resident sequences —
    proportional to the throughput deficit, capped at
    ``max_shed_fraction`` — to the fastest underloaded survivors.  This is
    the NODE_DRAIN machinery applied *partially*: the node stays in
    rotation with a lighter load, and a post-shed cooldown keeps its
    still-polluted EWMA from re-flagging it immediately.
    ``policy.shed_choice`` can veto individual moves (mirror of
    ``recovery_choice``)."""
    eng = sched.engine(ev.node)
    if eng is None or len(sched.engines) < 2:
        return
    tr = sched.progress
    survivors = [e for e in sched.engines
                 if e.node_id != ev.node and not tr.is_flagged(e.node_id)]
    if not survivors:
        sched.log.append(f"node_slow node={ev.node} refused: no fast "
                         "survivor")
        return
    # arm the hedge deadline on the slow node's own clock — if shedding
    # does not clear the flag by then, the stragglers get cloned
    sched._slow_since.setdefault(ev.node, eng.clock())
    live = [c for c in sched.cos.values()
            if c.node == ev.node and not c.done and c.remaining > 0]
    deficit = tr.deficit(ev.node)
    frac = min(deficit, sched.cfg.max_shed_fraction)
    n_shed = min(int(round(len(live) * frac)), len(live))
    if n_shed <= 0:
        tr.start_cooldown(ev.node, sched.ticks)
        return
    eng.drain_appends()     # land in-flight KV before checkpoints move

    def load(e):
        return sum(1 for c in sched.cos.values()
                   if c.node == e.node_id and not c.done)

    choose = sched.policy.shed_choice
    moved = 0
    # most-remaining-first: the longest tails gain the most from
    # finishing on a fast node
    for co in sorted(live, key=lambda c: -c.remaining):
        if moved >= n_shed:
            break
        dst = max(survivors,
                  key=lambda e: tr.rate(e.node_id) / (1.0 + load(e)))
        if choose is not None and choose(sched, co, eng, dst) != "shed":
            continue
        if co.status == Status.ACTIVE:
            prim.yield_(co, eng)
            sched.emit(PrimitiveEvent(co.seq_id, ev.node, primitive="yield",
                                      detail="shed"))
        co.partition_group = None
        try:
            prim.migrate(co, eng, dst)
        except TransferDeadLetter:
            # the blob never moved; the post-dispatch dead-letter sweep
            # escalates this node to NODE_FAILURE, which supersedes a shed
            sched.log.append(f"shed migrate dead-letter seq={co.seq_id}")
            return
        moved += 1
        sched.emit(PrimitiveEvent(co.seq_id, dst.node_id,
                                  primitive="migrate", detail="shed"))
    sched.sheds += 1
    sched.shed_moved += moved
    tr.start_cooldown(ev.node, sched.ticks)
    sched.log.append(f"node_slow node={ev.node} shed={moved}/{len(live)} "
                     f"deficit={deficit:.2f}")


def default_node_failure(sched: "CoroutineScheduler", ev: Event) -> None:
    """§5.6 recovery: drop the failed engine from rotation; sequences with
    a host checkpoint MIGRATE to the least-loaded survivor, everything
    whose state died with the node recomputes from the prompt.

    ``policy.recovery_choice`` (the migrate-vs-recompute cost model —
    ``Cluster`` plugs in the §5.4 performance-model version) can demote an
    eligible migrate to a recompute; it can never promote an ineligible
    one — only INACTIVE/INIT sequences with a host checkpoint have state
    that is safe to move."""
    failed = sched.engine(ev.node)
    if failed is None:
        return
    # Land the failed node's in-flight KV blobs before deciding migrate-
    # vs-recompute: the copies were issued before the failure (§5.6 "the
    # host tier survives"), and an undrained window would make a migrated
    # checkpoint lag co.generated.  (A deployment whose DMA died with the
    # node re-gathers instead — here the staged arrays are still live.)
    failed.drain_appends()
    # a dead-letter raised during that drain is already handled (the blob
    # was abandoned and its sequences will recompute below) — this node is
    # being recovered right now, so clear the escalation flag
    failed.dead_lettered = False
    ring = getattr(failed, "ring", None)
    if ring is not None:
        ring.reset()    # abandoned blobs must not hold staging space
    discard_restores = getattr(failed, "discard_restores", None)
    if callable(discard_restores):
        discard_restores()      # staged h2d restores died with the devices
    sched.health.mark_failed(ev.node)
    sched.engines = [e for e in sched.engines if e.node_id != ev.node]
    sched.log.append(f"node_failure node={ev.node}")
    if not sched.engines:
        logger.warning("node %d failed with no survivors; %d sequences "
                       "stranded", ev.node,
                       sum(1 for c in sched.cos.values()
                           if c.node == ev.node and not c.done))
        return

    def load(e):
        return sum(1 for c in sched.cos.values()
                   if c.node == e.node_id and not c.done)

    choose = sched.policy.recovery_choice
    for co in sched.cos.values():
        if co.node != ev.node or co.done:
            continue
        dst = min(sched.engines, key=load)
        co.partition_group = None       # the failed node's devices are gone
        migrated = False
        if (co.status in (Status.INACTIVE, Status.INIT)
                and failed.host_store.has(co.seq_id)
                and (choose is None
                     or choose(sched, co, failed, dst) == "migrate")):
            try:
                prim.migrate(co, failed, dst)
                migrated = True
            except TransferDeadLetter:
                failed.dead_lettered = False    # already recovering
                sched.log.append(
                    f"failover migrate dead-letter seq={co.seq_id}")
        if migrated:
            sched.emit(PrimitiveEvent(co.seq_id, dst.node_id,
                                      primitive="migrate", detail="failover"))
        else:
            # device state (or an unsynced checkpoint) died with the node
            if failed.host_store.has(co.seq_id):
                failed.host_store.drop(co.seq_id)
            co.generated.clear()
            co.token_logprobs.clear()
            co.top_token_logprobs.clear()
            co.length = 0
            co.prefix_hit_tokens = 0    # the re-prefill starts from scratch
            co.slot = None
            co.last_token = 0
            co.stopped = False
            co.phase = Phase.PREFILL
            co.status = Status.INIT
            co.node = dst.node_id
            sched.emit(PrimitiveEvent(co.seq_id, dst.node_id,
                                      primitive="recompute",
                                      detail="failover"))


def default_node_drain(sched: "CoroutineScheduler", ev: Event) -> None:
    """Elastic scale-down: gracefully drain one node and hand its work
    off.  Unlike NODE_FAILURE the node is alive, so every ACTIVE sequence
    YIELDs first (fresh host checkpoint) and then MIGRATEs to the
    least-loaded survivor — zero recompute by construction.  With no
    survivor inside this scheduler the drain is refused (the node stays
    in rotation); a replica-level drain (job tier) requeues instead."""
    eng = sched.engine(ev.node)
    if eng is None:
        return
    survivors = [e for e in sched.engines if e.node_id != ev.node]
    if not survivors:
        sched.log.append(f"node_drain node={ev.node} refused: no survivor")
        return
    eng.drain_appends()     # land in-flight KV before the state moves

    def load(e):
        return sum(1 for c in sched.cos.values()
                   if c.node == e.node_id and not c.done)

    for co in [c for c in sched.cos.values()
               if c.node == ev.node and not c.done]:
        if co.status == Status.ACTIVE:
            prim.yield_(co, eng)
            sched.emit(PrimitiveEvent(co.seq_id, ev.node, primitive="yield",
                                      detail="drain"))
        co.partition_group = None       # the drained node's devices leave
        dst = min(survivors, key=load)
        try:
            prim.migrate(co, eng, dst)
        except TransferDeadLetter:
            # the blob never moved; the post-dispatch dead-letter sweep
            # escalates this node to NODE_FAILURE, whose handler replays
            # the handoff with its migrate-vs-recompute fallback
            sched.log.append(f"drain migrate dead-letter seq={co.seq_id}")
            return
        sched.emit(PrimitiveEvent(co.seq_id, dst.node_id,
                                  primitive="migrate", detail="drain"))
    sched.engines = survivors
    sched.drained_nodes.append(ev.node)
    sched.log.append(f"node_drain node={ev.node}")


Handler = Callable[["CoroutineScheduler", Event], None]


@dataclasses.dataclass
class SchedulerPolicy:
    """Pluggable per-EventKind handler table (the §3 event-driven runtime).

    Replace any field to customize one phase without forking the loop —
    handlers receive ``(scheduler, event)`` and may push follow-up events
    onto ``scheduler.queue`` and emit stream records via
    ``scheduler.emit``.

    ``recovery_choice`` is the §5.6 migrate-vs-recompute cost-model hook
    consulted by ``default_node_failure`` for every eligible sequence:
    ``(sched, co, failed_engine, dst_engine) -> "migrate" | "recompute"``
    (None = always migrate when eligible).  ``shed_choice`` is its
    straggler-shedding mirror, consulted by ``default_node_slow`` per
    candidate move: ``(sched, co, slow_engine, dst_engine) -> "shed" |
    "keep"`` (None = always shed up to the deficit fraction).
    ``preempt_choice`` is the memory-pressure mirror, consulted by
    ``default_seq_preempt`` per watermark-preemption victim:
    ``(sched, co, engine) -> "preempt" | "keep"`` (None = always preempt
    least-progress-first until occupancy clears the high watermark)."""
    sync: Handler = default_sync
    sync_drain: Handler = default_sync_drain
    seq_done: Handler = default_seq_done
    seq_preempt: Handler = default_seq_preempt
    page_boundary: Handler = default_page_boundary
    module_ready: Handler = default_module_ready
    refill: Handler = default_refill
    long_tail: Handler = default_long_tail
    node_slow: Handler = default_node_slow
    migrate: Handler = default_migrate
    node_failure: Handler = default_node_failure
    node_drain: Handler = default_node_drain
    recovery_choice: Optional[Callable] = None
    shed_choice: Optional[Callable] = None
    preempt_choice: Optional[Callable] = None

    def table(self) -> Dict[EventKind, Handler]:
        t = {EventKind.SYNC: self.sync,
             EventKind.SYNC_DRAIN: self.sync_drain,
             EventKind.SEQ_DONE: self.seq_done,
             EventKind.SEQ_PREEMPT: self.seq_preempt,
             EventKind.PAGE_BOUNDARY: self.page_boundary,
             EventKind.MODULE_READY: self.module_ready,
             EventKind.REFILL: self.refill,
             EventKind.LONG_TAIL: self.long_tail,
             EventKind.NODE_SLOW: self.node_slow,
             EventKind.MIGRATE: self.migrate,
             EventKind.NODE_FAILURE: self.node_failure,
             EventKind.NODE_DRAIN: self.node_drain}
        missing = set(EventKind) - set(t)
        assert not missing, f"EventKinds without a handler: {missing}"
        return t


class CoroutineScheduler:
    def __init__(self, engines: Sequence, config: SchedulerConfig = None,
                 policy: SchedulerPolicy = None,
                 fault_plan: Optional[FaultPlan] = None,
                 health: Optional[HealthMonitor] = None):
        self.engines = [validate_backend(e) for e in engines]
        self.cfg = config or SchedulerConfig()
        self.policy = policy or SchedulerPolicy()
        self._handlers = self.policy.table()
        self.queue = EventQueue()
        self.cos: Dict[int, SequenceCoroutine] = {}
        self._next_id = 0
        self.retired = 0            # DONE coroutines dropped via retire()
        self.drained_nodes: List[int] = []      # NODE_DRAIN scale-downs
        self.log: List[str] = []
        self.ticks = 0
        self._t0: Optional[float] = None
        self._outbox: List[RuntimeRecord] = []
        # ---- §5.6 robustness: fault plan + live health monitoring --------
        self.fault_plan = fault_plan
        if fault_plan is not None:
            for e in self.engines:
                if getattr(e, "faults", None) is None:
                    e.faults = fault_plan.node_view(e.node_id)
        # default monitor counts missed beats per scheduler round
        # (interval_s=None: per-node clocks — SimEngine vclocks, wall
        # time — are never compared against each other)
        self.health = health or HealthMonitor(0, interval_s=None,
                                              dead_after=3)
        self.health.on_failure = self._on_health_failure
        # every engine ever in rotation — failed nodes keep contributing
        # their transfer/fault counters to report()
        self._all_engines: List = list(self.engines)
        self.health_failovers = 0       # NODE_FAILUREs from missed beats
        self.dead_letter_failovers = 0  # NODE_FAILUREs from dead letters
        # ---- straggler mitigation: detect -> shed -> hedge ---------------
        self.progress = ProgressTracker(
            slow_fraction=self.cfg.slow_fraction,
            slow_rounds=self.cfg.slow_rounds,
            cooldown=self.cfg.slow_cooldown,
            recover_fraction=self.cfg.slow_recover_fraction,
            ewma_alpha=self.cfg.slow_ewma_alpha)
        self._slow_since: Dict[int, float] = {}   # node -> clock at flag
        self.hedged: Dict[int, int] = {}          # original -> live clone
        self.hedge_origin: Dict[int, int] = {}    # live clone -> original
        self.sheds = 0                  # NODE_SLOW sheds executed
        self.shed_moved = 0             # sequences moved off slow nodes
        self.hedges_launched = 0
        self.hedges_won = 0             # clone finished before original
        self.hedges_lost = 0            # original beat its clone
        self.hedges_resolved = 0        # clones retired (won or lost)
        # ---- memory-pressure governor ------------------------------------
        # seq_ids preempted for memory pressure (or mid-flight oom) that
        # have not re-admitted yet (their next COMBINE is a restore)
        self._preempted: set = set()
        self.gov_preempts = 0           # watermark + oom preemptions
        self.gov_restores = 0           # preempted seqs re-admitted
        self.gov_host_spill_bytes = 0   # KV bytes checkpointed by preempts
        if (self.cfg.high_watermark is not None
                or self.cfg.low_watermark is not None):
            for e in self.engines:
                alloc = getattr(e, "allocator", None)
                if alloc is None:
                    continue
                if self.cfg.high_watermark is not None:
                    alloc.high_watermark = self.cfg.high_watermark
                if self.cfg.low_watermark is not None:
                    alloc.low_watermark = self.cfg.low_watermark
                assert (0.0 < alloc.low_watermark
                        <= alloc.high_watermark <= 1.0), (
                    alloc.low_watermark, alloc.high_watermark)

    # ------------------------------------------------------------------ API
    def submit(self, prompts: Sequence[Sequence[int]],
               max_out: Sequence[int],
               sampling: Union[None, SamplingParams,
                               Sequence[SamplingParams]] = None,
               logprobs: Union[bool, Sequence[bool]] = False,
               top_logprobs: Union[int, Sequence[int]] = 0,
               n: int = 1) -> List[int]:
        """Distribute S_global evenly over nodes (Alg. 2 line 1).

        ``sampling``: None (greedy), one SamplingParams broadcast to every
        sequence, or one per sequence.  The params ride the coroutine, so
        every later COMBINE/MIGRATE/PARTITION keeps them with it.
        ``logprobs`` / ``top_logprobs`` (scalar or per-sequence) request
        the chosen-token logprob (and the top-K alternatives) for every
        generated token — computed on device inside the fused megastep and
        returned through the same single per-page transfer.

        ``n`` > 1 fans each prompt out into n forked siblings
        (``prim.fork``): the whole group lands on one node, the engine
        prefills the prompt ONCE and every sibling shares the prompt's KV
        span copy-on-write.  Per-sequence lists (``max_out``, ``sampling``,
        ...) may be given per prompt (broadcast over the group) or per
        sibling (length ``len(prompts) * n``).  With ``seed=None`` each
        sibling streams off its own seq_id (token-addressable
        seeding), so the fan-out is bitwise-identical to n independent
        submissions; an explicit group-level seed is split per sibling via
        ``derive_fork_seed`` so forks actually diverge."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        n_groups = len(prompts)
        total = n_groups * n
        group_sampling = True       # sampling given per prompt, not sibling
        if sampling is None or isinstance(sampling, SamplingParams):
            sps = [sampling or SamplingParams()] * total
        else:
            sps = list(sampling)
            if len(sps) == n_groups and n > 1:
                sps = [sp for sp in sps for _ in range(n)]
            else:
                group_sampling = n == 1
            if len(sps) != total:
                raise ValueError(
                    f"sampling list length {len(sps)} != {total} sequences")
        mos = list(max_out)
        if len(mos) == n_groups and n > 1:
            mos = [mo for mo in mos for _ in range(n)]
        if len(mos) != total:
            raise ValueError(
                f"max_out list length {len(mos)} != {total} sequences")
        lps = self._broadcast(logprobs, n_groups, n, "logprobs")
        tlps = self._broadcast(top_logprobs, n_groups, n, "top_logprobs")
        ids = []
        for g, p in enumerate(prompts):
            base = g * n
            lead = SequenceCoroutine(
                seq_id=self._next_id, prompt=list(p), max_out=int(mos[base]),
                sampling=sps[base],
                logprobs=bool(lps[base]) or int(tlps[base]) > 0,
                top_logprobs=int(tlps[base]))
            lead.node = self.engines[g % len(self.engines)].node_id
            if n > 1:
                lead.fork_group = lead.seq_id
            self.cos[lead.seq_id] = lead
            ids.append(lead.seq_id)
            self._next_id += 1
            for k in range(1, n):
                j = base + k
                sp = sps[j]
                if group_sampling and sp.seed is not None:
                    sp = dataclasses.replace(
                        sp, seed=derive_fork_seed(sp.seed, k))
                sib = prim.fork(lead, self._next_id, sampling=sp)
                sib.max_out = int(mos[j])
                sib.logprobs = bool(lps[j]) or int(tlps[j]) > 0
                sib.top_logprobs = int(tlps[j])
                self.cos[sib.seq_id] = sib
                ids.append(sib.seq_id)
                self._next_id += 1
                self.emit(PrimitiveEvent(sib.seq_id, lead.node,
                                         primitive="fork",
                                         detail=lead.seq_id))
        return ids

    @staticmethod
    def _broadcast(val, n_groups: int, n: int, name: str) -> List:
        total = n_groups * n
        if isinstance(val, (bool, int)):
            return [val] * total
        vals = list(val)
        if len(vals) == n_groups and n > 1:
            vals = [v for v in vals for _ in range(n)]
        if len(vals) != total:
            raise ValueError(f"{name} list length {len(vals)} != {total}")
        return vals

    def retire(self, seq_id: int) -> bool:
        """Drop one DONE coroutine from the pool.  A streaming job feeder
        that sends a scheduler hundreds of thousands of requests over its
        lifetime must not let ``cos`` (and every ``pending()`` scan over
        it) grow with the whole job — a finished sequence whose result has
        been consumed carries no further scheduling state.  Refuses (and
        returns False) for live sequences."""
        co = self.cos.get(seq_id)
        if co is None or not co.done:
            return False
        del self.cos[seq_id]
        # normally SEQ_DONE already dropped the host state (releasing any
        # shared-prefix span reference); this sweep guarantees the release
        # for teardown paths that skipped it
        for e in self._all_engines:
            store = getattr(e, "host_store", None)
            if store is not None and store.has(seq_id):
                store.drop(seq_id)
        self.retired += 1
        return True

    def pending(self, node: int, status: Status) -> List[SequenceCoroutine]:
        return [c for c in self.cos.values()
                if c.node == node and c.status == status and not c.done]

    def all_done(self) -> bool:
        return all(c.done for c in self.cos.values())

    def engine(self, node: int):
        for e in self.engines:
            if e.node_id == node:
                return e
        return None

    # ------------------------------------------------------- stream records
    def emit(self, rec: RuntimeRecord) -> None:
        """Handlers publish stream records here; ``events()`` yields them
        in emission order after each dispatched event."""
        self._outbox.append(rec)

    def emit_token_block(self, co: SequenceCoroutine, offset: int) -> None:
        """Emit the tokens (and logprobs) ``co`` gained since ``offset``."""
        if len(co.generated) <= offset:
            return
        lps = tops = None
        if co.logprobs:
            lps = [float(x) for x in co.token_logprobs[offset:]]
            if co.top_logprobs:
                tops = [list(row) for row in co.top_token_logprobs[offset:]]
        self.emit(TokenBlockEvent(co.seq_id, co.node,
                                  tokens=list(co.generated[offset:]),
                                  offset=offset, logprobs=lps,
                                  top_logprobs=tops))

    # ------------------------------------------------------------ event core
    def dispatch(self, ev: Event) -> List[RuntimeRecord]:
        """Run the policy handler for one event; returns records emitted."""
        handler = self._handlers.get(ev.kind)
        if handler is None:
            raise KeyError(f"no handler registered for {ev.kind!r}")
        handler(self, ev)
        out, self._outbox = self._outbox, []
        return out

    def _seed_round(self) -> None:
        """Enqueue one round of per-node work: a round-seeding REFILL per
        node (whose handler chains the node's MODULE_READY decode) and one
        MIGRATE rebalance check."""
        for e in list(self.engines):
            self.queue.push(EventKind.REFILL, e.node_id, payload=_TICK)
        if len(self.engines) > 1:
            self.queue.push(EventKind.MIGRATE)

    def _advance_faults(self) -> None:
        """Arm every engine's injected faults scheduled at this round —
        the event boundary the FaultPlan is keyed to."""
        for e in list(self.engines):
            f = getattr(e, "faults", None)
            if f is not None:
                f.advance(self.ticks)

    def _collect_heartbeats(self) -> None:
        """Once per round: every engine in rotation reports to the health
        monitor (§5.6).  A missing beat (dead/suppressed node) counts a
        miss; ``dead_after`` consecutive misses fire ``_on_health_failure``
        which enqueues NODE_FAILURE itself.  Collection never dispatches —
        the failure event rides the normal priority drain.

        The same beats feed the ``ProgressTracker``: a beat that still
        ARRIVES but shows lagging progress raises NODE_SLOW (shedding),
        never NODE_FAILURE — slow is not dead."""
        mitigate = self.cfg.mitigate_stragglers
        for e in list(self.engines):
            if e not in self._all_engines:
                self._all_engines.append(e)     # elastic scale-up
            self.health.ensure_node(e.node_id)
            if self.health.failed[e.node_id]:
                continue
            hb = e.heartbeat()
            if hb is None:
                self.health.miss(e.node_id)
            else:
                self.health.report(hb)
                if mitigate:
                    self.progress.observe(hb)
        if not mitigate:
            return
        for node in self.progress.evaluate(
                self.ticks, [e.node_id for e in self.engines]):
            self.log.append(f"slow_flag node={node} "
                            f"rate={self.progress.rate(node):.1f}")
            self.emit(HealthEvent(-1, node, reason="slow",
                                  detail=self.progress.rate(node)))
            self.queue.push(EventKind.NODE_SLOW, node, payload="progress")
        self._sweep_hedges()

    def _on_health_failure(self, node: int) -> None:
        """HealthMonitor callback: a node stopped heartbeating — escalate
        to the §5.6 NODE_FAILURE recovery path."""
        self.health_failovers += 1
        self.log.append(f"health_failure node={node}")
        self.emit(HealthEvent(-1, node, reason="heartbeat",
                              detail="missed heartbeats"))
        self.queue.push(EventKind.NODE_FAILURE, node, payload="health")

    # -------------------------------------------- memory-pressure governor
    def _preempt(self, co: SequenceCoroutine, eng, detail: str) -> None:
        """One governor preemption: YIELD (checkpoint → host store → free
        device pages), account the spilled bytes, and mark the sequence
        for low-watermark re-admission.  Callers drain the engine's
        append pipeline first."""
        b0 = eng.stats.bytes_moved["yield"]
        prim.yield_(co, eng)
        spilled = eng.stats.bytes_moved["yield"] - b0
        if spilled == 0:
            # SimEngine checkpoints metadata only — account the modeled
            # KV footprint instead
            spilled = int(getattr(eng, "kv_bytes_per_token", 0) * co.length)
        self.gov_preempts += 1
        self.gov_host_spill_bytes += spilled
        self._preempted.add(co.seq_id)
        self.log.append(f"yield({detail}) seq={co.seq_id} "
                        f"occ={eng.allocator.occupancy:.2f}")
        self.emit(PrimitiveEvent(co.seq_id, co.node, primitive="yield",
                                 detail=detail))

    # -------------------------------------------- deadlines + hedged tails
    def _check_deadlines(self, node: int) -> None:
        """Graceful degradation: mark sequences past their per-request
        ``deadline_s`` (wall clock since submit) as deadlined — their
        ``remaining`` collapses to 0 and the normal SEQ_DONE eviction
        finishes them with ``finish_reason="deadline"``.  A sequence that
        has not produced a single token yet is spared: the deadline
        truncates output, it never returns an empty success."""
        now = time.monotonic()
        for co in self.cos.values():
            if (co.node != node or co.done or co.deadlined or co.stopped
                    or not co.generated):
                continue
            dl = co.sampling.deadline_s
            if dl is not None and now - co.submitted_t >= dl:
                co.deadlined = True
                self.log.append(f"deadline seq={co.seq_id} "
                                f"n={len(co.generated)}")

    def _sweep_hedges(self) -> None:
        """Launch speculative clones for sequences stuck on a node that
        has stayed slow-flagged past ``hedge_deadline_s`` on its own
        clock.  The clone restarts from the prompt on a fast node with
        the original's token-addressable seed pinned, so both race toward
        the SAME token stream — whichever finishes first wins through
        ``_resolve_hedge`` and the loser is cancelled."""
        cfg = self.cfg
        for node in list(self._slow_since):
            eng = self.engine(node)
            if eng is None or not self.progress.is_flagged(node):
                self._slow_since.pop(node, None)    # recovered or gone
                continue
            if eng.clock() - self._slow_since[node] < cfg.hedge_deadline_s:
                continue
            fast = [e for e in self.engines if e.node_id != node
                    and not self.progress.is_flagged(e.node_id)]
            if not fast:
                continue

            def load(e):
                return sum(1 for c in self.cos.values()
                           if c.node == e.node_id and not c.done)

            for co in [c for c in self.cos.values()
                       if c.node == node and not c.done
                       and c.remaining > 0]:
                if (co.seq_id in self.hedged
                        or co.seq_id in self.hedge_origin):
                    continue        # already hedged / is itself a clone
                dst = max(fast, key=lambda e: self.progress.rate(e.node_id)
                          / (1.0 + load(e)))
                self._launch_hedge(co, dst)

    def _launch_hedge(self, co: SequenceCoroutine, dst) -> None:
        sp = co.sampling
        if sp.seed is None:
            # pin the clone to the original's token-addressable stream:
            # with seed=None each stream keys off its own seq_id, and the
            # clone has a different one
            sp = dataclasses.replace(sp, seed=sp.effective_seed(co.seq_id))
        clone = SequenceCoroutine(
            seq_id=self._next_id, prompt=list(co.prompt),
            max_out=co.max_out, sampling=sp, logprobs=co.logprobs,
            top_logprobs=co.top_logprobs, node=dst.node_id)
        self._next_id += 1
        self.cos[clone.seq_id] = clone
        self.hedge_origin[clone.seq_id] = co.seq_id
        self.hedged[co.seq_id] = clone.seq_id
        self.hedges_launched += 1
        self.log.append(f"hedge seq={co.seq_id} clone={clone.seq_id} "
                        f"-> node={dst.node_id}")
        self.emit(PrimitiveEvent(clone.seq_id, dst.node_id,
                                 primitive="hedge", detail=co.seq_id))

    def _resolve_hedge(self, co: SequenceCoroutine
                       ) -> Optional[SequenceCoroutine]:
        """Called for every finishing sequence: returns the coroutine
        whose SeqFinishedEvent should surface, or None to suppress.

        A finishing CLONE transplants its (bitwise-identical) result into
        the original — BatchMaster/ledger only know the original's seq_id,
        and the ledger's first-wins journal then dedupes exactly as for
        any other finish.  A finishing ORIGINAL cancels its live clone."""
        orig_id = self.hedge_origin.get(co.seq_id)
        if orig_id is not None:             # a clone crossed the line first
            self.hedged.pop(orig_id, None)
            orig = self.cos.get(orig_id)
            if orig is None or orig.done:
                # original already surfaced (or was cancelled upstream):
                # the clone's output is a duplicate — swallow it
                self._drop_hedge_clone(co)
                return None
            before = len(orig.generated)
            orig.generated = list(co.generated)
            orig.token_logprobs = list(co.token_logprobs)
            orig.top_token_logprobs = [list(r)
                                       for r in co.top_token_logprobs]
            orig.stopped = co.stopped
            orig.deadlined = co.deadlined
            self._release_residency(orig)
            orig.node = co.node
            orig.length = len(orig.prompt) + len(orig.generated)
            orig.finish()
            # the clone streamed under its own seq_id (ignored by batch
            # consumers); re-emit the original's missing tail so ITS
            # stream is complete before the finish record
            self.emit_token_block(orig, before)
            self.hedges_won += 1
            self.log.append(f"hedge win clone={co.seq_id} orig={orig_id}")
            self._drop_hedge_clone(co)
            return orig
        clone_id = self.hedged.pop(co.seq_id, None)
        if clone_id is not None:            # original beat its hedge
            clone = self.cos.get(clone_id)
            if clone is not None and not clone.done:
                self._cancel_clone(clone)
            self.hedges_lost += 1
        return co

    def _release_residency(self, co: SequenceCoroutine) -> None:
        """Free a losing racer's device slot, pages, and host checkpoint
        on its current node (tolerates a node that already left
        rotation)."""
        eng = self.engine(co.node)
        if eng is not None:
            if co.status == Status.ACTIVE:
                eng.drain_appends()
            eng.allocator.free_seq(co.seq_id)
            eng.free_slot(co)
            discard = getattr(eng, "discard_restore", None)
            if callable(discard):
                discard(co.seq_id)      # a staged h2d prefetch is now moot
            if eng.host_store.has(co.seq_id):
                eng.host_store.drop(co.seq_id)
        co.slot = None
        co.partition_group = None

    def _cancel_clone(self, clone: SequenceCoroutine) -> None:
        self._release_residency(clone)
        clone.stopped = True
        clone.status = Status.DONE
        self.log.append(f"hedge cancel clone={clone.seq_id}")
        self._drop_hedge_clone(clone)

    def _drop_hedge_clone(self, clone: SequenceCoroutine) -> None:
        """Retire a resolved clone immediately — clones never linger in
        the pool (and are excluded from report() counts via the
        ``hedges_resolved`` ledger)."""
        if not clone.done:
            clone.status = Status.DONE
        self.hedge_origin.pop(clone.seq_id, None)
        self.hedges_resolved += 1
        self.retire(clone.seq_id)

    def _escalate_dead_letters(self) -> Iterator[RuntimeRecord]:
        """A transfer exhausted its retry budget during the last dispatch:
        escalate the owning node to NODE_FAILURE IMMEDIATELY (inline
        dispatch, not a queue push) — a node with a corrupt slot or a lost
        KV blob must not decode another page, or a garbage sequence could
        hit a stop token and finish before a queued low-priority
        NODE_FAILURE gets dispatched."""
        for e in list(self.engines):
            if getattr(e, "dead_lettered", False):
                e.dead_lettered = False
                self.dead_letter_failovers += 1
                self.health.mark_failed(e.node_id)
                self.log.append(f"dead_letter node={e.node_id}")
                self.emit(HealthEvent(-1, e.node_id, reason="dead_letter",
                                      detail=dict(e.transfer_stats)))
                yield from self.dispatch(Event(kind=EventKind.NODE_FAILURE,
                                               node=e.node_id,
                                               payload="dead_letter"))

    def _drain_queue(self) -> Iterator[RuntimeRecord]:
        while self.queue:
            yield from self.dispatch(self.queue.pop())
            yield from self._escalate_dead_letters()

    def _step_events(self) -> Iterator[RuntimeRecord]:
        if self._t0 is None:
            self._t0 = min((e.clock() for e in self.engines), default=0.0)
        self._advance_faults()
        self._collect_heartbeats()
        # Externally-pushed events (NODE_FAILURE from a health monitor,
        # custom policy work) drain BEFORE this round's work is seeded —
        # a failed node must not be refilled/decoded one last time just
        # because NODE_FAILURE's dispatch priority trails the others.
        yield from self._drain_queue()
        self._seed_round()
        yield from self._drain_queue()
        self.ticks += 1

    def step(self) -> List[RuntimeRecord]:
        """One scheduler round: seed per-node work, then drain the event
        queue in priority order.  Returns the records emitted."""
        return list(self._step_events())

    def events(self, max_ticks: int = 100000) -> Iterator[RuntimeRecord]:
        """Core generator: run rounds until batch completion (or the tick
        budget), yielding typed records as handlers emit them."""
        start = self.ticks
        while not self.all_done() and self.ticks - start < max_ticks:
            yield from self._step_events()
        if not self.all_done():
            done = sum(c.done for c in self.cos.values())
            logger.warning(
                "scheduler exhausted max_ticks=%d with %d/%d sequences "
                "unfinished — results are truncated", max_ticks,
                len(self.cos) - done, len(self.cos))

    def stream(self, max_ticks: int = 100000,
               kinds: Union[None, Type[RuntimeRecord],
                            Tuple[Type[RuntimeRecord], ...]] = None
               ) -> Iterator[RuntimeRecord]:
        """Stream-first result surface: yields ``TokenBlockEvent`` /
        ``SeqFinishedEvent`` / ``PrimitiveEvent`` records as pages
        complete.  ``kinds`` filters to the given record type(s).  New
        sequences may be submitted while the stream is live; the next
        round's REFILL picks them up."""
        for rec in self.events(max_ticks):
            if kinds is None or isinstance(rec, kinds):
                yield rec

    # ------------------------------------------------------------- main loop
    def run(self, max_ticks: int = 100000) -> Dict:
        """Run until batch completion; returns BCT stats.  Thin wrapper
        over ``events()`` — identical token output to consuming
        ``stream()`` yourself."""
        self._t0 = None                  # fresh BCT window per run() call
        for _ in self.events(max_ticks):
            pass
        return self.report()

    def _node_tick(self, node: int, eng=None) -> List[RuntimeRecord]:
        """Compat shim (tests/tools): one node's full
        refill -> decode -> page-boundary cycle through the event queue."""
        self.queue.push(EventKind.REFILL, node, payload=_TICK)
        return list(self._drain_queue())

    # ------------------------------------------------------------- reporting
    def report(self) -> Dict:
        """Current batch report.  ``status`` is derived from live state —
        "completed" only when every sequence is done, "exhausted" for any
        truncation (max_ticks hit OR an abandoned stream), so a normal-
        looking report can't hide unfinished sequences."""
        t1 = max((e.clock() for e in self.engines), default=0.0)
        t0 = self._t0 if self._t0 is not None else t1
        # hedge clones are speculative duplicates, not workload: exclude
        # live ones from the pool counts and retired ones from `retired`
        clones = set(self.hedge_origin)
        scts = [c.sct() for i, c in self.cos.items()
                if c.sct() is not None and i not in clones]
        stats = {}
        for i, e in enumerate(self.engines):
            stats[f"node{i}"] = {"counts": dict(e.stats.counts),
                                 "bytes": dict(e.stats.bytes_moved)}
        xfer = {"retries": 0, "timeouts": 0, "dead_letters": 0}
        for e in self._all_engines:
            for k in xfer:
                xfer[k] += getattr(e, "transfer_stats", {}).get(k, 0)
        prefix = {"hits": 0, "hit_tokens": 0, "inserted_pages": 0,
                  "evicted_pages": 0, "cow_copies": 0, "live_refs": 0,
                  "prefill_tokens_saved": 0}
        for e in self._all_engines:
            store = getattr(e, "host_store", None)
            if store is not None:
                prefix["cow_copies"] += getattr(store, "cow_copies", 0)
                idx = getattr(store, "prefix_index", None)
                if idx is not None:
                    for k in ("hits", "hit_tokens", "inserted_pages",
                              "evicted_pages"):
                        prefix[k] += idx.stats[k]
                    prefix["live_refs"] += idx.live_refs()
            prefix["prefill_tokens_saved"] += getattr(
                e, "prefill_tokens_saved", 0)
        governor = {
            "preempts": self.gov_preempts,
            "restores": self.gov_restores,
            "host_spill_bytes": self.gov_host_spill_bytes,
            "restore_stages": 0,
            "restore_stalls": 0,
            "restore_wait_s": 0.0,
            "restore_stage_hidden_s": 0.0,
            "budget_evictions": 0,
        }
        for e in self._all_engines:
            governor["restore_stages"] += getattr(e, "restore_stages", 0)
            governor["restore_stalls"] += getattr(e, "restore_stalls", 0)
            governor["restore_wait_s"] += getattr(e, "restore_wait_s", 0.0)
            governor["restore_stage_hidden_s"] += getattr(
                e, "restore_stage_hidden_s", 0.0)
            store = getattr(e, "host_store", None)
            if store is not None:
                governor["budget_evictions"] += getattr(
                    store, "budget_evictions", 0)
        robustness = {
            "health_failovers": self.health_failovers,
            "dead_letter_failovers": self.dead_letter_failovers,
            "failed_nodes": sorted(n for n, f in self.health.failed.items()
                                   if f),
            "drained_nodes": list(self.drained_nodes),
            "transfer": xfer,
            "slow_flags": self.progress.flags_raised,
            "slow_recoveries": self.progress.flags_cleared,
            "sheds": self.sheds,
            "shed_migrations": self.shed_moved,
            "hedges": {"launched": self.hedges_launched,
                       "won": self.hedges_won,
                       "lost": self.hedges_lost},
            "governor": governor,
        }
        return {
            "bct_s": t1 - t0,
            "ticks": self.ticks,
            "status": "completed" if self.all_done() else "exhausted",
            "completed": (sum(c.done for i, c in self.cos.items()
                              if i not in clones)
                          + self.retired - self.hedges_resolved),
            "total": (len(self.cos) - len(clones)
                      + self.retired - self.hedges_resolved),
            "mean_sct_s": sum(scts) / len(scts) if scts else 0.0,
            "primitives": stats,
            "prefix": prefix,
            "robustness": robustness,
            "log_tail": self.log[-20:],
        }
