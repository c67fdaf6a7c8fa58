"""Streaming job driver: bounded-window jsonl → elastic replicas →
segment-rotated ledger → input-order merged output.

The loop each round:

1. **fill** — pull from the input file only up to
   ``window - resident`` (resident = undispatched buffer + in-flight on
   every replica), so parsed requests in memory never exceed the bound;
2. **dispatch** — hand each non-draining replica up to its
   oversubscribed capacity;
3. **pump** — one scheduler round per replica; every finished row is
   journaled into the ``SegmentedJobLedger`` the moment it appears
   (write-ahead: a crash after the fsync costs nothing, a crash before
   it costs one re-decode);
4. **health** — a replica whose scheduler dead-lettered a node (or lost
   all engines) is drained automatically: its unfinished requests go
   back to the window and another replica recomputes them.  The
   first-wins ledger makes the drain/finish race benign — if the dying
   replica did finish a request, the recompute's duplicate row is
   refused, not double-written.

Straggler awareness (driver tier): the loop keeps a per-replica EWMA of
completion throughput on each replica's own timeline.  Dispatch is
rate-ordered (fast replicas admit first) and a replica below the fleet
median gets its admissions capped proportionally to its rate; one that
stays below ``slow_replica_fraction`` x median for
``slow_replica_rounds`` consecutive rounds is auto-drained with requeue
— the driver-level mirror of the scheduler's NODE_SLOW shedding.

``run()`` is crash-resumable end to end: on restart the ledger replays
only its index + tail segment, the source skips finished ids, and the
final merged output (input order, atomic rename) is byte-identical to
an uninterrupted run — SimEngine/NodeEngine decode is a pure function
of the request, never of which replica or scheduler slot ran it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import collections

from repro_torch.core.events import SeqFinishedEvent, TokenBlockEvent
from repro_torch.driver.replica import ReplicaHandle
from repro_torch.driver.source import JsonlRequestSource, iter_custom_ids
from repro_torch.runtime.api import BatchRequest
from repro_torch.runtime.ledger import SegmentedJobLedger


@dataclasses.dataclass
class DriverConfig:
    window: int = 4096          # max parsed requests resident (buffer+flight)
    replicas: int = 1           # initial replica count
    oversubscribe: float = 4.0  # dispatch depth per replica (§6.4)
    max_rounds: int = 10_000_000
    rotate_records: int = 50_000
    rotate_bytes: int = 64 << 20
    fsync_every: int = 64
    timeline_every: int = 1     # sample (now, completed) every N rounds
    # ---- replica-tier straggler mitigation -------------------------------
    rebalance: bool = True          # rate-aware dispatch + slow auto-drain
    rebalance_alpha: float = 0.3    # per-replica throughput EWMA smoothing
    slow_replica_fraction: float = 0.5   # slow when below this x median
    slow_replica_rounds: int = 25   # consecutive rounds before auto-drain


@dataclasses.dataclass
class DriverResult:
    status: str                 # "completed" | "exhausted"
    completed: int              # rows journaled by THIS run
    skipped_resume: int         # input lines already in the ledger
    requeued: int               # requests recycled through drains
    auto_drained: int           # replicas retired by the health trigger
    slow_drained: int           # replicas retired by the throughput trigger
    scale_ups: int
    peak_resident: int          # max parsed requests alive at once
    rounds: int
    makespan_s: float           # driver-timeline makespan (virtual)
    merged_path: str
    merged_records: int
    report: Dict[str, Any]


class StreamingJobDriver:
    """See module docstring.  ``engine_factory(rid)`` must return a fresh
    engine group per call — replicas never share engines."""

    def __init__(self, input_path: str, output_path: str, ledger_root: str,
                 engine_factory: Callable[[int], Sequence], *,
                 cfg: Optional[DriverConfig] = None, sched_cfg=None,
                 policy=None,
                 fault_plan_factory: Optional[Callable[[int], Any]] = None):
        self.input_path = input_path
        self.output_path = output_path
        self.cfg = cfg or DriverConfig()
        self._engine_factory = engine_factory
        self._sched_cfg = sched_cfg
        self._policy = policy
        self._fault_plan_factory = fault_plan_factory or (lambda rid: None)
        self.ledger = SegmentedJobLedger(
            ledger_root, rotate_records=self.cfg.rotate_records,
            rotate_bytes=self.cfg.rotate_bytes,
            fsync_every=self.cfg.fsync_every)
        self.source = JsonlRequestSource(input_path, skip=self.ledger.has)
        self.replicas: List[ReplicaHandle] = []
        self._window: Deque[BatchRequest] = collections.deque()
        self._next_rid = 0
        self.completed = 0
        self.partials_journaled = 0
        self.requeued = 0
        self.auto_drained = 0
        self.slow_drained = 0
        self.scale_ups = 0
        self.budget_throttled = 0   # dispatch rounds skipped: host budget
        # per-replica throughput EWMA (completions / replica-second on the
        # replica's own timeline) — the driver-tier straggler detector
        self._rep_rate: Dict[int, float] = {}
        self._rep_last: Dict[int, tuple] = {}   # rid -> (completed, now)
        self._rep_slow: Dict[int, int] = {}     # rid -> consecutive rounds
        self.peak_resident = 0
        self.rounds = 0
        self.timeline: List[Dict[str, float]] = []
        self.log: List[str] = []

    # ------------------------------------------------------------ elasticity
    def _spawn(self, join_offset: float = 0.0) -> ReplicaHandle:
        rid = self._next_rid
        self._next_rid += 1
        r = ReplicaHandle.spawn(
            rid, self._engine_factory(rid), sched_cfg=self._sched_cfg,
            oversubscribe=self.cfg.oversubscribe, policy=self._policy,
            fault_plan=self._fault_plan_factory(rid),
            join_offset=join_offset)
        self.replicas.append(r)
        self.log.append(f"spawn replica={rid} at t={join_offset:.3f}")
        return r

    def scale_up(self) -> int:
        """Add one replica mid-job, joined at the current driver time; it
        starts admitting on the next dispatch."""
        r = self._spawn(join_offset=self.sim_now())
        self.scale_ups += 1
        return r.rid

    def drain(self, rid: int, *, requeue: bool = True) -> int:
        """Retire a replica.  ``requeue=True`` (default): cancel now and
        recycle every unfinished request through the window — another
        replica recomputes it (MIGRATE across replicas is impossible;
        first-wins journaling makes the recompute race benign).
        ``requeue=False``: stop admissions and let in-flight finish
        (graceful scale-down; closed by the run loop when empty).
        Returns the number of requests requeued."""
        r = self._replica(rid)
        if r is None or r.closed:
            return 0
        if not requeue:
            r.draining = True
            self.log.append(f"drain replica={rid} graceful")
            return 0
        left = r.cancel()
        self._window.extendleft(reversed(left))
        self.requeued += len(left)
        self.log.append(f"drain replica={rid} requeued={len(left)}")
        return len(left)

    def _replica(self, rid: int) -> Optional[ReplicaHandle]:
        for r in self.replicas:
            if r.rid == rid:
                return r
        return None

    def _open_replicas(self) -> List[ReplicaHandle]:
        return [r for r in self.replicas if not r.closed]

    # -------------------------------------------------------------- run loop
    def resident(self) -> int:
        return len(self._window) + sum(r.in_flight()
                                       for r in self._open_replicas())

    def sim_now(self) -> float:
        return max((r.now() for r in self.replicas), default=0.0)

    def _fill(self) -> None:
        budget = self.cfg.window - self.resident()
        if budget > 0 and not self.source.exhausted:
            self._window.extend(self.source.take(budget))

    def _update_rates(self) -> None:
        """Refresh each replica's throughput EWMA from this round's
        (completed, now) delta on ITS OWN timeline.  An idle replica
        (nothing in flight) contributes no evidence — idle is not slow."""
        for r in self._open_replicas():
            now = r.now()
            prev = self._rep_last.get(r.rid)
            self._rep_last[r.rid] = (r.completed, now)
            if prev is None:
                continue
            dc, dt = r.completed - prev[0], now - prev[1]
            if dt <= 0 or (dc == 0 and r.in_flight() == 0):
                continue
            rate = dc / dt
            old = self._rep_rate.get(r.rid)
            a = self.cfg.rebalance_alpha
            self._rep_rate[r.rid] = rate if old is None else (
                a * rate + (1.0 - a) * old)

    def _rate_median(self) -> Optional[float]:
        rates = sorted(self._rep_rate[r.rid] for r in self._open_replicas()
                       if r.rid in self._rep_rate)
        if len(rates) < 2:
            return None     # one replica has no peers to lag
        mid = len(rates) // 2
        return (rates[mid] if len(rates) % 2
                else 0.5 * (rates[mid - 1] + rates[mid]))

    def _dispatch(self) -> None:
        """Rate-ordered admission: fast replicas pull from the window
        first, and a below-median replica's admissions are capped
        proportionally to its rate — new work flows away from stragglers
        without starving them entirely."""
        reps = self._open_replicas()
        med = self._rate_median() if self.cfg.rebalance else None
        if med is not None:
            # unknown-rate replicas (just spawned) sort as fast: they get
            # a full share until they produce evidence
            reps = sorted(reps, key=lambda r: -self._rep_rate.get(
                r.rid, float("inf")))
        for r in reps:
            if not self._window:
                break
            if r.host_over_budget():
                # the replica's host-spill budget is exhausted and the
                # prefix-LRU cascade could not clear it: stop admitting
                # here until decode drains the store — throttle, not die
                self.budget_throttled += 1
                continue
            n = min(r.headroom(), len(self._window))
            if med is not None and med > 0 and n > 0:
                rate = self._rep_rate.get(r.rid)
                if rate is not None and rate < med:
                    n = max(1, int(n * rate / med))
            if n > 0:
                r.admit([self._window.popleft() for _ in range(n)])

    def _pump_all(self) -> int:
        done = 0
        for r in self._open_replicas():
            if r.in_flight() == 0:
                if r.draining:
                    r.close()
                    self.log.append(f"drained replica={r.rid} empty")
                continue
            for rec in r.pump():
                if isinstance(rec, TokenBlockEvent) \
                        and rec.custom_id is not None:
                    # flush the partial block to the journal the moment
                    # the page lands — a tailing consumer streams tokens
                    # while the row is in flight; a recompute's replayed
                    # prefix is refused by offset, not double-written
                    if self.ledger.record_partial(rec.custom_id,
                                                  rec.offset, rec.tokens):
                        self.partials_journaled += 1
                elif isinstance(rec, SeqFinishedEvent):
                    row = r.pop_row(rec.seq_id)
                    if row is not None and self.ledger.record_output(
                            row["custom_id"], row):
                        self.completed += 1
                        done += 1
        return done

    def _health_sweep(self) -> None:
        for r in self._open_replicas():
            if not r.healthy():
                self.auto_drained += 1
                self.log.append(f"auto-drain replica={r.rid} (unhealthy)")
                self.drain(r.rid, requeue=True)
        if not self.cfg.rebalance:
            return
        med = self._rate_median()
        if med is None or med <= 0:
            return
        for r in self._open_replicas():
            rate = self._rep_rate.get(r.rid)
            if rate is None or r.draining:
                continue
            if rate < self.cfg.slow_replica_fraction * med:
                self._rep_slow[r.rid] = self._rep_slow.get(r.rid, 0) + 1
                if (self._rep_slow[r.rid] >= self.cfg.slow_replica_rounds
                        and len(self._open_replicas()) > 1):
                    self.slow_drained += 1
                    self._rep_slow.pop(r.rid, None)
                    self._rep_rate.pop(r.rid, None)
                    self.log.append(f"auto-drain replica={r.rid} (slow: "
                                    f"{rate:.1f} vs median {med:.1f})")
                    self.drain(r.rid, requeue=True)
            else:
                self._rep_slow[r.rid] = 0

    def run(self, on_round: Optional[Callable[["StreamingJobDriver", int],
                                              None]] = None) -> DriverResult:
        """Drive the job to completion.  ``on_round(driver, round)`` runs
        after each round — the hook tests and benchmarks use to trigger a
        mid-job ``scale_up()``/``drain()`` or to kill the process."""
        self.ledger.open()
        self.source.open()
        while len(self._open_replicas()) < self.cfg.replicas:
            self._spawn(join_offset=self.sim_now())
        status = "exhausted"
        while self.rounds < self.cfg.max_rounds:
            self.rounds += 1
            self._fill()
            self.peak_resident = max(self.peak_resident, self.resident())
            if not self._open_replicas() and (self._window
                                              or not self.source.exhausted):
                # every replica died/drained with work left: respawn one
                self.log.append("respawn: no open replicas, work remains")
                self.scale_up()
            if self.cfg.rebalance:
                self._update_rates()
            self._dispatch()
            self._pump_all()
            self._health_sweep()
            if self.cfg.timeline_every > 0 \
                    and self.rounds % self.cfg.timeline_every == 0:
                self.timeline.append({"round": self.rounds,
                                      "t": self.sim_now(),
                                      "completed": self.completed,
                                      "replicas":
                                          len(self._open_replicas())})
            if on_round is not None:
                on_round(self, self.rounds)
            if self.source.exhausted and not self._window \
                    and all(r.in_flight() == 0 for r in self._open_replicas()):
                status = "completed"
                break
        for r in self._open_replicas():
            r.close()
        merged = self._write_merged()
        rep = self.report()
        self.ledger.close()
        self.source.close()
        return DriverResult(
            status=status, completed=self.completed,
            skipped_resume=self.source.skipped, requeued=self.requeued,
            auto_drained=self.auto_drained, slow_drained=self.slow_drained,
            scale_ups=self.scale_ups,
            peak_resident=self.peak_resident, rounds=self.rounds,
            makespan_s=self.sim_now(), merged_path=self.output_path,
            merged_records=merged, report=rep)

    # ---------------------------------------------------------------- output
    def _write_merged(self) -> int:
        """Input-order merged jsonl, atomic via tmp + rename.  Row bytes
        come straight from the ledger segments (locator pread), so two
        runs that journaled the same rows — e.g. a clean run and a
        SIGKILL+resume run — produce byte-identical files."""
        tmp = self.output_path + ".tmp"
        with open(tmp, "w", encoding="utf-8", newline="\n") as fh:
            n = self.ledger.write_merged(iter_custom_ids(self.input_path),
                                         fh)
        os.replace(tmp, self.output_path)
        return n

    # ---------------------------------------------------------------- report
    def report(self) -> Dict[str, Any]:
        """Driver-level view: per-replica scheduler reports plus merged
        robustness/transfer counters (sums across replicas, node lists
        keyed by replica so ids never alias)."""
        per = {r.rid: r.report() for r in self.replicas}
        rob = {"health_failovers": 0, "dead_letter_failovers": 0,
               "failed_nodes": {}, "drained_nodes": {},
               "transfer": {"retries": 0, "timeouts": 0, "dead_letters": 0},
               "slow_flags": 0, "sheds": 0, "shed_migrations": 0,
               "hedges_launched": 0, "hedges_won": 0,
               "governor": {"preempts": 0, "restores": 0,
                            "host_spill_bytes": 0, "restore_stages": 0,
                            "restore_stalls": 0, "restore_wait_s": 0.0,
                            "restore_stage_hidden_s": 0.0,
                            "budget_evictions": 0}}
        for rid, rep in per.items():
            rb = rep.get("robustness", {})
            gv = rb.get("governor", {})
            for k in rob["governor"]:
                rob["governor"][k] += gv.get(k, 0)
            rob["health_failovers"] += rb.get("health_failovers", 0)
            rob["dead_letter_failovers"] += rb.get("dead_letter_failovers", 0)
            rob["slow_flags"] += rb.get("slow_flags", 0)
            rob["sheds"] += rb.get("sheds", 0)
            rob["shed_migrations"] += rb.get("shed_migrations", 0)
            rob["hedges_launched"] += rb.get("hedges", {}).get("launched", 0)
            rob["hedges_won"] += rb.get("hedges", {}).get("won", 0)
            if rb.get("failed_nodes"):
                rob["failed_nodes"][rid] = rb["failed_nodes"]
            if rb.get("drained_nodes"):
                rob["drained_nodes"][rid] = rb["drained_nodes"]
            for k in rob["transfer"]:
                rob["transfer"][k] += rb.get("transfer", {}).get(k, 0)
        return {
            "completed": self.completed,
            "skipped_resume": self.source.skipped,
            "requeued": self.requeued,
            "auto_drained": self.auto_drained,
            "slow_drained": self.slow_drained,
            "budget_throttled": self.budget_throttled,
            "replica_rates": {rid: round(v, 3)
                              for rid, v in self._rep_rate.items()},
            "scale_ups": self.scale_ups,
            "peak_resident": self.peak_resident,
            "window": self.cfg.window,
            "rounds": self.rounds,
            "makespan_s": self.sim_now(),
            "replicas": {rid: {"completed": r.completed,
                               "admitted": r.admitted,
                               "closed": r.closed}
                         for rid, r in ((x.rid, x) for x in self.replicas)},
            "robustness": rob,
            "ledger": {"finished": len(self.ledger),
                       "sealed_segments": self.ledger.sealed_segments,
                       "live_segment": self.ledger.live_segment,
                       "replayed_segments": self.ledger.replayed_segments,
                       "torn_records": self.ledger.torn_records,
                       "duplicates_refused": self.ledger.duplicates_refused,
                       "partials_journaled": self.partials_journaled,
                       "partial_duplicates_refused":
                           self.ledger.partial_duplicates_refused,
                       "partial_gaps": self.ledger.partial_gaps},
            "scheduler_reports": per,
            "log_tail": self.log[-20:],
        }
