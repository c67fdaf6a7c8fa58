"""Health monitoring + failure recovery policy (paper §5.6).

Per-node heartbeats carry every device's status; a node missing
``dead_after`` consecutive heartbeats is declared failed and its sequences
are recovered by the migrate-vs-recompute cost model (``recovery_choice``,
wired into the scheduler's NODE_FAILURE handler as a policy hook).

The monitor supports two detection modes, used together or alone:

* **missed-beat counting** (always on): the scheduler collects heartbeats
  once per round via ``ExecutionBackend.heartbeat``; an engine that fails
  to produce one accrues a miss, and ``dead_after`` *consecutive* misses
  declare the node dead.  This is clock-free, so it works across
  SimEngine's per-node virtual clocks (which are NOT comparable to each
  other) exactly as well as on real nodes.
* **wall-clock staleness** (``interval_s`` not None): a healthy report
  also arms a timestamp; any node whose last-ok timestamp lags the
  reporting clock by more than ``dead_after * interval_s`` is declared
  dead.  ``last_ok`` is seeded lazily at the *first observation* of each
  node — seeding to 0.0 would declare every other node dead on the first
  real wall-clock report (time.time() >> 0).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from repro_torch.core import plan as plan_lib
from repro_torch.models.api import ModelConfig


@dataclasses.dataclass
class DeviceStatus:
    device_id: int
    healthy: bool = True
    hbm_used: float = 0.0
    temperature_c: float = 55.0


@dataclasses.dataclass
class Heartbeat:
    """One node's per-round liveness + progress beat.

    ``decode_steps`` / ``tokens`` are CUMULATIVE counters (decode steps
    run, tokens emitted since the engine was built) — the
    ``ProgressTracker`` differences consecutive beats against the
    node-local clock ``t`` to get a throughput, so the beat itself stays
    stateless and a lost beat only widens one delta window."""
    node: int
    t: float
    devices: List[DeviceStatus]
    decode_steps: int = 0           # cumulative decode steps completed
    tokens: float = 0.0             # cumulative effective tokens emitted

    @property
    def healthy(self) -> bool:
        return all(d.healthy for d in self.devices)


class HealthMonitor:
    """Declares nodes dead from missed/unhealthy heartbeats.

    ``interval_s=None`` disables the wall-clock staleness check and
    leaves only consecutive-miss counting (the scheduler's default: its
    rounds are the clock)."""

    def __init__(self, nodes: int, *, interval_s: Optional[float] = 5.0,
                 dead_after: int = 3):
        self.interval = interval_s
        self.dead_after = dead_after
        # None = never observed; seeded at first report so a live wall
        # clock can't compare against an epoch-zero default.
        self.last_ok: Dict[int, Optional[float]] = {
            n: None for n in range(nodes)}
        self.missed: Dict[int, int] = {n: 0 for n in range(nodes)}
        self.failed: Dict[int, bool] = {n: False for n in range(nodes)}
        self.on_failure: Optional[Callable[[int], None]] = None

    def ensure_node(self, node: int) -> None:
        """Start tracking a node added after construction (elastic
        scale-up)."""
        if node not in self.failed:
            self.last_ok[node] = None
            self.missed[node] = 0
            self.failed[node] = False

    def report(self, hb: Heartbeat):
        """One heartbeat arrived.  Healthy beats clear the miss counter;
        unhealthy beats (a sick device) count as misses."""
        self.ensure_node(hb.node)
        if self.failed[hb.node]:
            return
        if hb.healthy:
            if self.last_ok[hb.node] is None:
                # first observation: also seed every never-seen peer so
                # relative staleness is measured from a common origin,
                # not from 0.0
                for n, t0 in self.last_ok.items():
                    if t0 is None:
                        self.last_ok[n] = hb.t
            self.last_ok[hb.node] = hb.t
            self.missed[hb.node] = 0
        else:
            self._miss(hb.node)
        self._check(hb.t)

    def miss(self, node: int, now: Optional[float] = None) -> None:
        """No heartbeat arrived for ``node`` this round (the scheduler's
        per-round collection calls this when an engine returns None)."""
        self.ensure_node(node)
        if self.failed[node]:
            return
        self._miss(node)
        if now is not None:
            self._check(now)

    def _miss(self, node: int) -> None:
        self.missed[node] += 1
        if self.missed[node] >= self.dead_after:
            self._declare_failed(node)

    def _check(self, now: float):
        if self.interval is None:
            return
        for n, t_ok in self.last_ok.items():
            if self.failed[n] or t_ok is None:
                continue
            if now - t_ok > self.dead_after * self.interval:
                self._declare_failed(n)

    def _declare_failed(self, node: int) -> None:
        if self.failed.get(node):
            return
        self.failed[node] = True
        if self.on_failure is not None:
            self.on_failure(node)

    def mark_failed(self, node: int) -> None:
        """Administrative failure (dead-letter escalation, operator
        action): mark dead WITHOUT firing on_failure — the caller owns
        the NODE_FAILURE event."""
        self.ensure_node(node)
        self.failed[node] = True

    def alive(self) -> List[int]:
        return [n for n, f in self.failed.items() if not f]


class ProgressTracker:
    """Per-node EWMA throughput from heartbeat progress deltas — the
    detection half of straggler mitigation (the paper's "mitigate
    stragglers / reallocate work across devices" claim, §4).

    Each round the scheduler feeds it every heartbeat (``observe``) and
    then asks for verdicts (``evaluate``).  A node's rate is
    ``Δtokens / Δt`` on its OWN clock — rates are comparable across nodes
    of one engine family even though absolute clocks are not (SimEngine
    vclocks share the §5.4 performance model; NodeEngine deltas share the
    wall).  A node whose EWMA stays below ``slow_fraction`` x the fleet
    median for ``slow_rounds`` consecutive evaluations is flagged slow
    exactly once; hysteresis (``recover_fraction`` > ``slow_fraction``)
    unflags a recovered node, and a post-shed cooldown keeps a
    just-shedded node from being re-flagged while its EWMA is still
    polluted by the slow window.  Idle rounds (no new tokens) neither
    build nor reset a slow streak — idle is not slow."""

    def __init__(self, *, slow_fraction: float = 0.5, slow_rounds: int = 3,
                 cooldown: int = 10, recover_fraction: float = 0.8,
                 ewma_alpha: float = 0.5):
        self.slow_fraction = slow_fraction
        self.slow_rounds = slow_rounds
        self.cooldown = cooldown
        self.recover_fraction = recover_fraction
        self.alpha = ewma_alpha
        self.ewma: Dict[int, float] = {}
        self.flagged: Dict[int, bool] = {}
        self.flags_raised = 0
        self.flags_cleared = 0
        self._last: Dict[int, tuple] = {}       # node -> (t, tokens)
        self._streak: Dict[int, int] = {}
        self._cool_until: Dict[int, int] = {}
        self._fresh: Dict[int, float] = {}      # this round's rates

    def observe(self, hb: Heartbeat) -> None:
        """Feed one heartbeat (once per node per round)."""
        prev = self._last.get(hb.node)
        self._last[hb.node] = (hb.t, hb.tokens)
        if prev is None:
            return
        dt = hb.t - prev[0]
        dtok = hb.tokens - prev[1]
        if dtok <= 0 or dt <= 0:
            return                  # idle (or clock glitch): no evidence
        rate = dtok / dt
        old = self.ewma.get(hb.node)
        self.ewma[hb.node] = rate if old is None else (
            self.alpha * rate + (1.0 - self.alpha) * old)
        self._fresh[hb.node] = self.ewma[hb.node]

    def median_rate(self) -> Optional[float]:
        rates = sorted(self.ewma.values())
        if len(rates) < 2:
            return None             # a fleet of one has no peers to lag
        n = len(rates)
        mid = n // 2
        return rates[mid] if n % 2 else 0.5 * (rates[mid - 1] + rates[mid])

    def evaluate(self, round_no: int, nodes) -> List[int]:
        """End-of-collection verdicts; returns nodes NEWLY flagged slow.
        ``nodes`` is the live rotation — departed nodes are forgotten so
        a dead straggler can't skew the median forever."""
        alive = set(nodes)
        for d in (self.ewma, self._last, self._streak, self.flagged,
                  self._cool_until):
            for n in [k for k in d if k not in alive]:
                del d[n]
        med = self.median_rate()
        fresh, self._fresh = self._fresh, {}
        if med is None or med <= 0:
            return []
        newly: List[int] = []
        for node, rate in fresh.items():
            if self.flagged.get(node):
                if rate >= self.recover_fraction * med:
                    self.flagged[node] = False
                    self.flags_cleared += 1
                    self._streak[node] = 0
                continue
            if round_no < self._cool_until.get(node, -1):
                continue
            if rate < self.slow_fraction * med:
                self._streak[node] = self._streak.get(node, 0) + 1
                if self._streak[node] >= self.slow_rounds:
                    self.flagged[node] = True
                    self.flags_raised += 1
                    self._streak[node] = 0
                    newly.append(node)
            else:
                self._streak[node] = 0
        return newly

    def is_flagged(self, node: int) -> bool:
        return bool(self.flagged.get(node))

    def start_cooldown(self, node: int, round_no: int) -> None:
        """Arm the post-shed re-flag holdoff for ``node``."""
        self._cool_until[node] = round_no + self.cooldown

    def deficit(self, node: int) -> float:
        """How far below the fleet median this node runs, in [0, 1] —
        the shed fraction is proportional to it."""
        med = self.median_rate()
        rate = self.ewma.get(node)
        if med is None or med <= 0 or rate is None:
            return 0.0
        return min(max(1.0 - rate / med, 0.0), 1.0)

    def rate(self, node: int) -> float:
        return self.ewma.get(node, 0.0)


def kv_bytes_per_token(cfg: ModelConfig) -> float:
    """Host KV bytes one token occupies (a copy of the cluster
    simulator's bf16 estimate)."""
    if cfg.use_mla:
        return 2.0 * (cfg.kv_lora_rank + cfg.rope_head_dim) * cfg.num_layers
    return 2.0 * 2 * cfg.num_kv_heads * cfg.head_dim * cfg.num_layers


def recovery_choice(cfg: ModelConfig, hw: plan_lib.Hardware, *,
                    kv_len: int, prompt_len: int,
                    inter_node_bw: float = 25e9) -> str:
    """migrate vs recompute: transfer time of the KV snapshot vs re-prefill
    time (paper: 'migrating hundreds of gigabytes may be slower than
    regenerating')."""
    t_migrate = kv_len * kv_bytes_per_token(cfg) / inter_node_bw
    plan = plan_lib.Plan(1, 1, False, False, 0, 0.0)
    t_recompute = plan_lib.step_time(cfg, hw, plan, 1, kv_len,
                                     max(kv_len, prompt_len))
    return "migrate" if t_migrate < t_recompute else "recompute"
