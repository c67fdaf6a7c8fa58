"""Cluster-scale runtime: virtual-clock engines + failure/elasticity.

SimEngine implements the identical slot protocol as the real NodeEngine, so
the CoroutineScheduler code that decodes real tokens in the examples is the
same code that is measured here at 16-128 GPUs.  Compute time comes from
the §5.4 performance model (core/plan.py) — module-level rooflines composed
through the execution DAG — which is how the paper itself derives its
static plans.

Includes:
* long-tail workload generation matched to Fig. 2c statistics,
* node-failure injection with the §5.6 migrate-vs-recompute cost model,
* elastic scale-up/down (instances are independent; the master re-partitions
  the sequence pool),
* a baseline "static engine" scheduler (vLLM/SGLang-style fixed binding)
  for the paper's comparisons.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import plan as plan_lib
from repro_torch.core.backend import validate_backend
from repro_torch.core.coroutine import Phase, SequenceCoroutine, Status
from repro_torch.core.events import EventKind, PrimitiveEvent
from repro_torch.core.primitives import PrimitiveStats
from repro_torch.core.scheduler import (CoroutineScheduler,
                                        SchedulerConfig, SchedulerPolicy)
from repro_torch.memory.allocator import PageAllocator
from repro_torch.memory.paged_kv import HostKVStore
from repro_torch.models.api import ModelConfig
from repro_torch.runtime.failure import (DeviceStatus, Heartbeat,
                                        kv_bytes_per_token)
from repro_torch.runtime.faults import (FaultPlan, NodeFaults,
                                       RetryPolicy, TransferDeadLetter,
                                       guarded_transfer)


class SimEngine:
    """Virtual-clock node engine (slot protocol compatible).

    A simulator: it holds no tensors and runs no kernel.  Its compute
    times come from the §5.4 model, with numpy on the host, as in the
    JAX package, so it takes no ``device=`` and needs no card."""

    def __init__(self, cfg: ModelConfig, hw: plan_lib.Hardware, *,
                 node_id: int = 0, num_devices: int = 8,
                 max_active: int = 64, max_len: int = 16384,
                 page_size: int = 64, plan: Optional[plan_lib.Plan] = None,
                 device_pages: Optional[int] = None,
                 partition_efficiency: float = 0.7,
                 reconfig_s: float = 7.0,
                 faults: Optional[NodeFaults] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 enable_prefix: bool = True):
        self.cfg = cfg
        self.hw = hw
        self.node_id = node_id
        self.num_devices = num_devices
        self.max_active = max_active
        self.max_len = max_len
        self.page_size = page_size
        self.partition_efficiency = partition_efficiency
        self.reconfig_s = reconfig_s
        self.plan = plan or plan_lib.search_plan(
            cfg, hw, ctx=max_len // 2, new_tokens=1, max_active=max_active)
        self.host_store = HostKVStore(page_size, enable_prefix=enable_prefix)
        # device_pages models the node's KV pool size: the governor's
        # oversubscription experiments shrink it well under the working
        # set; the default keeps the historical 4-pages-per-slot pool,
        # which is a soft modelling budget — only an explicit device_pages
        # is a real budget the governor may steer against
        self.allocator = PageAllocator(device_pages or max_active * 4,
                                       page_size,
                                       governed=device_pages is not None)
        self.kv_bytes_per_token = kv_bytes_per_token(cfg)
        self.stats = PrimitiveStats()
        self.vclock = 0.0
        self.busy_s = 0.0
        self.decode_steps = 0           # cumulative decode steps run
        self.tokens_out = 0.0           # cumulative tokens emitted — the
        #                                 heartbeat progress counter; raw
        #                                 counts, because an injected
        #                                 straggler inflates the vclock and
        #                                 the ProgressTracker's tokens/vclock
        #                                 rate drops by the same factor
        self.prefill_tokens = 0         # prompt tokens actually computed
        self.prefill_tokens_saved = 0   # served from fork dedupe / the index
        self.prefill_s = 0.0            # §5.4-model seconds spent in prefill
        self.failed = False
        self.slot_owner: List[Optional[int]] = [None] * max_active
        # pipelined host-KV staging (same two-stage protocol as the real
        # engine): entries are {"nbytes", "hidden"}; a decode between
        # stage and drain marks the blob hidden (its transfer overlapped
        # the compute).  plan.ring_buffer_bytes is the live gate.
        self._staged: List[Dict] = []
        self._staged_bytes = 0
        self.sync_stalls = 0
        # staged h2d restores (governor): seq_id -> {"nbytes", "length",
        # "hidden"} — the host→device mirror of the d2h pipeline above,
        # metered by its own h2d ring budget (a full-sequence restore
        # dwarfs a decode-page blob, and restore prefetch must never
        # starve the sync pipeline's staging room; two full sequences
        # deep, like the real engine's restore ring).  A decode between
        # stage and take marks the restore hidden (its transfer
        # overlapped compute).
        self._restore_staged: Dict[int, Dict] = {}
        self._restore_bytes = 0
        self._restore_cap = 2 * int(self.kv_bytes_per_token * max_len)
        self.restore_stages = 0
        self.restore_stalls = 0
        self.restore_wait_s = 0.0
        self.restore_stage_hidden_s = 0.0
        self.restore_staged_bytes = 0
        # §5.6 robustness: fault injection + guarded-transfer accounting
        # (identical surface to NodeEngine — same FaultPlan drives both)
        self.faults = faults
        self.retry_policy = retry_policy or RetryPolicy()
        self.transfer_stats = {"retries": 0, "timeouts": 0, "dead_letters": 0}
        self.dead_lettered = False
        self.oom_rejections = 0
        self.straggler_steps = 0
        self.abandoned_blobs = 0

    # ---------------------------------------------------------------- clock
    def clock(self) -> float:
        return self.vclock

    def idle_tick(self):
        self.vclock += 1e-3

    # ------------------------------------------------------------- protocol
    def heartbeat(self) -> Optional[Heartbeat]:
        """Liveness beat on the node's VIRTUAL clock.  The scheduler's
        monitor counts missed beats (interval_s=None) — per-node vclocks
        are never compared against each other."""
        if self.failed or (self.faults is not None and (
                self.faults.dead or self.faults.heartbeat_suppressed())):
            return None
        return Heartbeat(self.node_id, self.vclock,
                         [DeviceStatus(d) for d in range(self.num_devices)],
                         decode_steps=self.decode_steps,
                         tokens=self.tokens_out)

    def transfer(self, kind: str, fn):
        """Guarded transfer; retry backoff advances the virtual clock
        instead of sleeping."""
        return guarded_transfer(self, kind, fn, on_backoff=self._backoff)

    def _backoff(self, dt: float):
        self.vclock += dt

    def acquire_slot(self, co) -> Optional[int]:
        if self.faults is not None:
            if self.faults.dead:
                return None
            if self.faults.oom_active():
                self.oom_rejections += 1
                return None
        if not self.allocator.can_admit(2):
            return None         # page pool exhausted: admission waits
        for s, owner in enumerate(self.slot_owner):
            if owner is None:
                if self.allocator.alloc(co.seq_id, 2) is None:
                    return None
                self.slot_owner[s] = co.seq_id
                return s
        return None

    def free_slot(self, co):
        if co.slot is not None and co.slot < len(self.slot_owner) \
                and self.slot_owner[co.slot] == co.seq_id:
            self.slot_owner[co.slot] = None

    def extract_slot(self, co) -> Dict[str, np.ndarray]:
        return {}   # simulated: the host store tracks metadata only

    def install_slot(self, co, slices):
        # the simulated install is free, but it still passes through the
        # guarded-transfer envelope so injected install faults exercise
        # the same retry/dead-letter path as the real engine
        try:
            self.transfer("install", lambda: None)
        except TransferDeadLetter:
            pass        # scheduler escalates via the dead_lettered flag

    def reconfigure_partition(self, co, group):
        self.vclock += self.reconfig_s          # paper Table 2: 5-10 s

    # -------------------------------------------------------------- compute
    def decode_page(self, active: Sequence[SequenceCoroutine], P: int):
        if self.faults is not None and self.faults.dead:
            return              # zombie: no compute until failover
        for e in self._staged:          # this compute hides their transfer
            e["hidden"] = True
        for e in self._restore_staged.values():     # and the h2d prefetches
            e["hidden"] = True
        regular = [c for c in active if not c.partition_group]
        parts = [c for c in active if c.partition_group]
        steps = min(P, max(c.remaining for c in active))
        t_reg = 0.0
        if regular:
            ctx = float(np.mean([c.length for c in regular]))
            t_tok = plan_lib.step_time(self.cfg, self.hw, self.plan,
                                       len(regular), int(ctx), 1,
                                       ep_degree=min(self.num_devices, 8))
            t_reg = t_tok * steps
        t_part = 0.0
        for c in parts:
            g = max(len(c.partition_group), 1)
            t1 = plan_lib.step_time(self.cfg, self.hw, self.plan, 1,
                                    c.length, 1)
            t_part = max(t_part,
                         steps * t1 / max(g * self.partition_efficiency, 1.0))
        dt = max(t_reg, t_part)
        if self.faults is not None:
            f = self.faults.straggler_factor()
            if f > 1.0:
                self.straggler_steps += steps
                dt *= f         # same tokens, just slower — determinism
        self.vclock += dt
        self.busy_s += dt
        self.decode_steps += steps
        for c in active:
            n = min(steps, c.remaining)
            start = len(c.generated)
            toks, hit = c.sampling.truncate_at_stop(
                [self._sim_token(c, start + t) for t in range(n)])
            c.stopped = c.stopped or hit
            c.generated.extend(toks)
            c.length += len(toks)
            self.tokens_out += len(toks)
            self._sim_append_logprobs(c, start, toks)
        # host-store metadata so migrate/refill see real lengths
        for c in active:
            if not self.host_store.has(c.seq_id):
                self.host_store.checkpoint(c.seq_id, {}, c.length)
            else:
                self.host_store.seqs[c.seq_id].length = c.length

    @staticmethod
    def _sim_token(co: SequenceCoroutine, idx: int) -> int:
        """Virtual decode honors the sampling contract's *shape*: greedy
        sequences emit the constant 7; sampled ones emit a deterministic
        pseudo-stream of (effective seed, token index) — a pure function
        of per-sequence state, so migration/recovery replays identically."""
        sp = co.sampling
        if sp.temperature <= 0.0:
            return 7
        h = (sp.effective_seed(co.seq_id) * 2654435761 + idx * 40503) \
            & 0xFFFFFFFF
        return 7 + (h >> 16) % 89

    @staticmethod
    def _sim_logprob(co: SequenceCoroutine, idx: int) -> float:
        """Deterministic pseudo-logprob for the token at generated-index
        ``idx`` — like ``_sim_token``, a pure function of per-sequence
        state so streaming, replay and recovery all agree."""
        h = (co.sampling.effective_seed(co.seq_id) * 40503
             + idx * 2654435761) & 0xFFFFFFFF
        return -0.01 - (h >> 16) / 65536.0 * 8.0

    @classmethod
    def _sim_append_logprobs(cls, co: SequenceCoroutine, start: int,
                             toks) -> None:
        """Honor the logprobs surface in simulation: the virtual decode
        emits the same record shape as the real megastep's packed plane."""
        if not co.logprobs:
            return
        for t, tok in enumerate(toks):
            lp = cls._sim_logprob(co, start + t)
            co.token_logprobs.append(lp)
            if co.top_logprobs:
                co.top_token_logprobs.append(
                    [(int(tok) + j, lp - 0.5 * j)
                     for j in range(co.top_logprobs)])

    def sync_appends(self, active):
        # blocking sync: issue + land in one call (the page-boundary
        # barrier, 5-10 ms / 64 tokens cross-node sync, Table 2)
        self.stage_appends(active)
        self.drain_appends()

    def stage_appends(self, active):
        """Issue the page's KV transfer; cost is the dispatch only.  The
        §5.4 plan's ring_buffer_bytes gates in-flight bytes — a stage
        that would overflow it pays a synchronous drain first (the stall
        the configuration search sizes the buffer against), and a blob
        larger than the whole ring degrades to the blocking barrier with
        no overlap at all — the same fallback ladder as the real
        engine, so the simulator cannot report transfer hiding a given
        ring size would not actually deliver."""
        nbytes = int(len(active) * self.page_size
                     * kv_bytes_per_token(self.cfg))
        cap = max(int(self.plan.ring_buffer_bytes), 1)
        if self._staged_bytes + nbytes > cap:
            self.sync_stalls += 1
            self.drain_appends()
        if self._staged_bytes + nbytes <= cap:
            try:
                self.transfer("stage", lambda: None)
            except TransferDeadLetter:
                self.abandoned_blobs += 1   # sim KV is metadata-only:
                return                      # nothing to drop, just escalate
            self._staged.append({"nbytes": nbytes, "hidden": False})
            self._staged_bytes += nbytes
            self.vclock += 0.002
        else:
            # blob larger than the ring: synchronous stage + unhidden land.
            # Still a real d2h copy, so it rides the same guarded-drain
            # envelope the real engine's forced-synchronous path takes.
            try:
                self.transfer("drain", lambda: None)
            except TransferDeadLetter:
                self.abandoned_blobs += 1
                return
            self.vclock += 0.007    # synchronous: issue + unhidden land

    def drain_appends(self, keep_newest: int = 0):
        """Land staged blobs: a blob whose transfer overlapped a decode
        (hidden) pays only the residual barrier; a force-drained one pays
        the blocking remainder of the Table-2 sync cost."""
        while len(self._staged) > keep_newest:
            e = self._staged.pop(0)
            self._staged_bytes -= e["nbytes"]
            try:
                self.transfer("drain", lambda: None)
            except TransferDeadLetter:
                self.abandoned_blobs += 1
                continue
            self.vclock += 0.001 if e["hidden"] else 0.005

    # ------------------------------------- staged h2d restores (governor)
    _RESTORE_S = 0.004      # modeled h2d restore transfer (Table-2 scale)

    def stage_restore(self, co) -> bool:
        """Sim mirror of the real engine's restore prefetch: reserve the
        modeled restore bytes against the h2d restore-ring budget and
        issue the (virtual) host→device copy; the next decode marks it
        hidden."""
        ent = self._restore_staged.get(co.seq_id)
        if ent is not None:
            st = self.host_store.seqs.get(co.seq_id)
            if st is not None and st.length == ent["length"]:
                return True
            self.discard_restore(co.seq_id)     # stale: checkpoint advanced
        if not self.host_store.has(co.seq_id):
            return False
        length = self.host_store.seqs[co.seq_id].length
        nbytes = int(self.kv_bytes_per_token * length)
        if self._restore_bytes + nbytes > self._restore_cap:
            self.restore_stalls += 1
            return False
        try:
            self.transfer("restore", lambda: None)
        except TransferDeadLetter:
            return False
        self._restore_staged[co.seq_id] = {
            "nbytes": nbytes, "length": length, "hidden": False}
        self._restore_bytes += nbytes
        self.restore_stages += 1
        self.restore_staged_bytes += nbytes
        self.vclock += 0.001        # async issue: dispatch cost only
        return True

    def restore_ready(self, seq_id: int) -> bool:
        """True when the staged restore drained: a decode page ran since
        the (virtual) h2d copy was issued, so the transfer is hidden and
        COMBINE pays only the residual barrier."""
        ent = self._restore_staged.get(seq_id)
        st = self.host_store.seqs.get(seq_id)
        return (ent is not None and ent["hidden"]
                and st is not None and st.length == ent["length"])

    def take_restore(self, seq_id: int) -> Optional[Dict]:
        """Consume a staged restore at COMBINE: a hidden prefetch pays
        only the residual barrier (its transfer overlapped a decode); an
        unhidden or missing one pays the full modeled restore.  Returns
        ``{}`` (sim KV is metadata-only) or None without host state."""
        ent = self._restore_staged.pop(seq_id, None)
        st = self.host_store.seqs.get(seq_id)
        if ent is not None:
            self._restore_bytes -= ent["nbytes"]
            if st is not None and st.length == ent["length"]:
                self.restore_wait_s += self._RESTORE_S
                if ent["hidden"]:
                    self.restore_stage_hidden_s += self._RESTORE_S
                    self.vclock += 0.001
                else:
                    self.vclock += self._RESTORE_S
                return {}
        if st is None:
            return None
        self.restore_wait_s += self._RESTORE_S
        self.vclock += 0.001 + self._RESTORE_S      # synchronous restore
        return {}

    def discard_restore(self, seq_id: int) -> None:
        ent = self._restore_staged.pop(seq_id, None)
        if ent is not None:
            self._restore_bytes -= ent["nbytes"]

    def discard_restores(self) -> None:
        self._restore_staged.clear()
        self._restore_bytes = 0

    def prefill(self, cos: Sequence[SequenceCoroutine]):
        """Shared-prefix-aware prefill: identical prompts in the batch
        (fork groups or coincidental duplicates) run the virtual forward
        ONCE, and a prompt whose leading full pages match the node's
        PrefixIndex is charged only for its tail (§5.4 model) — at least
        one position is always recomputed so the last-token forward (and
        its logits, on the real engine) is genuine."""
        if self.faults is not None and self.faults.dead:
            return              # zombie: coroutines stay INIT for recovery
        if not cos:
            return
        P = self.page_size
        idx = self.host_store.prefix_index
        groups: Dict[tuple, List[SequenceCoroutine]] = {}
        for c in cos:
            # prefix reuse off => no fork dedupe either (naive baseline)
            key = tuple(c.prompt) if idx is not None else ("seq", c.seq_id)
            groups.setdefault(key, []).append(c)
        charged = 0
        max_tail = 0
        max_ctx = 0
        n_charged_groups = 0
        for group in groups.values():
            lead = group[0]
            chain = []
            if idx is not None and lead.prompt_len > 1:
                chain = idx.match(lead.prompt)
                chain = chain[: (lead.prompt_len - 1) // P]
            m = len(chain) * P
            tail = lead.prompt_len - m
            charged += tail
            n_charged_groups += 1
            max_tail = max(max_tail, tail)
            max_ctx = max(max_ctx, lead.prompt_len)
            if chain:
                st = self.host_store.attach_shared(lead.seq_id, chain)
                st.length = lead.prompt_len
                lead.prefix_hit_tokens = m
            else:
                self.host_store.checkpoint(lead.seq_id, {}, lead.prompt_len)
            if idx is not None:
                self.host_store.publish_prefix(lead.seq_id, lead.prompt)
            for sib in group[1:]:
                if idx is not None and \
                        self.host_store.seqs[lead.seq_id].prefix_node is not None:
                    st = self.host_store.clone_shared(lead.seq_id, sib.seq_id)
                    st.length = sib.prompt_len
                else:
                    self.host_store.checkpoint(sib.seq_id, {}, sib.prompt_len)
                sib.prefix_hit_tokens = sib.prompt_len
        if charged > 0:
            t = plan_lib.step_time(self.cfg, self.hw, self.plan,
                                   n_charged_groups, max_ctx, max_tail)
            self.vclock += t
            self.busy_s += t
            self.prefill_s += t
        self.prefill_tokens += charged
        self.prefill_tokens_saved += sum(c.prompt_len for c in cos) - charged
        for co in cos:
            co.length = co.prompt_len
            co.last_token = self._sim_token(co, 0)
            co.generated.append(co.last_token)
            self.tokens_out += 1
            self._sim_append_logprobs(co, 0, [co.last_token])
            if co.last_token in co.sampling.stop:
                co.stopped = True
            co.phase = Phase.DECODING
            co.status = Status.INACTIVE

    def utilization(self) -> float:
        return self.busy_s / max(self.vclock, 1e-9)


# SimEngine declares conformance to the same formal backend contract as
# the real NodeEngine — one scheduler code path drives both.
validate_backend(SimEngine)


# ---------------------------------------------------------------------------
# workloads (long-tail generation, Fig. 2c statistics)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Workload:
    prompts: List[List[int]]
    max_out: List[int]

    @property
    def n(self):
        return len(self.prompts)


def longtail_workload(n: int, *, mean_in: int = 2048, mean_out: int = 2048,
                      sigma: float = 1.0, seed: int = 0,
                      max_out_cap: int = 65536) -> Workload:
    """Lognormal output lengths; calibrated near Fig. 2c
    (P99/P95 ≈ 3.8x, max/P95 ≈ 9x at sigma≈1.0 for large n)."""
    rng = np.random.default_rng(seed)
    ins = np.maximum(rng.poisson(mean_in, n), 8)
    mu = math.log(mean_out) - sigma ** 2 / 2
    outs = np.minimum(np.maximum(
        rng.lognormal(mu, sigma, n).astype(int), 4), max_out_cap)
    prompts = [[1] * int(i) for i in ins]
    return Workload(prompts, [int(o) for o in outs])


def fixed_workload(n: int, in_len: int, out_len: int) -> Workload:
    return Workload([[1] * in_len for _ in range(n)], [out_len] * n)


# ---------------------------------------------------------------------------
# node groups (replica building block for the streaming driver)
# ---------------------------------------------------------------------------


def sim_node_group(cfg: ModelConfig, hw: plan_lib.Hardware, *,
                   nodes: int, first_node_id: int = 0,
                   devices_per_node: int = 8, max_active: int = 64,
                   max_len: int = 16384, page_size: int = 64,
                   plan: Optional[plan_lib.Plan] = None) -> List[SimEngine]:
    """A contiguous group of SimEngines sharing one static plan — the unit
    a data-parallel replica owns.  ``first_node_id`` keeps node ids unique
    across replicas so driver-level logs/reports never alias."""
    plan = plan or plan_lib.search_plan(cfg, hw, ctx=max_len // 2,
                                        new_tokens=1, max_active=max_active)
    return [SimEngine(cfg, hw, node_id=first_node_id + i,
                      num_devices=devices_per_node, max_active=max_active,
                      max_len=max_len, page_size=page_size, plan=plan)
            for i in range(nodes)]


# ---------------------------------------------------------------------------
# cluster with failures + elasticity
# ---------------------------------------------------------------------------


class Cluster:
    def __init__(self, cfg: ModelConfig, hw: plan_lib.Hardware, *,
                 nodes: int, devices_per_node: int = 8,
                 max_active: int = 64, max_len: int = 16384,
                 page_size: int = 64,
                 sched_cfg: Optional[SchedulerConfig] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 enable_prefix: bool = True,
                 device_pages: Optional[int] = None):
        self.cfg = cfg
        self.hw = hw
        plan = plan_lib.search_plan(cfg, hw, ctx=max_len // 2, new_tokens=1,
                                    max_active=max_active)
        self.engines = [SimEngine(cfg, hw, node_id=i,
                                  num_devices=devices_per_node,
                                  max_active=max_active, max_len=max_len,
                                  page_size=page_size, plan=plan,
                                  enable_prefix=enable_prefix,
                                  device_pages=device_pages)
                        for i in range(nodes)]
        self._inter_node_bw = 25e9
        # the §5.6 migrate-vs-recompute cost model rides the scheduler's
        # recovery_choice policy hook — ONE recovery code path (the
        # event-loop NODE_FAILURE handler) for sim and real engines
        policy = SchedulerPolicy(recovery_choice=self._recovery_choice)
        self.sched = CoroutineScheduler(
            self.engines, sched_cfg or SchedulerConfig(page_size=page_size),
            policy=policy, fault_plan=fault_plan)

    def run(self, wl: Workload, max_ticks: int = 200000, *,
            sampling=None, n: int = 1) -> Dict:
        """Run a workload to completion; ``n`` > 1 fans every prompt out
        into n forked siblings (see ``CoroutineScheduler.submit``)."""
        self.sched.submit(wl.prompts, wl.max_out, sampling=sampling, n=n)
        rep = self.sched.run(max_ticks=max_ticks)
        rep["utilization"] = float(np.mean(
            [e.utilization() for e in self.engines if not e.failed]))
        return rep

    # ---- §5.6 failure recovery ------------------------------------------
    def _recovery_choice(self, sched, co, failed, dst) -> str:
        """Migrate-vs-recompute cost model (the policy hook the scheduler
        consults per eligible sequence): KV transfer time over the
        inter-node link vs re-prefill time from the performance model.
        A chosen migrate also bills the transfer to the destination's
        virtual clock."""
        kv_bytes = co.length * kv_bytes_per_token(self.cfg)
        t_migrate = kv_bytes / self._inter_node_bw
        t_recompute = plan_lib.step_time(
            self.cfg, self.hw, dst.plan, 1, max(co.length, 1),
            max(co.length, 1))
        if t_migrate < t_recompute:
            dst.vclock += t_migrate
            return "migrate"
        return "recompute"

    def fail_node(self, node: int, *, inter_node_bw: float = 25e9) -> Dict:
        """Kill a node NOW: pushes NODE_FAILURE through the scheduler's
        event-loop handler — the same §5.6 recovery path a health-monitor
        declaration or a dead-lettered transfer takes — with this
        cluster's cost model deciding migrate-vs-recompute per sequence."""
        eng = self.engines[node]
        eng.failed = True
        self._inter_node_bw = inter_node_bw
        self.sched.health.mark_failed(node)
        self.sched.queue.push(EventKind.NODE_FAILURE, node,
                              payload="external")
        recs = list(self.sched._drain_queue())
        moved = sum(1 for r in recs if isinstance(r, PrimitiveEvent)
                    and r.primitive == "migrate" and r.detail == "failover")
        recomputed = sum(1 for r in recs if isinstance(r, PrimitiveEvent)
                         and r.primitive == "recompute"
                         and r.detail == "failover")
        return {"migrated": moved, "recomputed": recomputed}

    def drain_node(self, node: int) -> Dict:
        """Gracefully retire a node: pushes NODE_DRAIN through the
        scheduler's handler — every live sequence is checkpointed (fresh
        YIELD) and MIGRATEd to a survivor with zero recompute, then the
        node leaves the rotation.  Contrast ``fail_node``: that path may
        recompute; this one never should."""
        self.sched.queue.push(EventKind.NODE_DRAIN, node, payload="scale_down")
        recs = list(self.sched._drain_queue())
        moved = sum(1 for r in recs if isinstance(r, PrimitiveEvent)
                    and r.primitive == "migrate" and r.detail == "drain")
        return {"migrated": moved,
                "drained": node in self.sched.drained_nodes}

    # ---- elasticity -------------------------------------------------------
    def add_node(self) -> int:
        nid = len(self.engines)
        e = SimEngine(self.cfg, self.hw, node_id=nid,
                      num_devices=self.engines[0].num_devices,
                      max_active=self.engines[0].max_active,
                      max_len=self.engines[0].max_len,
                      page_size=self.engines[0].page_size,
                      plan=self.engines[0].plan)
        e.vclock = max(x.vclock for x in self.engines)
        self.engines.append(e)
        self.sched.engines = [x for x in self.engines if not x.failed]
        return nid


# ---------------------------------------------------------------------------
# static baseline (vLLM/SGLang-style fixed binding) for comparisons
# ---------------------------------------------------------------------------


def run_static_baseline(cfg: ModelConfig, hw: plan_lib.Hardware, wl: Workload,
                        *, nodes: int, max_active: int = 64,
                        max_len: int = 16384) -> Dict:
    """Sequences statically bound to nodes round-robin; no combine/migrate/
    partition; continuous batching within a node only; B_moe = whatever is
    active (no cross-phase accumulation)."""
    plan = plan_lib.Plan(b_attn=max_active, b_moe=max_active,
                         offload_kv=False, offload_params=False,
                         ring_buffer_bytes=0, layer_time_s=0.0)
    queues: List[List[Tuple[List[int], int]]] = [[] for _ in range(nodes)]
    for i, (p, o) in enumerate(zip(wl.prompts, wl.max_out)):
        queues[i % nodes].append((p, o))
    bct = 0.0
    busy = []
    for node_q in queues:
        t = 0.0
        work = 0.0
        pending = list(node_q)
        active: List[List] = []   # [remaining, length]
        while pending or active:
            while pending and len(active) < max_active:
                p, o = pending.pop(0)
                tp = plan_lib.step_time(cfg, hw, plan, 1, len(p), len(p))
                t += tp
                work += tp
                active.append([o, len(p)])
            ctx = float(np.mean([a[1] for a in active]))
            td = plan_lib.step_time(cfg, hw, plan, len(active), int(ctx), 1)
            t += td
            work += td * len(active) / max_active
            for a in active:
                a[0] -= 1
                a[1] += 1
            active = [a for a in active if a[0] > 0]
        bct = max(bct, t)
        busy.append(work / max(t, 1e-9))
    return {"bct_s": bct, "utilization": float(np.mean(busy))}
