"""OpenAI-compatible Batch API objects + master front-end (paper §5.6).

In-process implementation of the protocol shape (no HTTP server in this
container): a BatchMaster per model-parallel group accepts batch
submissions, over-subscribes its engines (dispatching far more requests
than concurrent capacity so the runtime can COMBINE from a deep resident
pool, §6.4 'Production deployment'), and serves results **stream-first**:
``BatchMaster.stream(bid)`` yields the scheduler's typed records
(``TokenBlockEvent`` / ``SeqFinishedEvent`` / ``PrimitiveEvent``,
annotated with the request's ``custom_id``) as pages complete, while
``BatchObject.results`` fills incrementally in completion order.
``run()`` is re-implemented on top of the stream — it drains it, then
re-orders the results to input order (the OpenAI batch contract).
"""
from __future__ import annotations

import dataclasses
import json
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional, Sequence

from repro_torch.core.events import RuntimeRecord, SeqFinishedEvent
from repro_torch.core.scheduler import CoroutineScheduler, SchedulerConfig
from repro_torch.sampling import SamplingParams


@dataclasses.dataclass
class BatchRequest:
    """One line of an OpenAI batch input file."""
    custom_id: str
    prompt: List[int]
    max_tokens: int = 128
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    logprobs: bool = False          # return chosen-token logprobs
    top_logprobs: int = 0           # also return the top-K alternatives

    @classmethod
    def from_json(cls, line: str) -> "BatchRequest":
        return cls.from_dict(json.loads(line))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BatchRequest":
        """Build from an already-parsed input line — the streaming driver
        peeks ``custom_id`` before deciding whether to materialize the
        request at all (resume skip / duplicate skip)."""
        body = d.get("body", d)
        sp = SamplingParams(
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            min_p=float(body.get("min_p", 0.0)),
            repetition_penalty=float(body.get("repetition_penalty", 1.0)),
            presence_penalty=float(body.get("presence_penalty", 0.0)),
            frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            seed=body.get("seed"),
            stop=tuple(body.get("stop", ())),
            deadline_s=(float(body["deadline_s"])
                        if body.get("deadline_s") is not None else None))
        return cls(custom_id=d.get("custom_id", str(uuid.uuid4())),
                   prompt=body["prompt"],
                   max_tokens=int(body.get("max_tokens", 128)),
                   sampling=sp,
                   logprobs=bool(body.get("logprobs", False)),
                   top_logprobs=int(body.get("top_logprobs", 0)))


@dataclasses.dataclass
class BatchObject:
    id: str
    status: str = "validating"        # validating|in_progress|completed
    created_at: float = dataclasses.field(default_factory=time.time)
    completed_at: Optional[float] = None
    request_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"total": 0, "completed": 0, "failed": 0})
    results: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _LiveBatch:
    """Working state of one incremental (driver-fed) batch: a long-lived
    scheduler that requests are appended to over time and pumped round by
    round.  Memory is bounded by the in-flight set, not the job: finished
    sequences are retired from the scheduler the moment their row is
    captured, and rows leave via ``pop_row`` (write-ahead consumers
    journal them immediately)."""
    sched: CoroutineScheduler
    by_seq: Dict[int, BatchRequest] = dataclasses.field(default_factory=dict)
    rows: Dict[int, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    appended: int = 0
    finished: int = 0


class BatchMaster:
    """Master node: accepts batches, partitions sequences across workers via
    the coroutine scheduler, streams results as they complete.

    Two submission surfaces:

    * ``submit`` + ``run``/``stream`` — the OpenAI-style one-shot batch
      (whole request list up front, results retained on the batch object).
    * ``open`` + ``append``/``pump`` — the incremental surface the
      streaming job driver feeds: requests trickle in under a bounded
      window, each ``pump`` runs ONE scheduler round and returns its
      records, finished rows are popped (not retained), and ``cancel``
      hands back whatever never finished (replica drain/requeue)."""

    def __init__(self, engines: Sequence, sched_cfg: SchedulerConfig = None,
                 oversubscribe: float = 4.0, policy=None, fault_plan=None):
        self.engines = list(engines)
        self.sched_cfg = sched_cfg or SchedulerConfig()
        self.oversubscribe = oversubscribe
        # robustness passthrough (§5.6): a SchedulerPolicy (e.g. with a
        # recovery_choice hook) and/or a seeded FaultPlan applied to every
        # scheduler this master builds
        self.policy = policy
        self.fault_plan = fault_plan
        self.batches: Dict[str, BatchObject] = {}
        # per-batch working state, dropped at _finalize (only the
        # BatchObject survives a finished batch)
        self._requests: Dict[str, List[BatchRequest]] = {}
        self._scheds: Dict[str, CoroutineScheduler] = {}
        self._ids: Dict[str, List[int]] = {}
        self._rows: Dict[str, Dict[int, Dict[str, Any]]] = {}
        self._live: Dict[str, _LiveBatch] = {}

    def submit(self, requests: Sequence[BatchRequest]) -> str:
        bid = f"batch_{uuid.uuid4().hex[:12]}"
        bo = BatchObject(id=bid)
        bo.request_counts["total"] = len(requests)
        bo.status = "in_progress"
        self.batches[bid] = bo
        self._requests[bid] = list(requests)
        return bid

    # ----------------------------------------------------- incremental batch
    def open(self) -> str:
        """Start a long-lived incremental batch: the scheduler exists
        immediately, requests arrive later via ``append``, and the caller
        pumps rounds explicitly.  This is one elastic data-parallel
        *replica* from the streaming driver's point of view."""
        bid = f"batch_{uuid.uuid4().hex[:12]}"
        bo = BatchObject(id=bid, status="in_progress")
        self.batches[bid] = bo
        self._live[bid] = _LiveBatch(
            sched=CoroutineScheduler(self.engines, self.sched_cfg,
                                     policy=self.policy,
                                     fault_plan=self.fault_plan))
        return bid

    def append(self, bid: str,
               requests: Sequence[BatchRequest]) -> List[int]:
        """Feed more requests to a live batch; the next pumped round's
        REFILL admits them (mid-stream COMBINE)."""
        lb = self._live[bid]
        reqs = list(requests)
        ids = lb.sched.submit([r.prompt for r in reqs],
                              [r.max_tokens for r in reqs],
                              sampling=[r.sampling for r in reqs],
                              logprobs=[r.logprobs for r in reqs],
                              top_logprobs=[r.top_logprobs for r in reqs])
        for sid, r in zip(ids, reqs):
            lb.by_seq[sid] = r
        lb.appended += len(reqs)
        self.batches[bid].request_counts["total"] += len(reqs)
        return ids

    def pump(self, bid: str) -> List[RuntimeRecord]:
        """Run ONE scheduler round of a live batch; returns its records
        with ``custom_id`` annotated.  Each ``SeqFinishedEvent``'s result
        row is staged for ``pop_row`` and the sequence is retired from the
        scheduler — resident state stays proportional to the in-flight
        window, never the job."""
        lb = self._live[bid]
        recs = lb.sched.step()
        finished: List[int] = []
        for rec in recs:
            req = lb.by_seq.get(rec.seq_id)
            if req is not None:
                rec.custom_id = req.custom_id
                if isinstance(rec, SeqFinishedEvent):
                    lb.rows[rec.seq_id] = self._result_row(
                        req, lb.sched.cos[rec.seq_id])
                    finished.append(rec.seq_id)
        for sid in finished:
            lb.sched.retire(sid)
            del lb.by_seq[sid]
            lb.finished += 1
            self.batches[bid].request_counts["completed"] += 1
        return recs

    def pop_row(self, bid: str, seq_id: int) -> Optional[Dict[str, Any]]:
        """Take ownership of one finished row (write-ahead consumers
        journal it, then it is gone from the master)."""
        return self._live[bid].rows.pop(seq_id, None)

    def in_flight(self, bid: str) -> int:
        return len(self._live[bid].by_seq)

    def live_engines(self, bid: str) -> List:
        """Engines still in the live batch's scheduler rotation (shrinks
        under NODE_FAILURE / NODE_DRAIN)."""
        return list(self._live[bid].sched.engines)

    def capacity(self, bid: str) -> int:
        """Max requests worth dispatching to this live batch: surviving
        slots times the oversubscription depth (§6.4)."""
        slots = sum(e.max_active for e in self._live[bid].sched.engines)
        return int(slots * self.oversubscribe)

    def scheduler(self, bid: str) -> CoroutineScheduler:
        return self._live[bid].sched

    def cancel(self, bid: str) -> List[BatchRequest]:
        """Tear down a live batch NOW and hand back every request that has
        no captured row — the drain/requeue path.  (Rows still staged in
        ``rows`` are NOT returned: their requests finished and a consumer
        should ``pop_row`` them before cancelling.)"""
        lb = self._live.pop(bid)
        bo = self.batches[bid]
        bo.status = "drained"
        bo.completed_at = time.time()
        rep = lb.sched.report()
        bo.scheduler_status = rep["status"]
        bo.bct_s = rep["bct_s"]
        self._final_reports = getattr(self, "_final_reports", {})
        self._final_reports[bid] = rep
        return list(lb.by_seq.values())

    def close(self, bid: str) -> BatchObject:
        """Finalize a live batch whose work is fully consumed."""
        lb = self._live.pop(bid)
        bo = self.batches[bid]
        rep = lb.sched.report()
        bo.status = "completed"
        bo.completed_at = time.time()
        bo.scheduler_status = rep["status"]
        bo.bct_s = rep["bct_s"]
        self._final_reports = getattr(self, "_final_reports", {})
        self._final_reports[bid] = rep
        return bo

    def report(self, bid: str) -> Dict[str, Any]:
        """The scheduler report behind one batch — live (current state) or
        final (snapshot taken at close/cancel).  One scheduler's view; the
        driver-level ``StreamingJobDriver.report()`` merges these across
        replicas."""
        lb = self._live.get(bid)
        if lb is not None:
            return lb.sched.report()
        return getattr(self, "_final_reports", {}).get(bid, {})

    # ------------------------------------------------------------- streaming
    def stream(self, bid: str,
               max_ticks: int = 100000) -> Iterator[RuntimeRecord]:
        """Elastic result surface: yield runtime records as pages complete.

        Each record carries the owning request's ``custom_id``; on every
        ``SeqFinishedEvent`` the request's result row is appended to
        ``BatchObject.results`` (completion order) so pollers see partial
        output while the batch is in flight.  Consume fully (or call
        ``run()``) to finalize the batch object.  Abandoning the stream
        mid-flight leaves the batch ``in_progress``; calling again starts
        a fresh pass (results and counts reset — sequences re-decode).
        A finalized batch cannot be streamed again (use ``retrieve()``)."""
        bo = self.batches[bid]
        if bid not in self._requests:
            raise ValueError(
                f"batch {bid} is already finalized; use retrieve()")
        # fresh pass: discard partial state from any abandoned stream
        bo.results = []
        bo.request_counts["completed"] = 0
        bo.request_counts["failed"] = 0
        reqs = self._requests[bid]
        sched = CoroutineScheduler(self.engines, self.sched_cfg,
                                   policy=self.policy,
                                   fault_plan=self.fault_plan)
        self._scheds[bid] = sched
        ids = sched.submit([r.prompt for r in reqs],
                           [r.max_tokens for r in reqs],
                           sampling=[r.sampling for r in reqs],
                           logprobs=[r.logprobs for r in reqs],
                           top_logprobs=[r.top_logprobs for r in reqs])
        self._ids[bid] = ids
        self._rows[bid] = {}
        by_seq = {sid: r for sid, r in zip(ids, reqs)}
        for rec in sched.events(max_ticks):
            req = by_seq.get(rec.seq_id)
            if req is not None:
                rec.custom_id = req.custom_id
                if isinstance(rec, SeqFinishedEvent):
                    row = self._result_row(req, sched.cos[rec.seq_id])
                    self._rows[bid][rec.seq_id] = row
                    bo.results.append(row)
                    bo.request_counts["completed"] += 1
            yield rec
        self._finalize(bid)

    # ------------------------------------------------------------- blocking
    def run(self, bid: str, max_ticks: int = 100000) -> BatchObject:
        """Run to completion; results preserve input order (OpenAI batch
        contract).  Thin wrapper that drains ``stream()``; idempotent on
        an already-finalized batch."""
        if bid not in self._requests:           # already finalized
            return self.batches[bid]
        for _ in self.stream(bid, max_ticks=max_ticks):
            pass
        return self.batches[bid]

    def _finalize(self, bid: str) -> None:
        """Re-order results to input order (rows keyed by seq_id, so
        duplicate custom_ids cannot collapse), fill 504 rows for anything
        the tick budget cut off, and drop the per-batch working state —
        a long-lived master must not retain one scheduler per batch."""
        bo = self.batches[bid]
        sched = self._scheds.pop(bid)
        reqs = self._requests.pop(bid)
        ids = self._ids.pop(bid)
        rows = self._rows.pop(bid)
        rep = sched.report()
        bo.results = []
        for req, sid in zip(reqs, ids):
            row = rows.get(sid)
            if row is None:             # exhausted before finishing
                row = self._result_row(req, sched.cos[sid])
                bo.request_counts["failed"] += 1
            bo.results.append(row)
        bo.status = "completed"
        bo.completed_at = time.time()
        bo.bct_s = rep["bct_s"]
        bo.scheduler_status = rep["status"]

    @staticmethod
    def _result_row(req: BatchRequest, co) -> Dict[str, Any]:
        resp: Dict[str, Any] = {
            "tokens": list(co.generated),
            "finish_reason": co.finish_reason if co.done else "incomplete",
        }
        if req.logprobs or req.top_logprobs > 0:
            resp["logprobs"] = {
                "token_logprobs": [float(x) for x in co.token_logprobs]}
            if req.top_logprobs > 0:
                resp["logprobs"]["top_logprobs"] = [
                    [[int(t), float(lp)] for t, lp in row]
                    for row in co.top_token_logprobs]
        return {"custom_id": req.custom_id, "response": resp,
                "status_code": 200 if co.done else 504}

    def result_row(self, bid: str, seq_id: int) -> Optional[Dict[str, Any]]:
        """The finished result row for one in-flight sequence, or None if
        it has not finished (or the batch is already finalized).  This is
        what a write-ahead consumer (``runtime/ledger.py``) journals the
        moment the ``SeqFinishedEvent`` comes off the stream."""
        return self._rows.get(bid, {}).get(seq_id)

    def retrieve(self, bid: str) -> BatchObject:
        return self.batches[bid]

    def output_file(self, bid: str) -> str:
        """JSONL results, input order preserved (OpenAI batch format)."""
        return "\n".join(json.dumps(r) for r in self.batches[bid].results)
