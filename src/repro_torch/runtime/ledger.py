"""Crash-resumable job ledger: write-ahead output log for batch jobs (§5.6).

``runtime/checkpoint.py`` snapshots *engine* state (params, sequence pool,
host KV) — enough to warm-restart a process that shut down cleanly.  This
module covers the other half of preemption tolerance: a **job-level
write-ahead ledger** that survives a SIGKILL mid-batch.  It is the
"crash-resumable progress ledger" the ROADMAP's million-sequence streaming
driver calls for: at that scale a batch runs for days and WILL be
preempted; recomputing finished sequences on every restart makes the job
quadratic.

Design
------
One append-only jsonl file, fsync'd per record, three record kinds:

``{"kind": "meta", "version": 1, ...}``
    header written when the ledger is created.
``{"kind": "submit", "custom_id": ..., "n": ...}``
    the job's request manifest, written before any work starts (so a
    resume can detect a changed request set).
``{"kind": "output", "custom_id": ..., "row": {...}}``
    one finished request's full result row, appended the moment its
    ``SeqFinishedEvent`` lands — the write-ahead part: a request is
    "finished" iff its output record is durably in the ledger.

Crash semantics:

* A SIGKILL between records loses at most the in-flight request(s) — they
  re-run on resume.  Finished rows are never recomputed (the acceptance
  bar: zero recompute of finished sequences).
* A SIGKILL mid-write leaves a torn trailing line; ``JobLedger.open``
  truncates it (the record never committed — its request re-runs).
* **Exactly-once outputs**: ``record_output`` refuses duplicates
  (first-wins by ``custom_id``), so a crash after the write but before
  the scheduler advanced cannot double-emit a row, and a resumed run
  re-streaming a finished id is a no-op.

Determinism is what makes resume *correct*, not just convenient: greedy
decode and the token-addressable fold_in sampled stream are bitwise
reproducible across batch composition, so the rows a resumed run computes
for the unfinished remainder are identical to what the uninterrupted run
would have produced — the combined output file is byte-for-byte the same.

``run_resumable`` packages the protocol: load ledger → skip finished →
submit the remainder → append each finish as it lands → return all rows
in input order.

Chunked segment rotation (million-line jobs)
--------------------------------------------
``JobLedger`` holds every finished row in memory and replays the whole
file on reopen — fine for a batch of thousands, quadratic pain for the
streaming driver's million-line jobs.  ``SegmentedJobLedger`` keeps the
record format but rotates the append file at ``rotate_records`` records
or ``rotate_bytes`` bytes.  Sealing a segment appends ONE fsync'd line to
``index.jsonl`` carrying the segment's ``[custom_id, offset, nbytes]``
locators; a resume therefore reads the index (ids + locators only, no
rows) plus the single live tail segment — reopen is O(segment), not
O(job), and no row body is ever resident unless explicitly read back
through its locator (``read_row`` / ``write_merged``).  Torn-line
truncation applies only to the newest (tail) segment and the index —
sealed segments were fsync'd before their seal record committed and are
never rewritten.  First-wins dedup spans segments: the earliest committed
locator for a ``custom_id`` is the row, across any crash/requeue race.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import (Any, Dict, IO, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

from repro_torch.core.events import SeqFinishedEvent

LEDGER_VERSION = 1
SEGMENT_VERSION = 1


class LedgerError(RuntimeError):
    pass


class JobLedger:
    """Append-only jsonl write-ahead ledger for one batch job."""

    def __init__(self, path: str):
        self.path = path
        self._fh: Optional[IO[str]] = None
        self.submitted: List[str] = []      # custom_ids in submit order
        self.finished: Dict[str, Dict[str, Any]] = {}   # custom_id -> row
        self.meta: Dict[str, Any] = {}
        self.torn_records = 0

    # ------------------------------------------------------------------ io
    def open(self) -> "JobLedger":
        """Load any existing records (tolerating a torn trailing line from
        a mid-write SIGKILL, which is truncated away) and open the file
        for appending.  Returns self."""
        if os.path.exists(self.path):
            self._load()
        dirn = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(dirn, exist_ok=True)
        fresh = not os.path.exists(self.path)
        self._fh = open(self.path, "a")
        if fresh or not self.meta:
            self._append({"kind": "meta", "version": LEDGER_VERSION})
        return self

    def _load(self) -> None:
        with open(self.path, "rb") as f:
            data = f.read()
        # a torn trailing line (no final newline, or unparseable) never
        # committed: drop it AND truncate the file so the next append
        # starts on a clean line instead of corrupting two records
        keep = len(data)
        if data and not data.endswith(b"\n"):
            keep = data.rfind(b"\n") + 1
            self.torn_records += 1
        for line in data[:keep].splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                self.torn_records += 1      # interior corruption: skip
                continue
            kind = rec.get("kind")
            if kind == "meta":
                self.meta = rec
                if rec.get("version", 1) > LEDGER_VERSION:
                    raise LedgerError(
                        f"ledger {self.path} written by a newer version "
                        f"({rec.get('version')} > {LEDGER_VERSION})")
            elif kind == "submit":
                self.submitted.append(rec["custom_id"])
            elif kind == "output":
                # first-wins: a duplicate append (crash between fsync and
                # scheduler advance) must not change the emitted row
                self.finished.setdefault(rec["custom_id"], rec["row"])
        if keep < len(data):
            with open(self.path, "ab") as f:
                f.truncate(keep)

    def _append(self, rec: Dict[str, Any]) -> None:
        assert self._fh is not None, "ledger not open"
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # ------------------------------------------------------------- protocol
    def record_submitted(self, custom_ids: Sequence[str]) -> None:
        """Write the job's request manifest (idempotent on resume: ids
        already in the ledger are not re-recorded)."""
        known = set(self.submitted)
        for cid in custom_ids:
            if cid not in known:
                self._append({"kind": "submit", "custom_id": cid})
                self.submitted.append(cid)

    def record_output(self, custom_id: str, row: Dict[str, Any]) -> bool:
        """Durably append one finished row BEFORE the caller treats the
        request as done.  Returns False (and writes nothing) if the id
        already has a committed row — exactly-once by first-wins."""
        if custom_id in self.finished:
            return False
        self._append({"kind": "output", "custom_id": custom_id, "row": row})
        self.finished[custom_id] = row
        return True

    def pending(self, custom_ids: Sequence[str]) -> List[str]:
        return [c for c in custom_ids if c not in self.finished]


# ---------------------------------------------------------------------------
# chunked segment rotation
# ---------------------------------------------------------------------------


def _read_clean_lines(path: str) -> Tuple[List[bytes], int]:
    """Read a ledger jsonl file tolerating a torn trailing line from a
    mid-write SIGKILL: the torn tail is truncated away (the record never
    committed) and the clean lines are returned.  Returns (lines,
    torn_count)."""
    with open(path, "rb") as f:
        data = f.read()
    torn = 0
    keep = len(data)
    if data and not data.endswith(b"\n"):
        keep = data.rfind(b"\n") + 1
        torn += 1
    if keep < len(data):
        with open(path, "ab") as f:
            f.truncate(keep)
    return data[:keep].splitlines(), torn


class SegmentedJobLedger:
    """Write-ahead output ledger with chunked segment rotation.

    Layout under ``root/``::

        index.jsonl       meta + one fsync'd "seal" record per sealed
                          segment: {"kind": "seal", "segment": k,
                          "records": n, "loc": [[custom_id, off, len], ..]}
        seg-00000000.jsonl  append-only output records (JobLedger format)
        seg-00000001.jsonl  ...

    ``open()`` loads the index and replays ONLY the live tail segment —
    ``replayed_segments`` reports how many segment files were actually
    parsed (the O(segment)-reopen acceptance bar).  Rows are not held in
    memory; ``finished`` maps ``custom_id -> (segment, offset, nbytes)``
    locators and ``read_row`` / ``write_merged`` fetch bodies on demand.

    ``fsync_every`` batches fsyncs (group commit): a crash can lose at
    most the last ``fsync_every`` *unsynced* rows, which simply re-run on
    resume — "finished" means durable, so correctness is unaffected.
    Seals and ``close()`` always fsync.
    """

    def __init__(self, root: str, *, rotate_records: int = 50_000,
                 rotate_bytes: int = 64 << 20, fsync_every: int = 64):
        assert rotate_records > 0 and rotate_bytes > 0
        self.root = root
        self.rotate_records = int(rotate_records)
        self.rotate_bytes = int(rotate_bytes)
        self.fsync_every = max(int(fsync_every), 1)
        self.finished: Dict[str, Tuple[int, int, int]] = {}   # cid -> loc
        # streaming partial progress: cid -> next expected token offset.
        # Advanced by ``record_partial``; carried through seals and tail
        # replay so a resumed run refuses re-emitted partial rows.
        self.partial_off: Dict[str, int] = {}
        self.meta: Dict[str, Any] = {}
        self.torn_records = 0
        self.replayed_segments = 0      # segment FILES parsed at open()
        self.sealed_segments = 0
        self.duplicates_refused = 0
        self.partial_duplicates_refused = 0
        self.partial_gaps = 0       # blocks journaled past the expected
        #                             offset (should be 0: a gap means a
        #                             producer skipped tokens)
        self._live_seg = 0
        self._seg_records = 0
        self._seg_bytes = 0
        self._seg_loc: List[List] = []      # [cid, off, nbytes] this segment
        self._unsynced = 0
        self._fh: Optional[IO[bytes]] = None
        self._idx_fh: Optional[IO[str]] = None
        self._readers: Dict[int, IO[bytes]] = {}

    # ------------------------------------------------------------------ paths
    def _seg_path(self, k: int) -> str:
        return os.path.join(self.root, f"seg-{k:08d}.jsonl")

    @property
    def _index_path(self) -> str:
        return os.path.join(self.root, "index.jsonl")

    @property
    def live_segment(self) -> int:
        return self._live_seg

    # ------------------------------------------------------------------ open
    def open(self) -> "SegmentedJobLedger":
        os.makedirs(self.root, exist_ok=True)
        fresh = not os.path.exists(self._index_path)
        if not fresh:
            self._load_index()
            self._replay_tail()
        self._idx_fh = open(self._index_path, "a")
        if fresh:
            self._append_index({"kind": "meta", "version": SEGMENT_VERSION,
                                "rotate_records": self.rotate_records,
                                "rotate_bytes": self.rotate_bytes})
        self._fh = open(self._seg_path(self._live_seg), "ab")
        return self

    def _load_index(self) -> None:
        """Sealed-segment state comes from the index alone: ids + locators,
        never row bodies.  A torn trailing seal (crash mid-seal) is
        truncated; its segment is then the live tail and replays fully."""
        lines, torn = _read_clean_lines(self._index_path)
        self.torn_records += torn
        for line in lines:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                self.torn_records += 1
                continue
            kind = rec.get("kind")
            if kind == "meta":
                self.meta = rec
                if rec.get("version", 1) > SEGMENT_VERSION:
                    raise LedgerError(
                        f"segmented ledger {self.root} written by a newer "
                        f"version ({rec.get('version')} > {SEGMENT_VERSION})")
            elif kind == "seal":
                seg = int(rec["segment"])
                self.sealed_segments += 1
                self._live_seg = max(self._live_seg, seg + 1)
                for cid, off, n in rec["loc"]:
                    # first-wins across segments: the earliest committed
                    # locator is THE row for this custom_id
                    self.finished.setdefault(cid, (seg, int(off), int(n)))
                # seals snapshot the live partial-progress map so a resume
                # never re-reads sealed segment bodies to rebuild it;
                # later seals carry later snapshots and override
                for cid, off in rec.get("partial_off", {}).items():
                    self.partial_off[cid] = int(off)

    def _replay_tail(self) -> None:
        """Parse the one live (unsealed) tail segment — the only segment
        file a resume ever reads."""
        path = self._seg_path(self._live_seg)
        if not os.path.exists(path):
            return
        self.replayed_segments = 1
        lines, torn = _read_clean_lines(path)
        self.torn_records += torn
        off = 0
        for line in lines:
            nbytes = len(line) + 1          # + newline
            if line.strip():
                try:
                    rec = json.loads(line)
                except ValueError:
                    self.torn_records += 1
                    off += nbytes
                    continue
                if rec.get("kind") == "output":
                    cid = rec["custom_id"]
                    loc = (self._live_seg, off, nbytes)
                    if cid in self.finished:
                        self.duplicates_refused += 1
                    else:
                        self.finished[cid] = loc
                        self._seg_loc.append([cid, off, nbytes])
                    self.partial_off.pop(cid, None)
                elif rec.get("kind") == "partial":
                    cid = rec["custom_id"]
                    if cid not in self.finished:
                        self.partial_off[cid] = max(
                            self.partial_off.get(cid, 0),
                            int(rec["off"]) + len(rec["tokens"]))
                self._seg_records += 1
            off += nbytes
        self._seg_bytes = off

    # ------------------------------------------------------------------ write
    def record_output(self, custom_id: str, row: Dict[str, Any]) -> bool:
        """Durably append one finished row; False (nothing written) if the
        id already committed — exactly-once by first-wins, across
        segments and across a crashed run's requeue race.  The same
        first-wins gate dedupes hedged re-execution: when the scheduler
        races a straggler against a speculative clone, both finishers
        surface under one custom_id and only the first commits."""
        if custom_id in self.finished:
            self.duplicates_refused += 1
            return False
        assert self._fh is not None, "ledger not open"
        line = (json.dumps({"kind": "output", "custom_id": custom_id,
                            "row": row}) + "\n").encode()
        off = self._seg_bytes
        self._fh.write(line)
        self._fh.flush()
        self._unsynced += 1
        if self._unsynced >= self.fsync_every:
            os.fsync(self._fh.fileno())
            self._unsynced = 0
        self.finished[custom_id] = (self._live_seg, off, len(line))
        self._seg_loc.append([custom_id, off, len(line)])
        self.partial_off.pop(custom_id, None)   # full row supersedes
        self._seg_records += 1
        self._seg_bytes += len(line)
        if (self._seg_records >= self.rotate_records
                or self._seg_bytes >= self.rotate_bytes):
            self._rotate()
        return True

    def record_partial(self, custom_id: str, offset: int,
                       tokens: Sequence[int]) -> bool:
        """Journal a partial token block for a still-running request (the
        streaming driver flushes every ``TokenBlockEvent`` here, so a
        consumer tailing the segments sees tokens while the row is in
        flight).  Exactly-once per token offset: a block at an offset the
        ledger has already committed — a finished row, or a requeued
        recompute re-emitting its (bitwise-identical) prefix — is refused
        without writing.  Returns True iff the block was journaled."""
        if custom_id in self.finished:
            self.partial_duplicates_refused += 1
            return False
        expected = self.partial_off.get(custom_id, 0)
        if offset < expected:
            # a recompute (replica drain / crash resume) replays from
            # offset 0; determinism makes the refused prefix identical to
            # what is already durable, so dropping it loses nothing
            self.partial_duplicates_refused += 1
            return False
        if offset > expected:
            # journaled anyway (the tokens are real), but a skipped window
            # means some producer lost blocks — surface it in the report
            self.partial_gaps += 1
        assert self._fh is not None, "ledger not open"
        line = (json.dumps({"kind": "partial", "custom_id": custom_id,
                            "off": int(offset),
                            "tokens": [int(t) for t in tokens]})
                + "\n").encode()
        self._fh.write(line)
        self._fh.flush()
        self._unsynced += 1
        if self._unsynced >= self.fsync_every:
            os.fsync(self._fh.fileno())
            self._unsynced = 0
        self.partial_off[custom_id] = int(offset) + len(tokens)
        self._seg_records += 1
        self._seg_bytes += len(line)
        if (self._seg_records >= self.rotate_records
                or self._seg_bytes >= self.rotate_bytes):
            self._rotate()
        return True

    def _rotate(self) -> None:
        """Seal the live segment: fsync it, commit its locator line to the
        index, then start a fresh segment.  Crash windows are all safe —
        before the seal fsyncs, the old segment is simply the tail and
        replays; after, the (possibly not-yet-created) next segment is."""
        assert self._fh is not None
        os.fsync(self._fh.fileno())
        self._unsynced = 0
        self._fh.close()
        self._append_index({"kind": "seal", "segment": self._live_seg,
                            "records": self._seg_records,
                            "loc": self._seg_loc,
                            "partial_off": dict(self.partial_off)})
        self.sealed_segments += 1
        self._live_seg += 1
        self._seg_records = 0
        self._seg_bytes = 0
        self._seg_loc = []
        self._fh = open(self._seg_path(self._live_seg), "ab")

    def _append_index(self, rec: Dict[str, Any]) -> None:
        assert self._idx_fh is not None
        self._idx_fh.write(json.dumps(rec) + "\n")
        self._idx_fh.flush()
        os.fsync(self._idx_fh.fileno())

    def close(self) -> None:
        for fh in self._readers.values():
            fh.close()
        self._readers = {}
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._unsynced = 0
            self._fh.close()
            self._fh = None
        if self._idx_fh is not None:
            self._idx_fh.close()
            self._idx_fh = None

    # ------------------------------------------------------------------ read
    def has(self, custom_id: str) -> bool:
        return custom_id in self.finished

    def __len__(self) -> int:
        return len(self.finished)

    def pending(self, custom_ids: Sequence[str]) -> List[str]:
        return [c for c in custom_ids if c not in self.finished]

    def _reader(self, seg: int) -> IO[bytes]:
        fh = self._readers.get(seg)
        if fh is None:
            fh = self._readers[seg] = open(self._seg_path(seg), "rb")
        return fh

    def read_record(self, custom_id: str) -> Optional[bytes]:
        """The raw committed ledger line for one finished id (locator
        pread — no segment scan)."""
        loc = self.finished.get(custom_id)
        if loc is None:
            return None
        seg, off, n = loc
        if seg == self._live_seg and self._fh is not None:
            self._fh.flush()
        fh = self._reader(seg)
        fh.seek(off)
        return fh.read(n)

    def read_row(self, custom_id: str) -> Optional[Dict[str, Any]]:
        raw = self.read_record(custom_id)
        if raw is None:
            return None
        return json.loads(raw)["row"]

    def write_merged(self, custom_ids: Iterable[str], out) -> int:
        """Stream the rows for ``custom_ids`` (typically the job's input
        order) to the text file object ``out`` as jsonl; ids without a
        committed row are skipped.  Returns rows written.  Deterministic
        given deterministic rows — the byte-identical-resume contract."""
        n = 0
        for cid in custom_ids:
            row = self.read_row(cid)
            if row is None:
                continue
            out.write(json.dumps(row) + "\n")
            n += 1
        return n

    def iter_finished(self) -> Iterator[str]:
        return iter(self.finished)


# ---------------------------------------------------------------------------
# resumable driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LedgerRunResult:
    rows: List[Dict[str, Any]]      # one per request, input order
    resumed: int                    # rows served from the ledger
    computed: int                   # rows decoded by this run
    report: Optional[Dict] = None   # scheduler report (None if no work)


def run_resumable(master, requests: Sequence, ledger_path: str,
                  max_ticks: int = 100000,
                  on_output=None) -> LedgerRunResult:
    """Run ``requests`` through ``master`` (a ``BatchMaster``) with
    write-ahead progress in ``ledger_path``.  On a fresh ledger this is a
    normal batch run that happens to journal every finish; after a crash,
    rerunning with the same arguments skips every journaled request (zero
    recompute of finished sequences) and decodes only the remainder.
    Returns all rows in input order — byte-identical to an uninterrupted
    run, because the runtime's decode is deterministic.

    ``on_output(custom_id, n_finished)`` fires after each row commits —
    chaos harnesses use it to SIGKILL the process at a deterministic
    point in the batch."""
    by_id: Dict[str, Any] = {}
    for r in requests:
        if r.custom_id in by_id:
            raise LedgerError(
                f"duplicate custom_id {r.custom_id!r}: the ledger keys "
                f"progress by custom_id, so ids must be unique per job")
        by_id[r.custom_id] = r
    led = JobLedger(ledger_path).open()
    try:
        led.record_submitted([r.custom_id for r in requests])
        todo = [by_id[cid] for cid in led.pending([r.custom_id
                                                   for r in requests])]
        resumed = len(requests) - len(todo)
        rep = None
        if todo:
            bid = master.submit(todo)
            for rec in master.stream(bid, max_ticks=max_ticks):
                if isinstance(rec, SeqFinishedEvent) \
                        and rec.custom_id is not None:
                    row = master.result_row(bid, rec.seq_id)
                    if row is not None and led.record_output(
                            rec.custom_id, row) and on_output is not None:
                        on_output(rec.custom_id, len(led.finished))
            bo = master.retrieve(bid)
            rep = {"status": bo.status,
                   "scheduler_status": getattr(bo, "scheduler_status", None),
                   "bct_s": getattr(bo, "bct_s", None)}
        rows = [led.finished[r.custom_id] for r in requests
                if r.custom_id in led.finished]
        return LedgerRunResult(rows=rows, resumed=resumed,
                               computed=len(led.finished) - resumed,
                               report=rep)
    finally:
        led.close()
