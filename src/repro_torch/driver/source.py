"""Bounded streaming reader for jsonl batch-input files.

A million-request job must never materialize a million ``BatchRequest``
objects: the driver pulls from this source only when its in-flight
window has room, so resident parsed requests stay O(window).  On resume
the source *peeks* each line's ``custom_id`` (cheap dict access, no
request materialization) and skips anything the ledger already holds.
"""
from __future__ import annotations

import json
from typing import Callable, Iterator, List, Optional

from repro_torch.runtime.api import BatchRequest


def iter_custom_ids(path: str) -> Iterator[str]:
    """Yield ``custom_id`` of every well-formed input line, in input
    order — the merge key for the final output file.  Skips blank and
    malformed lines exactly like ``JsonlRequestSource`` does, so the
    merged file and the request stream agree on the id sequence."""
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue
            cid = d.get("custom_id")
            if cid is not None:
                yield cid


class JsonlRequestSource:
    """Lazy jsonl request stream with resume-skip.

    ``take(n)`` parses at most ``n`` fresh requests; the driver calls it
    with exactly its window headroom.  ``skip`` (typically
    ``ledger.has``) filters finished ids before a ``BatchRequest`` is
    ever built."""

    def __init__(self, path: str,
                 skip: Optional[Callable[[str], bool]] = None):
        self.path = path
        self._skip = skip or (lambda cid: False)
        self._fh = None
        self.exhausted = False
        self.lines_read = 0       # non-blank lines consumed
        self.bad_lines = 0        # unparseable json (counted, skipped)
        self.skipped = 0          # resume-skip / duplicate-skip hits
        self.emitted = 0          # requests handed to the driver

    def open(self) -> "JsonlRequestSource":
        if self._fh is None:
            self._fh = open(self.path, "r", encoding="utf-8")
        return self

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def take(self, n: int) -> List[BatchRequest]:
        if self._fh is None:
            self.open()
        out: List[BatchRequest] = []
        while len(out) < n and not self.exhausted:
            line = self._fh.readline()
            if not line:
                self.exhausted = True
                break
            line = line.strip()
            if not line:
                continue
            self.lines_read += 1
            try:
                d = json.loads(line)
            except ValueError:
                self.bad_lines += 1
                continue
            cid = d.get("custom_id")
            if cid is not None and self._skip(cid):
                self.skipped += 1
                continue
            out.append(BatchRequest.from_dict(d))
        self.emitted += len(out)
        return out
