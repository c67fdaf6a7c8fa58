"""Streaming million-sequence job driver (paper §6.4 'Production
deployment' at job scale).

The batch API (`runtime/api.py`) answers "run THIS list of requests";
this package answers "run this FILE of a million requests on whatever
capacity I have right now":

* ``JsonlRequestSource`` streams the input file — requests are parsed
  lazily under a bounded in-flight window, never the whole job.
* ``ReplicaHandle`` wraps one data-parallel replica: a ``BatchMaster``
  + ``CoroutineScheduler`` over its own node group, fed through the
  incremental ``open``/``append``/``pump`` surface.
* ``StreamingJobDriver`` owns the loop: fill window → dispatch to
  replicas → pump → journal finished rows into a segment-rotated
  ``SegmentedJobLedger`` (crash-resumable, O(tail-segment) replay) →
  finally merge to an input-order jsonl output file.  Replicas are
  elastic: ``scale_up()`` adds one mid-job, ``drain()`` retires one
  with zero lost requests, and a replica that dead-letters is drained
  automatically (first-wins ledger makes the requeue race benign).
"""
from repro_torch.driver.driver import (DriverConfig, DriverResult,
                                       StreamingJobDriver)
from repro_torch.driver.replica import ReplicaHandle
from repro_torch.driver.source import JsonlRequestSource, iter_custom_ids

__all__ = ["DriverConfig", "DriverResult", "StreamingJobDriver",
           "ReplicaHandle", "JsonlRequestSource", "iter_custom_ids"]
