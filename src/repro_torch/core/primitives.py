"""The four coroutine primitives: YIELD / COMBINE / PARTITION / MIGRATE.

These are engine-agnostic: any object implementing the formal
``ExecutionBackend`` protocol (core/backend.py — extract_slot /
install_slot / free_slot / ..., .host_store, .allocator, .stats) can host
coroutines — the PyTorch engine (runtime/engine.py) declares conformance.

Semantics (paper §4.2):
* yield_  — suspend at a module boundary: checkpoint state to the host
            store, release the device slot, mark INACTIVE.  Control returns
            to the scheduler.
* combine — merge inactive coroutines into the active batch; resume is
            implicit (there is no separate resume primitive).
* partition — split one straggler's computation across a device group
            (TP for a single sequence, DP for several); requires the
            coroutine to have yielded first so its state is checkpointed.
* migrate — move a coroutine's host-resident state to another node.
* fork    — clone a submitted coroutine into a sibling that shares the
            prompt (and, once prefilled, the prompt's KV span pages
            copy-on-write); siblings diverge at their first sampled token.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

from repro_torch.core.coroutine import Phase, SequenceCoroutine, Status


class PrimitiveStats:
    def __init__(self):
        self.counts = {"yield": 0, "combine": 0, "partition": 0,
                       "migrate": 0, "fork": 0}
        self.seconds = {k: 0.0 for k in self.counts}
        self.bytes_moved = {"yield": 0, "combine": 0, "migrate": 0}

    def record(self, kind: str, dt: float, nbytes: int = 0):
        self.counts[kind] += 1
        self.seconds[kind] += dt
        if kind in self.bytes_moved:
            self.bytes_moved[kind] += nbytes


def yield_(co: SequenceCoroutine, engine, *, keep_device: bool = False) -> None:
    """Suspend `co`: checkpoint its device state to the host store and free
    the slot.  With keep_device=True only the metadata transition happens
    (intra-forward yield: hidden states stay on device per Alg. 1)."""
    assert co.status == Status.ACTIVE, co.status
    t0 = time.monotonic()
    nbytes = 0
    if not keep_device and co.slot is not None:
        slices = engine.extract_slot(co)
        nbytes = sum(int(v.nbytes) for v in slices.values())
        engine.host_store.checkpoint(co.seq_id, slices, co.length)
        engine.allocator.free_seq(co.seq_id)
        engine.free_slot(co)
        co.slot = None
    co.status = Status.INACTIVE
    co.yields += 1
    co.fire("on_yield", None)
    engine.stats.record("yield", time.monotonic() - t0, nbytes)


def combine(cos: Sequence[SequenceCoroutine], engine, *,
            handoff: bool = False) -> List[SequenceCoroutine]:
    """Resume-by-combination: restore each coroutine's state into a free
    device slot and mark ACTIVE.  Returns the coroutines that were actually
    admitted (slot/page budget permitting).

    A host→device restore staged earlier through the ring buffer
    (``engine.stage_restore``, the h2d mirror of the d2h sync pipeline) is
    consumed via ``engine.take_restore`` — its PCIe copy already rode
    behind a decode page, so the install here pays no transfer wait.
    ``handoff=True`` marks the prefill→decode handoff (the sequence was
    never spilled mid-flight): it installs directly without touching the
    restore pipeline or its wait accounting."""
    admitted = []
    t0 = time.monotonic()
    nbytes = 0
    take = None if handoff else getattr(engine, "take_restore", None)
    for co in cos:
        if co.status not in (Status.INACTIVE, Status.INIT):
            continue
        slot = engine.acquire_slot(co)
        if slot is None:
            break
        co.slot = slot
        if engine.host_store.has(co.seq_id):
            slices = take(co.seq_id) if callable(take) else None
            if slices is None:
                slices = engine.host_store.restore(co.seq_id, engine.max_len)
            nbytes += sum(int(v.nbytes)
                          for v in slices.values())
            engine.install_slot(co, slices)
        co.status = Status.ACTIVE
        admitted.append(co)
    engine.stats.record("combine", time.monotonic() - t0, nbytes)
    return admitted


def partition(co: SequenceCoroutine, engine, device_group: List[int]) -> None:
    """Straggler acceleration: assign `co` to a tensor-parallel device
    group.  The engine reconfigures its decode step for the group (on TPU:
    re-lower with the group mesh; KV split across heads for GQA, latent
    replicated for MLA, sequence-split otherwise — DESIGN.md §3)."""
    assert co.status == Status.INACTIVE, "partition requires a prior yield"
    t0 = time.monotonic()
    co.partition_group = list(device_group)
    engine.reconfigure_partition(co, device_group)
    co.fire("on_partition", device_group)
    engine.stats.record("partition", time.monotonic() - t0)


def fork(co: SequenceCoroutine, seq_id: int,
         sampling=None) -> SequenceCoroutine:
    """Clone a not-yet-prefilled coroutine into a fan-out sibling.

    The sibling shares the prompt; both carry the lead's seq_id as their
    ``fork_group`` so the engine prefills the prompt once and binds every
    sibling to the same span pages (COW).  Divergence comes from sampling:
    with ``seed=None`` the token-addressable seeding keys each stream
    off its own seq_id, so fork(n) is bitwise-identical to n independent
    submissions."""
    assert co.status == Status.INIT, "fork requires a not-yet-prefilled lead"
    sib = SequenceCoroutine(
        seq_id=seq_id, prompt=list(co.prompt), max_out=co.max_out,
        max_in=co.max_in, sampling=sampling if sampling is not None
        else co.sampling, logprobs=co.logprobs,
        top_logprobs=co.top_logprobs, node=co.node)
    co.fork_group = co.fork_group if co.fork_group is not None else co.seq_id
    sib.fork_group = co.fork_group
    co.fire("on_fork", sib.seq_id)
    return sib


def migrate(co: SequenceCoroutine, src_engine, dst_engine) -> None:
    """Move host-resident state between nodes.  Asynchronous on a real
    deployment (overlapped with compute); here the copy is immediate and
    the overhead is accounted by the caller's clock model."""
    assert co.status in (Status.INACTIVE, Status.INIT)
    t0 = time.monotonic()
    # a staged-but-undrained KV blob (pipelined sync) must land before the
    # host state crosses nodes — otherwise the moved checkpoint would lag
    # the coroutine's generated tokens
    src_engine.drain_appends()
    # a restore staged toward the source's devices is now pointed at the
    # wrong node — drop it (and release its ring reservation) before the
    # state moves
    discard = getattr(src_engine, "discard_restore", None)
    if callable(discard):
        discard(co.seq_id)
    nbytes = 0
    if src_engine.host_store.has(co.seq_id):
        src_store = src_engine.host_store
        moved = {"n": src_store.seqs[co.seq_id].nbytes()}

        def _move():
            # pop + release on the source index FIRST (while prefix_node
            # still names the source chain), then adopt on the destination:
            # shared span pages cross once per span — a sibling that
            # migrated earlier makes this sequence's span free
            st = src_store.pop_state(co.seq_id)
            src_node = st.prefix_node
            moved["n"] = dst_engine.host_store.adopt(co.seq_id, st)
            if src_node is not None and src_store.prefix_index is not None:
                src_store.prefix_index.release(src_node)
        # the inter-node blob move is a guarded transfer when the backend
        # provides the envelope (retry/backoff; a dead-letter propagates —
        # the scheduler's failure handlers fall back to recompute)
        xfer = getattr(src_engine, "transfer", None)
        if callable(xfer):
            xfer("migrate", _move)
        else:
            _move()
        nbytes = moved["n"]
    co.node = dst_engine.node_id
    co.migrations += 1
    co.fire("on_migrate", dst_engine.node_id)
    src_engine.stats.record("migrate", time.monotonic() - t0, nbytes)
