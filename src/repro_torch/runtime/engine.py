"""Per-node batch-inference engine in PyTorch: real execution on one card
plus coroutine slots.

Counterpart of ``repro.runtime.engine.NodeEngine`` for dense and MoE
decoders, MLA ones (DeepSeek-R1) among them: greedy, sampled and logprob
requests.  One NodeEngine owns a dense device decode cache with
``max_active`` sequence slots, a paged host store (the single source of
truth, §5.2), a page allocator, and the prefill / decode steps of
``models/transformer.py``.  The CoroutineScheduler drives it only
through the ExecutionBackend slot protocol (core/backend.py, conformance
declared below), exactly as it drives the JAX engine.

What differs from the JAX engine, and why:

* PyTorch runs eagerly, so there are no jitted executables to bucket or
  cache; the shapes the JAX engine buckets to bound its jit caches (pow2
  prefill batches and lengths, pow2 decode chunks) are kept.
* A dense model's fresh prompts are prefilled one at a time (an MoE
  batch stays whole): cuBLAS picks a bf16 GEMM's kernel by its shape (a
  row of the MLP's down projection has other bits at 128 rows than at
  256), so a shared batch's padding would make a request's tokens depend
  on its batch, and a resumed job would not repeat a clean run's bytes.
* Caches are written in place where JAX donates them.
* Host pages of a bf16 cache are ``uint16`` bit views (numpy has no
  bf16); ``compat.to_numpy`` / ``compat.from_numpy`` convert at the
  boundary with the cache dtype noted on the engine.
* The async device->host copy of ``stage_appends`` is a ``non_blocking``
  copy into pinned memory on a side stream with a CUDA event
  (``compat.HostCopy``); ``drain_appends`` waits on the event.

Decode megastep: ``decode_page`` runs ``min(P, max remaining)`` steps
as pow2 chunks (40 -> 32 + 8) of ``transformer.decode_page``; tokens,
lengths, the per-slot ``remaining`` countdown and the cache stay on the
device, and the page's token block crosses to the host in ONE copy
(counted in ``d2h_transfers``).  When any active coroutine asks for
logprobs the block is the packed (P, B, 2+2K) plane of
``transformer.pack_logprob_block`` instead, in the same one copy.

Sampling: when any active coroutine carries non-default SamplingParams
the page runs the sampled variant, with the per-slot PRNG position and
penalty counts of ``repro_torch.sampling`` carried on the device and a
static ``SampleFlags`` plan derived on the host from the active batch
(the fused sampling kernel; penalty / stop / greedy-select skips).  The
slot's sampling state is re-derived from the coroutine at
``install_slot`` (keys are fold_in(seed, token index), counts a bincount
of its tokens), staged on the host and written to the device in one
batched scatter at the next sampled page, so slot churn never perturbs a
sequence's stream.  The first token of a sampled prefill batch is drawn
on the device with key fold_in(seed, 0).  An all-greedy page keeps the
argmax and never runs the sampler.

Module granularity (Algorithm 1): with ``module_granularity=True`` each
pow2 decode chunk runs through ``core.forward.ModuleRuntime``: attention
per sub-batch of ``b_attn`` rows (default ``max_active``: one sub-batch),
then COMBINE of the sub-batches into the whole batch before each FFN/MoE.
Prefill stays monolithic, as in the JAX engine.

The cache's leaves are whatever ``transformer.init_cache`` gives: GQA's
{"k", "v"} (L, B, S, Hkv, dh), or MLA's latent {"ckv", "kr"} (L, B, S,
r) with no head axis; the host pages, staging blobs and installs handle
each leaf by its trailing dims, and all leaves share one dtype.

Not in this slice, and refused with ``NotImplementedError``: MLA with
``module_granularity=True`` (the JAX ``ModuleRuntime`` reads GQA's
``cache["k"]``, so the reference has no such path), sliding-window
configs, and the other families.  The JAX engine's looped ``fused=False``
baseline is not ported.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import compat
from repro_torch import sampling as smp
from repro_torch.core.backend import validate_backend
from repro_torch.core.coroutine import Phase, SequenceCoroutine, Status
from repro_torch.core.forward import (ModuleRuntime,
                                      check_module_granularity)
from repro_torch.core.primitives import PrimitiveStats
from repro_torch.memory.allocator import PageAllocator
from repro_torch.memory.buffers import RingBuffer
from repro_torch.memory.paged_kv import HostKVStore
from repro_torch.models import transformer as T
from repro_torch.models.api import ModelConfig
from repro_torch.runtime.failure import DeviceStatus, Heartbeat
from repro_torch.runtime.faults import (NodeFaults, RetryPolicy,
                                        TransferDeadLetter, guarded_transfer)

# staging-path PCIe-class bandwidth for the ring buffer's timing model
# (core/plan.py Hardware.host_link_bw); the live gate only uses occupancy
_HOST_LINK_BW = 32e9
# the per-slot sampling-params rows the batched sampler consumes
_SAMPLE_ROW_KEYS = ("temperature", "top_k", "top_p", "min_p",
                    "repetition_penalty", "presence_penalty",
                    "frequency_penalty")


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class _InFlightSync:
    """One staged KV blob: the gathered device tensor (then the host copy
    issued for it), plus everything needed to land it in the host store
    later: the leaf layout and the per-slot ``(seq_id, start, n, first)``
    spans snapshotted at issue time."""
    __slots__ = ("blob", "metas", "snaps", "nbytes", "name")

    def __init__(self, blob, metas, snaps, nbytes, name):
        self.blob = blob
        self.metas = metas
        self.snaps = snaps
        self.nbytes = nbytes
        self.name = name


def _np_top_k_idx(x: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest entries, ties broken by the LOWEST index,
    as on the device plane (``argsort()[::-1]`` would take the highest)."""
    return np.argsort(-x, kind="stable")[:k]


def _np_log_softmax(x: np.ndarray) -> np.ndarray:
    """Host-side log-softmax over the last axis (prefill logprobs; decode
    pages compute theirs on the device)."""
    x = np.asarray(x, np.float32)
    m = x.max(axis=-1, keepdims=True)
    e = np.exp(x - m)
    return (x - m) - np.log(e.sum(axis=-1, keepdims=True))


class NodeEngine:
    def __init__(self, cfg: ModelConfig, *, node_id: int = 0,
                 max_active: int = 8, max_len: int = 256,
                 page_size: int = 32, num_devices: int = 1,
                 device_pages: Optional[int] = None,
                 module_granularity: bool = False, b_attn: int = 0,
                 overlap: bool = True,
                 ring_buffer_bytes: Optional[int] = None,
                 restore_ring_bytes: Optional[int] = None, seed: int = 0,
                 params=None, device=None,
                 faults: Optional[NodeFaults] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 enable_prefix: bool = True):
        T.check_served(cfg)
        if module_granularity:
            check_module_granularity(cfg)
        self.device = compat.resolve_device(device)
        self.cfg = cfg
        self.node_id = node_id
        self.max_active = max_active
        self.max_len = max_len
        self.num_devices = num_devices
        self.page_size = page_size
        self.overlap = overlap

        self.params = (params if params is not None
                       else T.init_params(cfg, seed, self.device))
        self.module_rt = (ModuleRuntime(cfg, self.params)
                          if module_granularity else None)
        self.b_attn = b_attn or max_active
        self.host_store = HostKVStore(page_size, enable_prefix=enable_prefix)
        total_pages = device_pages or (max_active * max_len // page_size * 2)
        self.allocator = PageAllocator(total_pages, page_size)
        self.stats = PrimitiveStats()

        # ---- robustness (§5.6): fault injection + guarded transfers -------
        self.faults = faults
        self.retry_policy = retry_policy or RetryPolicy()
        self.transfer_stats = {"retries": 0, "timeouts": 0, "dead_letters": 0}
        self.dead_lettered = False
        self.oom_rejections = 0
        self.straggler_steps = 0
        self.abandoned_blobs = 0

        # device slot arrays
        self.cache = T.init_cache(cfg, max_active, max_len, self.device)
        # host pages: uint16 if bf16; a staged blob concatenates the
        # leaves, so they must share one dtype (as in the JAX engine)
        dtypes = {leaf.dtype for leaf in self.cache.values()}
        assert len(dtypes) == 1, f"cache leaves of mixed dtypes {dtypes}"
        self.dtype = dtypes.pop()
        self.tokens = torch.zeros((max_active,), dtype=torch.int32,
                                  device=self.device)
        self.lengths = torch.zeros((max_active,), dtype=torch.int32,
                                   device=self.device)
        self.slot_owner: List[Optional[int]] = [None] * max_active
        self.synced_len: Dict[int, int] = {}

        # per-slot sampling params (host mirror, uploaded lazily) and the
        # device sampling state the sampled page carries
        V = T.padded_vocab(cfg)
        self._sp_host = smp.pack_params([smp.SamplingParams()] * max_active,
                                        list(range(max_active)))
        self._sp_dev: Optional[Dict[str, torch.Tensor]] = None
        self._sample_state = {
            "base_key": torch.zeros((max_active, 2), dtype=torch.int64,
                                    device=self.device),
            "gen_count": torch.zeros((max_active,), dtype=torch.int32,
                                     device=self.device),
            "counts": torch.zeros((max_active, V), dtype=torch.int32,
                                  device=self.device),
            "prompt_counts": torch.zeros((max_active, V), dtype=torch.int32,
                                         device=self.device),
        }
        # slot installs stage their re-derived sampling state here (host
        # numpy, keyed by slot so a re-install overwrites); the next
        # sampled page writes them all in one batched scatter
        self._pending_smp: "OrderedDict[int, tuple]" = OrderedDict()

        self.decode_steps = 0
        self.tokens_out = 0.0       # heartbeat progress counter
        self.prefill_tokens = 0
        self.prefill_tokens_saved = 0   # prompt tokens served from shared KV
        self.d2h_transfers = 0      # device->host copies through _to_host

        # ---- pipelined host-KV staging (stage_appends / drain_appends) ----
        self._blob_metas = [(name, tuple(leaf.shape[3:]),
                             int(np.prod(leaf.shape[3:])) if leaf.shape[3:]
                             else 1)
                            for name, leaf in self.cache.items()]
        self._inflight: Deque[_InFlightSync] = deque()
        page_blob = sum(leaf.element_size() * leaf.shape[0]
                        * _pow2(max_active) * _pow2(page_size) * f
                        for (_, _, f), leaf in zip(self._blob_metas,
                                                   self.cache.values()))
        self.ring = RingBuffer(ring_buffer_bytes or 2 * page_blob,
                               _HOST_LINK_BW)
        self._sync_tag = 0
        self.sync_stages = 0
        self.sync_drains = 0
        self.sync_stalls = 0
        self.sync_wait_s = 0.0
        self.staged_bytes = 0

        # ---- batched slot installs (COMBINE/refill) -----------------------
        self._pending_install: "OrderedDict[int, tuple]" = OrderedDict()

        # ---- staged h2d restores (stage_restore / take_restore) -----------
        seq_blob = max(page_blob * max_len
                       // (_pow2(max_active) * _pow2(page_size)), 1)
        self.restore_ring = RingBuffer(restore_ring_bytes or 2 * seq_blob,
                                       _HOST_LINK_BW)
        self._restore_staged: "OrderedDict[int, tuple]" = OrderedDict()
        self.restore_stages = 0
        self.restore_stalls = 0
        self.restore_wait_s = 0.0
        self.restore_stage_hidden_s = 0.0
        self.restore_staged_bytes = 0

    # ------------------------------------------------------------- protocol
    def clock(self) -> float:
        return time.monotonic()

    def idle_tick(self):
        pass

    def heartbeat(self) -> Optional[Heartbeat]:
        """This round's liveness beat; None for a dead or heartbeat-
        suppressed node."""
        if self.faults is not None and (
                self.faults.dead or self.faults.heartbeat_suppressed()):
            return None
        return Heartbeat(self.node_id, self.clock(),
                         [DeviceStatus(d) for d in range(self.num_devices)],
                         decode_steps=self.decode_steps,
                         tokens=self.tokens_out)

    def transfer(self, kind: str, fn):
        """Run one risky host transfer through the retry/timeout/dead-
        letter envelope (ExecutionBackend.transfer)."""
        return guarded_transfer(self, kind, fn)

    def acquire_slot(self, co: SequenceCoroutine) -> Optional[int]:
        if self.faults is not None:
            if self.faults.dead:
                return None
            if self.faults.oom_active():
                self.oom_rejections += 1
                return None
        if not self.allocator.can_admit(2):
            return None
        for s, owner in enumerate(self.slot_owner):
            if owner is None:
                self.slot_owner[s] = co.seq_id
                self.allocator.alloc(co.seq_id, 2)
                return s
        return None

    def free_slot(self, co: SequenceCoroutine):
        if co.slot is not None and self.slot_owner[co.slot] == co.seq_id:
            self.slot_owner[co.slot] = None
            self.lengths[co.slot] = 0

    def extract_slot(self, co: SequenceCoroutine) -> Dict[str, np.ndarray]:
        self._flush_pending_installs()
        s = co.slot
        return {name: compat.to_numpy(leaf[:, s])
                for name, leaf in self.cache.items()}

    def install_slot(self, co: SequenceCoroutine, slices: Dict):
        """Stage a COMBINE resume; ``_flush_pending_installs`` applies all
        staged installs in one batched scatter at the next consumer of
        device state.  Re-installing the same slot overwrites its entry."""
        self._pending_install[co.slot] = (slices, int(co.last_token),
                                          int(co.length))
        self.synced_len[co.seq_id] = co.length
        self._install_sampling(co)

    def _slot_tensor(self, arr, leaf: torch.Tensor) -> torch.Tensor:
        """A restored (L, len, ...) slice as a device tensor of the leaf's
        (L, S, ...) slot shape (padded or cropped)."""
        if not isinstance(arr, torch.Tensor):
            arr = compat.from_numpy(arr, leaf.dtype, self.device)
        S = leaf.shape[2]
        if arr.shape[1] < S:
            pad = arr.new_zeros((arr.shape[0], S - arr.shape[1])
                                + tuple(arr.shape[2:]))
            arr = torch.cat([arr, pad], dim=1)
        return arr[:, :S].to(device=self.device, dtype=leaf.dtype)

    def _install_now(self, s: int, slices: Dict, last_token: int,
                     length: int):
        """Per-slot install, only for slices missing cache leaves (a
        partial checkpoint must not zero the leaves it omits)."""
        for name, arr in slices.items():
            if name in self.cache:
                leaf = self.cache[name]
                leaf[:, s] = self._slot_tensor(arr, leaf)
        self.tokens[s] = last_token
        self.lengths[s] = length

    def _flush_pending_installs(self):
        """Apply all staged slot installs in one batched scatter per leaf
        (plus tokens and lengths), before anything reads device slot state
        (decode, extract, the sync gather)."""
        if not self._pending_install:
            return
        items = list(self._pending_install.items())
        self._pending_install.clear()
        names = [m[0] for m in self._blob_metas]
        full, partial = [], []
        for s, (slices, tok, ln) in items:
            dst = full if all(nm in slices for nm in names) else partial
            dst.append((s, slices, tok, ln))
        for s, slices, tok, ln in partial:
            self._install_now(s, slices, tok, ln)
        if not full:
            return

        def apply():
            idx = torch.tensor([s for s, *_ in full], dtype=torch.long,
                               device=self.device)
            for name, leaf in self.cache.items():
                leaf[:, idx] = torch.stack(
                    [self._slot_tensor(sl[name], leaf)
                     for _, sl, _, _ in full], dim=1)
            self.tokens[idx] = torch.tensor(
                [t for _, _, t, _ in full], dtype=torch.int32,
                device=self.device)
            self.lengths[idx] = torch.tensor(
                [ln for *_, ln in full], dtype=torch.int32,
                device=self.device)

        try:
            self.transfer("install", apply)
        except TransferDeadLetter:
            # the staged installs are lost and their slots hold stale
            # data; the scheduler sees ``dead_lettered`` and escalates to
            # NODE_FAILURE, whose recovery recomputes the sequences
            return

    def _install_sampling(self, co: SequenceCoroutine):
        """Bind a slot's sampling params and stage its re-derived state.

        The PRNG position is len(generated) and the penalty counts are
        bincounts of the coroutine's tokens, so a coroutine arriving by
        COMBINE or MIGRATE resumes its stream exactly; no device sampling
        state crosses nodes.  A greedy-default sequence only resets the
        slot's params row (its state rows are never read: temperature <= 0
        takes the argmax).  The device write waits for the next sampled
        page (``_flush_pending_sampling``)."""
        s = co.slot
        row = smp.pack_params([co.sampling], [co.seq_id])
        for k in self._sp_host:
            self._sp_host[k][s] = row[k][0]
        self._sp_dev = None             # host mirror dirty; re-upload lazily
        if co.sampling.is_greedy_default:
            self._pending_smp.pop(s, None)
            return
        V = self._sample_state["counts"].shape[1]
        st_row = smp.init_state(row["seed"], [co.prompt], [co.generated], V)
        self._pending_smp[s] = (smp.base_keys_host(st_row["seed"])[0],
                                st_row["gen_count"][0], st_row["counts"][0],
                                st_row["prompt_counts"][0])

    def _flush_pending_sampling(self):
        """Write every staged slot's sampling state to the device: one
        batched index assignment per state tensor."""
        if not self._pending_smp:
            return
        slots = list(self._pending_smp)
        rows = list(self._pending_smp.values())
        self._pending_smp.clear()
        idx = torch.tensor(slots, dtype=torch.long, device=self.device)
        for i, name in enumerate(("base_key", "gen_count", "counts",
                                  "prompt_counts")):
            leaf = self._sample_state[name]
            col = np.stack([r[i] for r in rows]).astype(
                np.int64 if leaf.dtype == torch.int64 else np.int32)
            leaf[idx] = torch.from_numpy(col).to(self.device)

    def _sp_device(self) -> Dict[str, torch.Tensor]:
        """Packed per-slot sampling params as device tensors (cached until
        a slot install dirties the host mirror)."""
        if self._sp_dev is None:
            self._sp_dev = {k: torch.from_numpy(v).to(self.device)
                            for k, v in self._sp_host.items() if k != "seed"}
        return self._sp_dev

    def reconfigure_partition(self, co: SequenceCoroutine, group: List[int]):
        # one card per engine: bookkeeping only
        pass

    # ------------------------------------------------------------- transfers
    def _to_host(self, x) -> np.ndarray:
        """Single funnel for device->host copies (spy point for tests):
        a tensor, or a copy already issued as a ``compat.HostCopy``."""
        self.d2h_transfers += 1
        if isinstance(x, compat.HostCopy):
            x = x.wait()
        return compat.to_numpy(x)

    # ------------------------------------------------------------- compute
    def decode_page(self, active: Sequence[SequenceCoroutine], P: int):
        """Decode up to P tokens for every active sequence: exactly
        ``min(P, max remaining)`` steps as pow2 chunks, then ONE
        device->host copy of the page's token block (or logprob plane).
        Any active sequence with non-default SamplingParams selects the
        sampled variant, with the per-slot state carried on the device."""
        if self.faults is not None and self.faults.dead:
            return
        self._flush_pending_installs()
        if not active:
            return
        steps = min(P, max(c.remaining for c in active))
        if steps <= 0:
            return
        if self.faults is not None and self.faults.straggler_factor() > 1.0:
            self.straggler_steps += steps
        tot0 = sum(len(c.generated) for c in active)
        sampled = any(not c.sampling.is_greedy_default for c in active)
        want_lp = [c for c in active if c.logprobs]
        lp_k = max(c.top_logprobs for c in want_lp) if want_lp else None
        flags = (smp.flags_for([c.sampling for c in active],
                               T.padded_vocab(self.cfg)) if sampled else None)
        rem = torch.zeros((self.max_active,), dtype=torch.int32)
        for co in active:
            rem[co.slot] = co.remaining
        rem = rem.to(self.device)
        sp = self._sp_device() if sampled else None
        if sampled:
            self._flush_pending_sampling()
        state = self._sample_state
        blocks = []
        left = steps
        while left > 0:
            chunk = 1 << (left.bit_length() - 1)
            smp_arg = (sp, state) if sampled else None
            if self.module_rt is not None:
                out = self.module_rt.forward_decode_page(
                    self.tokens, self.cache, self.lengths, rem, self.b_attn,
                    chunk, sampling=smp_arg, lp_k=lp_k, flags=flags)
            else:
                out = T.decode_page(
                    self.cfg, self.params, self.cache, self.tokens,
                    self.lengths, rem, chunk, sampling=smp_arg, lp_k=lp_k,
                    flags=flags)
            blk, self.tokens, self.lengths, rem, self.cache = out[:5]
            if sampled:
                state = out[5]
            blocks.append(blk)
            left -= chunk
        self._sample_state = state
        self.decode_steps += steps
        block = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
        block_np = self._to_host(block)     # the ONE d2h transfer per page
        self._apply_block(active, block_np, steps)
        self._account_progress(active, tot0)

    def _account_progress(self, active: Sequence[SequenceCoroutine],
                          tot0: int) -> None:
        """Advance the heartbeat progress counter by this page's emitted
        tokens (an injected straggler divides the credit by its factor)."""
        emitted = sum(len(c.generated) for c in active) - tot0
        f = 1.0
        if self.faults is not None:
            f = max(self.faults.straggler_factor(), 1.0)
        self.tokens_out += emitted / f

    def _apply_block(self, active: Sequence[SequenceCoroutine], block_np,
                     steps: int):
        """Apply a (steps, max_active) token block, or the packed
        (steps, max_active, 2+2K) logprob plane, to coroutine state,
        truncating at each sequence's first stop-token hit (the stop token
        is emitted, then the sequence halts, as on the device)."""
        lp_np = topv = topi = None
        if block_np.ndim == 3:
            toks_np, lp_np, topv, topi = T.unpack_logprob_block(block_np)
        else:
            toks_np = block_np
        for co in active:
            n = min(steps, co.remaining)
            if n <= 0:
                continue
            toks, hit = co.sampling.truncate_at_stop(toks_np[:n, co.slot])
            co.stopped = co.stopped or hit
            co.generated.extend(toks)
            co.last_token = toks[-1]
            co.length += len(toks)
            if co.logprobs and lp_np is not None:
                self._append_logprobs(
                    co, [float(x) for x in lp_np[:len(toks), co.slot]],
                    None if topv is None else topv[:len(toks), co.slot],
                    None if topi is None else topi[:len(toks), co.slot])

    @staticmethod
    def _append_logprobs(co: SequenceCoroutine, chosen, topv, topi):
        """Append one block of chosen-token logprobs (and the requested
        top-K alternatives) aligned with the tokens just applied."""
        co.token_logprobs.extend(chosen)
        if co.top_logprobs and topv is not None:
            k = co.top_logprobs
            for t in range(len(chosen)):
                co.top_token_logprobs.append(
                    [(int(topi[t][j]), float(topv[t][j])) for j in range(k)])

    def sync_appends(self, active: Sequence[SequenceCoroutine]):
        """Blocking host-KV sync: stage + drain in one call."""
        self.stage_appends(active)
        self.drain_appends()

    def _gather_dirty(self, active) -> Optional[_InFlightSync]:
        """Gather every dirty slot's [synced, length) window into one
        (L, n, W, F_total) blob on the device and snapshot the per-slot
        spans; advances ``synced_len`` at issue time."""
        self._flush_pending_installs()
        todo = []
        for co in active:
            if co.slot is None:
                continue
            start = self.synced_len.get(co.seq_id, 0)
            first = not self.host_store.has(co.seq_id)
            if first:
                start = 0
            if co.length > start:
                todo.append((co, start, first))
        if not todo:
            return None
        n, W = len(todo), int(max(co.length - start
                                  for co, start, _ in todo))
        n_pad, W_pad = _pow2(n), _pow2(W)
        pad = [todo[0]] * (n_pad - n)
        slots = np.array([[co.slot] for co, _, _ in todo + pad], np.int64)
        starts = np.array([start for _, start, _ in todo + pad])
        pos = np.minimum(starts[:, None] + np.arange(W_pad)[None],
                         self.max_len - 1).astype(np.int64)
        slots_t = torch.from_numpy(slots).to(self.device)
        pos_t = torch.from_numpy(pos).to(self.device)
        L = self.cfg.num_layers
        blob = torch.cat([leaf[:, slots_t, pos_t].reshape(L, n_pad, W_pad, -1)
                          for leaf in self.cache.values()], dim=-1)
        snaps = []
        for co, start, first in todo:
            snaps.append((co.seq_id, start, co.length - start, first))
            self.synced_len[co.seq_id] = co.length
        self._sync_tag += 1
        nbytes = blob.numel() * blob.element_size()
        return _InFlightSync(blob, self._blob_metas, snaps, nbytes,
                             f"sync{self._sync_tag}")

    def stage_appends(self, active: Sequence[SequenceCoroutine]):
        """Gather the page's dirty KV windows and start their async
        device->host copy; the blob rides the ring buffer until
        ``drain_appends`` lands it.  With ``overlap=False`` (or a blob
        larger than the whole ring) this is the blocking path."""
        ent = self._gather_dirty(active)
        if ent is None:
            return
        if not self.overlap:
            self._materialize(ent)
            return
        if not self.ring.can_fit(ent.nbytes):
            self.sync_stalls += 1
            self.drain_appends()
        if self.ring.can_fit(ent.nbytes):
            try:
                ent.blob = self.transfer(
                    "stage", lambda: compat.HostCopy(ent.blob))
            except TransferDeadLetter:
                self._abandon_blob(ent)
                return
            self.ring.reserve(ent.name, ent.nbytes)
            self._inflight.append(ent)
            self.sync_stages += 1
            self.staged_bytes += ent.nbytes
        else:
            self._materialize(ent)

    def drain_appends(self, keep_newest: int = 0):
        """Land staged blobs in the host store, oldest first."""
        while len(self._inflight) > keep_newest:
            ent = self._inflight.popleft()
            self.ring.release(ent.name)
            self._materialize(ent)
            self.sync_drains += 1

    def _materialize(self, ent: _InFlightSync):
        """Blocking half of the pipeline: wait for the blob's copy and
        append it page by page into the host store."""
        t0 = time.perf_counter()
        try:
            blob = self.transfer("drain", lambda: self._to_host(ent.blob))
        except TransferDeadLetter:
            self._abandon_blob(ent)
            return
        finally:
            self.sync_wait_s += time.perf_counter() - t0
        offs, off = {}, 0
        for name, trail, f in ent.metas:
            offs[name] = (off, off + f)
            off += f
        L = blob.shape[0]
        for i, (seq_id, start, n, first) in enumerate(ent.snaps):
            if not first and not self.host_store.has(seq_id):
                continue    # dropped (evicted) after issue: do not resurrect
            slices = {}
            for name, trail, _ in ent.metas:
                lo, hi = offs[name]
                slices[name] = blob[:, i, :n, lo:hi].reshape((L, n) + trail)
            if self.host_store.has(seq_id):
                self.host_store.append_tokens(seq_id, slices, start)
            else:
                self.host_store.checkpoint(seq_id, slices, start + n)

    def _abandon_blob(self, ent: _InFlightSync):
        """A staged blob was lost to a dead-lettered transfer: drop its
        sequences' lagging host checkpoints (the NODE_FAILURE recovery
        recomputes them from their prompts)."""
        self.abandoned_blobs += 1
        for seq_id, _start, _n, _first in ent.snaps:
            if self.host_store.has(seq_id):
                self.host_store.drop(seq_id)
            self.synced_len.pop(seq_id, None)

    # ------------------------------------- staged h2d restores (governor)
    def stage_restore(self, co: SequenceCoroutine) -> bool:
        """Prefetch a suspended sequence's host checkpoint to the device
        behind a ring-buffer reservation (the h2d mirror of
        ``stage_appends``).  True when a restore is staged."""
        ent = self._restore_staged.get(co.seq_id)
        if ent is not None:
            if (self.host_store.has(co.seq_id)
                    and self.host_store.seqs[co.seq_id].length == ent[1]):
                return True
            self.discard_restore(co.seq_id)
        if not self.host_store.has(co.seq_id):
            return False
        t0 = time.perf_counter()
        slices = self.host_store.restore(co.seq_id, self.max_len)
        nbytes = sum(int(v.nbytes) for v in slices.values())
        if not self.restore_ring.can_fit(nbytes):
            self.restore_stalls += 1
            return False
        try:
            dev = self.transfer("restore", lambda: {
                k: self._slot_tensor(v, self.cache[k])
                for k, v in slices.items() if k in self.cache})
        except TransferDeadLetter:
            return False
        self.restore_ring.reserve(f"restore{co.seq_id}", nbytes)
        self._restore_staged[co.seq_id] = (
            dev, self.host_store.seqs[co.seq_id].length,
            f"restore{co.seq_id}", nbytes, time.perf_counter() - t0)
        self.restore_stages += 1
        self.restore_staged_bytes += nbytes
        return True

    def restore_ready(self, seq_id: int) -> bool:
        ent = self._restore_staged.get(seq_id)
        return (ent is not None and self.host_store.has(seq_id)
                and self.host_store.seqs[seq_id].length == ent[1])

    def take_restore(self, seq_id: int) -> Optional[Dict]:
        """Consume a staged restore for COMBINE; a stale one (the host
        checkpoint advanced since staging) falls back to the synchronous
        restore.  None only when the sequence has no host state."""
        ent = self._restore_staged.pop(seq_id, None)
        cur = (self.host_store.seqs[seq_id].length
               if self.host_store.has(seq_id) else None)
        if ent is not None:
            dev, length, name, nbytes, cost = ent
            self.restore_ring.release(name)
            if cur is not None and cur == length:
                self.restore_wait_s += cost
                self.restore_stage_hidden_s += cost
                return dev
        if cur is None:
            return None
        t0 = time.perf_counter()
        slices = self.host_store.restore(seq_id, self.max_len)
        self.restore_wait_s += time.perf_counter() - t0
        return slices

    def discard_restore(self, seq_id: int) -> None:
        ent = self._restore_staged.pop(seq_id, None)
        if ent is not None:
            self.restore_ring.release(ent[2])

    def discard_restores(self) -> None:
        for seq_id in list(self._restore_staged):
            self.discard_restore(seq_id)

    # ------------------------------------------------------------- prefill
    def _prefill_fresh(self, fresh: List[SequenceCoroutine],
                       lead_rows: Dict[int, torch.Tensor]) -> torch.Tensor:
        """Forward the fresh leads right-padded into one (pow2 B, pow2
        S >= 8) batch, gather each row's last-position logits, and
        checkpoint the prompts' KV through ONE host transfer."""
        maxlen = max(c.prompt_len for c in fresh)
        S = max(_pow2(maxlen), 8)
        B = max(_pow2(len(fresh)), 1)
        toks = np.zeros((B, S), np.int32)
        last_idx = np.zeros((B,), np.int64)
        for i, c in enumerate(fresh):
            toks[i, : c.prompt_len] = c.prompt[:]
            last_idx[i] = c.prompt_len - 1
        tokens = torch.from_numpy(toks).to(self.device)
        h, cache = T._backbone(self.cfg, self.params, tokens)
        last = torch.from_numpy(last_idx).to(self.device)
        hl = h[torch.arange(B, device=self.device), last][:, None, :]
        logits = T.logits_fn(self.cfg, self.params, hl)      # (B, 1, V)
        nf, W, L = len(fresh), maxlen, self.cfg.num_layers
        metas = self._blob_metas
        blob = self._to_host(torch.cat(
            [cache[name][:, :nf, :W].reshape(L, nf, W, -1)
             for name, _, _ in metas], dim=-1))
        offs, off = {}, 0
        for name, trail, f in metas:
            offs[name] = (off, off + f)
            off += f
        for i, lead in enumerate(fresh):
            pl = lead.prompt_len
            slices = {}
            for name, trail, _ in metas:
                lo, hi = offs[name]
                slices[name] = blob[:, i, :pl, lo:hi].reshape((L, pl) + trail)
            self.host_store.checkpoint(lead.seq_id, slices, pl)
            lead_rows[lead.seq_id] = logits[i, 0, :]
            self.prefill_tokens += pl
        return logits

    def _prefill_hit(self, lead: SequenceCoroutine, chain,
                     names: List[str]) -> torch.Tensor:
        """Cross-submit prefix hit: graft the span's host pages into a
        dense (1, pow2 S >= 8) cache and teacher-force only the prompt
        tail through the decode step."""
        P = self.host_store.page_size
        m = len(chain) * P
        pl = lead.prompt_len
        self.host_store.attach_shared(lead.seq_id, chain)
        S = max(_pow2(pl), 8)
        dense = T.init_cache(self.cfg, 1, S, self.device)
        for name in names:
            seg = np.concatenate([nd.pages[name] for nd in chain], axis=1)
            dense[name][:, 0, :m] = compat.from_numpy(seg, self.dtype,
                                                      self.device)
        row = None
        for t in range(m, pl):
            row, dense = T.decode_step_logits(
                self.cfg, self.params, dense,
                torch.tensor([lead.prompt[t]], dtype=torch.int32,
                             device=self.device),
                torch.tensor([t], dtype=torch.int32, device=self.device))
        slices = {name: self._to_host(dense[name][:, 0, m:pl])
                  for name in names}
        self.host_store.append_tokens(lead.seq_id, slices, m)
        lead.prefix_hit_tokens = m
        self.prefill_tokens += pl - m
        self.prefill_tokens_saved += m
        return row[0]

    def prefill(self, cos: Sequence[SequenceCoroutine]):
        """Prefill a batch of INIT coroutines; leaves them INACTIVE with KV
        checkpointed to the host store (paper Fig. 7 prefill flow).

        With the prefix index enabled the batch is first deduplicated by
        prompt: identical prompts are forwarded once.  A lead whose
        leading full pages already sit in the index skips their forward:
        the span's host pages are grafted into a dense cache and only the
        prompt tail is teacher-forced through the decode step."""
        if self.faults is not None and self.faults.dead:
            return
        if not cos:
            return
        idx = self.host_store.prefix_index
        groups: "OrderedDict[tuple, List[SequenceCoroutine]]" = OrderedDict()
        lead_of: Dict[int, int] = {}
        for c in cos:
            key = tuple(c.prompt) if idx is not None else ("seq", c.seq_id)
            groups.setdefault(key, []).append(c)
        for group in groups.values():
            for c in group:
                lead_of[c.seq_id] = group[0].seq_id
        leads = [g[0] for g in groups.values()]
        names = list(self.cache.keys())
        P = self.host_store.page_size
        # cross-submit hits: cap the reuse at the last full page BEFORE the
        # final prompt position, which must be recomputed for its logits
        hits: Dict[int, list] = {}
        fresh: List[SequenceCoroutine] = []
        for lead in leads:
            chain = []
            if idx is not None:
                chain = idx.match(lead.prompt)[: (lead.prompt_len - 1) // P]
                if chain and not all(all(nm in nd.pages for nm in names)
                                     for nd in chain):
                    chain = []
            if chain:
                hits[lead.seq_id] = chain
            else:
                fresh.append(lead)

        lead_rows: Dict[int, torch.Tensor] = {}
        fresh_logits = None
        if fresh:
            # a dense prompt is forwarded alone, so the shapes it meets
            # are a function of the prompt (module docstring); expert
            # capacity couples an MoE batch's rows, as in the JAX engine
            batches = [fresh] if self.cfg.is_moe else [[c] for c in fresh]
            fresh_logits = torch.cat(
                [self._prefill_fresh(b, lead_rows)[:len(b)] for b in batches])
        for lead in leads:
            chain = hits.get(lead.seq_id)
            if chain is not None:
                lead_rows[lead.seq_id] = self._prefill_hit(lead, chain,
                                                           names)

        # publish every lead's prompt pages, then bind fork siblings to
        # the lead's span copy-on-write
        if idx is not None:
            for group in groups.values():
                lead = group[0]
                self.host_store.publish_prefix(lead.seq_id, lead.prompt)
                for sib in group[1:]:
                    self.host_store.clone_shared(lead.seq_id, sib.seq_id)
                    sib.prefix_hit_tokens = sib.prompt_len
                    self.prefill_tokens_saved += sib.prompt_len

        n = len(cos)
        if fresh_logits is not None and len(fresh) == n:
            logits2d = fresh_logits[:n, 0, :]
        else:
            logits2d = torch.stack([lead_rows[lead_of[c.seq_id]]
                                    for c in cos])
        # first generated token: drawn on the device when any sequence
        # samples (key fold_in(PRNGKey(seed), 0), counts over the prompt);
        # all-greedy batches keep the host argmax
        logits_np = None
        if any(not c.sampling.is_greedy_default for c in cos):
            first = self._to_host(self._draw_first(cos, logits2d))
        else:
            logits_np = self._to_host(logits2d)
            first = np.argmax(logits_np, axis=-1)
        lp_np = None
        if any(c.logprobs for c in cos):
            if logits_np is None:       # sampled batch: logits still on dev
                logits_np = self._to_host(logits2d)
            lp_np = _np_log_softmax(logits_np)
        for i, co in enumerate(cos):
            co.last_token = int(first[i])
            co.generated.append(co.last_token)
            if co.logprobs and lp_np is not None:
                topv = topi = None
                if co.top_logprobs:
                    topi = [_np_top_k_idx(lp_np[i], co.top_logprobs)]
                    topv = [lp_np[i][topi[0]]]
                self._append_logprobs(
                    co, [float(lp_np[i, co.last_token])], topv, topi)
            if co.last_token in co.sampling.stop:
                co.stopped = True
            co.length = co.prompt_len
            co.phase = Phase.DECODING
            co.status = Status.INACTIVE
            self.synced_len[co.seq_id] = co.prompt_len
        f = 1.0
        if self.faults is not None:
            f = max(self.faults.straggler_factor(), 1.0)
        self.tokens_out += len(cos) / f

    def _draw_first(self, cos: Sequence[SequenceCoroutine],
                    logits2d: torch.Tensor) -> torch.Tensor:
        """The first generated token of each prefilled sequence, drawn on
        the device through the sampler with key fold_in(base, 0) and the
        prompt's penalty counts."""
        n, V = len(cos), T.padded_vocab(self.cfg)
        sp = smp.pack_params([c.sampling for c in cos],
                             [c.seq_id for c in cos])
        st = smp.init_state(sp["seed"], [list(c.prompt) for c in cos],
                            [[] for _ in cos], V)
        flags = smp.flags_for([c.sampling for c in cos], V)
        dev = self.device
        keys = smp.step_keys(smp.base_keys(st["seed"], dev),
                             torch.zeros((n,), dtype=torch.int32, device=dev))
        return smp.sample(
            logits2d, torch.from_numpy(st["prompt_counts"]).to(dev),
            torch.from_numpy(st["counts"]).to(dev),
            {k: torch.from_numpy(sp[k]).to(dev) for k in _SAMPLE_ROW_KEYS},
            keys, flags)


# NodeEngine declares conformance to the formal backend contract; the
# scheduler re-validates instances at construction.
validate_backend(NodeEngine)
