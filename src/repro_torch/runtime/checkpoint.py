"""Checkpoint management: sharded save/restore + fast cold start (§5.6).

* ``save`` / ``restore`` — params (+ optimizer state + sequence-pool
  snapshot) as one flat ``.npz``-style directory of raw ``.bin`` files with
  a JSON manifest; every leaf is a separate file so a restore can be
  sharded (each host reads only its slice ranges).
* Fast cold start — files are written in the final in-memory layout and
  loaded with ``mmap_mode`` (the ServerlessLLM-style memory-mapped format
  the paper adopts); on multi-TB pools the paper pairs this with 2 MB huge
  pages, which is a host-configuration concern outside this process.
* Engine-level snapshot/restart — checkpoint/restart of an in-flight batch
  (sequence pool + host KV store) so a preempted spot instance resumes
  without recomputing finished work.

The manifest is the JAX package's, so a checkpoint written by either
package restores in the other.  numpy has no bf16: a bf16 leaf is written
as its 16-bit patterns under the dtype string ``"bfloat16"`` (the bytes
and the string the JAX ``save`` writes for a bf16 array), ``restore``
maps such a file as ``uint16`` and ``unflatten_into`` views those bits as
``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import compat

_BF16 = "bfloat16"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _host_leaf(leaf) -> Tuple[np.ndarray, str]:
    """A leaf (a tensor on any device, or an array) as a host array of its
    bytes, bf16 as ``uint16`` bits, and its manifest dtype string."""
    if isinstance(leaf, torch.Tensor):
        arr = compat.to_numpy(leaf)
        return arr, _BF16 if leaf.dtype == torch.bfloat16 else str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _file_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf's file is read as."""
    return np.dtype(np.uint16) if name == _BF16 else np.dtype(name)


def save(path: str, params, extra: Optional[Dict[str, Any]] = None):
    os.makedirs(path, exist_ok=True)
    flat = _flatten(params)
    manifest = {}
    for name, leaf in flat.items():
        arr, dtype = _host_leaf(leaf)
        fn = name.replace("/", ".") + ".bin"
        arr.tofile(os.path.join(path, fn))
        manifest[name] = {"file": fn, "dtype": dtype,
                          "shape": list(arr.shape)}
    meta = {"manifest": manifest, "extra": extra or {},
            "saved_at": time.time()}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(meta, f)


def restore(path: str, *, mmap: bool = True,
            shard_filter=None) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Returns (flat param dict, extra).  With mmap=True leaves are
    memory-mapped — cold-start cost is page-in on first touch, not a full
    read (the ServerlessLLM loading model).  A bf16 leaf comes back as its
    ``uint16`` bits."""
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    flat = {}
    for name, info in meta["manifest"].items():
        if shard_filter is not None and not shard_filter(name):
            continue
        fp = os.path.join(path, info["file"])
        dtype = _file_dtype(info["dtype"])
        expect = dtype.itemsize * int(np.prod(info["shape"], dtype=np.int64))
        actual = os.path.getsize(fp)
        if actual != expect:
            raise ValueError(
                f"checkpoint leaf '{name}' is corrupt: {info['file']} is "
                f"{actual} bytes but manifest dtype={info['dtype']} "
                f"shape={tuple(info['shape'])} requires {expect} — the "
                f"checkpoint is truncated or was written by a different "
                f"config")
        if mmap:
            arr = np.memmap(fp, dtype=dtype, mode="r",
                            shape=tuple(info["shape"]))
        else:
            arr = np.fromfile(fp, dtype=dtype).reshape(info["shape"])
        flat[name] = arr
    return flat, meta["extra"]


def _leaf_to(arr: np.ndarray, like: torch.Tensor, name: str,
             dev: torch.device) -> torch.Tensor:
    """One restored leaf as a tensor of ``like``'s dtype on ``dev``, through
    one host tensor of this leaf alone (a read-only memmap is copied, never
    wrapped).  Refuses a leaf of another shape or dtype."""
    bf16 = like.dtype == torch.bfloat16
    want = np.dtype(np.uint16) if bf16 else \
        torch.empty(0, dtype=like.dtype).numpy().dtype
    if arr.dtype != want or tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf '{name}': {arr.dtype} "
                         f"{tuple(arr.shape)} does not fit {like.dtype} "
                         f"{tuple(like.shape)}")
    host = torch.empty(tuple(arr.shape), dtype=like.dtype)
    if bf16:
        np.copyto(host.view(torch.int16).numpy(), arr.view(np.int16))
    else:
        np.copyto(host.numpy(), arr)
    return host.to(dev)


def unflatten_into(tree, flat: Dict[str, np.ndarray], prefix="", *,
                   device=None):
    """Rebuild a tree of tensors matching `tree`'s structure, each leaf of
    its template leaf's dtype and shape (a template on the ``meta`` device,
    ``transformer.param_template``, holds no storage), on ``device``:
    ``"cuda"`` unless the caller asks for ``"cpu"``.  Leaves are copied to
    the device one at a time."""
    dev = compat.resolve_device(device)
    if isinstance(tree, dict):
        return {k: unflatten_into(v, flat, f"{prefix}{k}/", device=dev)
                for k, v in tree.items()}
    name = prefix[:-1]
    return _leaf_to(flat[name], tree, name, dev)


# --------------------------------------------------------------------------
# in-flight batch snapshot (coroutine pool + host KV)
# --------------------------------------------------------------------------


def snapshot_pool(path: str, scheduler):
    os.makedirs(path, exist_ok=True)
    pool = []
    for co in scheduler.cos.values():
        pool.append({"seq_id": co.seq_id, "prompt": co.prompt,
                     "generated": co.generated, "max_out": co.max_out,
                     "status": co.status.value, "node": co.node,
                     "length": co.length, "last_token": co.last_token})
    with open(os.path.join(path, "pool.json"), "w") as f:
        json.dump(pool, f)


def restore_pool(path: str, scheduler):
    from repro_torch.core.coroutine import SequenceCoroutine, Status

    with open(os.path.join(path, "pool.json")) as f:
        pool = json.load(f)
    for d in pool:
        co = SequenceCoroutine(seq_id=d["seq_id"], prompt=d["prompt"],
                               max_out=d["max_out"])
        co.generated = list(d["generated"])
        co.length = int(d["length"])
        co.last_token = int(d["last_token"])
        co.node = d["node"] % len(scheduler.engines)
        # active sequences lost their device state -> re-prefillable INIT,
        # inactive/done restore exactly
        st = Status(d["status"])
        co.status = Status.INIT if st == Status.ACTIVE else st
        if st == Status.INACTIVE and not any(
                scheduler.engines[e].host_store.has(co.seq_id)
                for e in range(len(scheduler.engines))):
            co.status = Status.INIT   # KV not persisted: recompute
        if co.status == Status.INIT:
            co.generated = []
            co.length = 0
        scheduler.cos[co.seq_id] = co
        scheduler._next_id = max(scheduler._next_id, co.seq_id + 1)
    return len(pool)
