"""Batch-job entry point of the PyTorch port: a JSONL request file streamed
through ``StreamingJobDriver`` over ``NodeEngine`` replicas that share one
parameter set, every finished row journaled write-ahead in a
segment-rotated ledger, the rows merged in input order at the end.

    PYTHONPATH=src python -m repro_torch.launch.job IN.jsonl OUT.jsonl LEDGER
    PYTHONPATH=src python -m repro_torch.launch.job IN.jsonl OUT.jsonl LEDGER \
        --reduced --device cpu --replicas 2 --kill-after 8

A rerun with the same arguments resumes: rows already in ``LEDGER`` are
skipped, only the rest is decoded, and ``OUT`` equals an uninterrupted
run's byte for byte (decode is a pure function of the request).
``--kill-after K`` sends the process SIGKILL at the end of the driver
round in which the K-th row was journaled: the crash of a kill-and-resume
check.  ``OUT`` is written only when the job ends (tmp file + rename), so
a killed run leaves none.

The weights are random from seed 0, or a checkpoint written by
``runtime.checkpoint.save`` of either package (``--checkpoint DIR``).
Each replica is one engine of 8 slots, 2048 positions and pages of 16;
the driver keeps at most 24 requests resident and seals a ledger segment
every 16 records.

Without a CUDA card the default ``--device cuda`` raises; ``--device
cpu`` runs the plain PyTorch path.  Prints one JSON line: ``status``,
``completed`` (rows journaled by this run), ``skipped`` (input rows
already journaled), ``replayed`` (ledger segments parsed on open) and
``merged`` (rows in ``OUT``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal

from repro_torch import compat
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.driver import DriverConfig, StreamingJobDriver
from repro_torch.models import transformer as T
from repro_torch.runtime import checkpoint
from repro_torch.runtime.engine import NodeEngine


# one replica's engine, and the driver's window and ledger segment size
ENGINE = dict(max_active=8, max_len=2048, page_size=16)
WINDOW = 24
ROTATE_RECORDS = 16


def load_params(cfg, *, checkpoint_dir=None, device=None):
    """The job's one parameter set: random from seed 0, or restored from
    ``checkpoint_dir`` (memory-mapped, copied to ``device`` leaf by
    leaf)."""
    if checkpoint_dir is None:
        return T.init_params(cfg, 0, device)
    flat, _ = checkpoint.restore(checkpoint_dir, mmap=True)
    return checkpoint.unflatten_into(T.param_template(cfg), flat,
                                     device=device)


def engine_factory(cfg, params, device=None):
    """``factory(rid)``: replica ``rid``'s node group, one ``NodeEngine``
    with node id ``rid * 100`` on the shared ``params``."""
    def factory(rid):
        return [NodeEngine(cfg, node_id=rid * 100, params=params,
                           device=device, **ENGINE)]
    return factory


def make_driver(input_path: str, output_path: str, ledger_root: str,
                factory, replicas: int = 2) -> StreamingJobDriver:
    return StreamingJobDriver(
        input_path, output_path, ledger_root, factory,
        cfg=DriverConfig(window=WINDOW, replicas=replicas,
                         rotate_records=ROTATE_RECORDS),
        sched_cfg=SchedulerConfig(page_size=ENGINE["page_size"]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("ledger")
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dtype", default=None,
                    help="override the config's dtype (e.g. float32)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--kill-after", type=int, default=None)
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    device = compat.resolve_device(args.device)
    params = load_params(cfg, checkpoint_dir=args.checkpoint, device=device)
    drv = make_driver(args.input, args.output, args.ledger,
                      engine_factory(cfg, params, device), args.replicas)

    def kill(d, rnd):
        if d.completed >= args.kill_after:
            os.kill(os.getpid(), signal.SIGKILL)

    res = drv.run(on_round=kill if args.kill_after is not None else None)
    print(json.dumps({"status": res.status, "completed": res.completed,
                      "skipped": res.skipped_resume,
                      "replayed": res.report["ledger"]["replayed_segments"],
                      "merged": res.merged_records}), flush=True)
    return res


if __name__ == "__main__":
    main()
