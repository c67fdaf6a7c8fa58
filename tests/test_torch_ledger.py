"""The port's write-ahead job ledgers held to the JAX package's.

Each test runs one scenario through the JAX module and the port's
(``repro.runtime.ledger`` / ``repro_torch.runtime.ledger``), each in its
own directory, with the same assertions on both, and then requires the
two directories to hold the same files with the same bytes.  The
``run_resumable`` legs serve the same requests through each package's
``BatchMaster`` over its own ``NodeEngine`` with the same weights
(reduced ``llama3_2_1b`` in fp32, the port's from ``params_from_numpy``):
the rows must be equal.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as j_reduced
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.runtime import ledger as jledger
from repro.runtime.api import BatchMaster as JBatchMaster
from repro.runtime.api import BatchRequest as JBatchRequest
from repro.runtime.engine import NodeEngine as JNodeEngine
from repro_torch.configs import reduced_config
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.models import transformer as TT
from repro_torch.runtime import ledger as tledger
from repro_torch.runtime.api import BatchMaster, BatchRequest
from repro_torch.runtime.engine import NodeEngine

SRC = Path(__file__).resolve().parents[1] / "src"
PACKAGES = {"jax": jledger, "torch": tledger}


def _tree(root):
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _both(tmp_path, scenario):
    """Run ``scenario(ledger_module, dir)`` for both packages; the two
    directories must hold the same bytes.  Returns the two results."""
    res = {}
    for name, mod in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        res[name] = scenario(mod, str(d))
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")
    return res


# ---------------------------------------------------------------------------
# JobLedger
# ---------------------------------------------------------------------------


def test_job_ledger_exactly_once(tmp_path):
    def scenario(L, d):
        p = os.path.join(d, "led.jsonl")
        led = L.JobLedger(p).open()
        led.record_submitted(["a", "b"])
        assert led.record_output("a", {"v": 1})
        assert not led.record_output("a", {"v": 2}), "duplicate refused"
        led.close()
        led2 = L.JobLedger(p).open()
        assert led2.finished == {"a": {"v": 1}}, "first write wins"
        assert led2.pending(["a", "b"]) == ["b"]
        led2.close()
    _both(tmp_path, scenario)


def test_job_ledger_truncates_torn_trailing_line(tmp_path):
    def scenario(L, d):
        p = os.path.join(d, "led.jsonl")
        led = L.JobLedger(p).open()
        led.record_output("a", {"v": 1})
        led.close()
        with open(p, "a") as f:     # SIGKILL mid-write: no trailing newline
            f.write('{"kind": "output", "custom_id": "b", "ro')
        led2 = L.JobLedger(p).open()
        assert led2.finished == {"a": {"v": 1}} and led2.torn_records == 1
        led2.record_output("c", {"v": 3})   # append lands on a clean line
        led2.close()
        led3 = L.JobLedger(p).open()
        assert set(led3.finished) == {"a", "c"}
        led3.close()
    _both(tmp_path, scenario)


# ---------------------------------------------------------------------------
# run_resumable over each package's BatchMaster + NodeEngine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def masters():
    """``make(pkg)`` builds a fresh BatchMaster of package ``pkg`` over one
    NodeEngine; both packages' engines hold the same fp32 weights."""
    jcfg = dataclasses.replace(j_reduced("llama3_2_1b"), dtype="float32")
    tcfg = dataclasses.replace(reduced_config("llama3_2_1b"),
                               dtype="float32")
    kw = dict(max_active=3, max_len=64, page_size=8)
    params = TT.params_from_numpy(
        jax.tree.map(np.asarray, JNodeEngine(jcfg, seed=0, **kw).params),
        tcfg, device="cpu")

    def make(pkg):
        if pkg == "jax":
            return JBatchMaster([JNodeEngine(jcfg, seed=0, **kw)],
                                JSchedulerConfig(page_size=8))
        return BatchMaster([NodeEngine(tcfg, params=params, device="cpu",
                                       **kw)], SchedulerConfig(page_size=8))
    return make


def _reqs(pkg, n=6):
    cls = JBatchRequest if pkg == "jax" else BatchRequest
    rng = np.random.default_rng(5)
    return [cls(custom_id=f"r{i}", prompt=[int(t) for t in
                                           rng.integers(2, 100, 5)],
                max_tokens=6) for i in range(n)]


def test_job_ledger_resume_skips_finished(tmp_path, masters):
    """Kill-and-resume protocol, in process: a ledger holding the first 3
    committed rows of a 6-request batch resumes to the same rows as the
    uninterrupted run, recomputing only the 3 unfinished requests."""
    def scenario(L, d):
        pkg = "jax" if L is jledger else "torch"
        reqs = _reqs(pkg)
        full_p = os.path.join(d, "full.jsonl")
        crash_p = os.path.join(d, "crash.jsonl")
        full = L.run_resumable(masters(pkg), reqs, full_p)
        assert full.resumed == 0 and full.computed == 6
        assert len(full.rows) == 6
        kept = dropped = 0
        with open(full_p) as f, open(crash_p, "w") as g:
            for line in f:
                if json.loads(line).get("kind") == "output":
                    if kept >= 3:
                        dropped += 1
                        continue
                    kept += 1
                g.write(line)
        assert kept == 3 and dropped == 3
        res = L.run_resumable(masters(pkg), reqs, crash_p)
        assert res.resumed == 3 and res.computed == 3
        assert res.rows == full.rows
        again = L.run_resumable(masters(pkg), reqs, crash_p)
        assert again.resumed == 6 and again.computed == 0
        assert again.rows == full.rows
        return full.rows
    rows = _both(tmp_path, scenario)
    assert rows["torch"] == rows["jax"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_job_ledger_rejects_duplicate_custom_ids(tmp_path, masters, pkg):
    reqs = _reqs(pkg, 2)
    reqs[1].custom_id = reqs[0].custom_id
    with pytest.raises(PACKAGES[pkg].LedgerError,
                       match="duplicate custom_id"):
        PACKAGES[pkg].run_resumable(masters(pkg), reqs,
                                    str(tmp_path / "led.jsonl"))


# ---------------------------------------------------------------------------
# SegmentedJobLedger
# ---------------------------------------------------------------------------


def _seg_led(L, d, **kw):
    kw.setdefault("rotate_records", 4)
    kw.setdefault("fsync_every", 1)
    return L.SegmentedJobLedger(os.path.join(d, "led"), **kw)


def test_segmented_ledger_rotation_boundary_exact(tmp_path):
    def scenario(L, d):
        led = _seg_led(L, d).open()
        for i in range(10):
            assert led.record_output(f"r{i}", {"v": i})
        assert led.sealed_segments == 2 and led.live_segment == 2
        root = led.root
        led.close()
        for k, nrec in ((0, 4), (1, 4), (2, 2)):
            with open(os.path.join(root, f"seg-{k:08d}.jsonl")) as f:
                assert len(f.read().splitlines()) == nrec
        led2 = _seg_led(L, d).open()
        assert len(led2) == 10 and led2.sealed_segments == 2
        assert led2.replayed_segments == 1
        assert all(led2.read_row(f"r{i}") == {"v": i} for i in range(10))
        led2.close()
    _both(tmp_path, scenario)


def test_segmented_ledger_torn_line_newest_segment_only(tmp_path):
    def scenario(L, d):
        led = _seg_led(L, d).open()
        for i in range(6):
            led.record_output(f"r{i}", {"v": i})    # seg0 sealed, seg1 live
        led.close()
        sealed = os.path.join(led.root, "seg-00000000.jsonl")
        live = os.path.join(led.root, "seg-00000001.jsonl")
        with open(live, "a") as f:
            f.write('{"kind": "output", "custom_id": "r9", "ro')
        with open(sealed, "a") as f:
            f.write("SEALED-FILE-GARBAGE")
        led2 = _seg_led(L, d).open()
        assert led2.torn_records == 1 and len(led2) == 6
        assert open(sealed).read().endswith("SEALED-FILE-GARBAGE")
        assert not open(live, "rb").read().endswith(b"ro")
        assert led2.read_row("r5") == {"v": 5}
        led2.close()
    _both(tmp_path, scenario)


_KILL_PROG = """
import os, signal, sys
sys.path.insert(0, {src!r})
from {pkg}.runtime.ledger import SegmentedJobLedger
led = SegmentedJobLedger(sys.argv[1], rotate_records=4, fsync_every=1000)
led.open()
for i in range(11):
    led.record_output(f'r{{i}}', {{'v': i}})
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_segmented_ledger_sigkill_resume_across_boundary(tmp_path):
    """Real SIGKILL between rotations: every row sealed before the crash
    is durable and a fresh process resumes with zero recompute of sealed
    rows, replaying only the tail segment."""
    def scenario(L, d):
        pkg = "repro" if L is jledger else "repro_torch"
        root = os.path.join(d, "led")
        p = subprocess.run(
            [sys.executable, "-c", _KILL_PROG.format(src=str(SRC), pkg=pkg),
             root], capture_output=True)
        assert p.returncode == -9, p.stderr.decode()[-1000:]
        led = L.SegmentedJobLedger(root, rotate_records=4).open()
        assert led.sealed_segments == 2 and led.replayed_segments <= 1
        assert all(led.has(f"r{i}") for i in range(8))
        assert led.pending([f"r{i}" for i in range(8)]) == []
        led.close()
    _both(tmp_path, scenario)


def test_segmented_ledger_duplicate_first_wins_across_segments(tmp_path):
    def scenario(L, d):
        led = _seg_led(L, d).open()
        for i in range(5):
            led.record_output(f"r{i}", {"v": i})
        assert not led.record_output("r0", {"v": 999})
        assert led.duplicates_refused == 1
        led.close()
        live = os.path.join(led.root, "seg-00000001.jsonl")
        with open(live, "a") as f:
            f.write(json.dumps({"kind": "output", "custom_id": "r0",
                                "row": {"v": 777}}) + "\n")
        led2 = _seg_led(L, d).open()
        assert led2.duplicates_refused == 1
        assert led2.read_row("r0") == {"v": 0}
        assert len(led2) == 5
        led2.close()
    _both(tmp_path, scenario)
