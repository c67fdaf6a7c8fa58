"""The port's streaming job driver held to the JAX package's.

The simulated legs build each replica on each package's own
``sim_node_group`` (virtual clocks, so both runs take the same rounds):
the merged output, every ledger segment and the driver's report must be
equal.  The long-tail stream must write the JAX stream's bytes.

The slice as a whole: the port's ``StreamingJobDriver`` over two
replicas of the port's ``NodeEngine`` (reduced ``llama3_2_1b`` in fp32)
runs a 24-request long-tail job in which every fourth row samples; the
JAX driver over two JAX ``NodeEngine``s runs the same job on the same
weights; the merged files must be equal byte for byte.  The
kill-and-resume legs run ``python -m repro_torch.launch.job --reduced
--device cpu`` on those weights (a checkpoint the JAX package wrote),
SIGKILL it mid-job and resume it: the resumed output must equal the JAX
clean run's bytes, and no token may be journaled twice.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced
from repro.core import plan as jplan
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.data.pipeline import LongTailRequestStream as JLongTail
from repro.driver import DriverConfig as JDriverConfig
from repro.driver import StreamingJobDriver as JDriver
from repro.runtime import checkpoint as jckpt
from repro.runtime.cluster import sim_node_group as j_sim_node_group
from repro.runtime.engine import NodeEngine as JNodeEngine
from repro.runtime.faults import Fault as JFault
from repro.runtime.faults import FaultPlan as JFaultPlan
from repro.runtime.ledger import SegmentedJobLedger as JLedger
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import plan as tplan
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.pipeline import LongTailRequestStream
from repro_torch.driver import (DriverConfig, JsonlRequestSource,
                                StreamingJobDriver, iter_custom_ids)
from repro_torch.launch import job
from repro_torch.runtime.cluster import sim_node_group
from repro_torch.runtime.faults import Fault, FaultPlan
from repro_torch.runtime.ledger import SegmentedJobLedger

SRC = Path(__file__).resolve().parents[1] / "src"
N = 400
WINDOW = 48

# each package's pieces of a simulated driver run
SIM = {
    "jax": dict(get_config=j_get_config, plan=jplan,
                sim_node_group=j_sim_node_group, Driver=JDriver,
                DriverConfig=JDriverConfig, SchedulerConfig=JSchedulerConfig,
                Fault=JFault, FaultPlan=JFaultPlan),
    "torch": dict(get_config=get_config, plan=tplan,
                  sim_node_group=sim_node_group, Driver=StreamingJobDriver,
                  DriverConfig=DriverConfig, SchedulerConfig=SchedulerConfig,
                  Fault=Fault, FaultPlan=FaultPlan),
}


def _sim_driver(pkg, inp, root, *, window=WINDOW, rotate_records=64,
                fault_plan_factory=None):
    m = SIM[pkg]
    cfg = m["get_config"]("qwen3_moe_30b")
    hw = m["plan"].Hardware()
    plan = m["plan"].search_plan(cfg, hw, ctx=2048, new_tokens=1,
                                 max_active=16)

    def factory(rid):
        return m["sim_node_group"](cfg, hw, nodes=2,
                                   first_node_id=rid * 100, max_active=16,
                                   max_len=4096, page_size=64, plan=plan)
    return m["Driver"](
        inp, os.path.join(root, "out.jsonl"), os.path.join(root, "led"),
        factory, cfg=m["DriverConfig"](window=window,
                                       rotate_records=rotate_records),
        sched_cfg=m["SchedulerConfig"](page_size=64),
        fault_plan_factory=fault_plan_factory)


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _sim_only(x):
    """``x`` without ``mean_sct_s``, the one report entry timed on the
    host's clock rather than the simulated one."""
    if isinstance(x, dict):
        return {k: _sim_only(v) for k, v in x.items() if k != "mean_sct_s"}
    if isinstance(x, (list, tuple)):
        return [_sim_only(v) for v in x]
    return x


def _run_both(tmp_path, inp, hook=None, **kw):
    """The same simulated job through both drivers: merged output, ledger
    files and reports must be equal.  Returns ``{pkg: (result, driver)}``."""
    out = {}
    for pkg in SIM:
        root = tmp_path / pkg
        root.mkdir()
        drv = _sim_driver(pkg, inp, str(root), **{
            k: (v(pkg) if k == "fault_plan_factory" else v)
            for k, v in kw.items()})
        out[pkg] = (drv.run(on_round=hook), drv)
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")
    jres, tres = out["jax"][0], out["torch"][0]
    for f in dataclasses.fields(jres):
        a, b = getattr(jres, f.name), getattr(tres, f.name)
        if f.name == "merged_path":
            continue
        assert json.dumps(_sim_only(b), sort_keys=True, default=str) == \
            json.dumps(_sim_only(a), sort_keys=True, default=str), f.name
    return out


def _input(tmp_path, n=N, seed=11):
    p = str(tmp_path / "in.jsonl")
    LongTailRequestStream(n, seed=seed, mean_in=24,
                          mean_out=10).write_jsonl(p)
    return p


# ---------------------------------------------------------------------------
# long-tail request stream and the jsonl source
# ---------------------------------------------------------------------------


def test_longtail_stream_deterministic_and_long_tailed(tmp_path):
    a = list(LongTailRequestStream(200, seed=3))
    assert a == list(LongTailRequestStream(200, seed=3))
    assert a == list(JLongTail(200, seed=3)), "the JAX stream's requests"
    s = LongTailRequestStream(200, seed=3)
    assert s.request(17) == a[17], "request(i) is a pure function"
    assert [r["custom_id"] for r in a] == \
        [f"req-{i:08d}" for i in range(200)]
    outs = sorted(r["body"]["max_tokens"] for r in a)
    assert outs[-1] >= 4 * outs[len(outs) // 2]
    p, q = str(tmp_path / "in.jsonl"), str(tmp_path / "jax.jsonl")
    kw = dict(seed=1, temperature=0.7, vocab=128256, mean_in=128,
              max_in_cap=1024)
    assert LongTailRequestStream(50, **kw).write_jsonl(p) == 50
    JLongTail(50, **kw).write_jsonl(q)
    assert open(p, "rb").read() == open(q, "rb").read()
    assert list(iter_custom_ids(p)) == [f"req-{i:08d}" for i in range(50)]


def test_jsonl_source_bounded_take_and_skip(tmp_path):
    inp = _input(tmp_path, n=30)
    seen = {f"req-{i:08d}" for i in range(0, 30, 2)}   # pretend even done
    src = JsonlRequestSource(inp, skip=seen.__contains__).open()
    got = src.take(5)
    assert len(got) == 5 and not src.exhausted
    got += src.take(100)
    assert src.exhausted and src.skipped == 15
    assert [r.custom_id for r in got] == \
        sorted({f"req-{i:08d}" for i in range(1, 30, 2)})
    src.close()


# ---------------------------------------------------------------------------
# the driver on simulated replicas
# ---------------------------------------------------------------------------


def test_driver_elastic_end_to_end(tmp_path):
    inp = _input(tmp_path)

    acts = {}           # per driver: the mid-job scale-up and drain

    def hook(d, rnd):
        mine = acts.setdefault(id(d), {})
        if rnd == 3 and "up" not in mine:
            mine["up"] = d.scale_up()
        if rnd == 6 and "drain" not in mine and len(d._open_replicas()) > 1:
            mine["drain"] = d.drain(d.replicas[0].rid, requeue=True)

    res, drv = _run_both(tmp_path, inp, hook)["torch"]
    assert res.status == "completed"
    assert res.merged_records == N, "drain must lose zero requests"
    assert res.scale_ups == 1 and "drain" in acts[id(drv)]
    assert res.peak_resident <= WINDOW
    with open(res.merged_path) as f:
        cids = [json.loads(line)["custom_id"] for line in f]
    assert cids == [f"req-{i:08d}" for i in range(N)], "input order"
    rep = res.report
    assert rep["completed"] == N
    assert set(rep["scheduler_reports"]) == {r.rid for r in drv.replicas}
    assert rep["robustness"]["transfer"]["dead_letters"] == 0
    assert rep["ledger"]["sealed_segments"] >= 2, "rotation exercised"


def test_driver_auto_drains_dead_lettered_replica(tmp_path):
    inp = _input(tmp_path, n=120)

    def fpf(pkg):
        m = SIM[pkg]

        def plan(rid):
            if rid == 0:    # poison only the first replica
                return m["FaultPlan"]([m["Fault"](
                    "transfer_fail", node=0, at_tick=2, count=99,
                    transfer_kind="install")], seed=0)
            return None
        return plan

    res, drv = _run_both(tmp_path, inp, fault_plan_factory=fpf)["torch"]
    assert res.status == "completed"
    assert res.merged_records == 120
    assert res.auto_drained >= 1, "dead-letter must trigger auto-drain"
    assert res.report["robustness"]["dead_letter_failovers"] >= 1
    assert any(r.closed for r in drv.replicas)


def test_driver_graceful_drain_finishes_in_flight(tmp_path):
    inp = _input(tmp_path, n=80)

    def hook(d, rnd):
        if rnd == 2 and d.scale_ups == 0:
            d.scale_up()
            d.drain(d.replicas[0].rid, requeue=False)

    res, drv = _run_both(tmp_path, inp, hook)["torch"]
    assert res.status == "completed" and res.merged_records == 80
    assert res.requeued == 0, "graceful drain never requeues"
    assert drv.replicas[0].closed


def _scan_partials(ledger_root):
    """All committed partial records across every segment, per custom_id."""
    per = {}
    for f in sorted(os.listdir(ledger_root)):
        if not f.startswith("seg-"):
            continue
        for line in open(os.path.join(ledger_root, f), "rb").read() \
                .splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue            # torn tail line
            if rec.get("kind") == "partial":
                per.setdefault(rec["custom_id"], []).append(
                    (rec["off"], len(rec["tokens"])))
    return per


def _assert_no_overlap(per):
    for cid, blocks in per.items():
        covered = set()
        for off, n in blocks:
            span = set(range(off, off + n))
            assert not (covered & span), \
                f"duplicate partial coverage for {cid} at offset {off}"
            covered |= span


def test_segmented_ledger_partial_journal_exactly_once(tmp_path):
    """record_partial is exactly-once per token offset, survives rotation
    and reopen, and a finished row supersedes the partial stream; the
    port's segments and index equal the JAX ledger's bytes."""
    for pkg, Led in (("jax", JLedger), ("torch", SegmentedJobLedger)):
        root = str(tmp_path / pkg)
        led = Led(root, rotate_records=4).open()
        assert led.record_partial("a", 0, [1, 2, 3])
        assert not led.record_partial("a", 0, [1, 2, 3])
        assert not led.record_partial("a", 2, [9])
        assert led.partial_duplicates_refused == 2
        assert led.record_partial("a", 3, [4, 5])
        assert led.record_output("a", {"custom_id": "a", "ok": True})
        assert not led.record_partial("a", 5, [6])
        assert led.record_partial("b", 0, [7] * 3)
        for i in range(4):
            led.record_output(f"fill-{i}", {"custom_id": f"fill-{i}"})
        assert led.sealed_segments >= 1
        led.close()
        led2 = Led(root, rotate_records=4).open()
        assert led2.replayed_segments <= 1
        assert not led2.record_partial("a", 0, [1])
        assert not led2.record_partial("b", 0, [7] * 3)
        assert led2.record_partial("b", 3, [8])
        led2.close()
        _assert_no_overlap(_scan_partials(root))
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")


# ---------------------------------------------------------------------------
# the slice as a whole: NodeEngine replicas, both packages, same weights
# ---------------------------------------------------------------------------

JOB_N = 24


def _write_job(path, vocab):
    """24 long-tail requests; every fourth samples (T 0.8, its own seed)."""
    with open(path, "w") as f:
        for i, r in enumerate(LongTailRequestStream(
                JOB_N, seed=0, mean_in=20, mean_out=12, vocab=vocab,
                max_in_cap=64, max_out_cap=40)):
            if i % 4 == 3:
                r["body"].update(temperature=0.8, seed=1000 + i)
            f.write(json.dumps(r) + "\n")


@pytest.fixture(scope="module")
def job_case(tmp_path_factory):
    """The job's input, the JAX driver's merged bytes over JAX NodeEngines
    (reduced llama3_2_1b in fp32, seed 0), and those weights as a
    checkpoint the JAX package wrote."""
    d = tmp_path_factory.mktemp("job")
    jcfg = dataclasses.replace(j_reduced("llama3_2_1b"), dtype="float32")
    inp = str(d / "in.jsonl")
    _write_job(inp, jcfg.vocab_size)

    def factory(rid):
        return [JNodeEngine(jcfg, node_id=rid * 100, seed=0, **job.ENGINE)]
    out = str(d / "jax.jsonl")
    res = JDriver(inp, out, str(d / "jax_led"), factory,
                  cfg=JDriverConfig(window=job.WINDOW, replicas=2,
                                    rotate_records=job.ROTATE_RECORDS),
                  sched_cfg=JSchedulerConfig(
                      page_size=job.ENGINE["page_size"])).run()
    assert res.status == "completed" and res.merged_records == JOB_N
    ck = str(d / "ckpt")
    jckpt.save(ck, factory(0)[0].params)
    return inp, open(out, "rb").read(), ck


def test_driver_over_node_engines_matches_jax(tmp_path, job_case):
    inp, want, ck = job_case
    cfg = dataclasses.replace(reduced_config("llama3_2_1b"),
                              dtype="float32")
    params = job.load_params(cfg, checkpoint_dir=ck, device="cpu")
    drv = job.make_driver(inp, str(tmp_path / "out.jsonl"),
                          str(tmp_path / "led"),
                          job.engine_factory(cfg, params, "cpu"))
    res = drv.run()
    assert res.status == "completed" and res.merged_records == JOB_N
    assert res.report["ledger"]["sealed_segments"] >= 2
    assert len(res.report["replicas"]) == 2
    rows = [json.loads(line) for line in open(res.merged_path)]
    assert sum(len(r["response"]["tokens"]) for r in rows) > JOB_N
    assert open(res.merged_path, "rb").read() == want


def _job_cmd(inp, out, led, ck):
    return [sys.executable, "-m", "repro_torch.launch.job", inp, out, led,
            "--reduced", "--device", "cpu", "--dtype", "float32",
            "--checkpoint", ck]


def _kill_and_resume(tmp_path, job_case, kill_after):
    inp, _, ck = job_case
    out, led = str(tmp_path / "killed.jsonl"), str(tmp_path / "led_killed")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    cmd = _job_cmd(inp, out, led, ck)
    p = subprocess.run(cmd + ["--kill-after", str(kill_after)],
                       capture_output=True, env=env, timeout=300)
    assert p.returncode == -signal.SIGKILL, p.stderr.decode()[-2000:]
    assert not os.path.exists(out), "a killed run must not publish output"
    killed = _scan_partials(led)
    p = subprocess.run(cmd, capture_output=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    info = json.loads(p.stdout.decode().strip().splitlines()[-1])
    assert info["status"] == "completed" and info["merged"] == JOB_N
    assert info["skipped"] >= kill_after, "resume skips journaled rows"
    assert info["replayed"] <= 1, "resume replays only the tail segment"
    return out, led, killed


def test_driver_kill_resume_no_duplicate_partials(tmp_path, job_case):
    _, led, killed = _kill_and_resume(tmp_path, job_case, 4)
    assert killed, "the killed run must have journaled partials"
    _assert_no_overlap(_scan_partials(led))


def test_driver_kill_resume_byte_identical(tmp_path, job_case):
    out, _, _ = _kill_and_resume(tmp_path, job_case, 10)
    assert open(out, "rb").read() == job_case[1]
