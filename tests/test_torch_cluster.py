"""The port's cluster simulator held to the JAX package's.

Each test drives the same scenario through the JAX ``Cluster`` and the
port's (``SimEngine`` virtual clocks, the §5.4 model on the host; no
tensors, so no device) and requires the same assertions of both and equal
reports, ``run_static_baseline``'s included.
"""
import json

import pytest

from repro.configs import get_config as j_get_config
from repro.core import plan as jplan
from repro.runtime import cluster as jcluster
from repro_torch.configs import get_config
from repro_torch.core import plan as tplan
from repro_torch.runtime import cluster as tcluster

PACKAGES = {"jax": (jcluster, jplan, j_get_config),
            "torch": (tcluster, tplan, get_config)}


def _sim_only(x):
    """``x`` without ``mean_sct_s``, the one report entry timed on the
    host's clock rather than the simulated one."""
    if isinstance(x, dict):
        return {k: _sim_only(v) for k, v in x.items() if k != "mean_sct_s"}
    if isinstance(x, (list, tuple)):
        return [_sim_only(v) for v in x]
    return x


def _same(reports):
    """Both packages' reports, as JSON, are equal."""
    j, t = (json.dumps(_sim_only(reports[p]), sort_keys=True, default=str)
            for p in ("jax", "torch"))
    assert t == j


def _cluster(pkg, nodes, **kw):
    C, P, get = PACKAGES[pkg]
    return C.Cluster(get("qwen3_moe_30b"), P.Hardware(), nodes=nodes,
                     max_active=32, max_len=8192, **kw), C


def test_cluster_failure_recovery():
    reports = {}
    for pkg in PACKAGES:
        cl, C = _cluster(pkg, 4)
        wl = C.fixed_workload(64, 512, 256)
        cl.sched.submit(wl.prompts, wl.max_out)
        for _ in range(3):
            for node, eng in enumerate(cl.sched.engines):
                cl.sched._node_tick(node, eng)
        r = cl.fail_node(1)
        assert r["migrated"] + r["recomputed"] > 0
        assert not cl.sched.health.failed.get(0) and cl.sched.health.failed[1]
        rep = cl.sched.run(max_ticks=50000)
        assert rep["completed"] == 64, "all sequences survive a node failure"
        assert rep["robustness"]["failed_nodes"] == [1]
        reports[pkg] = (r, rep)
    _same(reports)


def test_cluster_drain_node_graceful_handoff():
    reports = {}
    for pkg in PACKAGES:
        cl, C = _cluster(pkg, 2)
        wl = C.fixed_workload(24, 256, 2048)
        cl.sched.submit(wl.prompts, wl.max_out)
        for node, eng in enumerate(cl.sched.engines):
            cl.sched._node_tick(node, eng)
        r = cl.drain_node(1)
        assert r["drained"] and r["migrated"] > 0
        assert len(cl.sched.engines) == 1
        rep = cl.sched.run(max_ticks=50000)
        assert rep["completed"] == 24, "drain loses zero sequences"
        assert rep["robustness"]["drained_nodes"] == [1]
        assert not cl.sched.health.failed.get(1)
        # no survivor: the drain must refuse rather than strand the work
        cl2, _ = _cluster(pkg, 1)
        cl2.sched.submit(wl.prompts[:4], [8] * 4)
        r2 = cl2.drain_node(0)
        assert not r2["drained"] and len(cl2.sched.engines) == 1
        reports[pkg] = (r, rep, r2)
    _same(reports)


def test_cluster_elastic_scale_up():
    reports = {}
    for pkg in PACKAGES:
        cl, C = _cluster(pkg, 2)
        wl = C.fixed_workload(48, 256, 128)
        cl.sched.submit(wl.prompts, wl.max_out)
        cl.add_node()
        rep = cl.sched.run(max_ticks=50000)
        assert rep["completed"] == 48
        assert len(cl.sched.engines) == 3
        reports[pkg] = rep
    _same(reports)


@pytest.mark.parametrize("n", [1, 2])
def test_cluster_run_and_static_baseline_on_longtail(n):
    """``longtail_workload`` draws the same workload in both packages; the
    coroutine cluster (with ``n`` forked samples a prompt) and the static
    baseline report the same BCT and utilization."""
    reports = {}
    for pkg in PACKAGES:
        C, P, get = PACKAGES[pkg]
        cfg, hw = get("qwen3_moe_30b"), P.Hardware()
        wl = C.longtail_workload(48, mean_in=256, mean_out=256, sigma=1.2,
                                 seed=3)
        cl = C.Cluster(cfg, hw, nodes=2, max_active=16, max_len=8192)
        rep = cl.run(wl, n=n)
        base = C.run_static_baseline(cfg, hw, wl, nodes=2, max_active=16,
                                     max_len=8192)
        assert rep["completed"] == wl.n * n
        reports[pkg] = (wl.prompts, wl.max_out, rep, base)
    _same(reports)


def test_sim_node_group_ids_and_plan():
    groups = {}
    for pkg in PACKAGES:
        C, P, get = PACKAGES[pkg]
        cfg, hw = get("qwen3_moe_30b"), P.Hardware()
        g = C.sim_node_group(cfg, hw, nodes=3, first_node_id=200,
                             max_active=16, max_len=4096, page_size=64)
        assert [e.node_id for e in g] == [200, 201, 202]
        assert all(e.plan is g[0].plan for e in g)
        assert g[0].kv_bytes_per_token == C.kv_bytes_per_token(cfg)
        groups[pkg] = [(e.node_id, e.plan.b_attn, e.plan.b_moe,
                        e.plan.ring_buffer_bytes, e.kv_bytes_per_token)
                       for e in g]
    _same(groups)
