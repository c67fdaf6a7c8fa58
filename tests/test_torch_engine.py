"""The port's serving slice as a whole, held to the JAX engine on the CPU.

The JAX ``NodeEngine(seed=0)`` and the port's ``NodeEngine`` built from
the same weights (``params_from_numpy``) are each driven by their own
package's ``BatchMaster`` through the same workload: six requests, then a
second submit whose prompts share full pages with a first-batch prompt
(a cross-submit prefix hit, teacher-forced tail) and repeat one prompt
(deduplicated within the batch).  Reduced ``llama3_2_1b`` in fp32.
Tokens must be identical per ``custom_id``; host-store pages agree to
1e-5 (the two frameworks sum in different orders).

The sampled workload mixes greedy rows, temperature, top-k, top-p, min-p,
penalties, a stop token and logprobs; the JAX engine runs its Pallas
sampling kernel in interpret mode (``REPRO_SAMPLING_BACKEND``), whose
histogram threshold the port's kernel route computes.  Tokens are
identical and logprobs agree to 1e-5.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as j_reduced
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.runtime.api import BatchMaster as JBatchMaster
from repro.runtime.api import BatchRequest as JBatchRequest
from repro.runtime.engine import NodeEngine as JNodeEngine
from repro.sampling import SamplingParams as JSamplingParams
from repro_torch.configs import reduced_config
from repro_torch.core.scheduler import CoroutineScheduler, SchedulerConfig
from repro_torch.models import transformer as TT
from repro_torch.runtime.api import BatchMaster, BatchRequest
from repro_torch.runtime.engine import NodeEngine
from repro_torch.sampling import SamplingParams

PAGE = 8
ENGINE_KW = dict(max_active=3, max_len=128, page_size=PAGE)
SRC = Path(__file__).resolve().parents[1] / "src"


def _cfgs():
    return (dataclasses.replace(j_reduced("llama3_2_1b"), dtype="float32"),
            dataclasses.replace(reduced_config("llama3_2_1b"),
                                dtype="float32"))


def _workload(vocab):
    r = np.random.default_rng(11)
    first = [(f"a{i}", [int(t) for t in r.integers(2, vocab, int(n))], int(m))
             for i, (n, m) in enumerate(zip([20, 5, 12, 17, 9, 24],
                                            [9, 14, 5, 20, 12, 7]))]
    base = first[0][1]
    tail = [int(t) for t in r.integers(2, vocab, 5)]
    second = [("b0", base[:2 * PAGE] + tail, 10),
              ("b1", base[:PAGE] + tail, 6),
              ("b2", first[3][1], 8),
              ("b3", first[3][1], 8)]
    return first, second


def _spy_host_pages(store):
    """Snapshot each sequence's host KV, in order, when the scheduler drops
    it (seq ids restart with each batch's scheduler)."""
    seen = []
    orig = store.drop

    def drop(seq_id):
        st = store.seqs.get(seq_id)
        if st is not None:
            seen.append((seq_id, {
                n: np.concatenate(ps, axis=1)[:, :st.length]
                for n, ps in st.pages.items() if ps}))
        orig(seq_id)

    store.drop = drop
    return seen


def _serve(master, req_cls, batches):
    out = {}
    for batch in batches:
        bo = master.run(master.submit(
            [req_cls(custom_id=c, prompt=p, max_tokens=m)
             for c, p, m in batch]))
        assert bo.request_counts["failed"] == 0
        for row in bo.results:
            out[row["custom_id"]] = row["response"]["tokens"]
    return out


def test_engine_matches_jax_engine_through_batch_master():
    jcfg, tcfg = _cfgs()
    jeng = JNodeEngine(jcfg, seed=0, **ENGINE_KW)
    params = TT.params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                  tcfg, device="cpu")
    teng = NodeEngine(tcfg, params=params, device="cpu", **ENGINE_KW)
    jpages, tpages = (_spy_host_pages(jeng.host_store),
                      _spy_host_pages(teng.host_store))
    batches = _workload(tcfg.vocab_size)
    want = _serve(JBatchMaster([jeng], JSchedulerConfig(page_size=PAGE)),
                  JBatchRequest, batches)
    got = _serve(BatchMaster([teng], SchedulerConfig(page_size=PAGE)),
                 BatchRequest, batches)
    assert got == want
    assert teng.prefill_tokens_saved == jeng.prefill_tokens_saved > 0
    assert teng.prefill_tokens == jeng.prefill_tokens
    assert teng.decode_steps == jeng.decode_steps
    assert [s for s, _ in tpages] == [s for s, _ in jpages]
    assert len(tpages) == 10
    for (sid, tleaves), (_, jleaves) in zip(tpages, jpages):
        assert tleaves.keys() == jleaves.keys() == {"k", "v"}
        for name, a in jleaves.items():
            np.testing.assert_allclose(tleaves[name], a, atol=1e-5,
                                       rtol=1e-5, err_msg=f"{sid}.{name}")


def _moe_cfgs():
    return (dataclasses.replace(j_reduced("qwen3_moe_30b"), dtype="float32"),
            dataclasses.replace(reduced_config("qwen3_moe_30b"),
                                dtype="float32"))


# Algorithm 1 in both engines: attention in sub-batches of 2 of 4 slots,
# COMBINE before each MoE layer
MOE_KW = dict(max_active=4, max_len=128, page_size=PAGE,
              module_granularity=True, b_attn=2)


def test_moe_module_engine_matches_jax_engine_through_batch_master():
    """Reduced qwen3 MoE with module granularity: the greedy workload,
    its prefix hit included, gives the JAX engine's tokens."""
    jcfg, tcfg = _moe_cfgs()
    jeng = JNodeEngine(jcfg, seed=0, **MOE_KW)
    params = TT.params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                  tcfg, device="cpu")
    teng = NodeEngine(tcfg, params=params, device="cpu", **MOE_KW)
    assert teng.module_rt is not None and teng.b_attn == 2
    batches = _workload(tcfg.vocab_size)
    want = _serve(JBatchMaster([jeng], JSchedulerConfig(page_size=PAGE)),
                  JBatchRequest, batches)
    got = _serve(BatchMaster([teng], SchedulerConfig(page_size=PAGE)),
                 BatchRequest, batches)
    assert got == want
    assert teng.prefill_tokens_saved == jeng.prefill_tokens_saved > 0
    assert teng.decode_steps == jeng.decode_steps


def test_moe_module_sampled_engine_matches_jax_engine(monkeypatch):
    monkeypatch.setenv("REPRO_SAMPLING_BACKEND", "pallas_interpret")
    _sampled_parity(*_moe_cfgs(), MOE_KW)


def test_one_transfer_per_decode_page():
    """Transfer spy: exactly ONE device->host copy per decode_page call."""
    _, tcfg = _cfgs()
    eng = NodeEngine(tcfg, max_active=3, max_len=128, page_size=8, seed=0,
                     device="cpu")
    sched = CoroutineScheduler([eng], SchedulerConfig(page_size=8))
    sched.submit([[2, 3, 4, 5]] * 3, [20] * 3)

    calls = []
    in_page = [False]
    orig_decode, orig_to_host = eng.decode_page, eng._to_host

    def spy_to_host(arr):
        if in_page[0]:              # ignore prefill/sync transfers
            calls[-1] += 1
        return orig_to_host(arr)

    def spy_decode(active, P):
        calls.append(0)
        in_page[0] = True
        try:
            return orig_decode(active, P)
        finally:
            in_page[0] = False

    eng.decode_page, eng._to_host = spy_decode, spy_to_host
    rep = sched.run(max_ticks=300)
    assert rep["completed"] == 3
    assert calls and all(c == 1 for c in calls), calls


def test_later_slices_are_refused():
    """Sliding windows are served at model level only (the JAX engine
    refuses them too), so both engine modes refuse them, naming model
    level, while the model functions take them; MLA is served, but not
    with module granularity (the JAX ``ModuleRuntime`` has no MLA path)."""
    _, tcfg = _cfgs()
    window = dataclasses.replace(tcfg, sliding_window=64)
    with pytest.raises(NotImplementedError, match="model level"):
        NodeEngine(window, device="cpu", module_granularity=True)
    with pytest.raises(NotImplementedError, match="model level"):
        NodeEngine(window, device="cpu", max_active=2, max_len=32)
    assert set(TT.init_cache(window, 2, 32, "cpu")) == {"k", "v", "pos"}
    TT.init_params(window, device="cpu")
    mla = dataclasses.replace(reduced_config("deepseek_r1"), dtype="float32")
    with pytest.raises(NotImplementedError, match="MLA"):
        NodeEngine(mla, device="cpu", module_granularity=True)
    assert set(NodeEngine(mla, device="cpu", max_active=2, max_len=32,
                          page_size=8).cache) == {"ckv", "kr"}


def test_sampled_and_logprob_requests_are_served():
    _, tcfg = _cfgs()
    eng = NodeEngine(tcfg, device="cpu", max_active=2, max_len=64,
                     page_size=8)
    sched = CoroutineScheduler([eng], SchedulerConfig(page_size=8))
    ids = sched.submit([[2, 3, 4], [5, 6]], [6, 9],
                       sampling=[SamplingParams(temperature=0.7, seed=1),
                                 SamplingParams(top_k=3, temperature=1.2,
                                                seed=2)],
                       logprobs=True, top_logprobs=2)
    assert sched.run(max_ticks=50)["completed"] == 2
    for i, n in zip(ids, (6, 9)):
        co = sched.cos[i]
        assert len(co.generated) == len(co.token_logprobs) == n
        assert all(len(alts) == 2 for alts in co.top_token_logprobs)
        assert all(lp <= 0.0 for lp in co.token_logprobs)


def _sampled_workload(vocab, stop_token):
    """Mixed SamplingParams kwargs, logprob flags and a cross-submit prefix
    hit; rows are (custom_id, prompt, max_tokens, sampling kwargs,
    logprobs, top_logprobs)."""
    r = np.random.default_rng(5)

    def prompt(n):
        return [int(t) for t in r.integers(2, vocab, n)]

    first = [("a0", prompt(20), 9, {}, True, 0),
             ("a1", prompt(5), 14, dict(temperature=0.8, top_k=20, seed=1),
              False, 0),
             ("a2", prompt(12), 5, dict(temperature=1.1, top_p=0.9, seed=2),
              True, 3),
             ("a3", prompt(17), 20, dict(temperature=0.7, min_p=0.05,
                                         repetition_penalty=1.3,
                                         presence_penalty=0.2,
                                         frequency_penalty=0.1, seed=3),
              False, 0),
             ("a4", prompt(9), 16, dict(temperature=0.9, seed=4,
                                        stop=(stop_token,)), True, 0),
             ("a5", prompt(24), 7, dict(temperature=1.0, top_k=50, top_p=0.8,
                                        seed=5), True, 0)]
    second = [("b0", first[0][1][:2 * PAGE] + prompt(5), 6,
               dict(temperature=0.9, top_k=30, seed=9), False, 0),
              ("b1", prompt(11), 16, {}, True, 2),
              ("b2", prompt(6), 18, {}, False, 0)]
    return first, second


def _serve_sampled(master, req_cls, sp_cls, batches):
    out = {}
    for batch in batches:
        bo = master.run(master.submit(
            [req_cls(custom_id=c, prompt=p, max_tokens=m,
                     sampling=sp_cls(**kw), logprobs=lp, top_logprobs=k)
             for c, p, m, kw, lp, k in batch]))
        assert bo.request_counts["failed"] == 0
        for row in bo.results:
            out[row["custom_id"]] = row["response"]
    return out


def test_sampled_engine_matches_jax_engine_through_batch_master(monkeypatch):
    monkeypatch.setenv("REPRO_SAMPLING_BACKEND", "pallas_interpret")
    _sampled_parity(*_cfgs(), ENGINE_KW)


def _sampled_parity(jcfg, tcfg, engine_kw):
    """The sampled workload through both engines: identical tokens and
    finish reasons, logprobs within 1e-5, the stop row stopped."""
    jeng = JNodeEngine(jcfg, seed=0, **engine_kw)
    params = TT.params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                  tcfg, device="cpu")

    def port():
        eng = NodeEngine(tcfg, params=params, device="cpu", **engine_kw)
        return eng, BatchMaster([eng], SchedulerConfig(page_size=PAGE))

    # a stop token the stop row really emits: its 5th token without one
    probe = _serve_sampled(port()[1], BatchRequest, SamplingParams,
                           _sampled_workload(tcfg.vocab_size, -1))
    stop = probe["a4"]["tokens"][4]
    batches = _sampled_workload(tcfg.vocab_size, stop)
    want = _serve_sampled(JBatchMaster([jeng],
                                       JSchedulerConfig(page_size=PAGE)),
                          JBatchRequest, JSamplingParams, batches)
    teng, master = port()
    got = _serve_sampled(master, BatchRequest, SamplingParams, batches)
    assert got.keys() == want.keys()
    for cid, w in want.items():
        g = got[cid]
        assert g["tokens"] == w["tokens"], cid
        assert g["finish_reason"] == w["finish_reason"], cid
        assert ("logprobs" in g) == ("logprobs" in w), cid
        if "logprobs" in w:
            np.testing.assert_allclose(g["logprobs"]["token_logprobs"],
                                       w["logprobs"]["token_logprobs"],
                                       atol=1e-5, rtol=1e-5, err_msg=cid)
            if "top_logprobs" in w:
                gt, wt = (g["logprobs"]["top_logprobs"],
                          w["logprobs"]["top_logprobs"])
                assert [[t for t, _ in row] for row in gt] == \
                    [[t for t, _ in row] for row in wt], cid
                np.testing.assert_allclose(
                    [[v for _, v in row] for row in gt],
                    [[v for _, v in row] for row in wt], atol=1e-5,
                    rtol=1e-5, err_msg=cid)
    assert got["a4"]["finish_reason"] == "stop"
    assert got["a4"]["tokens"] == probe["a4"]["tokens"][:5]
    assert got["a0"]["tokens"] != got["b0"]["tokens"]
    assert teng.prefill_tokens_saved == jeng.prefill_tokens_saved > 0
    assert teng.decode_steps == jeng.decode_steps


def test_seed_reproducible_across_batch_composition():
    """A fixed per-sequence seed yields the identical stream alone, with
    co-resident neighbours, and in a wider slot array."""
    _, tcfg = _cfgs()
    rng = np.random.default_rng(11)
    target = [int(t) for t in rng.integers(2, tcfg.vocab_size, 7)]
    sp = SamplingParams(temperature=0.8, top_k=30, seed=123)

    def stream(extra, max_active):
        eng = NodeEngine(tcfg, max_active=max_active, max_len=128,
                         page_size=8, seed=0, device="cpu")
        sched = CoroutineScheduler([eng], SchedulerConfig(page_size=8))
        prompts = [target] + extra
        sps = [sp] + [SamplingParams(temperature=1.1, seed=50 + i)
                      for i in range(len(extra))]
        ids = sched.submit(prompts, [16] * len(prompts), sampling=sps)
        assert sched.run(max_ticks=500)["completed"] == len(prompts)
        return sched.cos[ids[0]].generated

    def prompt(n):
        return [int(t) for t in rng.integers(2, tcfg.vocab_size, n)]

    alone = stream([], 3)
    crowded = stream([prompt(5), prompt(9)], 3)
    wider = stream([prompt(6)], 4)
    assert alone == crowded == wider
    assert len(alone) == 16


@pytest.mark.parametrize("arch, batched", [("llama3_2_1b", False),
                                            ("qwen3_moe_30b", True)])
def test_prefill_batches_by_family(arch, batched):
    """A dense engine forwards each fresh prompt alone, so a request's
    prefill shapes are a function of its prompt (on the card a bf16 GEMM's
    kernel depends on its row count); an MoE batch stays whole, its rows
    coupled by expert capacity.  The tokens are the same either way."""
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in (5, 12, 9)]

    def serve(batch):
        eng = NodeEngine(cfg, max_active=4, max_len=64, page_size=8, seed=0,
                         device="cpu")
        sizes = []
        orig = eng._prefill_fresh

        def spy(fresh, lead_rows):
            sizes.append(len(fresh))
            return orig(fresh, lead_rows)
        eng._prefill_fresh = spy
        sched = CoroutineScheduler([eng], SchedulerConfig(page_size=8))
        ids = sched.submit(batch, [6] * len(batch))
        assert sched.run(max_ticks=300)["completed"] == len(batch)
        return [sched.cos[i].generated for i in ids], sizes

    together, sizes = serve(prompts)
    assert sizes == ([3] if batched else [1, 1, 1])
    if not batched:
        assert together == [serve([p])[0][0] for p in prompts]


def test_sampled_one_transfer_per_decode_page():
    """Transfer spy: sampled decode with logprobs on still performs
    exactly ONE device->host copy per decode_page."""
    _, tcfg = _cfgs()
    eng = NodeEngine(tcfg, max_active=3, max_len=128, page_size=8, seed=0,
                     device="cpu")
    sched = CoroutineScheduler([eng], SchedulerConfig(page_size=8))
    sched.submit([[2, 3, 4, 5]] * 3, [20] * 3,
                 sampling=SamplingParams(temperature=0.8, top_k=30,
                                         top_p=0.9, seed=5),
                 logprobs=True, top_logprobs=2)
    calls = []
    in_page = [False]
    orig_decode, orig_to_host = eng.decode_page, eng._to_host

    def spy_to_host(arr):
        if in_page[0]:
            calls[-1] += 1
        return orig_to_host(arr)

    def spy_decode(active, P):
        calls.append(0)
        in_page[0] = True
        try:
            return orig_decode(active, P)
        finally:
            in_page[0] = False

    eng.decode_page, eng._to_host = spy_decode, spy_to_host
    rep = sched.run(max_ticks=300)
    assert rep["completed"] == 3
    assert calls and all(c == 1 for c in calls), calls


def test_serve_cli_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "4"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "completed: 4 failed: 0" in proc.stdout, proc.stdout
