"""The port's meta-device dry run (``launch/dryrun.py``) on the CPU.

Llama-3.2-1B and Qwen3-30B-A3B, every shape, on the production meshes
(16, 8) and (2, 16, 8), with no card: one JSON record a cell, ok or
skipped, none failed.  Each train cell's reckoned parameter bytes equal
the local slices ``shard_params`` cuts from the meta-device template on
rank 0; its gradients match the parameters (bf16), its fp32 sums are 4 B
a local parameter when it has more than one microbatch, and its ZeRO-1
state is 12 B a parameter over the ranks (within the padding).  The full
Qwen3-30B-A3B at ``train_4k`` on (16, 8) holds about 3.9 B parameters a
rank and fits in 80 GB before activations; the full DeepSeek-R1 does
not (though ``build_cell`` takes it); on one node (1, 8) Qwen3-30B-A3B's
ZeRO-1 state alone is ~46 GB
and the rank's sum ~77 GB before activations.  DeepSeek-R1's and
Pixtral-12B's train and serving cells, H2O-Danube-1.8B's serving cells,
and Mamba2-370M's, RecurrentGemma-2B's and Whisper-base's cells run, with
the design's collectives (no all-to-all for MLA's or the SSM's prefill).
"""
import json

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as TT


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dry")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        recs = dryrun.run(["llama3_2_1b", "qwen3_moe_30b"],
                          list(dryrun.SHAPES), [False, True], str(out))
    return out, recs


def _rec(recs, tag):
    return next(r for r in recs if r["cell"] == tag)


def test_every_cell_is_recorded(records):
    out, recs = records
    assert len(recs) == 2 * 4 * 2
    assert {r["status"] for r in recs} == {"ok", "skipped"}
    files = sorted(p.name for p in out.glob("*.json"))
    assert len(files) == 16
    on_disk = json.loads((out / "qwen3_moe_30b.train_4k.single.json")
                         .read_text())
    assert on_disk["status"] == "ok" and on_disk["runs"] is True
    assert _rec(recs, "llama3_2_1b.long_500k.multi")["status"] == "skipped"
    assert _rec(recs, "llama3_2_1b.decode_32k.single")["runs"] is True


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen3_moe_30b"])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_train_reckoning_matches_the_sliced_template(records, arch, multi):
    _, recs = records
    rec = _rec(recs, f"{arch}.train_4k.{'multi' if multi else 'single'}")
    mesh = mesh_lib.make_production_mesh(multi_pod=multi)
    rank0 = mesh_lib.Mesh(mesh.axis_names, mesh.sizes, rank=0)
    cfg = get_config(arch)
    specs = shd.param_specs(cfg, mesh_lib.mesh_axes(mesh), 8, "tp")
    local = shd.shard_params(TT.param_template(cfg), specs, rank0)
    leaves = list(_leaves(local))
    assert all(t.device.type == "meta" for t in leaves)
    n = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    b = rec["per_rank_bytes"]
    assert rec["per_rank_parameters"] == n
    assert b["parameters"] == nbytes == b["gradients"]
    assert rec["microbatches"] > 1 and b["grad_accumulators"] == 4 * n
    total = TT.param_count(cfg)
    assert 12 * total / mesh.size <= b["zero1_state"] \
        <= 12 * total / mesh.size + 12 * 2 * len(leaves)
    assert rec["per_rank_total_bytes"] == sum(b.values())
    assert rec["fits_80gb"] and rec["per_rank_total_bytes"] < 80e9


def test_qwen3_on_the_production_mesh_and_on_one_node(records):
    _, recs = records
    rec = _rec(recs, "qwen3_moe_30b.train_4k.single")
    assert 3.8e9 < rec["per_rank_parameters"] < 4.0e9
    assert 7.6e9 < rec["per_rank_bytes"]["parameters"] < 8.0e9
    node = mesh_lib.Mesh(("data", "model"), (1, 8))
    one = dryrun.reckon("qwen3_moe_30b", "train_4k", node)
    assert 44e9 < one["per_rank_bytes"]["zero1_state"] < 48e9
    # 77 GB before activations: under 3 GB of the card left for them
    assert 75e9 < one["per_rank_total_bytes"] < 80e9
    ds = dryrun.reckon("deepseek_r1", "train_4k",
                       mesh_lib.make_production_mesh())
    # build_cell takes it (MLA in the tp regime); it does not fit
    assert not ds["fits_80gb"] and ds["runs"]


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen3_moe_30b"])
def test_the_peak_while_drawing_the_weights(records, arch):
    """Each rank draws its slices (``init_params`` with ``part``), so the
    peak while the weights are drawn is its parameters plus the largest
    single draw: the padded vocabulary's fp32 draw and its bf16 cast (the
    embedding and ``lm_head``; 1.87 GB for Qwen3-30B-A3B), not the full
    tree."""
    _, recs = records
    rec = _rec(recs, f"{arch}.train_4k.single")
    cfg = get_config(arch)
    draw = TT.padded_vocab(cfg) * cfg.d_model * (4 + 2)
    assert rec["per_rank_init_peak_bytes"] == \
        rec["per_rank_bytes"]["parameters"] + draw
    assert rec["per_rank_init_peak_bytes"] < 80e9
    if cfg.is_moe:  # under a quarter of the full tree's 61 GB in bf16
        assert rec["per_rank_init_peak_bytes"] < TT.param_count(cfg) * 2 / 4


def test_serving_cells_reckon_the_cache(records):
    """Each serving cell of Llama-3.2-1B and Qwen3-30B-A3B runs
    (``build_cell`` takes it) and reckons k and v of (L, B / data, S / 8,
    Hkv, dh) in bf16 a rank, no gradients; the decode regime replicates
    the attention weights, so its parameters outweigh the prefill's."""
    _, recs = records
    for arch in ("llama3_2_1b", "qwen3_moe_30b"):
        cfg = get_config(arch)
        for shape, B in (("decode_32k", 128), ("prefill_32k", 32)):
            for mesh, data in (("single", 16), ("multi", 32)):
                rec = _rec(recs, f"{arch}.{shape}.{mesh}")
                assert rec["status"] == "ok" and rec["runs"] is True, rec
                want = 2 * cfg.num_layers * (B // data) * (32768 // 8) \
                    * cfg.num_kv_heads * cfg.head_dim * 2
                assert rec["per_rank_bytes"]["cache"] == want
                assert rec["per_rank_bytes"]["gradients"] == 0
        dec = _rec(recs, f"{arch}.decode_32k.single")["per_rank_bytes"]
        pre = _rec(recs, f"{arch}.prefill_32k.single")["per_rank_bytes"]
        assert dec["parameters"] > pre["parameters"]


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen2_0_5b"])
def test_seq_cells_run_with_the_designs_collectives(arch):
    """SmolLM-360M's 15 and Qwen2-0.5B's 14 q heads do not split over the
    production mesh's model axis of 8: their train and prefill cells run
    in the ``seq`` attention mode.  A prefill's collectives are 1 + 2 L
    all-reduces and the logits' all-gather, without the ``heads`` mode's
    two all-to-alls (Llama-3.2-1B's).  The gloo runs hold the design's
    counts to what the ranks send (``test_torch_distributed.
    test_collective_stats_of_the_sharded_step``, ``test_torch_seq_fsdp.
    test_seq_train_step_matches_jax``, ``test_seq_prefill_cell_matches_jax``).
    """
    mesh = mesh_lib.make_production_mesh()
    cfg = get_config(arch)
    L = cfg.num_layers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        pre = dryrun.reckon(arch, "prefill_32k", mesh)
        train = dryrun.reckon(arch, "train_4k", mesh)
        llama = dryrun.reckon("llama3_2_1b", "prefill_32k", mesh)
    assert pre["runs"] and train["runs"], (pre["why_not"], train["why_not"])
    assert pre["note"] == train["note"] == "attention=seq"
    assert pre["collectives"] == {"all-reduce": 1 + 2 * L, "all-gather": 1}
    assert llama["collectives"]["all-to-all"] == 2


ATTN_CELLS = [("deepseek_r1", s) for s in ("train_4k", "prefill_32k",
                                           "decode_32k")] \
    + [("pixtral_12b", s) for s in ("train_4k", "prefill_32k",
                                    "decode_32k")] \
    + [("h2o_danube_1_8b", s) for s in ("prefill_32k", "decode_32k",
                                        "long_500k")] \
    + [(a, s) for a in ("mamba2_370m", "recurrentgemma_2b", "whisper_base")
       for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")
       if not (a == "whisper_base" and s == "long_500k")]
# the recurrent and encoder-decoder families on (16, 8): a prefill's and a
# decode step's all-reduces (Mamba2-370M 1 + 2 x 48 both; RecurrentGemma-
# 2B 1 + 2 x 26 sublayers, and a step 1 + 2 x 18 RG-LRU + 3 x 8 ring
# sublayers; Whisper-base 1 + 2 x 6 encoder + 3 x 6 decoder layers, and
# a step 1 + 5 x 6), a prefill's all-to-alls (Whisper's K, V and cross K,
# V; none for the SSM, and none for the hybrid's 10 heads over 8, the seq
# mode), and a train cell's note
FAMILY_CELLS = {"mamba2_370m": (97, 97, 0, "attention=seq, channel TP"),
                "recurrentgemma_2b": (53, 61, 0,
                                      "attention=seq, channel TP"),
                "whisper_base": (31, 31, 4, "attention=heads")}


@pytest.mark.parametrize("arch,shape", ATTN_CELLS,
                         ids=[f"{a}-{s}" for a, s in ATTN_CELLS])
def test_attention_family_cells_run_with_the_designs_collectives(arch,
                                                                 shape):
    """DeepSeek-R1's MLA and Pixtral-12B's vision decoder in the train and
    both serving cells, H2O-Danube-1.8B's ring in the serving cells
    (``long_500k`` among them), and Mamba2-370M, RecurrentGemma-2B and
    Whisper-base in every cell that applies, run on the production mesh
    (16, 8).  A decoder's prefill collectives are 1 + 2 L all-reduces and
    the logits' all-gather, with the two all-to-alls of K and V (a ring's
    over its slots) and none for MLA, whose latent every rank holds; a
    decode step 1 + 3 L all-reduces and the argmax's all-gather, whatever
    the cache; the other families' are ``FAMILY_CELLS``'.  The gloo runs
    hold these counts to what the ranks send
    (``test_torch_attn_families_tp.py``,
    ``test_torch_recurrent_encdec_tp.py``).  The rings' caches are their
    4096 (Danube) or 2048 (RecurrentGemma) slots over the model axis, at
    any sequence, beside the RG-LRU's states and convolutions over its
    channels."""
    mesh = mesh_lib.make_production_mesh()
    cfg = get_config(arch)
    L = cfg.num_layers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        rec = dryrun.reckon(arch, shape, mesh)
    assert rec["runs"], rec["why_not"]
    kind = dryrun.SHAPES[shape].kind
    if arch in FAMILY_CELLS:
        pre, dec, a2a, note = FAMILY_CELLS[arch]
        want = {"train": None, "prefill": {"all-reduce": pre,
                                           "all-gather": 1},
                "decode": {"all-reduce": dec, "all-gather": 1}}[kind]
        if kind == "prefill" and a2a:
            want["all-to-all"] = a2a
        if want is None:
            assert rec["note"] == note
        else:
            assert rec["collectives"] == want
        if cfg.family == "hybrid" and kind == "decode":
            B = dryrun.SHAPES[shape].global_batch
            rows = B // 16 if B % 16 == 0 else B
            n_units, n_tail = TT._hybrid_counts(cfg)
            Wl, W = cfg.local_window // 8, cfg.lru_width // 8
            n_rec = n_units * 2 + n_tail
            assert rec["per_rank_bytes"]["cache"] == rows * (
                n_units * Wl * (2 * cfg.head_dim * 2 + 4)
                + n_rec * (W * 4 + 3 * W * 2))
        return
    if kind == "prefill":
        want = {"all-reduce": 1 + 2 * L, "all-gather": 1}
        if not cfg.use_mla:
            want["all-to-all"] = 2
        assert rec["collectives"] == want
    elif kind == "decode":
        assert rec["collectives"] == {"all-reduce": 1 + 3 * L,
                                      "all-gather": 1}
    else:
        assert rec["note"] == "attention=heads" + (
            f", EP {cfg.num_experts}/8 experts per shard" if cfg.is_moe
            else "")
    if cfg.sliding_window and kind == "decode":
        B = dryrun.SHAPES[shape].global_batch
        rows = B // 16 if B % 16 == 0 else B
        slots = cfg.sliding_window // 8
        assert rec["per_rank_bytes"]["cache"] == L * rows * slots * (
            2 * cfg.num_kv_heads * cfg.head_dim * 2 + 4)
