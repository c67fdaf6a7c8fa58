"""Scheduling-plan optimization (paper §5.4).

Three pieces, exactly as the paper structures them:

1. **Module-level performance model** — roofline-style cost per module as a
   function of batch size (profiled on real hardware in the paper; here the
   model is analytic over the TPU v5e constants and validated against the
   dry-run cost_analysis in benchmarks/roofline.py).
2. **Execution DAG** — one layer's forward as nodes (compute / transfer)
   with dependency edges; COMBINE cannot run before its inputs' attention
   sub-batches; a module cannot run before its parameters are staged.
3. **Configuration search** — enumerate (B_attn, B_moe, buffer sizes), build
   the DAG, take the critical path (O(V+E) topological DP), pick the
   shortest.

The same PerfModel drives the cluster simulator (runtime/cluster.py) and
the paper-table benchmarks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.models.api import ModelConfig


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "tpu_v5e"
    peak_flops: float = 197e12          # bf16 / chip
    hbm_bw: float = 819e9               # bytes/s
    hbm_bytes: float = 16 * 2**30
    ici_bw: float = 50e9                # bytes/s/link
    host_link_bw: float = 32e9          # host<->device staging (PCIe-class)
    host_bytes: float = 2 * 2**40       # 2 TB host per node (paper testbed)
    chips_per_node: int = 8

    def with_(self, **kw):
        return dataclasses.replace(self, **kw)


# A5000-class memory-constrained accelerator for §6.5 experiments
A5000 = Hardware(name="a5000", peak_flops=27.8e12, hbm_bw=768e9,
                 hbm_bytes=24 * 2**30, ici_bw=0.0, host_link_bw=16e9,
                 host_bytes=1 * 2**40, chips_per_node=1)


@dataclasses.dataclass
class ModuleCost:
    flops: float
    hbm_bytes: float
    ici_bytes: float = 0.0

    def time(self, hw: Hardware) -> float:
        t = max(self.flops / hw.peak_flops, self.hbm_bytes / hw.hbm_bw)
        if self.ici_bytes and hw.ici_bw:
            t = max(t, self.ici_bytes / hw.ici_bw)
        return t


# ---------------------------------------------------------------------------
# module-level roofline model
# ---------------------------------------------------------------------------


def _attn_param_bytes(cfg: ModelConfig) -> float:
    H, Hkv, dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return 2.0 * (D * H * dh + 2 * D * Hkv * dh + H * dh * D)


def _expert_param_bytes(cfg: ModelConfig) -> float:
    return 2.0 * 3 * cfg.d_model * cfg.moe_d_ff


def _mlp_param_bytes(cfg: ModelConfig) -> float:
    return 2.0 * 3 * cfg.d_model * cfg.d_ff


def attention_cost(cfg: ModelConfig, batch: int, ctx: int, new_tokens: int,
                   *, params_resident: bool = True) -> ModuleCost:
    """One layer's attention for `batch` sequences with `ctx` history,
    processing `new_tokens` positions each (decode: 1; prefill: S)."""
    H, Hkv, dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    toks = batch * new_tokens
    eff_ctx = min(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
    proj = 2.0 * toks * D * (H * dh + 2 * Hkv * dh + H * dh)
    attn = 4.0 * batch * new_tokens * eff_ctx * H * dh
    if new_tokens > 1:  # causal prefill: half the rectangle
        attn *= 0.5
    flops = proj + attn
    kv_bytes = 2.0 * batch * eff_ctx * Hkv * dh * 2
    act_bytes = 2.0 * toks * D * 4
    pbytes = 0.0 if params_resident else _attn_param_bytes(cfg)
    return ModuleCost(flops, kv_bytes + act_bytes + pbytes)


def moe_cost(cfg: ModelConfig, tokens: int, *, experts_resident: bool = True,
             ep_degree: int = 1) -> ModuleCost:
    """One layer's MoE for a combined batch of `tokens`.

    Per-expert batch = tokens*k/E — the quantity COMBINE inflates (Fig. 2b).
    Weight traffic counts every *activated* expert's weights once (the
    memory-bound regime when per-expert batches are small)."""
    E, k, F, D = cfg.num_experts, cfg.experts_per_token, cfg.moe_d_ff, cfg.d_model
    flops = 2.0 * 3 * tokens * k * D * F
    activated = E * (1.0 - (1.0 - k / E) ** max(tokens, 1))
    w_bytes = activated / max(ep_degree, 1) * _expert_param_bytes(cfg)
    if experts_resident and tokens * k / E >= 1:
        w_bytes = min(w_bytes, E / max(ep_degree, 1) * _expert_param_bytes(cfg))
    act_bytes = 2.0 * tokens * D * 2 * k
    ici = 2.0 * tokens * D * 2 if ep_degree > 1 else 0.0   # dispatch+combine
    return ModuleCost(flops, w_bytes + act_bytes, ici)


def mlp_cost(cfg: ModelConfig, tokens: int, *, params_resident=True) -> ModuleCost:
    flops = 2.0 * 3 * tokens * cfg.d_model * cfg.d_ff
    pb = 0.0 if params_resident else _mlp_param_bytes(cfg)
    return ModuleCost(flops, pb + 2.0 * tokens * cfg.d_model * 4)


def saturation_tokens(cfg: ModelConfig, hw: Hardware) -> int:
    """Tokens needed at the MoE gate so every expert's GEMM becomes
    compute-bound (the paper's 16384-token example, §7)."""
    if not cfg.is_moe:
        return 1
    # per-expert batch b*: 2*b*D*F/peak >= 3*2*D*F/bw  =>  b* = 3*peak/bw...
    b_star = math.ceil(hw.peak_flops / hw.hbm_bw)  # ~240 on v5e
    return math.ceil(b_star * cfg.num_experts / cfg.experts_per_token)


# ---------------------------------------------------------------------------
# execution DAG + critical path
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Node:
    name: str
    cost_s: float
    deps: List[str] = dataclasses.field(default_factory=list)
    resource: str = "compute"     # compute | host_link | ici


class DAG:
    def __init__(self):
        self.nodes: Dict[str, Node] = {}

    def add(self, name, cost_s, deps=(), resource="compute"):
        self.nodes[name] = Node(name, cost_s, list(deps), resource)
        return name

    def critical_path(self) -> Tuple[float, List[str]]:
        """Longest path via topological DP — O(V+E)."""
        finish: Dict[str, float] = {}
        parent: Dict[str, Optional[str]] = {}

        def visit(n: str) -> float:
            if n in finish:
                return finish[n]
            node = self.nodes[n]
            best, bp = 0.0, None
            for d in node.deps:
                t = visit(d)
                if t > best:
                    best, bp = t, d
            finish[n] = best + node.cost_s
            parent[n] = bp
            return finish[n]

        end, end_n = 0.0, None
        for n in self.nodes:
            t = visit(n)
            if t > end:
                end, end_n = t, n
        path = []
        while end_n is not None:
            path.append(end_n)
            end_n = parent[end_n]
        return end, list(reversed(path))


@dataclasses.dataclass(frozen=True)
class Plan:
    b_attn: int                   # attention sub-batch (COMBINE on attention)
    b_moe: int                    # combined MoE batch (COMBINE on MoE)
    offload_kv: bool
    offload_params: bool
    # staging-buffer budget: capacity of the transient host<->device ring
    # (memory/buffers.py).  Not just a model input any more — SimEngine's
    # pipelined stage_appends meters its in-flight KV bytes against this
    # (the real NodeEngine sizes its gate from the cache leaves directly).
    ring_buffer_bytes: int
    layer_time_s: float
    notes: str = ""


def build_layer_dag(cfg: ModelConfig, hw: Hardware, b_attn: int, b_moe: int,
                    ctx: int, new_tokens: int, *, offload_kv: bool,
                    offload_params: bool, ep_degree: int = 1) -> DAG:
    """One layer of Algorithm 1 under the memory plan (§5.2 Figure 7)."""
    dag = DAG()
    n_sub = max(b_moe // max(b_attn, 1), 1)
    attn = attention_cost(cfg, b_attn, ctx, new_tokens,
                          params_resident=not offload_params)
    prev = None
    sub_names = []
    for g in range(n_sub):
        deps = [prev] if prev else []
        if offload_params:
            pf = dag.add(f"prefetch_attn_{g}",
                         _attn_param_bytes(cfg) / hw.host_link_bw if g == 0 else 0.0,
                         deps=[], resource="host_link")
            deps.append(pf)
        a = dag.add(f"attn_{g}", attn.time(hw), deps)
        # async KV checkpoint fully overlaps (paper Table 2: <5us + overlap)
        if offload_kv:
            dag.add(f"kv_offload_{g}",
                    2.0 * b_attn * new_tokens * cfg.num_kv_heads
                    * cfg.head_dim * 2 / hw.host_link_bw,
                    [a], resource="host_link")
        sub_names.append(a)
        prev = a
    tokens = b_moe * new_tokens
    comb = dag.add("combine", 0.0, sub_names)
    if cfg.is_moe:
        deps = [comb]
        if offload_params:
            deps.append(dag.add(
                "prefetch_experts",
                moe_cost(cfg, tokens, ep_degree=ep_degree).hbm_bytes
                / hw.host_link_bw, [], resource="host_link"))
        m = moe_cost(cfg, tokens, experts_resident=not offload_params,
                     ep_degree=ep_degree)
        dag.add("moe", m.time(hw), deps)
    else:
        dag.add("mlp", mlp_cost(cfg, tokens,
                                params_resident=not offload_params).time(hw),
                [comb])
    return dag


def search_plan(cfg: ModelConfig, hw: Hardware, *, ctx: int, new_tokens: int,
                max_active: int, offload_kv: bool = False,
                offload_params: bool = False, ep_degree: int = 1) -> Plan:
    """Enumerate (B_attn, B_moe) and pick the shortest critical path per
    token (paper §5.4 'Configuration search')."""
    best: Optional[Plan] = None
    b_moe = max_active
    b = 1
    cands = []
    while b <= b_moe:
        cands.append(b)
        b *= 2
    if b_moe not in cands:
        cands.append(b_moe)
    for b_attn in cands:
        dag = build_layer_dag(cfg, hw, b_attn, b_moe, ctx, new_tokens,
                              offload_kv=offload_kv,
                              offload_params=offload_params,
                              ep_degree=ep_degree)
        t, _ = dag.critical_path()
        per_tok = t / max(b_moe * new_tokens, 1)
        if best is None or per_tok < best.layer_time_s:
            best = Plan(b_attn, b_moe, offload_kv, offload_params,
                        ring_buffer_bytes=int(2 * _expert_param_bytes(cfg))
                        if cfg.is_moe else int(2 * _mlp_param_bytes(cfg)),
                        layer_time_s=per_tok,
                        notes=f"critical-path {t*1e3:.3f} ms/layer")
    return best


def step_time(cfg: ModelConfig, hw: Hardware, plan: Plan, batch: int,
              ctx: int, new_tokens: int, ep_degree: int = 1) -> float:
    """End-to-end forward time for `batch` sequences under `plan`."""
    dag = build_layer_dag(cfg, hw, min(plan.b_attn, batch), batch, ctx,
                          new_tokens, offload_kv=plan.offload_kv,
                          offload_params=plan.offload_params,
                          ep_degree=ep_degree)
    t, _ = dag.critical_path()
    L = cfg.num_layers + cfg.encoder_layers
    # embedding + head
    toks = batch * new_tokens
    head = 2.0 * toks * cfg.d_model * cfg.vocab_size / hw.peak_flops
    return t * L + head
