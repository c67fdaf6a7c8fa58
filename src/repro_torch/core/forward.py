"""Algorithm 1: module-granularity decode with intra-forward yields.

PyTorch counterpart of ``repro.core.forward``.  The paper's module
wrapper (Fig. 4b) makes each neural module a coroutine step: attention
runs per sub-batch of B_attn rows, YIELDs its hidden states, and the
runtime COMBINEs all sub-batches into one B_moe batch before the (sparse)
MoE module, so each expert sees the whole batch's tokens (paper Fig. 2b).

PyTorch runs eagerly, so there are no jitted module functions and no
cache of page executables: each module call is a Python call on the
device, as ``transformer.decode_page`` already is.  A sub-batch's
attention writes its rows of the layer's cache in place (a view of rows
``sl`` of the (B, S, Hkv, dh) leaf); COMBINE is the concatenation of the
sub-batch hidden states.  ``forward_decode_page`` is the same page loop
as ``transformer.decode_page`` (``transformer.page_loop``) around the
module-granularity step; the scheduler regains control at the page
boundary, which is all §5.3 requires.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.models.api import ModelConfig


def _sub_slices(B: int, n_sub: int) -> List[slice]:
    """Static sub-batch boundaries covering ALL rows; when B % n_sub != 0
    the later groups absorb the remainder."""
    bounds = [g * B // n_sub for g in range(n_sub + 1)]
    return [slice(bounds[g], bounds[g + 1]) for g in range(n_sub)]


@dataclasses.dataclass
class ModuleTrace:
    """Record of one coroutine step (for overhead accounting, Table 2)."""
    module: str
    layer: int
    batch: int
    tokens: int


def check_module_granularity(cfg: ModelConfig) -> None:
    """What ``ModuleRuntime`` serves: ``NodeEngine``'s decoders with GQA
    attention.  MLA raises: the runtime splits attention over the {k, v}
    cache, and the JAX ``ModuleRuntime`` (which reads ``cache["k"]``) has
    no MLA path either."""
    T.check_served(cfg)
    if cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: module granularity splits GQA attention over the "
            f"{{k, v}} cache; MLA's latent cache has no such path (nor has "
            f"the JAX ModuleRuntime)")


class ModuleRuntime:
    """A model's decode step split at the paper's yield points.

    Yield-point option (b) from Fig. 6: attention | FFN/MoE as separate
    coroutine units (option (a) fuses them; option (c) per-expert is noted
    as memory-prohibitive by the paper)."""

    def __init__(self, cfg: ModelConfig, params):
        check_module_granularity(cfg)
        self.cfg = cfg
        self.params = params
        self.layer_params = T._per_layer(params)
        self.traces: List[ModuleTrace] = []

    # --- module bodies ----------------------------------------------------
    def _attn(self, p, h, k_cache, v_cache, lengths, rope_tab):
        """Attention for ONE sub-batch (B_attn rows of the slot arrays);
        writes the sub-batch's rows of the layer's cache in place."""
        xn = layers.apply_norm(self.cfg, p["ln1"], h)
        a, _, _ = layers.attention_decode(self.cfg, p["attn"], xn, k_cache,
                                          v_cache, lengths, rope_tab=rope_tab)
        return h + a

    def _step_logits(self, tokens, cache, lengths, n_sub: int,
                     on_yield: Optional[Callable] = None,
                     traces: Optional[List[ModuleTrace]] = None):
        """One Algorithm-1 decode step -> (logits (B, V) fp32, cache)."""
        cfg = self.cfg
        B = tokens.shape[0]
        slices = _sub_slices(B, n_sub)
        h = T._embed_tokens(cfg, self.params, tokens[:, None])
        cos, sin = layers.rope_tables(lengths[:, None], cfg.head_dim,
                                      cfg.rope_theta)
        for l, p in enumerate(self.layer_params):
            kc, vc = cache["k"][l], cache["v"][l]
            parts = []
            for g, sl in enumerate(slices):
                parts.append(self._attn(p, h[sl], kc[sl], vc[sl],
                                        lengths[sl], (cos[sl], sin[sl])))
                if traces is not None:
                    bsz = sl.stop - sl.start
                    traces.append(ModuleTrace("attention", l, bsz, bsz))
                if on_yield is not None:
                    on_yield("attention", l, g)     # intra-forward YIELD
            # COMBINE: the yielded sub-batches -> one B_moe batch
            h = T.ffn(cfg, p, torch.cat(parts, dim=0))[0]
            if traces is not None:
                traces.append(ModuleTrace("moe" if cfg.is_moe else "mlp", l,
                                          B, B))
            if on_yield is not None:
                on_yield("ffn", l, 0)
        return T.head_logits(cfg, self.params, h), cache

    # --- Algorithm 1 ------------------------------------------------------
    def forward_decode(self, tokens, cache, lengths, b_attn: int,
                       on_yield: Optional[Callable] = None,
                       want_logits: bool = False):
        """One decode step for the full active batch with B_attn
        sub-batching and COMBINE before each FFN/MoE.

        tokens (B,), cache {"k", "v"} with leaves (L, B, S, Hkv, dh),
        lengths (B,).  Returns (next_tokens, cache), or (logits, cache)
        with ``want_logits``.  The cache is written in place."""
        n_sub = max(tokens.shape[0] // max(b_attn, 1), 1)
        logits, cache = self._step_logits(tokens, cache, lengths, n_sub,
                                          on_yield, self.traces)
        if want_logits:
            return logits, cache
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    def forward_decode_page(self, tokens, cache, lengths, remaining,
                            b_attn: int, steps: int, sampling=None,
                            lp_k=None, flags=None):
        """Algorithm-1 decode megastep: ``steps`` module-granularity
        decode steps, each the decomposition of ``forward_decode``, with
        the page semantics of ``transformer.decode_page`` (greedy, or
        ``sampling=(sp, state)``; ``lp_k`` for the logprob plane; finished
        slots masked on the device).  Returns ``(token_block, tokens,
        lengths, remaining, cache)`` (+ the advanced sampling state), as
        ``transformer.decode_page`` does."""
        n_sub = max(int(tokens.shape[0]) // max(b_attn, 1), 1)
        return T.page_loop(
            lambda c, t, ln: self._step_logits(t, c, ln, n_sub), cache,
            tokens, lengths, remaining, steps, sampling=sampling, lp_k=lp_k,
            flags=flags)

    def expert_load(self, b_moe: int) -> Dict[str, float]:
        """Per-expert batch statistics at the MoE gate for a combined batch
        of b_moe tokens (Fig. 2b quantity)."""
        cfg = self.cfg
        if not cfg.is_moe:
            return {"per_expert": float(b_moe), "experts": 1}
        per = b_moe * cfg.experts_per_token / cfg.num_experts
        return {"per_expert": per, "experts": cfg.num_experts}
