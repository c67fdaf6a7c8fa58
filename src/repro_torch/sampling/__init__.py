"""Sampling subsystem of the PyTorch port: temperature / top-k / top-p /
min-p / penalty decoding with per-sequence seeds and stop tokens.

* ``params``     — the host-side :class:`SamplingParams` carried on every
  coroutine, and ``pack_params`` (a copy of ``repro.sampling.params``).
* ``processors`` — penalties and temperature, then ONE joint top-k /
  top-p / min-p value threshold (``joint_threshold``); every stage is an
  exact identity at its default, so ``SamplingParams()`` reproduces the
  greedy argmax bit for bit.
* ``sample``     — the bitwise threefry ``fold_in`` and token-addressed
  Gumbel noise, the batched ``sample`` and the decode step's
  ``sample_step``, dispatching on a static :class:`SampleFlags` plan
  (``flags_for``): the fused sampling kernel (``repro_torch.kernels.
  fused_sampling``; CUDA on the card, its plain version on the CPU), or
  the shared-sort route kept as the specification.

Reproducibility contract: the key of a sequence's t-th sampled token is
``fold_in(PRNGKey(seed), t)``, a pure function of the seed and the token
index, never of batch composition, slot, page size or node; penalty
counts and the token index are re-derived from the coroutine's tokens,
so YIELD / COMBINE / MIGRATE preserve the sampled stream.  The kernel
sums no float in an order that depends on scheduling, so a fixed seed
gives the same stream on the card too.
"""
from repro_torch.sampling.params import (MAX_STOP_TOKENS, SamplingParams,
                                         derive_fork_seed, pack_params)
from repro_torch.sampling.processors import (apply_min_p, apply_penalties,
                                             apply_temperature, apply_top_k,
                                             apply_top_p, joint_filter,
                                             joint_threshold, process_logits)
from repro_torch.sampling.sample import (DEFAULT_FLAGS, SampleFlags,
                                         base_keys, base_keys_host,
                                         flags_for, fold_in, init_state,
                                         sample, sample_one, sample_step,
                                         step_keys, stop_hit, token_gumbel)

__all__ = [
    "MAX_STOP_TOKENS", "SamplingParams", "derive_fork_seed", "pack_params",
    "apply_penalties", "apply_temperature", "apply_top_k", "apply_top_p",
    "apply_min_p", "joint_threshold", "joint_filter", "process_logits",
    "DEFAULT_FLAGS", "SampleFlags", "base_keys", "base_keys_host",
    "flags_for", "fold_in", "init_state", "sample", "sample_one",
    "sample_step", "step_keys", "stop_hit", "token_gumbel",
]
