"""Sampling parameters of the PyTorch port.

Only the host-side :class:`SamplingParams` carried on every coroutine is
ported so far (a copy of ``repro.sampling.params``); the device-side
logit processors and the fused sampling kernel come with sampled
decoding.  The engine refuses non-greedy requests until then."""
from repro_torch.sampling.params import (MAX_STOP_TOKENS, SamplingParams,
                                         derive_fork_seed, pack_params)

__all__ = ["MAX_STOP_TOKENS", "SamplingParams", "derive_fork_seed",
           "pack_params"]
