"""The sequence coroutine abstraction (paper §4, Figure 4a).

A SequenceCoroutine carries everything needed to pause, migrate, combine,
partition and resume one sequence's computation: identity, token state,
phase, and references to where its KV/recurrent state lives (host store
pages vs a device slot).  The runtime manipulates coroutines exclusively
through the primitives in core/primitives.py.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.sampling.params import SamplingParams


class Phase(str, enum.Enum):
    PREFILL = "prefill"
    DECODING = "decoding"


class Status(str, enum.Enum):
    INIT = "init"          # submitted, not yet prefilled
    ACTIVE = "active"      # occupying a device slot
    INACTIVE = "inactive"  # yielded; state checkpointed to host
    DONE = "done"


@dataclasses.dataclass
class SequenceCoroutine:
    seq_id: int
    prompt: List[int]
    max_out: int
    max_in: int = 0
    phase: Phase = Phase.PREFILL
    status: Status = Status.INIT

    # generation state
    generated: List[int] = dataclasses.field(default_factory=list)
    last_token: int = 0
    length: int = 0                 # tokens represented in the KV state

    # sampling: params travel WITH the coroutine so COMBINE/MIGRATE/
    # PARTITION preserve per-sequence decoding behavior; device-side
    # sampling state (PRNG key index, penalty counts) is re-derived from
    # (sampling.seed, generated, prompt) at slot install, so no extra
    # state crosses nodes.  `stopped` records a stop-token hit (the stop
    # token IS emitted, then the sequence halts).
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    stopped: bool = False
    # deadline degradation: the scheduler's SEQ_DONE sweep sets this when
    # wall time since submit exceeds sampling.deadline_s — the sequence
    # finishes gracefully with whatever it has (finish_reason="deadline")
    deadlined: bool = False

    # logprobs: when requested, the fused megastep returns a second (P, B)
    # f32 chosen-token logprob plane (and optional top-K alternatives)
    # through the SAME single per-page transfer; values are log-softmax of
    # the raw model logits (pre-sampling-pipeline), aligned 1:1 with
    # `generated`.
    logprobs: bool = False               # collect chosen-token logprobs
    top_logprobs: int = 0                # also collect top-K alternatives
    token_logprobs: List[float] = dataclasses.field(default_factory=list)
    top_token_logprobs: List[List[tuple]] = dataclasses.field(
        default_factory=list)            # per token: [(token_id, lp), ...]

    # placement (scheduler book-keeping; the paper's `migrate` target)
    node: int = 0
    slot: Optional[int] = None      # device slot when ACTIVE
    partition_group: Optional[List[int]] = None  # device ids when PARTITIONed

    # shared-prefix fan-out: forks of one prompt share a fork_group (the
    # lead sibling's seq_id); the engine prefills the group's prompt once
    # and every sibling rides the lead's span pages copy-on-write.
    # prefix_hit_tokens counts prompt tokens whose prefill was skipped
    # (fork dedupe or a cross-submit PrefixIndex hit) — reset on recompute
    # recovery, where the prompt is re-prefilled from scratch.
    fork_group: Optional[int] = None
    prefix_hit_tokens: int = 0

    # module-level execution cursor (intra-forward yield position)
    module_cursor: int = 0          # index into the coroutine execution flow
    output: Any = None              # hidden states between module calls

    # user callbacks (paper §4.3: custom local state handling, e.g. dynamic
    # KV quantization) — called as cb(coroutine, event, payload)
    callbacks: Dict[str, Callable] = dataclasses.field(default_factory=dict)

    # accounting
    submitted_t: float = dataclasses.field(default_factory=time.monotonic)
    finished_t: Optional[float] = None
    yields: int = 0
    migrations: int = 0

    # ------------------------------------------------------------------
    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return self.status == Status.DONE

    @property
    def remaining(self) -> int:
        if self.stopped or self.deadlined:
            return 0
        return max(self.max_out - len(self.generated), 0)

    @property
    def finish_reason(self) -> str:
        # a stop-token hit outranks the deadline: the output is already
        # complete, the deadline merely arrived in the same round
        if self.stopped:
            return "stop"
        if self.deadlined:
            return "deadline"
        return "length"

    def tokens(self) -> List[int]:
        return self.prompt + self.generated

    def fire(self, event: str, payload=None):
        cb = self.callbacks.get(event)
        if cb is not None:
            cb(self, event, payload)

    def finish(self):
        self.status = Status.DONE
        self.finished_t = time.monotonic()
        self.fire("on_done", None)

    def sct(self) -> Optional[float]:
        """Sequence completion time (paper §2.1)."""
        if self.finished_t is None:
            return None
        return self.finished_t - self.submitted_t
