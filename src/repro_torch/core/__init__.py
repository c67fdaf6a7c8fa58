"""The paper's primary contribution: the event-driven sequence coroutine
compute model.

- coroutine.py    SequenceCoroutine state machine (Fig. 4a)
- primitives.py   YIELD / COMBINE / PARTITION / MIGRATE (§4.2)
- backend.py      formal ExecutionBackend protocol (slot contract) +
                  validate_backend
- scheduler.py    Algorithm 2 — event-driven scheduling: SchedulerPolicy
                  handler table draining the priority EventQueue, §5.3
                  dynamic sequence management, stream-first results
- events.py       priority event queue + typed stream records
- plan.py         §5.4 — module roofline model, execution DAG,
                  critical-path configuration search
"""
from repro_torch.core.backend import ExecutionBackend, validate_backend  # noqa
from repro_torch.core.coroutine import Phase, SequenceCoroutine, Status  # noqa
from repro_torch.core.events import (EventKind, EventQueue,  # noqa
                                     PrimitiveEvent, SeqFinishedEvent,
                                     TokenBlockEvent)
from repro_torch.core.primitives import combine, migrate, partition, yield_  # noqa
from repro_torch.core.scheduler import (CoroutineScheduler,  # noqa
                                        SchedulerConfig, SchedulerPolicy)
