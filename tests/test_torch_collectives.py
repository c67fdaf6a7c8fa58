"""The port's collective accounting against the reference's, on the CPU.

The reference reads (kind, result bytes, group size) off partitioned
HLO; the port records the same triple at each call.  The events the
reference's own parser finds in ``tests/test_roofline.py``'s HLO give
the port's ``stats_of`` the reference's ``collective_stats`` dict, at
the world sizes that test and the reference's default use;
``hierarchical_a2a_cost`` is the reference's; a group of one records an
event that counts nowhere and returns its input.
"""
import pytest
import torch

from repro.distributed import collectives as J
from repro_torch.distributed import collectives as C
from test_roofline import HLO


def _events(hlo, world):
    out = []
    for m in J._OP_RE.finditer(hlo):
        out.append((m.group("kind").replace("-start", ""),
                    J._shape_bytes(m.group("shape")),
                    J._group_size(m.group("rest"), world)))
    return out


@pytest.mark.parametrize("world", [512, 256, 1])
def test_stats_of_events_match_the_reference(world):
    events = _events(HLO, world)
    assert len(events) == 5
    assert C.stats_of(events) == J.collective_stats(HLO, world=world)


@pytest.mark.parametrize("pods,per_pod,nbytes",
                         [(2, 256, 1e9), (1, 256, 1e9), (2, 8, 3.5e7),
                          (4, 8, 1.0)])
def test_hierarchical_a2a_cost_matches_the_reference(pods, per_pod, nbytes):
    assert C.hierarchical_a2a_cost(nbytes, pods, per_pod) == \
        J.hierarchical_a2a_cost(nbytes, pods, per_pod)
    assert C._FACTORS.keys() == J._FACTORS.keys()
    for kind in C._FACTORS:
        assert C._FACTORS[kind](16) == J._FACTORS[kind](16)


def test_a_group_of_one_is_skipped():
    C.reset_events()
    g = C.ONE
    x = torch.arange(6.0, requires_grad=True)
    for fn in (g.all_reduce, g.all_gather, g.reduce_scatter, g.all_to_all,
               g.copy_in, g.reduce_out):
        assert fn(x) is x
    assert C.EVENTS == [] and C.collective_stats()["total_wire_bytes"] == 0
    C.EVENTS.extend([("all-reduce", 64, 1), ("all-gather", 32, 4)])
    st = C.collective_stats()
    assert st["counts"] == {"all-gather": 1}
    assert st["wire_bytes"] == {"all-gather": 32 * 3 / 4}
    C.reset_events()
