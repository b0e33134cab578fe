"""The capture probe of the split step's collectives
(parallel/probe.py) and the spawn's own limits (parallel/launch.py), on
the CPU over gloo ranks.

The probe's captures need a card; here it runs its ``eager`` place,
which holds each collective, with the split step's own split pattern,
against the value computed on the host from every rank's inputs: the
halo (an all_gather_into_tensor of every rank's two end planes: rank -
1's last plane and rank + 1's first, cyclically), the particle-to-grid
exchange's equal-block all_to_all_single of values and of int32 cells,
all_gather_into_tensor, all_reduce sum and max and a broadcast from the
last rank, at 1, 2 and 4 ranks; and the collectives of `probe.OTHERS`,
among them the halo as the uneven all_to_all_single it replaced, which
gives the same planes. A case that fails on a rank ends that spawn and
the probe starts the ranks anew after it, naming the case; a watch
that returns a message ends the ranks and raises it.
"""

import pytest

torch = pytest.importorskip("torch")

from sedifoam_tpu_torch.parallel import probe  # noqa: E402
from sedifoam_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from torch_port_sequence import sleepy_job  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_every_collective_of_the_step_gives_its_value(ranks):
    res = probe.probe_ranks(ranks, backend="gloo", device="cpu",
                            places=("eager",))
    assert set(res["results"]) == set(probe.COLLECTIVES)
    assert all(d == {"eager": "ok"} for d in res["results"].values()), \
        res["results"]
    assert res["restarts"] == 0


@pytest.mark.parametrize("ranks", [2, 4])
def test_the_other_collectives_and_the_old_halo_give_their_values(ranks):
    res = probe.probe_ranks(ranks, backend="gloo", device="cpu",
                            only=[(c, "eager") for c in probe.OTHERS])
    assert res["results"] == {c: {"eager": "ok"} for c in probe.OTHERS}


def test_a_failed_case_is_named_and_the_ranks_start_anew():
    # a capture needs a card: on the CPU the case raises on both ranks
    res = probe.probe_ranks(2, backend="gloo", device="cpu",
                            only=[("halo", "graph"), ("broadcast", "eager")])
    assert res["results"]["halo"]["graph"] != "ok"
    assert res["results"]["broadcast"] == {"eager": "ok"}
    assert res["restarts"] == 1 and len(res["seconds"]) == 2


def test_a_watch_ends_the_ranks_with_its_message():
    calls = []

    def watch():
        calls.append(1)
        return "stalled in the test" if len(calls) >= 3 else None
    with pytest.raises(TimeoutError, match="stalled in the test"):
        run_ranks(sleepy_job, 2, args=(60,), device="cpu", timeout=120,
                  watch=watch)
