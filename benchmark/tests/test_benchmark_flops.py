"""A recount of the pinned FLOP files on the meta device."""

import pytest

from benchmark import flops, manifest


@pytest.mark.parametrize("workload", [w["name"] for w in manifest.benchmark()["workloads"]])
def test_recount_matches_the_file(workload):
    w = manifest.workload(workload)
    batch = manifest.traffic(w["traffic"])["batch_size"]
    pinned = manifest.flops(w["config"], batch)
    again = flops.count(w["config"], batch)
    assert again["flops_per_step"] == pinned["flops_per_step"]
    assert again["by_operator"] == pinned["by_operator"]


def test_flagship_count_is_the_ports_own():
    # the port's own count of the same step (utils/step_cost.py): 468.47 GFLOP
    assert abs(manifest.flops("flagship", 512)["flops_per_step"] / 1e9 - 468.47) < 0.01
