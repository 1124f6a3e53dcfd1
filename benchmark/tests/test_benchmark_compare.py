"""The comparison's arithmetic on hand-made readings."""

import math

import pytest

from benchmark import compare


def readings(scale=1.0, grad_scale=1.0, quiet=1e-9):
    grads = {"a": 1.0 * grad_scale, "b": 2.0 * grad_scale, "c": 4.0 * grad_scale, "bias": quiet}
    return {
        "loss": {"step1": {"rotation": 100.0 * scale, "mcmi": 0.0, "prior": 20.0 * scale, "total": 120.0 * scale},
                 "steps2_3": {"rotation": 90.0, "total": 90.0}},
        "grad1": grads,
        "change3": {k: 3e-4 * grad_scale for k in grads},
        "state3": {"bn.x": 10.0, "mals.Sxx0": 1000.0 * scale},
    }


GROUPS = {"a": "bf16/bf16", "b": "f32/f32", "c": "f32/f32", "bias": "f32/f32"}


def numbers(prog, ref):
    return compare.numbers(prog, ref, GROUPS)


def test_sound_readings_gap_nought():
    nums = numbers(readings(), readings())
    assert all(v == 0.0 for v, _ in nums.values())


def test_gap_is_held_to_the_group_median():
    g = compare.gaps({"big": 110.0, "tiny": 0.5}, {"big": 100.0, "tiny": 1e-6})
    assert math.isclose(g["big"], 0.1)
    # the tiny reading is held to the median reference reading, 50.0
    assert math.isclose(g["tiny"], (0.5 - 1e-6) / 50.0, rel_tol=1e-6)


def test_quiet_leaves_left_out_and_median_taken():
    prog = readings()
    prog["grad1"]["bias"] = 1.0  # a quiet leaf's round-off: not compared
    prog["grad1"]["c"] = 8.0  # one leaf off by 100%: the median of three stays 0
    nums = numbers(prog, readings())
    assert nums["grad1"][0] == 0.0 and "3 leaves" in nums["grad1"][1]


def test_unchanged_state_reads_one():
    prog = readings()
    prog["change3"] = {k: 0.0 for k in prog["change3"]}
    assert numbers(prog, readings())["change3"][0] == 1.0


def test_prior1_is_step_ones_prior_term():
    prog = readings()
    prog["loss"]["step1"]["prior"] = 20.2
    assert numbers(prog, readings())["prior1"] == (pytest.approx(0.01), "step 1's prior")
    del prog["loss"]["step1"]["prior"]
    assert numbers(prog, readings())["prior1"][0] == math.inf


def test_a_group_left_unmoved_reads_one():
    """One launch's leaves left where they were: the median leaf does not
    see it, the group's norm does."""
    prog = readings()
    prog["change3"]["a"] = 0.0
    nums = numbers(prog, readings())
    assert nums["change3"][0] == 0.0
    assert nums["change3_group"] == (1.0, "group bf16/bf16")


def test_group_norm_is_over_the_groups_moving_leaves():
    prog, ref = readings(), readings()
    prog["change3"]["b"] = 0.0  # b and c moved 3e-4 each: the group's norm falls by 1 - 1 / sqrt(2)
    prog["change3"]["bias"] = 5.0  # quiet: left out
    g = numbers(prog, ref)["change3_group"]
    assert g[1] == "group f32/f32" and abs(g[0] - (1 - 2**-0.5)) < 1e-12


def test_missing_or_nan_reading_is_infinite():
    prog = readings()
    del prog["state3"]["bn.x"]
    assert numbers(prog, readings())["state3"][0] == math.inf
    prog = readings()
    prog["grad1"]["a"] = math.nan
    assert numbers(prog, readings())["grad1"][0] == math.inf


def test_judge_against_limits():
    nums = {"loss": (0.01, "x"), "prior1": (1e-4, "u"), "grad1": (5.0, "y"), "change3": (0.1, "z"), "change3_group": (0.1, "v"),
            "state3": (0.2, "w")}
    limits = {"loss": 0.02, "prior1": 1e-3, "grad1": None, "change3": 0.2, "change3_group": 0.2, "state3": 0.3}
    ok, table, lines = compare.judge(nums, limits)
    assert ok and table["grad1"]["limit"] is None and "not compared" in lines[2]
    ok, _, lines = compare.judge(nums, dict(limits, loss=0.005))
    assert not ok and "FAILED" in lines[0]
