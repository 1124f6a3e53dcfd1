"""The reference against the measured program at the CPU size (f32 on both
sides), and the comparison refusing the control and the planted faults.

The CPU size is ``run.SMALL`` with the type's model keys
(``reference.model.small_shape``; the rcnn's: the bench's smoke widths,
channels 8-8-16-16-32, z 16), batch 16, 800 frames, f32 compute and
storage. At
that size the two sides differ by summation order alone, so the limits
here are tight; where Adam's first step meets a gradient element at
round-off level its sign can differ, which moves a small leaf's change
by up to a few percent.
"""

import pytest
import torch

from benchmark import compare, manifest, run

F32_LIMITS = {"loss": 1e-5, "prior1": 1e-5, "grad1": 1e-5, "change3": 0.05, "change3_group": 0.01, "state3": 0.01}
CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_program_matches_reference_on_the_cpu(cell):
    result, lines = run.run_cell(cell, 2**31 + 11, 0.1, False, device="cpu", small=True, limits=F32_LIMITS)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.fixture(scope="module", params=CELLS)
def readings(request):
    su = run.set_up(request.param, 5, "cpu", small=True)
    run.free_program(su)
    return request.param, su, run.reference_readings(su)


def test_control_fails_the_cells_limits(readings):
    """The fp8 control at the CPU size. The numbers that refuse it, full5's
    ``loss`` and flagship's ``prior1``, read at this size as at the
    cell's; ``test_control_at_the_cells_size`` holds it on the card, also
    the TF32 control of a configuration computed in f32, which the CPU
    lacks."""
    cell, su, ref = readings
    if su.control != "fp8":
        pytest.skip(f"the {su.control} control exists on the card only")
    ok, _, lines = compare.judge(compare.numbers(run.reference_readings(su, control=True), ref, su.groups),
                                 manifest.limits(cell))
    assert not ok, lines


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    su = run.set_up(cell, 2**31 + 21, "cuda")
    run.free_program(su)
    ref = run.reference_readings(su)
    ok, _, lines = compare.judge(compare.numbers(run.reference_readings(su, control=True), ref, su.groups),
                                 manifest.limits(cell))
    assert not ok, lines


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_whose_low_precision_launch_is_skipped_is_not_correct(cell):
    """The whole run on the card with the optimizer's launch over the bf16
    weights or bf16 moments left out (at the CPU size every leaf is f32,
    so there is no such launch): the group's change reads 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark import calibrate

    with calibrate.skip_lowp_launches():
        result, lines = run.run_cell(cell, 2**31 + 31, 1.0, False)
    assert not result["correct"], lines
    group = result["checks"]["change3_group"]
    assert group["value"] > group["limit"], lines


def test_half_batch_fails_the_cells_limits(readings):
    cell, su, ref = readings
    ok, _, lines = compare.judge(compare.numbers(run.reference_readings(su, fault="half_batch"), ref, su.groups),
                                 manifest.limits(cell))
    assert not ok, lines


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_with_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    """The whole run, the chip's look skipped, with the timed path broken
    underneath: the optimizer leaves the state as it was, or each batch
    loses its second half (every mean is then the first half's). A run
    that raises prints no result, which is not correct either: in full5
    the MCMI estimator of half a batch no longer fits the state it
    replaces."""
    from scrubvae_torch.data.dataset import StreamDataset
    from scrubvae_torch.train.optim import FusedAdamW

    if fault == "unchanged_state":
        monkeypatch.setattr(FusedAdamW, "update_and_apply", lambda self, grads, state, params: state)
    else:
        batch = StreamDataset.batch
        monkeypatch.setattr(StreamDataset, "batch", lambda self, idx: batch(self, idx[: len(idx) // 2]))
    try:
        result, lines = run.run_cell(cell, 9, 0.1, False, device="cpu", small=True,
                                     limits=manifest.limits(cell))
    except ValueError as err:
        assert "does not fit" in str(err)
        return
    assert not result["correct"], lines
