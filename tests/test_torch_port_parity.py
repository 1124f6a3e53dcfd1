"""``scrubvae_torch.train.parity``'s step-1 weights check on a synthetic
leaf of 100,000 weights with planted faults: the reference's gradient is a
float64 gradient plus f32-sized noise (1e-4), the run under test another
such draw, and both take Adam's step-1 update at ``parity.LR``.

- ``sign_unsure`` marks where the reference's own gradient may have either
  sign, from the reference and its float64 twin alone;
- where the reference is unsure, flips of the run under test are excused,
  however many;
- a sign error of the run under test where the reference is sure is
  caught: in the noise band by the flips' count, outside it element by
  element.
"""

import pytest
import torch

from scrubvae_torch.train import parity

N, NOISE = 100_000, 1e-4
NAME = "vae.fc_mu.weight"


def _update(g: torch.Tensor) -> torch.Tensor:
    return parity.LR * g / (g.abs() + parity.ADAM_EPS)


@pytest.fixture(scope="module")
def leaf():
    gen = torch.Generator().manual_seed(0)
    g64 = torch.randn(N, generator=gen, dtype=torch.float64)
    # 400 elements far below the noise: either run may give them either sign
    g64[:400] = 1e-6 * torch.sign(g64[:400])
    ref = (g64 + NOISE * torch.randn(N, generator=gen, dtype=torch.float64)).float()
    got = (g64 + NOISE * torch.randn(N, generator=gen, dtype=torch.float64)).float()
    w0 = torch.randn(N, generator=gen)
    return {"g64": g64, "ref": ref, "got": got, "w0": w0}


def _check(leaf, got_grad):
    want = {NAME: leaf["w0"] - _update(leaf["ref"])}
    got = {NAME: leaf["w0"] - _update(got_grad)}
    unsure = parity.sign_unsure({NAME: leaf["ref"]}, {NAME: leaf["g64"]})
    return parity.check_weights(want, got, {NAME: leaf["ref"]}, unsure=unsure, got_grads={NAME: got_grad})


def test_sign_unsure_is_the_reference_alone(leaf):
    unsure = parity.sign_unsure({NAME: leaf["ref"]}, {NAME: leaf["g64"]})[NAME]
    ref_flipped = torch.sign(leaf["ref"].double()) != torch.sign(leaf["g64"])
    assert int(ref_flipped.sum()) > 100 and bool(unsure[ref_flipped].all())
    # far above the noise nothing is marked, whatever the run under test did
    assert not bool(unsure[leaf["g64"].abs() > 10 * NOISE].any())


def test_flips_where_the_reference_is_unsure_are_excused(leaf):
    readings = _check(leaf, leaf["got"])
    # about half of the 400 tiny elements differ in sign between the runs
    assert readings["weight_flips_unsure"] > 1e-3 * N
    assert readings["weight_flips"] < 1e-3 * N


@pytest.mark.parametrize("where", ["noise_band", "outside"])
def test_a_sign_error_where_the_reference_is_sure_is_caught(leaf, where):
    g = leaf["ref"]
    rms = float(torch.sqrt(torch.mean(g * g)))
    if where == "noise_band":
        # 200 (2e-3 of the leaf) of the band's elements, each well above the noise
        idx = ((g.abs() < 5e-2 * rms) & (g.abs() > 100 * NOISE)).nonzero().flatten()[:200]
        match = "weights differ after step 1"
    else:
        idx = (g.abs() > rms).nonzero().flatten()[:1]
        match = "outside the noise band"
    assert not bool(parity.sign_unsure({NAME: g}, {NAME: leaf["g64"]})[NAME][idx].any())
    faulty = leaf["got"].clone()
    faulty[idx] = -faulty[idx]
    with pytest.raises(AssertionError, match=match):
        _check(leaf, faulty)
