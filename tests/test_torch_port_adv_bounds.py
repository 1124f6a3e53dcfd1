"""The discriminator's card-against-CPU bounds of ``chip_smoke.py``
(``ADV_TOL`` on each leaf, ``ADV_MEDIAN_TOL`` on the median leaf), read on
the CPU: the CPU run against itself with the discriminator's input
perturbed by 1e-6 (about the card's rounding of mu) stays inside them, and
two planted faults, one inner step left out and an inner lr of 0.09 for
0.1, break them. Both configs the script holds this way, at its narrow
parity shapes (``FULL_PARITY``). Run with ``-s`` to see the readings.
"""

import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from scrubvae_torch.models import scrubbers  # noqa: E402
from scrubvae_torch.train import parity  # noqa: E402
from scrubvae_torch.train import trainer as trainer_mod  # noqa: E402

torch.set_num_threads(1)

CONFIGS = {"ladder/5_full": cs.FULL_PARITY["z_dim"], "sane/4_full": 32}


@pytest.fixture(scope="module")
def sound():
    out = {}
    for name, z in CONFIGS.items():
        rows, draws = cs.full_parity_draws(z)
        out[name] = (rows, draws, cs._full_parity_run("cpu", rows, draws, name, z)["adv"])
    return out


def _reading(want, got):
    rec = parity.check_adv(want, got, math.inf)
    return rec["max_adv_rel"], rec["median_adv_rel"]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_perturbed_input_stays_inside(sound, monkeypatch, name, seed):
    rows, draws, want = sound[name]
    gen = torch.Generator().manual_seed(seed)
    adv_fit = scrubbers.adv_fit

    def perturbed(tx, state, z, *args):
        z = z.detach() * (1.0 + 1e-6 * torch.randn(z.shape, generator=gen))
        return adv_fit(tx, state, z, *args)

    monkeypatch.setattr(scrubbers, "adv_fit", perturbed)
    top, median = _reading(want, cs._full_parity_run("cpu", rows, draws, name, CONFIGS[name])["adv"])
    print(f"{name} input x (1 + 1e-6 N), seed {seed}: largest leaf {top:.3e}, median {median:.3e}")
    assert top <= cs.ADV_TOL[name] / 2 and median <= cs.ADV_MEDIAN_TOL / 10


@pytest.mark.parametrize("fault", ["skip_inner_step", "inner_lr_0.09"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_planted_fault_breaks_the_bounds(sound, monkeypatch, name, fault):
    rows, draws, want = sound[name]
    if fault == "skip_inner_step":
        draws = cs.skip_inner_step(draws)
    else:
        init = trainer_mod.Trainer.__init__

        def wrong_lr(self, *args, **kwargs):
            init(self, *args, **kwargs)
            self.adv_bundle["tx"].lr = 0.09

        monkeypatch.setattr(trainer_mod.Trainer, "__init__", wrong_lr)
    got = cs._full_parity_run("cpu", rows, draws, name, CONFIGS[name])["adv"]
    top, median = _reading(want, got)
    print(f"{name} {fault}: largest leaf {top:.3e}, median {median:.3e}")
    assert top > 10 * cs.ADV_TOL[name] or median > 100 * cs.ADV_MEDIAN_TOL
    with pytest.raises(AssertionError):
        parity.check_adv(want, got, cs.ADV_TOL[name], median_tol=cs.ADV_MEDIAN_TOL)
