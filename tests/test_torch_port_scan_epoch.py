"""``train.scan_epoch`` in the port: the in-place train step, the kernel's
Philox step read from the optimizer's device count, the epochs with the
key on and off, the port's scanned epochs against the JAX package's
(``make_train_epoch``, ``make_eval_epoch``), and ``profile_step``.

On the CPU the in-place step runs eagerly (the CUDA graphs that replay it
on the card are held by ``chip_smoke.py --phases graph``); it must equal
the functional step bit for bit. The sizes are the bench's ``--small``
(channels 8-8-16-16-32, z 16, batch 16, f32).
"""

import copy
import json

import numpy as np
import pytest
import torch
from _port_fit import run_both, write_pose_files
from test_torch_port_eval import jax_draws
from test_torch_port_fit import CONFIG, band

from scrubvae_tpu.train.trainer import Trainer as JaxTrainer
from scrubvae_torch import bench, profile_step
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.ops import fused_adamw as fa
from scrubvae_torch.train import optim
from scrubvae_torch.train.graph import storage
from scrubvae_torch.train.step import land_state
from scrubvae_torch.train.trainer import Trainer
from scrubvae_torch.utils import profiling

torch.set_num_threads(1)

STEPS = 3


def _state_bits(trainer) -> dict:
    """Every tensor of the trainer's model and state (integer views of the
    floats, so bits compare), the host step counts and the generator."""
    st = trainer.state
    out = {f"model.{k}": v for k, v in trainer.model.state_dict().items()}

    def walk(prefix, o):
        if isinstance(o, torch.Tensor):
            out[prefix] = o
        elif isinstance(o, torch.nn.Module):
            for k, v in o.state_dict().items():
                out[f"{prefix}.{k}"] = v
        elif isinstance(o, dict):
            for k, v in o.items():
                walk(f"{prefix}.{k}", v)
        elif isinstance(o, (list, tuple)):
            for i, v in enumerate(o):
                walk(f"{prefix}.{i}", v)
        elif isinstance(o, torch.Generator):
            out[prefix] = o.get_state()
        elif isinstance(o, (int, float)) and not isinstance(o, bool):
            out[prefix] = torch.tensor(o)
        elif hasattr(o, "__dataclass_fields__"):
            for k in o.__dataclass_fields__:
                walk(f"{prefix}.{k}", getattr(o, k))

    walk("state", st)
    return {
        k: (v.detach().clone().view({2: torch.int16, 4: torch.int32, 8: torch.int64}[v.element_size()])
            if v.is_floating_point() else v.detach().clone())
        for k, v in out.items()
    }


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, bad


def _small(scan: bool):
    return bench.build(16, 51, 16, bench.SMALL_CH, "cpu", precision="fp32", bf16_params=False, scan_epoch=scan)


def test_inplace_step_equals_functional_step_bitwise():
    """The flagship at small width: three in-place steps (state tensors
    landing where they came from, weights from the device buffer, metrics
    summed in place) against three functional steps, bit for bit, and
    every state tensor still where it lay."""
    (fun, ds), (inp, _) = _small(False), _small(True)
    rows = torch.as_tensor(np.random.default_rng(0).integers(0, len(ds), (STEPS, 16)))
    scale = fun.loss_scale_for_epoch(1)
    weights = inp._loss_weights(scale)
    ptrs = storage([inp.model, inp.state])
    sums, want = {}, {}
    for r in rows:
        fun.state, m = fun.train_step(fun.state, r, scale)
        want = {k: want[k] + v if k in want else v for k, v in m.items()}
        inp.state = inp.inplace_step(inp.state, r, weights, sums)
    _assert_same(_state_bits(fun), _state_bits(inp))
    assert {k: float(v) for k, v in sums.items()} == {k: float(v) for k, v in want.items()}
    assert inp.state.step == inp.state.opt_state.step == int(inp.state.opt_state.count) == STEPS
    # every tensor of the in-place trainer's state lies where it did
    assert storage([inp.model, inp.state]) == ptrs


def test_land_state_copies_into_the_old_storage():
    old = {"a": torch.zeros(3), "b": [torch.ones(2)], "n": 1}
    keep = old["a"]
    new = {"a": torch.arange(3.0), "b": [old["b"][0]], "n": 2}
    out = land_state(old, new)
    assert out["a"] is keep and torch.equal(keep, torch.arange(3.0))
    assert out["b"][0] is old["b"][0] and out["n"] == 2
    with pytest.raises(ValueError):
        land_state({"a": torch.zeros(3)}, {"a": torch.zeros(4)})


def _functional_epoch(trainer, epoch: int, rows: np.ndarray) -> dict:
    """An epoch of ``rows`` through the functional train step from the
    host, the loss weights as floats: the reference of the in-place
    epochs."""
    scale = trainer.loss_scale_for_epoch(epoch)
    sums = {}
    for r in torch.as_tensor(rows):
        trainer.state, m = trainer.train_step(trainer.state, r, scale)
        sums = {k: sums[k] + v if k in sums else v for k, v in m.items()}
    return {k: float(sums[k]) / len(rows) for k in sorted(sums)}


def test_full_stack_epochs_scan_on_equal_off_bitwise():
    """configs/ladder/5_full.yaml at small width (QDA, the adversarial
    discriminator and its inner AdamW, MCMI, total correlation): an epoch,
    the validation epoch (which rebuilds the MCMI estimator) and another
    epoch of ``Trainer.train_epoch`` (the in-place step) against the same
    epochs through the functional step, bit for bit; then the flagship's
    two epochs with ``train.scan_epoch`` on and off, bit for bit."""
    runs = {}
    for scan in (False, True):
        trainer, ds = profile_step.build_from_config(
            profile_step.ROOT / "configs" / "ladder" / "5_full.yaml", "cpu", small=True, scan_epoch=scan,
            val_frames=400,
        )
        assert trainer.scan_train == scan and not trainer.use_graphs
        epoch = trainer.train_epoch if scan else lambda e, rows: _functional_epoch(trainer, e, rows)
        r = np.random.default_rng(3)
        m1 = epoch(1, r.integers(0, len(ds), (2, 16)))
        val, z = trainer.test_epoch(1)
        m2 = epoch(2, r.integers(0, len(ds), (2, 16)))
        runs[scan] = (m1, val, z, m2, _state_bits(trainer))
    off, on = runs[False], runs[True]
    assert off[0] == on[0] and off[1] == on[1] and off[3] == on[3]
    assert np.array_equal(off[2], on[2])
    _assert_same(off[4], on[4])
    flag = {}
    for scan in (False, True):
        trainer, ds = _small(scan)
        r = np.random.default_rng(4)
        flag[scan] = ([trainer.train_epoch(e, r.integers(0, len(ds), (2, 16))) for e in (1, 2)], _state_bits(trainer))
    assert flag[False][0] == flag[True][0]
    _assert_same(flag[False][1], flag[True][1])


@pytest.mark.parametrize("count", [1, 2, 3, 41])
def test_plain_version_takes_its_step_from_the_device_count(count):
    """The plain version's bits with the step taken from an int32 count
    tensor equal its bits at the int step, and the optimizer's update at a
    count (1 to 3, and a count a restored state resumes from) rounds as
    the plain version at that step."""
    word = torch.tensor(count, dtype=torch.int32)
    assert torch.equal(fa.philox_noise(1000, 17, 5, word), fa.philox_noise(1000, 17, 5, count))
    params = [torch.nn.Parameter(torch.randn(70000) * 0.05), torch.nn.Parameter(torch.randn(9))]
    tx = optim.FusedAdamW(1e-3, weight_decay=0.01)
    state = tx.init(params)
    state.count.fill_(count - 1)  # as a restored state holds it
    grads = [torch.randn_like(p) * 1e-2 for p in params]
    before = [p.detach().clone() for p in params], [m.clone() for m in state.mu], [v.clone() for v in state.nu]
    scal = tx._scalars(torch.tensor(count, dtype=torch.int32), grads)
    lr, b1c, b2c, gscale = scal.unbind(0)
    want = fa.fused_adamw_multi_reference(
        before[0], grads, before[1], before[2], lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, seed=tx.seed, step=count,
        b1=tx.b1, b2=tx.b2, eps=tx.eps, wd=tx.wd,
    )
    state = tx.update_and_apply(grads, state, params)
    assert int(state.count) == count
    for i, (w, m, v) in enumerate(want):
        assert torch.equal(params[i].detach(), w) and torch.equal(state.mu[i], m) and torch.equal(state.nu[i], v)


def test_port_scanned_epochs_match_jax_scanned_epochs(tmp_path):
    """One tiny config with ``train.scan_epoch: true`` in both packages, from
    JAX's initial weights: the validation epoch (one full batch: JAX's
    ``make_eval_epoch``) at those weights, the port taking JAX's
    restrictiveness draws (``draws=``), every value within
    ``test_torch_port_fit.band`` of epoch 1 (the same weights and batch);
    then a train epoch of 2 steps (JAX's ``make_train_epoch``) on the same
    rows (both take the epoch's permutation from
    ``np.random.default_rng(seed)``), whose second step follows a step of
    different sample noise: within the band of the fit test's later
    epochs."""
    cfg = copy.deepcopy(CONFIG)
    cfg["train"]["scan_epoch"] = True
    data = write_pose_files(tmp_path / "data", synthetic_pose_stream, (("train", 0, 120, 1), ("val", 1, 81, 1)))
    cfg["data"] = dict(cfg["data"], data_path=str(data) + "/")
    out = {}

    def jax_epochs(self, num_epochs=None):
        assert self.scan_train and self.use_scan_epoch
        out["jax"] = self.test_epoch(1)[0], self.train_epoch(1)
        return self.state

    def port_epochs(self, num_epochs=None):
        assert self.scan_train and self.steps_per_epoch == 2
        out["port"] = self.test_epoch(1, draws=jax_draws(len(self.val_ds), 1))[0], self.train_epoch(1)
        return self.state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTrainer, "fit", jax_epochs)
        mp.setattr(Trainer, "fit", port_epochs)
        run_both(tmp_path, cfg)
    for part, suffix, epoch in ((0, "_test", 1), (1, "_train", 2)):
        want, got = out["jax"][part], out["port"][part]
        assert set(got) == set(want)
        for k, v in want.items():
            rel = abs(got[k] - float(v)) / max(abs(float(v)), 1e-12)
            print(f"{k}{suffix}: port {got[k]:.6g} JAX {float(v):.6g} rel {rel:.3e}")
            assert np.isfinite(got[k]) and rel <= band(epoch, k + suffix), (k, got[k], float(v), rel)


def test_profile_step_prints_every_key(capsys):
    profile_step.main(["--small", "--device", "cpu", "--steps", "2"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {
        "config", "path", "batch", "steps", "device_kind", "wall_ms_per_step", "device_busy_ms_per_step",
        "device_idle_share", "kernel_launches_per_step", "copies_per_step", "fused_adamw_launches_per_step",
        "top", "table", "peak_mem_gib", "bytes_per_step", "bound_ms_per_step", "classes_table", "slot_ms_per_step",
    }
    assert rec["path"] == "eager" and rec["steps"] == 2 and rec["top"] and rec["wall_ms_per_step"] > 0
    # the CPU's stamps: every layer of a step, the one gap between its two steps
    assert all(rec["slot_ms_per_step"][s] > 0 for s in profiling.SLOTS)
