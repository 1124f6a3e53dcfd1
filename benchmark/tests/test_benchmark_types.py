"""A configuration of another ``model.type`` in the harness, on the CPU: the
reference VAE found by type, the start-weight kinds a module declares, the
step's generator reaching the forward after the sample noise and the
shuffles, the control chosen by the precision the program computes in,
and the rcnn cells' readings held bit for bit to the pinned ones.

The other type is the port's ``mlp`` (``scrubvae_torch/models/mlp_vae.py``),
which no cell runs: its plain reference is written here and registered
under the name the lookup imports, ``benchmark.reference.vae_mlp``, and
the cell ``mlp.b512`` (full5's scrubbers and traffic with the mlp in the
rcnn's place) exists only inside these tests.
"""

import copy
import json
import pathlib
import sys
import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from benchmark import compare, flops, manifest, run
from benchmark import weights as bw
from benchmark.reference import geometry as geo
from benchmark.reference import model as rm
from benchmark.reference.step import Reference

PINNED = pathlib.Path(__file__).resolve().parent / "data" / "rcnn_small_readings.json"
SEED = 2**31 + 53
MLP_CELL = {"name": "mlp.b512", "config": "mlp", "traffic": "b512", "chips": 1}
MLP_MODEL = {"type": "mlp", "z_dim": 128, "window": 51, "hidden": [512, 256], "diag": False, "prior": "gaussian"}
# f32 on both sides at the CPU size: the gaps are summation order alone
F32_GAP = 1e-4

# --- the plain reference of the port's mlp, as a vae_<type> module keeps it

SMALL = {"z_dim": 16, "hidden": [32, 16]}


def compute_precision(model_cfg: dict, train_cfg: dict) -> str:
    return "f32"  # the port's mlp takes no precision setting


def build_vae(model_cfg, in_ch, cond_dim, conditional_keys, discrete_classes, arena, loss_keys, quant, dropout=0.0):
    if model_cfg.get("diag", True):
        raise ValueError("the reference mlp holds the dense Cholesky head only")
    return MLPVAE(in_ch, model_cfg.get("window") or 51, model_cfg.get("z_dim") or 32,
                  tuple(model_cfg.get("hidden") or (512, 256)), cond_dim, arena, conditional_keys, discrete_classes,
                  dropout)


class MLPVAE(nn.Module):
    """ReLU dense layers over the flattened window (the pose and the
    arena-normalised root of every frame) to ``fc_mu`` and the dense
    Cholesky head over ``fc_sigma``; the decoder takes z and the
    conditionals through the layers in reverse order to ``dec_out`` and a
    tanh. ``dropout`` (the stub of a VAE that draws in its forward) drops
    the encoder's hidden units in training mode with masks from the
    forward's generator, and keeps each mask in ``drawn``."""

    def __init__(self, in_ch, window, z_dim, hidden, cond_dim, arena, conditional_keys, discrete_classes, dropout):
        super().__init__()
        self.z_dim, self.cond_dim, self.window, self.hidden, self.dropout = z_dim, cond_dim, window, hidden, dropout
        self.conditional_keys, self.discrete_classes = tuple(conditional_keys), dict(discrete_classes)
        self.register_buffer("arena", torch.as_tensor(arena, dtype=torch.float32), persistent=False)
        width = window * in_ch
        for i, w in enumerate(hidden):
            setattr(self, f"enc_{i}", rm.Linear(width, w))
            width = w
        self.fc_mu = rm.Linear(width, z_dim)
        self.fc_sigma = rm.Linear(width, z_dim * (z_dim + 1) // 2)
        width = z_dim + cond_dim
        for i, w in enumerate(reversed(hidden)):
            setattr(self, f"dec_{i}", rm.Linear(width, w))
            width = w
        self.dec_out = rm.Linear(width, window * in_ch)
        self.drawn = []

    def encode(self, data, mu_only=False, generator=None):
        B, W = data["x6d"].shape[:2]
        h = torch.cat([data["x6d"].reshape(B, W, -1), geo.normalize_root(data["root"], self.arena)], dim=-1)
        h = h.reshape(B, -1)
        for i in range(len(self.hidden)):
            h = F.relu(getattr(self, f"enc_{i}")(h))
            if self.training and self.dropout > 0:
                keep = torch.rand(h.shape, generator=generator, device=h.device) >= self.dropout
                self.drawn.append(keep)
                h = torch.where(keep, h / (1.0 - self.dropout), 0.0)
        mu = self.fc_mu(h)
        if mu_only:
            return {"mu": mu}
        return {"mu": mu, "L": rm.packed_to_L(rm.packed_softplus_diag(self.fc_sigma(h), self.z_dim), self.z_dim)}

    def forward(self, data, eps=None, generator=None):
        out = self.encode(data, generator=generator)
        out["z"] = out["mu"] + torch.einsum("bij,bj->bi", out["L"], eps) if self.training and eps is not None \
            else out["mu"]
        z = out["z"]
        if self.cond_dim > 0:
            parts = [F.one_hot(data[k].reshape(-1).long(), self.discrete_classes[k]).float()
                     if k in self.discrete_classes else data[k] for k in self.conditional_keys]
            out["var"] = torch.cat(parts, dim=-1)
            z = torch.cat([z, out["var"]], dim=-1)
        h = z
        for i in range(len(self.hidden)):
            h = F.relu(getattr(self, f"dec_{i}")(h))
        x_hat = torch.tanh(self.dec_out(h)).reshape(z.shape[0], self.window, -1)
        out["root"] = geo.inv_normalize_root(x_hat[..., -3:], self.arena)
        out["x6d"] = x_hat[..., :-3].reshape(x_hat.shape[0], self.window, -1, 6)
        return out


# --- the cell that runs it


@pytest.fixture
def mlp_cell(monkeypatch):
    """``mlp.b512`` found by the manifest, with its FLOP count made on the
    meta device, and this file as ``benchmark.reference.vae_mlp``."""
    monkeypatch.setitem(sys.modules, "benchmark.reference.vae_mlp", sys.modules[__name__])
    cfg = copy.deepcopy(manifest.config("full5"))
    cfg.update(name="mlp", reduced=[])
    cfg["sections"]["model"] = dict(MLP_MODEL)
    # f32 moments on every leaf: both sides in f32
    cfg["sections"]["train"]["moment_dtype"] = "f32"
    config, workload, pinned = manifest.config, manifest.workload, manifest.flops
    monkeypatch.setattr(manifest, "config", lambda name: copy.deepcopy(cfg) if name == "mlp" else config(name))
    monkeypatch.setattr(manifest, "workload",
                        lambda name, root=manifest.ROOT: MLP_CELL if name == MLP_CELL["name"] else workload(name, root))
    monkeypatch.setattr(manifest, "flops", lambda c, b: flops.count(c, b) if c == "mlp" else pinned(c, b))
    return MLP_CELL["name"]


def test_a_type_without_a_module_names_the_file():
    with pytest.raises(ValueError, match="benchmark/reference/vae_nosuch.py"):
        rm.build({"type": "nosuch"}, {}, ["rotation"], 18, [[-1, -1, 0], [1, 1, 1]], {"ids": 4})
    with pytest.raises(ValueError, match="benchmark/reference/vae_nosuch.py"):
        rm.control({"model": {"type": "nosuch"}, "train": {}})


def test_a_new_type_through_set_up_the_reference_and_the_count(mlp_cell):
    """Set-up, the reference's three steps and the FLOP count of the mlp at
    the CPU size: the start weights go to both sides by name, and the two
    agree to summation order."""
    su = run.set_up(mlp_cell, SEED, "cpu", small=True)
    names = [n for n, _ in su.shell.named_parameters()]
    assert names == [n for n, _ in su.trainer.model.named_parameters()]
    assert any(n.startswith("vae.enc_0.") for n in names) and su.sections["model"]["hidden"] == SMALL["hidden"]
    run.free_program(su)
    nums = compare.numbers(su.readings, run.reference_readings(su), su.groups)
    assert nums["loss"][0] < F32_GAP and nums["change3"][0] < F32_GAP, nums
    assert nums["state3"][0] < 1e-3, nums
    # the count at the cell's own size, on the meta device: at least each
    # dense layer's forward product and its weight gradient
    B = manifest.traffic("b512")["batch_size"]
    count = flops.count("mlp", B)
    with torch.device("meta"):
        full = rm.build(MLP_MODEL, {}, [], su.skel.n_keypts, su.sections["data"]["arena_size"], {"ids": 4})
    forward = 2 * B * sum(m.in_features * m.out_features for m in full.vae.modules() if isinstance(m, nn.Linear))
    assert su.flops == count["flops_per_step"] >= 2 * forward and "aten.mm" in count["by_operator"]


def test_a_new_type_runs_a_whole_cell(mlp_cell, monkeypatch):
    """The whole run, the chip's look skipped: set-up, a window epoch and
    the comparison."""
    cell = manifest.cell
    monkeypatch.setattr(manifest, "cell", lambda name: {"window_epochs": 1} if name == mlp_cell else cell(name))
    limits = dict.fromkeys(compare.NUMBERS, F32_GAP) | {"state3": 1e-3, "change3_group": 1e-3}
    result, lines = run.run_cell(mlp_cell, SEED + 1, 0.1, False, device="cpu", small=True, limits=limits)
    assert result["correct"] and result["attempted"] > 0, lines


def _tf32_seen(monkeypatch):
    seen = []
    forward = MLPVAE.forward

    def spying(self, *args, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return forward(self, *args, **kw)

    monkeypatch.setattr(MLPVAE, "forward", spying)
    return seen


def test_the_control_follows_the_compute_precision(mlp_cell, monkeypatch):
    """TF32 for the mlp, computed in f32; fp8 layers for both rcnn cells,
    computed in bf16, with TF32 off as in the reference."""
    seen = _tf32_seen(monkeypatch)
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    su = run.set_up(mlp_cell, SEED, "cpu", small=True)
    run.free_program(su)
    assert su.control == "tf32"
    seen.clear()  # set-up's FLOP count on the meta device
    run.reference_readings(su)
    assert seen and set(seen) == {(False, False)}
    seen.clear()
    run.reference_readings(su, control=True)
    assert seen and set(seen) == {(True, True)}
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before

    for config in ("flagship", "full5"):
        assert rm.control(manifest.sections(config, 512)) == "fp8"
    su = run.set_up("full5.b512", SEED, "cpu", small=True)
    run.free_program(su)
    assert su.control == "fp8" and su.sections["train"]["precision"] == "fp32"
    w = bw.as_stored(bw.make(su.shell, bw.derived_seed(su.seed, run.WEIGHTS), su.device), su.lowp)
    ref = Reference(su.sections, su.pose, su.ids, su.skel, w, su.adv_w, su.seed, su.device, batch=su.batch,
                    precision=su.control)
    assert ref.model.vae.encoder.conv_in.quant is rm.fp8 and not ref.tf32


def test_precision_read_as_the_program_reads_it():
    assert rm.compute_precision({"type": "rcnn"}, {"precision": "bf16"}) == "bf16"
    assert rm.compute_precision({"precision": "bf16"}, {}) == "bf16"
    # an explicit model.precision wins over the train section's, None too
    assert rm.compute_precision({"precision": None}, {"precision": "bf16"}) == "f32"
    assert rm.compute_precision({}, {}) == "f32"


def test_the_forward_draws_after_the_noise_and_the_shuffles(mlp_cell, monkeypatch):
    """A reference VAE with dropout gets the step's generator after the
    sample noise and the adversarial shuffles; two references of one seed
    draw the same masks; MCMI's eval-mode encode draws none."""
    drop = types.SimpleNamespace(SMALL=SMALL, compute_precision=compute_precision,
                                 build_vae=lambda *a, **kw: build_vae(*a, **kw, dropout=0.25))
    monkeypatch.setitem(sys.modules, "benchmark.reference.vae_mlpdrop", drop)
    su = run.set_up(mlp_cell, SEED, "cpu", small=True)
    run.free_program(su)
    sections = copy.deepcopy(su.sections)
    sections["model"]["type"] = "mlpdrop"
    w = bw.as_stored(bw.make(su.shell, bw.derived_seed(su.seed, run.WEIGHTS), su.device), su.lowp)
    refs = [Reference(sections, su.pose, su.ids, su.skel, w, su.adv_w, su.seed, su.device, batch=su.batch)
            for _ in range(2)]
    states = []
    for ref in refs:
        vae = ref.model.vae

        def entering(self, *args, _forward=type(vae).forward, _gen=ref.gen, **kw):
            assert kw["generator"] is _gen
            states.append(_gen.get_state())
            return _forward(self, *args, **kw)

        vae.forward = types.MethodType(entering, vae)
        ref.run(su.rows)
    masks = [ref.model.vae.drawn for ref in refs]
    assert len(masks[0]) == 3 * len(SMALL["hidden"])  # one a hidden layer a step; none in MCMI's encode
    assert all(torch.equal(a, b) for a, b in zip(*masks))
    kept = torch.cat([m.flatten() for m in masks[0]]).float().mean()
    assert 0.6 < kept < 0.9

    gen = torch.Generator().manual_seed(su.seed)
    n_adv = len(sections["disentangle"]["method"]["adversarial_net"])
    assert n_adv > 0
    torch.randn((su.batch, SMALL["z_dim"]), generator=gen)
    for _ in range(1 + n_adv * int(sections["disentangle"].get("n_iter") or 5)):
        torch.randperm(su.batch, generator=gen)
    assert torch.equal(states[0], gen.get_state()) and torch.equal(states[0], states[3])


class _LayerNorm(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.weight, self.bias = nn.Parameter(torch.empty(d)), nn.Parameter(torch.empty(d))

    def init_kind(self, pname):
        return ("one" if pname == "weight" else "zero"), None


class _Attention(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.d = d
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = rm.Linear(d, d)

    def init_kind(self, pname):
        return ("kernel", self.d) if pname == "in_proj_weight" else ("zero", None)


def test_start_weight_kinds_declared_by_the_module():
    """A module's ``init_kind`` decides its own parameters (a LayerNorm's
    ones and zeros, an attention's bare in-projection over its input
    width); its sub-modules keep the rules."""
    d = 64
    model = nn.Sequential(_Attention(d), _LayerNorm(d), rm.PReLU())
    kinds = {n: (k, f) for n, _, k, f in rm.init_kinds(model)}
    assert kinds == {"0.in_proj_weight": ("kernel", d), "0.in_proj_bias": ("zero", None),
                     "0.out_proj.weight": ("kernel", d), "0.out_proj.bias": ("zero", None),
                     "1.weight": ("one", None), "1.bias": ("zero", None), "2.weight": ("prelu", None)}
    w = bw.make(model, 7, "cpu")
    assert torch.equal(w["1.weight"], torch.ones(d)) and not w["1.bias"].any() and not w["0.in_proj_bias"].any()
    assert abs(float(w["0.in_proj_weight"].std()) * d**0.5 - 1.0) < 0.05
    assert float(w["0.in_proj_weight"].abs().max()) <= 2.0 * rm.lecun_std(d)


def _pinned():
    with open(PINNED) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", sorted(_pinned()["cells"]))
def test_rcnn_readings_are_the_pinned_ones(cell):
    """The CPU-size readings of each rcnn cell, the program's, the
    reference's and the control's, bit for bit as pinned before a reference
    VAE could be of another type (one thread; the bits are this CPU build's
    and its vector unit's)."""
    pin = _pinned()
    here = torch.__version__, torch.backends.cpu.get_cpu_capability()
    if here != (pin["torch"], pin["cpu_capability"]):
        pytest.skip(f"pinned on torch {pin['torch']} ({pin['cpu_capability']}); this is {here[0]} ({here[1]})")
    threads = torch.get_num_threads()
    torch.set_num_threads(pin["threads"])
    try:
        su = run.set_up(cell, pin["seed"], "cpu", small=True)
        run.free_program(su)
        got = {"program": su.readings, "reference": run.reference_readings(su),
               "control": run.reference_readings(su, control=True)}
    finally:
        torch.set_num_threads(threads)
    assert json.loads(json.dumps(got)) == pin["cells"][cell]
