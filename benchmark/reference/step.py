"""The train step of a configuration, plain PyTorch in f32, and its readings.

A frozen copy of the measured program's step order: window assembly,
the sample noise and then the adversarial shuffles drawn from one
generator seeded with ``train.seed`` (one shuffle for the generator
losses, then ``n_iter`` for each feature's inner fit), the forward in
training mode (handed the same generator for any dropout masks of the
VAE), the loss terms, the backward, AdamW, the MALS and QDA
updates on the detached mu, the discriminators' inner fits on the
detached (mu, conditionals), and MCMI's estimator rebuilt from the batch
encoded in eval mode under the updated parameters.

``Reference(...)`` takes the configuration's sections, the raw pose
stream, the weights the benchmark made (by parameter name) and the seed;
``run(rows)`` takes one step a row of window indices and returns the
readings the comparison uses. ``precision`` is "fp32" (the reference,
TF32 off) or the control that ``model.control`` names for the
configuration: "fp8" (the VAE's layers rounded to fp8, where the program
computes in bf16) or "tf32" (products and convolutions in TF32, where it
computes in f32). ``fault="half_batch"`` leaves out the second half of
each row (every mean is then the first half's); ``fault="unchanged"``
takes each step and then puts every piece of state back as it was before
it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference import data as rdata
from benchmark.reference import losses as rl
from benchmark.reference import model as rm
from benchmark.reference import optim as ropt

KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids")
ADAM_B1 = 0.9


@contextlib.contextmanager
def f32_products(tf32: bool = False):
    """f32 products and convolutions with TF32 off (or on, ``tf32``),
    restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def loss_scale(loss_cfg: dict, train_cfg: dict, epoch: int) -> Dict[str, float]:
    scale = {k: float(v) for k, v in loss_cfg.items()}
    if "prior" in scale and train_cfg.get("beta_anneal"):
        scale["prior"] = ropt.cyclical_beta(epoch, beta_max=float(loss_cfg["prior"]))
    return scale


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


class Reference:
    def __init__(self, sections: dict, pose: np.ndarray, ids: np.ndarray, skeleton, weights: Dict[str, torch.Tensor],
                 adv_weights: Dict[str, Dict[str, torch.Tensor]], seed: int, device, *, batch: int,
                 precision: str = "fp32", fault: Optional[str] = None):
        self.cfg = sections
        data_cfg, model_cfg, train_cfg = sections["data"], dict(sections["model"]), sections["train"]
        self.dis_cfg, self.loss_cfg, self.train_cfg = sections["disentangle"], dict(sections["loss"]), train_cfg
        self.device = torch.device(device)
        self.skeleton = skeleton
        self.fault = fault
        self.tf32 = precision == "tf32"
        window = model_cfg.get("window") or 51
        self.store = rdata.build_frame_store(pose, ids, skeleton, window, int(data_cfg.get("stride") or 2), self.device)
        self.B = min(batch, len(self.store))
        self.direction = data_cfg.get("direction_process") or "midfwd"
        classes = np.unique(ids)
        self.discrete = {"ids": len(classes)}
        quant = {"fp32": None, "fp8": rm.fp8, "tf32": None}[precision]
        arena = np.asarray(data_cfg["arena_size"], np.float32)
        self.model = rm.build(model_cfg, self.dis_cfg, self.loss_cfg.keys(), skeleton.n_keypts, arena, self.discrete,
                              quant=quant).to(self.device)
        load(self.model, weights)
        methods = self.dis_cfg.get("method") or {}
        fd = rm.feat_dims(window, self.discrete)
        cond = list(methods.get("conditional", []))
        off, self.slices = 0, {}
        for k in cond:
            self.slices[k] = torch.arange(off, off + fd[k], device=self.device)
            off += fd[k]
        z = self.model.vae.z_dim
        self.scrub = {}
        if "moving_avg_lsq" in methods:
            self.scrub["moving_avg_lsq"] = {
                k: rl.mals_init(z, fd[k], float(self.loss_cfg.get(k + "_mals", 0)) < 0,
                                float(self.dis_cfg.get("l2_reg") or 0.0), self.device,
                                int(self.dis_cfg.get("polynomial") or 1))
                for k in methods["moving_avg_lsq"]
            }
        if "qda" in methods:
            self.scrub["qda"] = {k: rl.qda_init(z, classes, self.device) for k in methods["qda"]}
        self.adv = {}
        for k in methods.get("adversarial_net", []):
            net = rm.AdvNet(z + off).to(self.device)
            load(net, adv_weights[k])
            self.adv[k] = (net, ropt.AdamW(0.1, weight_decay=1e-4))
        self.n_iter = int(self.dis_cfg.get("n_iter") or 5)
        self.bandwidth = float(self.dis_cfg.get("bandwidth") or 1.0)
        self.use_mcmi = "mcmi" in self.loss_cfg
        self.mi = None
        if self.use_mcmi:
            zeros = lambda n: torch.zeros((self.B, n), device=self.device)  # noqa: E731
            self.mi = rl.mi_init(zeros(z), zeros(max(off, 1)), self.bandwidth, self.dis_cfg.get("var_mode") or "sphere",
                                 valid=0.0)
        steps_per_epoch = max(len(self.store) // self.B, 1)
        lr = float(train_cfg.get("lr") or 1e-4)
        sched = ropt.cawr(lr, steps_per_epoch) if train_cfg.get("lr_schedule") == "cawr" else lr
        clip = train_cfg.get("clip_norm")
        clip = 1e6 if clip is None else (float(clip) if clip and float(clip) > 0 else None)
        wd = 0.01 if (train_cfg.get("optimizer") or "adam") == "adamw" else 0.0
        self.opt = ropt.AdamW(sched, weight_decay=wd, clip_norm=clip)
        # the meta device (the FLOP count) has shapes and no generator
        self.gen = None if self.device.type == "meta" else torch.Generator(device=self.device).manual_seed(int(seed))
        self.params = list(self.model.parameters())
        self.names = [n for n, _ in self.model.named_parameters()]
        self.w0 = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        self.adv0 = {k: {n: p.detach().clone() for n, p in net.named_parameters()} for k, (net, _) in self.adv.items()}

    def _draw(self, fn, *args):
        kw = {} if self.gen is None else {"generator": self.gen}
        return fn(*args, device=self.device, **kw)

    def step(self, idx: torch.Tensor, epoch: int) -> Dict[str, float]:
        if self.fault == "unchanged":
            saved = self._snapshot()
            terms = self.step_terms(idx, epoch)
            self._restore(saved)
        else:
            terms = self.step_terms(idx, epoch)
        return {k: float(v.detach()) for k, v in terms.items()}

    def _snapshot(self):
        import copy

        tensors = [t.detach().clone() for t in list(self.model.parameters()) + list(self.model.buffers())]
        nets = [[p.detach().clone() for p in net.parameters()] for net, _ in self.adv.values()]
        return tensors, nets, copy.copy(self.scrub), self.mi, copy.deepcopy((self.opt.count, self.opt.m, self.opt.n))

    @torch.no_grad()
    def _restore(self, saved) -> None:
        tensors, nets, self.scrub, self.mi, (self.opt.count, self.opt.m, self.opt.n) = saved
        for t, s in zip(list(self.model.parameters()) + list(self.model.buffers()), tensors):
            t.copy_(s)
        for (net, _), ps in zip(self.adv.values(), nets):
            for p, s in zip(net.parameters(), ps):
                p.copy_(s)

    def step_terms(self, idx: torch.Tensor, epoch: int) -> Dict[str, torch.Tensor]:
        """One train step on the windows ``idx``; its loss terms."""
        if self.fault == "half_batch":
            idx = idx[: len(idx) // 2]
        data = rdata.assemble(self.store, self.skeleton.tree, idx, KEYS, self.direction)
        B = len(idx)
        eps = self._draw(torch.randn, (B, self.model.vae.z_dim))
        perms = None
        if self.adv:
            perm = lambda: self._draw(torch.randperm, B)  # noqa: E731
            perms = {"loss": perm(), "fit": {k: [perm() for _ in range(self.n_iter)] for k in self.adv}}
        self.model.train()
        out = self.model(data, eps=eps, generator=self.gen)
        bl, new_scrub = rl.batch_loss(
            data, out, loss_scale(self.loss_cfg, self.train_cfg, epoch), self.dis_cfg, self.skeleton.tree, self.scrub,
            {k: net for k, (net, _) in self.adv.items()}, self.mi, perms["loss"] if perms else None, self.slices,
        )
        grads = torch.autograd.grad(bl["total"], self.params, allow_unused=True)
        self.opt.step(self.params, grads)
        mu = out["mu"].detach()
        for k, st in new_scrub.get("moving_avg_lsq", {}).items():
            new_scrub["moving_avg_lsq"][k] = rl.mals_update(st, mu, data[k])
        for k, st in new_scrub.get("qda", {}).items():
            new_scrub["qda"][k] = rl.qda_update(st, mu, data[k])
        self.scrub = new_scrub
        for k, (net, opt) in self.adv.items():
            rl.adv_fit(opt, net, mu, out["var"].detach(), self.slices[k], perms["fit"][k])
        if self.use_mcmi:
            with torch.no_grad():
                self.model.eval()
                mu_eval = self.model.vae.encode(data, mu_only=True)["mu"]
                self.model.train()
            self.mi = rl.mi_init(mu_eval, out["var"].detach(), self.bandwidth)
        return bl

    def run(self, rows: np.ndarray, epoch: int = 1) -> dict:
        """Steps over ``rows`` (3, B) and the readings: each loss term of
        step 1 and the mean of steps 2 and 3, each leaf's norm of the first
        gradient as AdamW took it, each leaf's norm of its change over the
        three steps, and each streaming state's norm after them."""
        with f32_products(self.tf32):
            rows_t = torch.as_tensor(np.asarray(rows), device=self.device)
            l1 = self.step(rows_t[0], epoch)
            grad1 = {n: norm(g) for n, g in zip(self.names, self.opt.last_grads)}
            l2 = self.step(rows_t[1], epoch)
            l3 = self.step(rows_t[2], epoch)
        return {
            "loss": {"step1": l1, "steps2_3": {k: 0.5 * (l2[k] + l3[k]) for k in l2}},
            "grad1": grad1,
            "change3": {n: norm(p.detach() - self.w0[n]) for n, p in self.model.named_parameters()},
            "state3": self.state_norms(),
        }

    def state_norms(self) -> Dict[str, float]:
        out = {f"bn.{n}": norm(b) for n, b in self.model.named_buffers() if b.is_floating_point() and "running" in n}
        for k, st in self.scrub.get("moving_avg_lsq", {}).items():
            out.update({f"mals.{k}.{f}": norm(getattr(st, f)) for f in ("Sxx0", "Sxy0", "Sxx1", "Sxy1", "lam0", "lam1")})
        for k, st in self.scrub.get("qda", {}).items():
            out.update({f"qda.{k}.{f}": norm(getattr(st, f)) for f in QDA_FIELDS})
        if self.mi is not None:
            out.update({"mi.x_s": norm(self.mi.x_s), "mi.y_s": norm(self.mi.y_s)})
        for k, (net, _) in self.adv.items():
            out.update({f"adv.{k}.{n}": norm(p.detach() - self.adv0[k][n]) for n, p in net.named_parameters()})
        return out


QDA_FIELDS = ("m0a", "m1a", "m0b", "m1b", "S0a", "S1a", "S0b", "S1b", "lama", "lamb")


@torch.no_grad()
def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise KeyError(f"weights for {sorted(set(weights) ^ set(params))[:4]} do not match the model's leaves")
    for n, p in params.items():
        p.copy_(weights[n].to(p.dtype))
