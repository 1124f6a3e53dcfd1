"""The loss terms and the streaming scrubbers, plain PyTorch in f32.

A frozen copy of the measured program's batch loss: the stable rotation
loss, the KL prior (packed or dense head), the joint-position error
through forward kinematics, the root error, MCMI's kernel estimate, and
per feature the linear decoder, moving-average least squares (MALS),
QDA, gradient reversal and the adversarial generator loss, then total
correlation; ``total`` is the weighted sum in that order. The streaming
states (MALS, QDA), the discriminator's inner AdamW fit and MCMI's
estimator are here too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import geometry as geo
from benchmark.reference.model import packed_diag, packed_to_L, spd_solve

LN2PI = math.log(2.0 * math.pi)


def mse_sum(a, b):
    return torch.sum((a - b) ** 2)


def stable_rotation_loss(x, x_hat, eps: float = 1e-7):
    diff = geo.rotation_6d_to_matrix(x_hat) - geo.rotation_6d_to_matrix(x)
    sin = torch.sqrt(torch.sum(diff * diff, dim=(-1, -2)) + 1e-14) / (2.0**1.5)
    return 2.0 * torch.sum(torch.asin(torch.clamp(sin, -1.0 + eps, 1.0 - eps)))


def prior_loss(mu, L):
    var_diag = torch.sum(L * L, dim=-1)
    log_diag = torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
    return -0.5 * torch.sum(1.0 + 2.0 * log_diag - mu**2 - var_diag) / mu.shape[0]


def prior_loss_packed(mu, Lp):
    D = mu.shape[1]
    kl = -0.5 * (mu.shape[0] * D + 2.0 * torch.sum(torch.log(packed_diag(Lp, D))) - torch.sum(mu**2) - torch.sum(Lp * Lp))
    return kl / mu.shape[0]


def mpjpe_loss(target_pose, x6d_hat, tree, offsets):
    B, W, J = target_pose.shape[:3]
    pose_hat = geo.fwd_kin_cont6d(
        x6d_hat.reshape(-1, J, 6), tree, offsets.reshape(-1, J, 3),
        root_pos=torch.zeros_like(target_pose[..., 0, :]).reshape(-1, 3), do_root_R=True, eps=1e-8,
    ).reshape(target_pose.shape)
    return torch.sum((target_pose - pose_hat) ** 2) / (B * 3 * J)


def total_correlation(z, mu, L):
    logvar = torch.log(torch.sum(L * L, dim=-1))
    diff_sq = (z.detach()[:, None] - mu[None, :]) ** 2
    lq = -0.5 * (torch.exp(-logvar[None, :]) * diff_sq + logvar[None, :] + LN2PI)
    log_qz_product = torch.sum(torch.logsumexp(lq, dim=1), dim=1)
    log_qz = torch.logsumexp(torch.sum(lq, dim=2), dim=1)
    return torch.mean(log_qz - log_qz_product)


# --- moving-average least squares (polynomial order 1) ----------------------


@dataclasses.dataclass
class MALS:
    Sxx0: torch.Tensor
    Sxy0: torch.Tensor
    Sxx1: torch.Tensor
    Sxy1: torch.Tensor
    lam0: torch.Tensor
    lam1: torch.Tensor
    bias: bool
    l2_reg: float
    lamdiff: float = 1e-1
    delta: float = 1e-4


def mals_init(nx, ny, bias, l2_reg, device, polynomial_order: int = 1) -> MALS:
    if polynomial_order != 1:
        raise ValueError("the reference holds MALS at polynomial order 1")
    n = nx + int(bias)
    f32 = dict(dtype=torch.float32, device=device)
    return MALS(torch.eye(n, **f32), torch.zeros((n, ny), **f32), torch.eye(n, **f32), torch.zeros((n, ny), **f32),
                torch.tensor(0.9, **f32), torch.tensor(0.9 + 1e-1, **f32), bias, float(l2_reg))


def _mals_x(st: MALS, x):
    return torch.cat([x, x.new_ones(x.shape[0], 1)], dim=-1) if st.bias else x


def mals_loss(st: MALS, x, y):
    x = _mals_x(st, x)
    l2 = torch.full((x.shape[1],), st.l2_reg, dtype=x.dtype, device=x.device)
    if st.bias:
        l2[-1] = 0.0
    y0 = x @ spd_solve(st.Sxx0 + torch.diag(l2), st.Sxy0)
    y1 = x @ spd_solve(st.Sxx1 + torch.diag(l2), st.Sxy1)
    l0, l1 = torch.sum((y - y0) ** 2), torch.sum((y - y1) ** 2)
    better0 = (l0 < l1).detach()
    down = torch.clamp(st.lam0 - st.delta, 0.0, 1.0)
    up = torch.clamp(st.lam1 + st.delta, 0.0, 1.0)
    new = dataclasses.replace(st, lam0=torch.where(better0, down, up - st.lamdiff),
                              lam1=torch.where(better0, down + st.lamdiff, up))
    return 0.5 * (l0 + l1), new


@torch.no_grad()
def mals_update(st: MALS, x, y) -> MALS:
    x = _mals_x(st, x.detach())
    xx, xy = x.T @ x, x.T @ y.detach()
    return dataclasses.replace(st, Sxx0=st.lam0 * st.Sxx0 + xx, Sxy0=st.lam0 * st.Sxy0 + xy,
                               Sxx1=st.lam1 * st.Sxx1 + xx, Sxy1=st.lam1 * st.Sxy1 + xy)


# --- quadratic discriminant filter --------------------------------------------


@dataclasses.dataclass
class QDA:
    classes: torch.Tensor
    m0a: torch.Tensor
    m1a: torch.Tensor
    m0b: torch.Tensor
    m1b: torch.Tensor
    S0a: torch.Tensor
    S1a: torch.Tensor
    S0b: torch.Tensor
    S1b: torch.Tensor
    lama: torch.Tensor
    lamb: torch.Tensor
    lamdiff: float = 1e-2
    delta: float = 1e-3


def qda_init(nx, classes, device) -> QDA:
    classes = torch.as_tensor(classes, device=device)
    C = classes.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    z = lambda: torch.zeros((C, nx), **f32)  # noqa: E731
    e = lambda: torch.eye(nx, **f32).repeat(C, 1, 1)  # noqa: E731
    return QDA(classes, z(), z(), z(), z(), e(), e(), e(), e(), torch.full((C,), 0.2, **f32),
               torch.full((C,), 0.21, **f32))


def _cgll(x, m, S):
    diff = x[None] - m[:, None]
    sol = spd_solve(S, diff.transpose(-1, -2))
    resid = torch.einsum("cbd,cdb->cb", diff, sol)
    return -0.5 * (torch.linalg.slogdet(S)[1][:, None] + resid)


def qda_loss(st: QDA, x, y):
    i1 = (y.reshape(-1)[None] == st.classes[:, None]).to(x.dtype)
    i0 = 1.0 - i1
    lla0, lla1 = _cgll(x, st.m0a, st.S0a), _cgll(x, st.m1a, st.S1a)
    llb0, llb1 = _cgll(x, st.m0b, st.S0b), _cgll(x, st.m1b, st.S1b)
    by = i1 * 2.0 - 1.0
    llra = torch.einsum("cb,cb->c", by, lla1 - lla0)
    llrb = torch.einsum("cb,cb->c", by, llb1 - llb0)
    loss = torch.sum((llra + llrb) * 0.5) / st.classes.shape[0]
    with torch.no_grad():
        a_better = torch.sum(i0 * lla0 + i1 * lla1, 1) > torch.sum(i0 * llb0 + i1 * llb1, 1)
        down = torch.clamp(st.lama - st.delta, 0.0, 1.0)
        up = torch.clamp(st.lamb + st.delta, 0.0, 1.0)
        st = dataclasses.replace(st, lama=torch.where(a_better, down, up - st.lamdiff),
                                 lamb=torch.where(a_better, down + st.lamdiff, up))
    return loss, st


def _masked_moments(x, mask):
    cnt = torch.clamp(mask.sum(-1), min=1.0)[:, None]
    mean = (mask[:, :, None] * x).sum(1) / cnt
    c = (x[None] - mean[:, None]) * mask[:, :, None]
    return mean, c.transpose(-1, -2) @ c / cnt[:, :, None]


@torch.no_grad()
def qda_update(st: QDA, x, y) -> QDA:
    x = x.detach()
    i1 = (y.reshape(-1)[None] == st.classes[:, None]).to(x.dtype)
    x1m, x1S = _masked_moments(x, i1)
    x0m, x0S = _masked_moments(x, 1.0 - i1)
    la, lb = st.lama[:, None], st.lamb[:, None]
    las, lbs = la[..., None], lb[..., None]
    return dataclasses.replace(
        st, m0a=(1 - la) * st.m0a + la * x0m, m1a=(1 - la) * st.m1a + la * x1m,
        S0a=(1 - las) * st.S0a + las * x0S, S1a=(1 - las) * st.S1a + las * x1S,
        m0b=(1 - lb) * st.m0b + lb * x0m, m1b=(1 - lb) * st.m1b + lb * x1m,
        S0b=(1 - lbs) * st.S0b + lbs * x0S, S1b=(1 - lbs) * st.S1b + lbs * x1S,
    )


# --- adversarial discriminator ------------------------------------------------


def adv_shuffle(z, v, v_ind, perm):
    v_shuffle = v.index_copy(1, v_ind, v[perm][:, v_ind])
    return torch.cat([z, z], 0), torch.cat([v, v_shuffle], 0)


def _adv_labels(batch, device):
    fake = torch.arange(2 * batch, device=device) >= batch
    return torch.stack([~fake, fake], dim=-1).float()


def _softmax_ce(p, y):
    return -torch.sum(y * F.log_softmax(p, dim=-1))


def adv_generator_loss(net, mu, var, v_ind, perm):
    z_aug, v_aug = adv_shuffle(mu, var, v_ind, perm)
    frozen = {k: p.detach() for k, p in net.named_parameters()}
    preds = torch.func.functional_call(net, frozen, (z_aug, v_aug))
    y = _adv_labels(mu.shape[0], mu.device)
    return sum(_softmax_ce(p, y) for p in preds) / (-(len(preds) * mu.shape[0]))


def adv_fit(opt, net, z, v, v_ind, perms):
    z, v = z.detach(), v.detach()
    y = _adv_labels(z.shape[0], z.device)
    params = list(net.parameters())
    for perm in perms:
        z_aug, v_aug = adv_shuffle(z, v, v_ind, perm)
        with torch.enable_grad():
            preds = net(z_aug, v_aug)
            loss = sum(_softmax_ce(p, y) for p in preds) / len(preds) / z.shape[0]
            grads = torch.autograd.grad(loss, params)
        opt.step(params, grads)


# --- MCMI kernel estimator (sphere bandwidth) -------------------------------------


@dataclasses.dataclass
class MI:
    x_s: torch.Tensor
    y_s: torch.Tensor
    var_s: torch.Tensor
    logA_x: torch.Tensor
    logA_y: torch.Tensor
    valid: torch.Tensor
    gamma: float


def mi_init(x_s, y_s, bandwidth: float, var_mode: str = "sphere", valid: float = 1.0) -> MI:
    if var_mode != "sphere":
        raise ValueError("the reference holds MCMI's sphere bandwidth only")
    f32 = dict(dtype=torch.float32, device=x_s.device)
    log2pi = torch.log(torch.full((), 2.0 * math.pi, **f32))
    bw = torch.full((), bandwidth, **f32)
    return MI(x_s.detach(), y_s.detach(), bw, x_s.shape[1] * (log2pi + torch.log(bw)),
              y_s.shape[1] * (log2pi + torch.log(bw)), torch.full((), float(valid), **f32), float(bandwidth))


def mi_score(st: MI, x, y):
    dx = x[:, None, :] - st.x_s[None]
    dy = y[:, None, :] - st.y_s[None]
    sdx = torch.sum((dx / st.var_s) * dx, dim=-1)
    sdy = torch.sum((dy / st.gamma) * dy, dim=-1)
    lse = torch.logsumexp
    pxy = lse(-0.5 * (st.logA_x + st.logA_y + sdx + sdy), dim=-1)
    return torch.mean(pxy - lse(-0.5 * (st.logA_x + sdx), dim=-1) - lse(-0.5 * (st.logA_y + sdy), dim=-1))


# --- the batch loss -------------------------------------------------------------------


def batch_loss(data, out, loss_scale: Dict[str, float], dis_cfg: dict, tree, scrub: dict, adv_nets: dict,
               mi: Optional[MI], adv_perm, feat_slices: Dict[str, torch.Tensor]):
    """(loss terms with ``total``, new streaming states)."""
    B = data["x6d"].shape[0]
    bl: Dict[str, torch.Tensor] = {}
    new = {m: dict(v) for m, v in scrub.items()}
    if "rotation" in loss_scale:
        bl["rotation"] = stable_rotation_loss(data["x6d"], out["x6d"])
    if "prior" in loss_scale:
        bl["prior"] = prior_loss_packed(out["mu"], out["Lp"]) if "Lp" in out else prior_loss(out["mu"], out["L"])
    if "jpe" in loss_scale:
        bl["jpe"] = mpjpe_loss(data["target_pose"], out["x6d"], tree, data["offsets"])
    if "root" in loss_scale:
        bl["root"] = mse_sum(out["root"], data["root"]) / B
    if "mcmi" in loss_scale:
        bl["mcmi"] = mi.valid * mi_score(mi, out["mu"], out["var"]) if mi is not None else out["mu"].new_zeros(())
    methods = dis_cfg.get("method") or {}
    linear_keys = set(methods.get("linear") or ())
    for method, keys in methods.items():
        if method == "conditional":
            continue
        for key in keys:
            latent = out["disentangle"]["linear"][key]["z_null"] if key in linear_keys else out["mu"]
            if method == "moving_avg_lsq":
                loss, new["moving_avg_lsq"][key] = mals_loss(scrub["moving_avg_lsq"][key], latent, data[key])
                bl[key + "_mals"] = loss / B
            elif method == "qda":
                loss, new["qda"][key] = qda_loss(scrub["qda"][key], latent, data[key])
                bl[key + "_qda"] = loss / B
            elif method == "linear":
                bl[key + "_lin"] = mse_sum(out["disentangle"]["linear"][key]["v"], data[key]) / len(keys) / B
            elif method == "grad_reversal":
                heads = out["disentangle"]["grad_reversal"][key]
                total = sum(mse_sum(h, data[key]) for h in heads)
                bl[key + "_gr"] = total / (len(heads) * len(keys) * B)
            elif method == "adversarial_net":
                bl[key + "_an"] = adv_generator_loss(adv_nets[key], out["mu"], out["var"], feat_slices[key], adv_perm)
            else:
                raise ValueError(f"the reference holds no scrubber {method!r}")
    if "total_correlation" in loss_scale:
        L = out["L"] if "L" in out else packed_to_L(out["Lp"], out["mu"].shape[1])
        bl["total_correlation"] = total_correlation(out["z"], out["mu"], L)
    total = out["mu"].new_zeros(())
    for k, v in bl.items():
        if k in loss_scale:
            total = total + loss_scale[k] * v
    bl["total"] = total
    return bl, new
