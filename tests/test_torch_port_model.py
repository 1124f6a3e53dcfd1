"""The port's ScrubVAE(ResVAE) against the JAX model with carried weights,
at the bench's --small widths (8, 8, 16, 16, 32), z 16, window 51, f32,
with the bench's conditional, linear and gradient-reversal scrubbers.

Outputs (mu, packed L, x6d, root, linear v / z_null, the four GR heads) in
train mode with injected sample noise and in eval mode, and the BatchNorm
running stats after one train forward: rtol 1e-4 (conv summation order),
atol 1e-5 for entries near zero. Also: the carried VAE weights equal the
JAX package's own torch exporter output, key by key.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrubvae_tpu import factory as jfactory
from scrubvae_tpu.utils.torch_export import export_resvae_state_dict
from scrubvae_torch import factory
from scrubvae_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

B, W, Z = 8, 51, 16
ARENA = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)
MODEL = {
    "type": "rcnn", "z_dim": Z, "window": W, "diag": False, "channel": [8, 8, 16, 16, 32],
    "kernel": 5, "prior": "gaussian", "activation": "prelu", "precision": "fp32",
}
DIS = {
    "method": {
        "conditional": ["avg_speed_3d", "heading"],
        "linear": ["avg_speed_3d"],
        "moving_avg_lsq": ["avg_speed_3d"],
        "grad_reversal": ["avg_speed_3d"],
    },
    "features": ["avg_speed_3d", "heading"],
    "alpha": 1.0,
}
LOSS_KEYS = ("rotation", "prior", "root", "jpe", "avg_speed_3d_mals", "avg_speed_3d_lin", "avg_speed_3d_gr")


def flatten(tree) -> dict:
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    data = {
        "x6d": rng.normal(size=(B, W, 18, 6)).astype(np.float32) * 0.5,
        "root": rng.uniform(-200, 200, size=(B, W, 3)).astype(np.float32),
        "avg_speed_3d": rng.normal(size=(B, 3)).astype(np.float32),
        "heading": rng.normal(size=(B, 2)).astype(np.float32),
    }
    jmodel, _ = jfactory.build_model(MODEL, DIS, 18, "midfwd", arena_size=ARENA, loss_keys=LOSS_KEYS)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jdata, rng=jax.random.PRNGKey(0), train=True,
    )
    tmodel, _ = factory.build_model(MODEL, DIS, 18, "midfwd", arena_size=ARENA, loss_keys=LOSS_KEYS, device="cpu")
    tmodel.load_state_dict(from_jax_variables(flatten(variables)), strict=True)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    return jmodel, variables, tmodel, jdata, tdata


def _outputs(out, as_np):
    dis = out["disentangle"]
    res = {k: as_np(out[k]) for k in ("mu", "Lp", "z", "x6d", "root") if k in out}
    res["lin_v"] = as_np(dis["linear"]["avg_speed_3d"]["v"])
    res["lin_z_null"] = as_np(dis["linear"]["avg_speed_3d"]["z_null"])
    for i, h in enumerate(dis["grad_reversal"]["avg_speed_3d"]):
        res[f"gr_{i}"] = as_np(h)
    return res


def _compare(got, want):
    assert set(got) == set(want)
    for k in want:
        # root is the decoder's tanh output times the arena half-width (290):
        # the decoder output's atol, carried through that scale
        atol = 1e-5 * (290.0 if k == "root" else 1.0)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol, err_msg=k)


def test_train_forward_and_batch_stats(models):
    jmodel, variables, tmodel, jdata, tdata = models
    rng = jax.random.PRNGKey(7)
    jout, upd = jmodel.apply(variables, jdata, rng=rng, train=True, mutable=["batch_stats"])
    eps = np.asarray(jax.random.normal(rng, (B, Z)))
    tmodel.train()
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    with torch.no_grad():
        tout = tmodel(tdata, eps=torch.from_numpy(eps))
    after = {k: v.clone() for k, v in tmodel.state_dict().items()}
    tmodel.load_state_dict(before)  # the eval test reads the carried stats
    _compare(_outputs(tout, lambda t: t.numpy()), _outputs(jout, np.asarray))
    want = from_jax_variables(flatten({"batch_stats": upd["batch_stats"]}))
    for k, v in want.items():
        if "running" in k:
            assert not torch.equal(after[k], before[k]), k
            np.testing.assert_allclose(after[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_eval_forward(models):
    jmodel, variables, tmodel, jdata, tdata = models
    jout = jmodel.apply(variables, jdata, rng=None, train=False)
    tmodel.eval()
    with torch.no_grad():
        tout = tmodel(tdata)
    got, want = _outputs(tout, lambda t: t.numpy()), _outputs(jout, np.asarray)
    _compare(got, want)
    np.testing.assert_array_equal(got["z"], got["mu"])


def test_carried_vae_weights_match_the_exporter(models):
    _, variables, _, _, _ = models
    flat = flatten(variables)
    ours = {k[len("vae."):]: v for k, v in from_jax_variables(flat).items() if k.startswith("vae.")}
    sd, unexported = export_resvae_state_dict(variables)
    theirs = {k: v for k, v in sd.items() if not k.startswith("disentangle.")}
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v, ours[k].numpy().dtype), err_msg=k)
    # the scrubber heads land under the port's own names
    heads = [k for k in from_jax_variables(flat) if not k.startswith("vae.")]
    assert "linear.avg_speed_3d.weight" in heads and len(heads) == 1 + 22


@pytest.mark.parametrize("width", [1, 4, 13])
def test_upsample_linear_matches_jax(width):
    """The decoder's skip upsample: the JAX blend, torch's linear
    interpolation with half-pixel centers, and the port agree."""
    from scrubvae_tpu.models.layers import upsample_linear_1d as jax_upsample
    from scrubvae_torch.models.layers import upsample_linear_1d

    x = np.random.default_rng(width).normal(size=(3, width, 5)).astype(np.float32)  # (B, W, C)
    got = upsample_linear_1d(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    want = np.asarray(jax_upsample(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    interp = torch.nn.functional.interpolate(
        torch.from_numpy(x).transpose(1, 2), scale_factor=2, mode="linear", align_corners=False
    )
    np.testing.assert_allclose(got, interp.transpose(1, 2).numpy(), rtol=1e-6, atol=1e-7)
