"""The port's serving export (``scrubvae_torch/utils/export.py``) against
the JAX package's (``scrubvae_tpu/utils/export.py``), on the CPU at small
widths (channels 8-8-16-16-32, window 31, z 32; the mlp and the
transformer at small test sizes), decoding conditional on avg_speed_3d and
heading:

- the port's encoder, mu-only encoder and decoder artifacts, exported from
  an example batch of 2 and loaded with ``load_exported``, against JAX's
  (``jax.export``, called through ``load_exported(...).call``) from the
  same weights (carried with ``from_jax_variables``), at batches 1 and 3:
  rtol 1e-4, atol 1e-5 (times 290 for the root, the decoder's atol
  carried through the arena's half-width), for the rcnn with the packed
  head, the dense head, ``sigma_head_rank`` and the beta prior, the mlp
  and the transformer (the decoder for the packed rcnn, the mlp and the
  transformer: the other rcnn variants share its decoder);
- JAX's size rule (``tests/test_models.py``), where there is a sigma head:
  the mu-only artifact is smaller than the full one by at least 0.9 times
  the head's bytes (``fc_sigma``, or both low-rank factors);
- an eager forward after an export equals the one before it bit for bit
  (the packed head's and the polynomial expansion's index caches).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrubvae_tpu import factory as jfactory
from scrubvae_tpu.utils import export as jexport
from scrubvae_torch import factory
from scrubvae_torch.models import layers, scrubbers
from scrubvae_torch.utils.export import export_decoder, export_encoder, load_exported
from scrubvae_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

W, Z = 31, 32
ARENA = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)
RCNN = {"type": "rcnn", "z_dim": Z, "window": W, "diag": False, "channel": [8, 8, 16, 16, 32], "kernel": 5,
        "prior": "gaussian", "activation": "prelu", "precision": "fp32"}
VARIANTS = {
    "rcnn_packed": RCNN | {"packed_sigma": True},
    "rcnn_dense": RCNN | {"packed_sigma": False},
    "rcnn_low_rank": RCNN | {"packed_sigma": True, "sigma_head_rank": 4},
    "rcnn_beta": RCNN | {"prior": "beta"},
    "mlp": {"type": "mlp", "z_dim": Z, "window": W, "diag": False, "hidden": [32, 16]},
    "transformer": {"type": "transformer", "z_dim": Z, "window": W, "n_heads": 2, "ff_size": 16, "n_layers": 1,
                    "diag": False},
}
DIS = {"method": {"conditional": ["avg_speed_3d", "heading"]}, "features": ["avg_speed_3d", "heading"]}
COND = ("avg_speed_3d", "heading")
ENC = ("x6d", "root")


def batch(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "x6d": np.tanh(rng.normal(size=(n, W, 18, 6))).astype(np.float32),
        "root": rng.uniform(-200, 200, size=(n, W, 3)).astype(np.float32),
        "avg_speed_3d": rng.normal(size=(n, 3)).astype(np.float32),
        "heading": rng.normal(size=(n, 2)).astype(np.float32),
    }


def pair(model_config: dict):
    """The JAX model and variables, and the port's model with the same
    weights, in eval mode."""
    jmodel, _ = jfactory.build_model(model_config, DIS, 18, "midfwd", arena_size=ARENA, loss_keys=("rotation", "prior"))
    data = {k: jnp.asarray(v) for k, v in batch(2, 0).items()}

    def encode_decode(m, data):  # every leaf, without the beta prior's gamma draws
        return m.encode(data, train=False), m.decode(jnp.zeros((2, Z)), data, train=False)

    variables = jmodel.init({"params": jax.random.PRNGKey(0)}, data, method=encode_decode)
    flat = {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(variables, sep="/").items()}
    tmodel, _ = factory.build_model(
        model_config, DIS, 18, "midfwd", arena_size=ARENA, loss_keys=("rotation", "prior"), device="cpu"
    )
    tmodel.load_state_dict(from_jax_variables(flat), strict=True)
    return jmodel, variables, tmodel.eval()


def compare(got: dict, want: dict) -> None:
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        atol = 1e-5 * (290.0 if k == "root" else 1.0)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=atol, err_msg=k)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_artifacts_match_jax(variant):
    jmodel, variables, tmodel = pair(VARIANTS[variant])
    ex_np = batch(2, 0)
    ex_j = {k: jnp.asarray(v) for k, v in ex_np.items()}
    ex_t = {k: torch.from_numpy(v) for k, v in ex_np.items()}
    arts = {
        "encoder": (
            jexport.export_encoder(jmodel, variables, ex_j, platforms=("cpu",)), export_encoder(tmodel, ex_t),
        ),
        "encoder_mu": (
            jexport.export_encoder(jmodel, variables, ex_j, platforms=("cpu",), mu_only=True),
            export_encoder(tmodel, ex_t, mu_only=True),
        ),
    }
    if variant in ("rcnn_packed", "mlp", "transformer"):
        arts["decoder"] = (
            jexport.export_decoder(jmodel, variables, ex_j, Z, COND, platforms=("cpu",)),
            export_decoder(tmodel, ex_t, Z, COND),
        )
    for name, (jblob, tblob) in arts.items():
        jfn, tfn = jexport.load_exported(jblob), load_exported(tblob)
        for n in (1, 3):
            data = batch(n, 10 + n)
            if name == "decoder":
                z = np.random.default_rng(n).normal(size=(n, Z)).astype(np.float32)
                want = jfn.call(jnp.asarray(z), {k: jnp.asarray(data[k]) for k in COND})
                got = tfn(torch.from_numpy(z), {k: torch.from_numpy(data[k]) for k in COND})
            else:
                want = jfn.call({k: jnp.asarray(data[k]) for k in ENC})
                got = tfn({k: torch.from_numpy(data[k]) for k in ENC})
            assert all(v.shape[0] == n for v in got.values()), name
            compare(got, want)
    sigma_bytes = sum(p.numel() * p.element_size() for n, p in tmodel.named_parameters() if "fc_sigma" in n)
    if VARIANTS[variant].get("prior") != "beta":
        shrink = len(arts["encoder"][1]) - len(arts["encoder_mu"][1])
        assert sigma_bytes > 0 and shrink >= 0.9 * sigma_bytes, (shrink, sigma_bytes)


def _packed_forward(model, data):
    """The eval encoder's outputs and a train-mode forward's (the packed
    sampler), the BatchNorm statistics restored after it."""
    stats = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.eval()
        enc = model.encode(data)
        model.train()
        out = model(data, eps=torch.ones(data["x6d"].shape[0], Z))
        model.eval()
    model.load_state_dict(stats)
    return {**{f"eval_{k}": v for k, v in enc.items()}, **{k: out[k] for k in ("z", "x6d", "root")}}


def test_eager_forward_after_an_export_is_unchanged():
    """The packed head's index tensors and the polynomial expansion's
    monomial indices are cached; a trace (here an export, first to fill
    the caches) must leave them real, so eager calls after it give what
    they gave before."""
    _, _, tmodel = pair(VARIANTS["rcnn_packed"])
    data = {k: torch.from_numpy(v) for k, v in batch(3, 5).items()}
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(4, 3)).astype(np.float32))
    before = _packed_forward(tmodel, data)
    poly_before = scrubbers.polynomial_expand(x, 3)
    layers._tril_tensors.cache_clear()
    scrubbers.polynomial_indices.cache_clear()
    scrubbers._polynomial_indices_on.cache_clear()
    export_encoder(tmodel, data)

    class Poly(torch.nn.Module):
        def forward(self, x):
            return scrubbers.polynomial_expand(x, 3)

    torch.export.export(Poly(), (x,), strict=False)
    after = _packed_forward(tmodel, data)
    assert set(after) == set(before)
    for k, v in before.items():
        assert type(after[k]) is torch.Tensor and torch.equal(after[k], v), k
    poly_after = scrubbers.polynomial_expand(x, 3)
    assert type(poly_after) is torch.Tensor and torch.equal(poly_after, poly_before)
