from scrubvae_torch.evals import cluster, latents, metrics, restrictiveness, traverse  # noqa: F401
from scrubvae_torch.evals.restrictiveness import (  # noqa: F401
    generative_restrictiveness_batch,
)
