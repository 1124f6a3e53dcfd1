from scrubvae_torch.evals.restrictiveness import (  # noqa: F401
    generative_restrictiveness_batch,
)
