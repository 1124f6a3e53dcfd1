"""Mutual-information estimator re-export (counterpart of
``scrubvae_tpu/models/mi.py``): the MCMI state and functions live in
``models/scrubbers.py`` beside the other scrubber states; this module keeps
the reference's layout, where the estimator sits apart."""

from scrubvae_torch.models.scrubbers import MIState, mi_init, mi_score  # noqa: F401

__all__ = ["MIState", "mi_init", "mi_score"]
