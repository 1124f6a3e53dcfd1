"""PyTorch/CUDA port of scrubvae-tpu for NVIDIA Hopper (H100).

Module names mirror ``scrubvae_tpu`` so each counterpart is easy to find.
The package imports torch, numpy and yaml only. Entry points
(``factory.build_model``, ``data.dataset.StreamDataset``,
``train.trainer.Trainer``) run on ``device="cuda"`` unless the caller asks
for ``device="cpu"``.
"""

__version__ = "0.1.0"
