"""Config schema (the port's own copy of
``scrubvae_tpu/params/param_keys.py``): the reference's 4-section key set
plus keys it reads without declaring them.

The JAX package's accelerator keys stay in the schema so one config file
reads the same in both packages. In the port ``train.mesh`` must be unset
(one device), and ``train.scan_epoch`` and ``train.donate`` are accepted
and have no effect (see ``scrubvae_torch.train.trainer.Trainer``).
"""

PARAM_KEYS = dict(
    data=[
        "arena_size",
        "batch_size",
        "data_path",
        "dataset",
        "direction_process",
        "encoder_direction_process",
        "host_stream",
        "exact_offsets",  # un-truncated scaled offsets (reference: int-truncated)
        "part_centered_speed",  # true part-root speed centering (reference: no-op)
        "normalize",
        "remove_speed_outliers",
        "stride",
        "window",
    ],
    disentangle=[
        "alpha",
        "balance_loss",
        "bandwidth",
        "features",
        "method",
        "polynomial",
        "var_mode",
        "l2_reg",
        "n_iter",
        "adv_fit",
        "gr_legacy_norm",
    ],
    model=[
        "activation",
        "channel",
        "diag",
        "init_dilation",
        "kernel",
        "load_model",
        "prior",
        "start_epoch",
        "type",
        "window",
        "z_dim",
        "sigma_head_rank",
        "packed_sigma",
        "hidden",
        "n_heads",
        "ff_size",
        "n_layers",
    ],
    train=[
        "beta_anneal",
        "lr",
        "num_epochs",
        "optimizer",
        "lr_schedule",
        "minimal_test",
        "precision",  # "bf16" | "f32" compute for the conv/matmul path
        "mesh",  # must be unset in the port (one device)
        "seed",
        "donate",  # accepted, no effect in the port
        "moment_dtype",  # "bf16" (default) | "f32" Adam moments of large leaves
        "param_dtype",  # "bf16" storage for large kernels (stochastic rounding)
        "fused_optimizer",  # the fused AdamW kernel (the port's only optimizer)
        "clip_norm",  # grad-clip max norm; 0 disables; None = 1e6
        "scan_epoch",  # accepted, no effect in the port
        "eval_start_epoch",  # first epoch for val metrics (reference: 50)
        "halt_on_nonfinite",  # divergence tripwire (default on)
    ],
)
